"""The port's copy of ``src/repro/core/simulator.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and
``tests/test_torch_control.py`` holds the two to the same results.
The original's docstring follows.

Discrete-event cluster simulator (§6.3's SLO-attainment experiment).

Requests arrive by a Poisson process, sizes sampled from a dataset; the LB
routes to instances; each instance runs a continuous-batching loop whose
step time comes from the same engine model used for profiling.  Per-request
TTFT and average TPOT are recorded, giving the Fig.-12 CDFs and the SLO
attainment rate.  Also accounts cost, enabling the Fig.-9-style comparisons
under bursty (non-steady-state) load.

The engine is split into reusable pieces so the trace-driven orchestrator
(`repro.orchestrator`) can run the same simulation with a *mutable* fleet:

  * ``InstanceEngine`` — one continuous-batching engine loop (chunked
    prefill, deque admission queue, memory-bounded admission);
  * ``ClusterEngine``  — the event queue + fleet: dynamic instance
    add/drain/remove, per-instance-lifetime cost accounting, and control
    callbacks that let an external controller run inside the sim clock;
  * ``simulate``       — the original fixed-allocation entry point, now a
    thin wrapper over ``ClusterEngine``.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

from .accelerators import Accelerator, chips_by_base, chips_by_pool
from .balancer import FleetBalancer, InstanceRef, LoadBalancer
from .engine_model import EngineModel, ModelPerf, EngineModelParams, DEFAULT_ENGINE
from .profiler import Profile
from .workload import sample_requests


@dataclasses.dataclass
class SimRequest:
    rid: int
    arrival: float
    input_len: int
    output_len: int
    model: str = ""                 # fleet model this request targets
    home_region: str = ""           # region the request originates in
    served_region: str = ""         # region of the instance that served it
    rtt_s: float = 0.0              # round trip burned by cross-region routing
    inst_id: int = -1
    first_token_t: float = -1.0
    finish_t: float = -1.0
    decoded: int = 0
    preemptions: int = 0
    reroutes: int = 0
    dropped: bool = False

    @property
    def tpot(self) -> float:
        if self.decoded <= 1 or self.first_token_t < 0:
            return 0.0
        return (self.finish_t - self.first_token_t) / max(1, self.decoded - 1)

    @property
    def tpot_charged(self) -> float:
        """TPOT with the cross-region RTT amortized over the generated
        tokens — the realized-request mirror of the solver's effective
        deadline ``slo - rtt / rep_output`` (``regions.rtt_tightened_slo``):
        a request served remotely must decode fast enough to win back the
        round trip its tokens spend on the wire."""
        if self.decoded <= 1 or self.first_token_t < 0:
            return 0.0
        return self.tpot + self.rtt_s / max(1, self.decoded)

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.arrival + self.rtt_s

    def reset_progress(self) -> None:
        """Lose all generation progress (instance preempted mid-flight)."""
        self.first_token_t = -1.0
        self.finish_t = -1.0
        self.decoded = 0
        self.preemptions += 1


class InstanceEngine:
    """One serving instance: continuous batching with chunked prefill."""

    def __init__(self, inst_id: int, gpu: Accelerator, em: EngineModel,
                 max_prefill_tokens_per_step: int = 4096,
                 gpu_name: str = "", launched_at: float = 0.0,
                 model: str = ""):
        self.inst_id = inst_id
        self.gpu = gpu
        self.gpu_name = gpu_name or gpu.name
        self.model = model          # fleet model whose weights are loaded
        self.em = em
        self.queue: collections.deque[SimRequest] = collections.deque()
        self.prefilling: list[tuple[SimRequest, int]] = []  # (req, remaining)
        self.active: list[SimRequest] = []
        self.pf_budget = max_prefill_tokens_per_step
        self.launched_at = launched_at
        self.retired_at: Optional[float] = None
        self.draining = False

    @property
    def tp(self) -> int:
        """Tensor-parallel degree of this engine instance."""
        return self.gpu.tp

    @property
    def chips(self) -> int:
        """Chips of the base type this instance draws from the pool."""
        return self.gpu.chips

    @property
    def is_spot(self) -> bool:
        """Preemptible price tier (spot reclaims may kill this instance)."""
        return self.gpu.is_spot

    def kv_tokens(self) -> float:
        return (sum(r.input_len + r.decoded for r in self.active)
                + sum(r.input_len - rem for r, rem in self.prefilling))

    def load(self) -> int:
        """Total in-flight requests (queued + prefilling + decoding)."""
        return len(self.queue) + len(self.prefilling) + len(self.active)

    def backlog(self) -> int:
        """Requests not yet decoding — the LB's queue-depth signal."""
        return len(self.queue) + len(self.prefilling)

    def in_flight(self) -> list[SimRequest]:
        return (list(self.queue) + [r for r, _ in self.prefilling]
                + list(self.active))

    def can_admit(self, r: SimRequest) -> bool:
        m = self.em.m
        n_seqs = len(self.active) + len(self.prefilling) + 1
        need = (m.param_bytes + m.state_bytes * n_seqs
                + (self.kv_tokens() + r.input_len + 8) * m.kv_bytes_per_token)
        return need <= self.gpu.mem_bytes * 0.92

    def step(self, now: float):
        """One engine step with Sarathi-style chunked prefill: at most
        pf_budget prompt tokens share the step with decode, so one huge
        prefill never stalls co-resident decodes for seconds (the paper's
        §6.3 co-location violation source)."""
        budget = self.pf_budget
        pf_tokens = 0
        while budget > 0:
            if not self.prefilling:
                if (self.queue and self.queue[0].arrival <= now
                        and self.can_admit(self.queue[0])):
                    r = self.queue.popleft()
                    self.prefilling.append((r, r.input_len))
                else:
                    break
            r, rem = self.prefilling[0]
            chunk = min(budget, rem)
            pf_tokens += chunk
            budget -= chunk
            rem -= chunk
            if rem == 0:
                self.prefilling.pop(0)
                self.active.append(r)
            else:
                self.prefilling[0] = (r, rem)
        b = len(self.active)
        if b == 0 and pf_tokens == 0:
            return None, []
        dur = self.em.decode_step_time(self.gpu, b, self.kv_tokens()
                                       / max(1, b)) if b else 0.0
        if pf_tokens:
            dur += pf_tokens / self.em.prefill_rate(self.gpu, pf_tokens)
        done = []
        for r in self.active:
            if r.decoded == 0:
                r.first_token_t = now + dur
            r.decoded += 1
            if r.decoded >= r.output_len:
                r.finish_t = now + dur
                done.append(r)
        self.active = [r for r in self.active if r.decoded < r.output_len]
        return dur, done


_Instance = InstanceEngine        # backwards-compatible alias


class ClusterEngine:
    """Event-driven simulation over a mutable fleet of ``InstanceEngine``s.

    Event kinds (heap order at equal timestamps): request arrival, engine
    step, control callback.  Control callbacks are how the orchestrator's
    telemetry windows, delayed instance launches, and fleet events run
    *inside* the simulation clock.

    Multi-model fleets: further models are added with ``register_model``;
    instances are launched *for* a model (``add_instance(..., model=m)``),
    requests carry ``SimRequest.model``, and routing is model-first — each
    model has its own ``LoadBalancer`` over only its instances (per-model
    SLO, per-model output-length estimator).  The default single-model API
    is the ``""`` model and is unchanged.
    """

    ARRIVAL, STEP, CONTROL = 0, 1, 2

    def __init__(self, profile: Profile, em: EngineModel, *,
                 seed: int = 0, straggler_factor: float = 0.0,
                 prefill_chunk: int = 4096, depth_aware: bool = True,
                 tracer=None):
        self.profile = profile
        # optional repro.obs.trace.SpanTracer: sampled request-lifecycle
        # spans are emitted at completion/drop (zero work when absent or
        # disabled); duck-typed to keep the simulator obs-import-free
        self._tracer = tracer
        self.em = em
        self.prefill_chunk = prefill_chunk
        self.instances: dict[int, InstanceEngine] = {}
        self.retired: list[InstanceEngine] = []
        # depth_aware=False restores the paper's pure MaxTput-weighted
        # routing (App. A.2) for fidelity experiments
        self.balancer = FleetBalancer(
            seed=seed, straggler_factor=straggler_factor,
            depth_probe=self._backlog_of if depth_aware else None)
        self.models: dict[str, tuple[Profile, EngineModel]] = {}
        self.register_model("", profile, em)
        self.completed: list[SimRequest] = []
        self.dropped: list[SimRequest] = []
        self.now = 0.0
        self._ev: list[tuple[float, int, int]] = []   # (t, kind, seq)
        self._payload: dict[int, object] = {}
        self._seq = 0
        self._stepping: set[int] = set()
        self._next_id = 0
        self._pending: list[SimRequest] = []   # arrivals during a fleet gap

    @classmethod
    def for_fleet(cls, models: "dict[str, tuple[Profile, EngineModel]]",
                  **kw) -> "ClusterEngine":
        """Build a multi-model engine from {model: (profile, engine)}.

        Only the named models are registered — the single-model ``""``
        sentinel is dropped (unless it is one of the names), so
        ``add_instance(gpu)`` without an explicit model on a fleet engine
        raises instead of silently creating a billed-but-unreachable
        instance."""
        if not models:
            raise ValueError("fleet engine needs at least one model")
        first = next(iter(models))
        eng = cls(models[first][0], models[first][1], **kw)
        if "" not in models:
            del eng.models[""]
            del eng.balancer.lbs[""]
        for m, (profile, em) in models.items():
            eng.register_model(m, profile, em)
        return eng

    # -- wiring --------------------------------------------------------------
    def register_model(self, model: str, profile: Profile,
                       em: EngineModel) -> None:
        """Add a model the fleet can serve (idempotent per name)."""
        if model not in self.models:
            self.models[model] = (profile, em)
            self.balancer.register_model(model, profile)

    @property
    def lb(self) -> LoadBalancer:
        """Default model's balancer (single-model back-compat); on a
        fleet engine with no ``""`` model, the first model's balancer."""
        if "" in self.balancer.lbs:
            return self.balancer.lb("")
        return next(iter(self.balancer.lbs.values()))

    def _backlog_of(self, inst_id: int) -> float:
        inst = self.instances.get(inst_id)
        return float(inst.backlog()) if inst is not None else 0.0

    def _push(self, t: float, kind: int, payload) -> None:
        self._seq += 1
        self._payload[self._seq] = payload
        heapq.heappush(self._ev, (t, kind, self._seq))

    # -- fleet mutation ------------------------------------------------------
    def add_instance(self, gpu_name: str, at: Optional[float] = None,
                     model: str = "") -> int:
        if model not in self.models:
            raise KeyError(f"model '{model}' not registered with the engine")
        t = self.now if at is None else at
        iid = self._next_id
        self._next_id += 1
        profile, em = self.models[model]
        inst = InstanceEngine(iid, profile.gpus[gpu_name], em,
                              self.prefill_chunk, gpu_name=gpu_name,
                              launched_at=t, model=model)
        self.instances[iid] = inst
        self.balancer.add_instance(model, InstanceRef(iid, gpu_name))
        if self._pending:   # this model's capacity is back: requeue its holds
            held = [r for r in self._pending if r.model == model]
            if held:
                self._pending = [r for r in self._pending
                                 if r.model != model]
                for r in held:
                    self._push(t, self.ARRIVAL, r)
        return iid

    def retarget_instance(self, inst_id: int, model: str,
                          reload_delay_s: float = 0.0) -> list[SimRequest]:
        """Repoint a live instance at another model (weight swap) instead
        of drain-and-relaunch.  Its in-flight requests are returned to the
        caller (they belong to the old model); the instance itself comes
        back ``reload_delay_s`` later as a fresh instance of the same GPU
        serving ``model``.  Returns the orphaned requests."""
        inst = self.instances.get(inst_id)
        if inst is None:
            return []
        if model not in self.models:
            raise KeyError(f"model '{model}' not registered with the engine")
        gpu_name = inst.gpu_name
        orphans = self.remove_instance(inst_id)
        if reload_delay_s <= 0:
            self.add_instance(gpu_name, model=model)
        else:
            self.schedule(self.now + reload_delay_s,
                          lambda e, g=gpu_name, m=model: e.add_instance(
                              g, model=m))
        return orphans

    def begin_drain(self, inst_id: int) -> None:
        """No new routes; the instance retires once its in-flight work ends."""
        inst = self.instances.get(inst_id)
        if inst is None:
            return
        inst.draining = True
        self.balancer.mark_draining(inst.model, inst_id)
        if inst.load() == 0:
            self._retire(inst_id)

    def cancel_drain(self, inst_id: int) -> bool:
        """Reuse a still-warm draining instance instead of launching anew."""
        inst = self.instances.get(inst_id)
        if inst is None or not inst.draining:
            return False
        inst.draining = False
        self.balancer.undrain(inst.model, inst_id)
        return True

    def draining_ids(self, gpu_name: Optional[str] = None,
                     model: Optional[str] = None) -> list[int]:
        return [i for i, inst in self.instances.items() if inst.draining
                and (gpu_name is None or inst.gpu_name == gpu_name)
                and (model is None or inst.model == model)]

    def _retire(self, inst_id: int) -> None:
        inst = self.instances.pop(inst_id)
        inst.retired_at = self.now
        self.retired.append(inst)
        self.balancer.remove_instance(inst.model, inst_id)
        self._stepping.discard(inst_id)

    def remove_instance(self, inst_id: int) -> list[SimRequest]:
        """Hard removal (preemption): in-flight requests are returned to the
        caller, which decides whether to resubmit or drop them."""
        inst = self.instances.get(inst_id)
        if inst is None:
            return []
        orphans = inst.in_flight()
        inst.queue.clear()
        inst.prefilling.clear()
        inst.active.clear()
        self._retire(inst_id)
        return orphans

    def fleet_counts(self, include_draining: bool = True,
                     model: Optional[str] = None) -> dict[str, int]:
        out: dict[str, int] = {}
        for inst in self.instances.values():
            if not include_draining and inst.draining:
                continue
            if model is not None and inst.model != model:
                continue
            out[inst.gpu_name] = out.get(inst.gpu_name, 0) + 1
        return out

    def fleet_counts_by_model(self, include_draining: bool = True
                              ) -> dict[str, dict[str, int]]:
        """{model: {gpu: live instances}} — the fleet's per-model view
        (models with no instances are omitted)."""
        out: dict[str, dict[str, int]] = {}
        for inst in self.instances.values():
            if not include_draining and inst.draining:
                continue
            d = out.setdefault(inst.model, {})
            d[inst.gpu_name] = d.get(inst.gpu_name, 0) + 1
        return out

    def chips_by_base(self, include_draining: bool = True) -> dict[str, int]:
        """Chips held per base-type pool (TP variants aggregated, summed
        across every model's instances — the pool is shared)."""
        out: dict[str, int] = {}
        for inst in self.instances.values():
            if not include_draining and inst.draining:
                continue
            base = inst.gpu.base_name
            out[base] = out.get(base, 0) + inst.chips
        return out

    def chips_by_pool(self, include_draining: bool = True) -> dict[str, int]:
        """Chips held per pool at both granularities: physical base pools
        plus ``"<base>:spot"`` market sub-pools (spot stockout caps read
        the latter)."""
        counts: dict[str, int] = {}
        for inst in self.instances.values():
            if not include_draining and inst.draining:
                continue
            counts[inst.gpu_name] = counts.get(inst.gpu_name, 0) + 1
        return chips_by_pool(counts, self.profile.gpus)

    def cost_rate(self) -> float:
        """Current fleet $/h (draining instances still bill; spot
        instances bill at their variant's — i.e. spot — price)."""
        return sum(i.gpu.price_hr for i in self.instances.values())

    def cost(self, until: Optional[float] = None) -> float:
        """$ spent: per-instance lifetime integral of the hourly price.

        Lifetimes are clamped to ``[launched_at, until]`` on *both* ends:
        an instance retired (drained, preempted, or retargeted) after
        ``until`` bills only up to ``until``, and one launched after
        ``until`` bills nothing — otherwise a retarget, which retires the
        donor and starts a fresh instance, would double-bill the overlap
        window in any ``cost(until=...)`` query that predates it."""
        t_end = self.now if until is None else until
        total = 0.0
        for inst in list(self.instances.values()) + self.retired:
            t1 = inst.retired_at if inst.retired_at is not None else t_end
            t1 = min(t1, t_end)
            total += (inst.gpu.price_hr
                      * max(0.0, t1 - inst.launched_at) / 3600.0)
        return total

    # -- request flow --------------------------------------------------------
    def submit(self, req: SimRequest, at: Optional[float] = None) -> None:
        self._push(req.arrival if at is None else at, self.ARRIVAL, req)

    def resubmit(self, reqs: list[SimRequest], at: float) -> None:
        """Re-route preempted requests; they restart prefill from scratch."""
        for r in reqs:
            r.reset_progress()
            self._push(at, self.ARRIVAL, r)

    def drop(self, req: SimRequest) -> None:
        req.dropped = True
        self.dropped.append(req)
        tr = self._tracer
        if tr is not None and tr.sampled(req.rid):
            tr.instant(f"drop:{req.rid}", self.now, track="events",
                       model=req.model or None)

    def schedule(self, t: float, fn: Callable[["ClusterEngine"], None]) -> None:
        """Run ``fn(engine)`` at simulated time ``t`` (control event)."""
        self._push(t, self.CONTROL, fn)

    def _route(self, r: SimRequest, now: float) -> None:
        # model-first: only instances serving r.model are candidates; a
        # per-model fleet gap (e.g. mass preemption) holds that model's
        # arrivals until one of *its* instances launches
        if not self.balancer.has_instances(r.model):
            self._pending.append(r)
            return
        ref = self.balancer.route(r.model, r.input_len)
        r.inst_id = ref.inst_id
        inst = self.instances[ref.inst_id]
        inst.queue.append(r)
        if ref.inst_id not in self._stepping:
            self._stepping.add(ref.inst_id)
            self._push(now, self.STEP, ref.inst_id)

    # -- event loop ----------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        """Process events until the heap empties (or past ``until``)."""
        while self._ev:
            if until is not None and self._ev[0][0] > until:
                break
            now, kind, seq = heapq.heappop(self._ev)
            payload = self._payload.pop(seq)
            self.now = max(self.now, now)
            if kind == self.ARRIVAL:
                self._route(payload, now)
            elif kind == self.CONTROL:
                payload(self)
            else:
                self._on_step(payload, now)

    def _on_step(self, iid: int, now: float) -> None:
        inst = self.instances.get(iid)
        if inst is None:                  # preempted with a step in flight
            self._stepping.discard(iid)
            return
        dur, done = inst.step(now)
        for r in done:
            self.balancer.observe(inst.model, r.input_len, r.output_len,
                                  inst_id=iid, tpot=r.tpot)
            self.completed.append(r)
            tr = self._tracer
            if tr is not None and tr.sampled(r.rid):
                tr.request_span(r.rid, r.arrival, r.first_token_t,
                                r.finish_t, gpu=inst.gpu_name,
                                model=r.model or inst.model)
        if dur is None:
            self._stepping.discard(iid)
            if inst.queue:
                head = inst.queue[0]
                if head.arrival > now:    # waiting on a future arrival
                    self._stepping.add(iid)
                    self._push(head.arrival, self.STEP, iid)
                else:
                    # head can never be admitted on an otherwise-empty
                    # instance (request larger than its memory): re-route it
                    # — another type in the fleet may fit it — with a
                    # bounded retry budget so the loop always progresses.
                    inst.queue.popleft()
                    if head.reroutes < 3 * max(1, len(self.instances)):
                        head.reroutes += 1
                        self._push(now, self.ARRIVAL, head)
                    else:
                        self.drop(head)
                    if inst.load():
                        self._stepping.add(iid)
                        self._push(now, self.STEP, iid)
            if inst.draining and inst.load() == 0:
                self._retire(iid)
        else:
            self._push(now + dur, self.STEP, iid)

    def drop_stranded(self) -> int:
        """Explicitly drop arrivals still held with no instance ever coming
        back (call after the event loop drains)."""
        held, self._pending = self._pending, []
        for r in held:
            self.drop(r)
        return len(held)

    def conservation(self) -> dict[str, int]:
        """Every submitted request is completed, dropped, or in flight."""
        in_flight = (sum(i.load() for i in self.instances.values())
                     + len(self._pending))
        return {"completed": len(self.completed),
                "dropped": len(self.dropped), "in_flight": in_flight}


@dataclasses.dataclass
class SimResult:
    requests: list[SimRequest]
    duration_s: float
    cost: float
    slo_tpot_s: float
    n_dropped: int = 0

    @property
    def tpots(self) -> np.ndarray:
        return np.array([r.tpot for r in self.requests
                         if r.decoded > 1 and not r.dropped])

    @property
    def ttfts(self) -> np.ndarray:
        return np.array([r.ttft for r in self.requests
                         if r.first_token_t >= 0 and not r.dropped])

    @property
    def slo_attainment(self) -> float:
        """Dropped requests count as SLO misses."""
        t = self.tpots
        denom = len(t) + self.n_dropped
        if denom == 0:
            return 1.0
        return float((t <= self.slo_tpot_s + 1e-9).sum() / denom)

    def tpot_percentiles(self, qs=(50, 90, 99, 99.5)):
        t = self.tpots
        return {q: float(np.percentile(t, q)) for q in qs} if len(t) else {}


def simulate(
    allocation_counts: dict[str, int],
    profile: Profile,
    model: ModelPerf,
    dataset: str,
    rate: float,
    n_requests: int = 2000,
    *,
    engine_params: EngineModelParams = DEFAULT_ENGINE,
    seed: int = 0,
    straggler_factor: float = 0.0,
    prefill_chunk: int = 4096,
    depth_aware: bool = True,
) -> SimResult:
    """Fixed-allocation simulation (the paper's §6.3 setup)."""
    rng = np.random.default_rng(seed)
    em = EngineModel(model, engine_params)
    eng = ClusterEngine(profile, em, seed=seed,
                        straggler_factor=straggler_factor,
                        prefill_chunk=prefill_chunk,
                        depth_aware=depth_aware)
    for gpu_name, n in sorted(allocation_counts.items()):
        for _ in range(int(n)):
            eng.add_instance(gpu_name, at=0.0)

    ins, outs = sample_requests(dataset, n_requests, seed=seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    reqs = [SimRequest(i, float(arrivals[i]), int(ins[i]), int(outs[i]))
            for i in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return SimResult(reqs, eng.now, eng.cost(), profile.slo_tpot_s,
                     n_dropped=len(eng.dropped))


# ---------------------------------------------------------------------------
# Multi-model fleet simulation
# ---------------------------------------------------------------------------
def slo_attainment_by_model(requests: list[SimRequest],
                            slo_by_model: "dict[str, float]",
                            model: Optional[str] = None) -> float:
    """THE per-model SLO judging rule, shared by every fleet surface
    (simulator and orchestrator results): each request is measured against
    *its own model's* TPOT SLO; dropped requests count as misses;
    single-token responses produce no TPOT sample and are excluded."""
    ok = n = 0
    for r in requests:
        if model is not None and r.model != model:
            continue
        if r.dropped:
            n += 1
        elif r.decoded > 1:
            n += 1
            if r.tpot <= slo_by_model[r.model] + 1e-9:
                ok += 1
    return ok / n if n else 1.0


@dataclasses.dataclass
class FleetSimResult:
    """Simulation of several models sharing one cluster: every request is
    judged against *its own model's* TPOT SLO."""

    requests: list[SimRequest]
    duration_s: float
    cost: float
    slo_by_model: dict[str, float]
    n_dropped: int = 0

    def tpots(self, model: Optional[str] = None) -> np.ndarray:
        return np.array([r.tpot for r in self.requests
                         if r.decoded > 1 and not r.dropped
                         and (model is None or r.model == model)])

    def slo_attainment(self, model: Optional[str] = None) -> float:
        return slo_attainment_by_model(self.requests, self.slo_by_model,
                                       model)

    def per_model(self) -> dict[str, dict]:
        return {m: {"slo_tpot_s": slo,
                    "n": sum(1 for r in self.requests if r.model == m),
                    "slo_attainment": self.slo_attainment(m)}
                for m, slo in self.slo_by_model.items()}


def simulate_fleet(
    counts_by_model: "dict[str, dict[str, int]]",
    members: "dict[str, tuple[Profile, EngineModel]]",
    datasets: "dict[str, str]",
    rates: "dict[str, float]",
    n_requests: int = 2000,
    *,
    seed: int = 0,
    straggler_factor: float = 0.0,
    prefill_chunk: int = 4096,
    depth_aware: bool = True,
) -> FleetSimResult:
    """Fixed multi-model allocation under Poisson load per model.

    ``counts_by_model`` maps model -> {gpu: instances} (e.g. from
    ``FleetAllocation.per_model[...].counts``); ``members`` carries each
    model's profile (its SLO) and engine model; request volume is split
    across models in proportion to their rates."""
    rng = np.random.default_rng(seed)
    eng = ClusterEngine.for_fleet(members, seed=seed,
                                  straggler_factor=straggler_factor,
                                  prefill_chunk=prefill_chunk,
                                  depth_aware=depth_aware)
    for m, counts in sorted(counts_by_model.items()):
        for gpu_name, n in sorted(counts.items()):
            for _ in range(int(n)):
                eng.add_instance(gpu_name, at=0.0, model=m)
    total_rate = sum(rates.values())
    reqs: list[SimRequest] = []
    rid = 0
    for k, m in enumerate(sorted(rates)):
        if rates[m] <= 0:
            continue
        n_m = max(1, int(round(n_requests * rates[m] / max(total_rate,
                                                           1e-9))))
        ins, outs = sample_requests(datasets[m], n_m, seed=seed + 1 + k)
        arrivals = np.cumsum(rng.exponential(1.0 / rates[m], size=n_m))
        for i in range(n_m):
            reqs.append(SimRequest(rid, float(arrivals[i]), int(ins[i]),
                                   int(outs[i]), model=m))
            rid += 1
    for r in reqs:
        eng.submit(r)
    eng.run()
    eng.drop_stranded()
    return FleetSimResult(
        reqs, eng.now, eng.cost(),
        {m: members[m][0].slo_tpot_s for m in members},
        n_dropped=len(eng.dropped))
