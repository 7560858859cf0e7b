"""The port's copy of ``src/repro/core/balancer.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

Heterogeneity-aware load balancer (paper App. A.2).

For each input-length bucket the LB keeps a running average of observed
output lengths; a new request's output length is estimated from its input
bucket, identifying its (input, estimated-output) bucket.  The request is
then routed by weighted-random selection over instances, weights
proportional to each instance's MaxTput for that bucket.

Beyond-paper: optional straggler-aware weighting — instances report a TPOT
EWMA and weights are scaled by (slo / max(tpot, slo))^k so slow/overloaded
instances shed load.

Elastic extensions (trace-driven orchestration):
  * the instance set is mutable (``add_instance`` / ``remove_instance``);
  * *drain-aware* routing — instances marked draining finish their in-flight
    requests but receive no new routes (``mark_draining`` / ``undrain``);
  * *backlog-aware* routing — an optional ``depth_probe`` reports each
    instance's admission-queue depth and weights are divided by
    ``1 + depth``, so a backlogged instance is not chosen purely on
    throughput weight.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from .profiler import Profile
from .workload import INPUT_EDGES, OUTPUT_EDGES, edge_bucket, grid_edges


@dataclasses.dataclass
class InstanceRef:
    inst_id: int
    gpu: str


class LoadBalancer:
    def __init__(self, profile: Profile, instances: Sequence[InstanceRef],
                 *, seed: int = 0, straggler_factor: float = 0.0,
                 depth_probe: Optional[Callable[[int], float]] = None):
        self.profile = profile
        self.instances = list(instances)
        self.rng = np.random.default_rng(seed)
        self.straggler_factor = straggler_factor
        self.depth_probe = depth_probe
        self.draining: set[int] = set()
        # bucket edges come from the *profile's* grid (not the module
        # defaults): MaxTput rows are indexed by that grid, so a profile
        # built over a custom coarse grid must be routed on it too.
        # (profile=None is allowed for bucket-math-only uses and keeps
        # the default grid.)
        in_edges, out_edges = ((INPUT_EDGES, OUTPUT_EDGES)
                               if profile is None
                               else grid_edges(profile.buckets))
        ni = len(in_edges) - 1
        # output-length estimator state per input bucket
        self._sum = np.zeros(ni)
        self._cnt = np.zeros(ni)
        self._tpot_ewma = {}        # inst_id -> observed tpot
        self._i_edges = np.asarray(in_edges)
        self._o_edges = np.asarray(out_edges)
        self._no = len(out_edges) - 1

    # -- output length estimation ------------------------------------------
    def _input_bucket(self, input_len: int) -> int:
        # half-open [lo, hi) semantics shared with workload histograms
        return int(edge_bucket(input_len, self._i_edges))

    def estimate_output(self, input_len: int) -> float:
        bi = self._input_bucket(input_len)
        if self._cnt[bi] > 0:
            return self._sum[bi] / self._cnt[bi]
        tot_c, tot_s = self._cnt.sum(), self._sum.sum()
        return tot_s / tot_c if tot_c > 0 else 128.0

    def observe(self, input_len: int, output_len: int,
                inst_id: Optional[int] = None,
                tpot: Optional[float] = None) -> None:
        bi = self._input_bucket(input_len)
        self._sum[bi] += output_len
        self._cnt[bi] += 1
        if inst_id is not None and tpot is not None:
            prev = self._tpot_ewma.get(inst_id, tpot)
            self._tpot_ewma[inst_id] = 0.8 * prev + 0.2 * tpot

    # -- routing -------------------------------------------------------------
    def bucket_index(self, input_len: int, output_len_est: float) -> int:
        bi = self._input_bucket(input_len)
        bo = int(edge_bucket(output_len_est, self._o_edges))
        return bi * self._no + bo

    def route(self, input_len: int) -> InstanceRef:
        if not self.instances:
            raise RuntimeError("LoadBalancer.route: no instances registered")
        cand = [i for i in self.instances if i.inst_id not in self.draining]
        if not cand:          # whole fleet draining: keep serving somewhere
            cand = list(self.instances)
        est = self.estimate_output(input_len)
        bidx = self.bucket_index(input_len, est)
        weights = np.zeros(len(cand))
        for k, inst in enumerate(cand):
            w = self.profile.max_tput[inst.gpu][bidx]
            if self.straggler_factor > 0 and inst.inst_id in self._tpot_ewma:
                slo = self.profile.slo_tpot_s
                t = self._tpot_ewma[inst.inst_id]
                w *= (slo / max(t, slo)) ** self.straggler_factor
            weights[k] = w
        if not np.isfinite(weights).all() or weights.sum() <= 0:
            # nothing profiled-feasible for this bucket (every candidate's
            # MaxTput is 0 — e.g. a transient fleet where only oversized
            # requests' types remain): weighted-random degenerates, so fall
            # back to uniform over the candidates instead of raising.  The
            # depth division below still steers away from backlogged
            # instances.
            weights = np.ones(len(cand))
        if self.depth_probe is not None:
            depths = np.array([max(0.0, float(self.depth_probe(i.inst_id)))
                               for i in cand])
            weights = weights / (1.0 + depths)
        weights = weights / weights.sum()
        k = int(self.rng.choice(len(cand), p=weights))
        return cand[k]

    # -- fleet mutation (elastic orchestration) ------------------------------
    def add_instance(self, inst: InstanceRef) -> None:
        self.instances.append(inst)
        self.draining.discard(inst.inst_id)

    def remove_instance(self, inst_id: int) -> None:
        self.instances = [i for i in self.instances if i.inst_id != inst_id]
        self.draining.discard(inst_id)
        self._tpot_ewma.pop(inst_id, None)

    def mark_draining(self, inst_id: int) -> None:
        """Drain: the instance finishes in-flight work, gets no new routes."""
        self.draining.add(inst_id)

    def undrain(self, inst_id: int) -> None:
        self.draining.discard(inst_id)

    def is_draining(self, inst_id: int) -> bool:
        return inst_id in self.draining


class FleetBalancer:
    """Model-first routing for multi-model fleets.

    A request names its model; the fleet balancer dispatches it to that
    model's own ``LoadBalancer`` (each holding only the instances serving
    that model, with its own output-length estimator and the model's own
    SLO for straggler weighting).  Routing therefore never mixes models:
    an instance serves exactly one model's weights at a time.
    """

    def __init__(self, *, seed: int = 0, straggler_factor: float = 0.0,
                 depth_probe: Optional[Callable[[int], float]] = None):
        self.seed = seed
        self.straggler_factor = straggler_factor
        self.depth_probe = depth_probe
        self.lbs: dict[str, LoadBalancer] = {}

    def register_model(self, model: str, profile: Profile) -> LoadBalancer:
        """Create (or return) the per-model balancer.  Seeds are derived
        from the fleet seed + registration order so runs stay deterministic
        regardless of model-name hashing."""
        if model not in self.lbs:
            self.lbs[model] = LoadBalancer(
                profile, [], seed=self.seed + len(self.lbs),
                straggler_factor=self.straggler_factor,
                depth_probe=self.depth_probe)
        return self.lbs[model]

    def lb(self, model: str = "") -> LoadBalancer:
        return self.lbs[model]

    @property
    def models(self) -> list[str]:
        return list(self.lbs)

    def has_instances(self, model: str) -> bool:
        lb = self.lbs.get(model)
        return bool(lb and lb.instances)

    # -- model-first routing -------------------------------------------------
    def route(self, model: str, input_len: int) -> InstanceRef:
        lb = self.lbs.get(model)
        if lb is None:
            raise KeyError(f"no balancer registered for model '{model}'")
        return lb.route(input_len)

    def observe(self, model: str, input_len: int, output_len: int,
                inst_id: Optional[int] = None,
                tpot: Optional[float] = None) -> None:
        self.lbs[model].observe(input_len, output_len, inst_id=inst_id,
                                tpot=tpot)

    # -- fleet mutation ------------------------------------------------------
    def add_instance(self, model: str, inst: InstanceRef) -> None:
        self.lbs[model].add_instance(inst)

    def remove_instance(self, model: str, inst_id: int) -> None:
        self.lbs[model].remove_instance(inst_id)

    def mark_draining(self, model: str, inst_id: int) -> None:
        self.lbs[model].mark_draining(inst_id)

    def undrain(self, model: str, inst_id: int) -> None:
        self.lbs[model].undrain(inst_id)
