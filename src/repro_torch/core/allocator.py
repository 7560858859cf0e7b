"""The port's copy of ``src/repro/core/allocator.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and
``tests/test_torch_control.py`` holds the two to the same results.
The original's docstring follows.

Mélange end-to-end (Fig. 1): inputs -> profile -> ILP -> allocation.

TP-degree-aware mode (``tp_degrees=...``): the catalog is expanded into
(type, tp) variants before profiling, the solver picks per-variant instance
counts, and availability can be bounded in *chips of the base type* shared
across variants (``chip_caps``).

Price-tier-aware mode (``spot_tiers=True``): the catalog additionally
gains a preemptible spot sibling per base type (same silicon, spot price,
``preemption_rate``).  ``allocate(min_ondemand_frac=...,
replacement_delay_s=...)`` then prices preemption risk in: spot columns'
throughput is discounted by the expected replacement downtime, and each
bucket keeps at least the floored share of its slices on non-preemptible
instances.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from .accelerators import (Accelerator, chips_by_base, chips_by_pool,
                           expand_price_tiers, expand_tp_variants, pool_key)
from .engine_model import DEFAULT_ENGINE, EngineModelParams, ModelPerf
from .ilp import ILPProblem, ILPSolution, solve, solve_incremental
from .loadmatrix import build_fleet_problem, build_problem
from .profiler import Profile, profile_catalog
from .workload import ModelSpec, Workload


def group_counts_by(counts: Mapping[str, int],
                    gpus: Mapping[str, Accelerator],
                    key) -> dict[str, dict[str, int]]:
    """Group per-variant instance counts by ``key(acc)`` (tier, region,
    ...) — THE grouping rule shared by every allocation view (core and
    regional alike), so the split can never diverge between them."""
    out: dict[str, dict[str, int]] = {}
    for g, n in counts.items():
        out.setdefault(key(gpus[g]), {})[g] = n
    return out


def group_cost_by(counts: Mapping[str, int],
                  gpus: Mapping[str, Accelerator],
                  key) -> dict[str, float]:
    """$/h split by ``key(acc)`` — every variant bills at its own
    (tier- and region-adjusted) ``price_hr``."""
    out: dict[str, float] = {}
    for g, n in counts.items():
        acc = gpus[g]
        out[key(acc)] = out.get(key(acc), 0.0) + acc.price_hr * n
    return out


@dataclasses.dataclass
class Allocation:
    counts: dict[str, int]              # GPU variant name -> instances
    cost_per_hour: float
    solution: ILPSolution
    profile: Profile
    workload: Workload

    @property
    def total_instances(self) -> int:
        return sum(self.counts.values())

    solution_gpu_names: list[str] = dataclasses.field(default_factory=list)
    # the ILP this allocation solved — kept so the next allocate() call can
    # diff against it and re-open only the changed columns (solver fast
    # path's incremental re-solve)
    problem: Optional[ILPProblem] = None

    def counts_by_tp(self) -> dict[tuple[str, int], int]:
        """Instance counts keyed by (base type, tp degree)."""
        out: dict[tuple[str, int], int] = {}
        for g, n in self.counts.items():
            acc = self.profile.gpus[g]
            key = (acc.base_name, acc.tp)
            out[key] = out.get(key, 0) + n
        return out

    def chips_by_base(self) -> dict[str, int]:
        """Chips drawn from each base-type pool (Σ_tp tp·B_{g,tp})."""
        return chips_by_base(self.counts, self.profile.gpus)

    def chips_by_pool(self) -> dict[str, int]:
        """Chips per pool at both granularities: physical base pools (all
        tiers) plus ``"<base>:spot"`` market sub-pools."""
        return chips_by_pool(self.counts, self.profile.gpus)

    def counts_by_tier(self) -> dict[str, dict[str, int]]:
        """Instance counts split by price tier: tier -> {variant: n}."""
        return group_counts_by(self.counts, self.profile.gpus,
                               lambda a: a.tier)

    def counts_by_region(self) -> dict[str, dict[str, int]]:
        """Instance counts split by region ("" for global entries) — the
        per-region view for region-expanded catalogs."""
        return group_counts_by(self.counts, self.profile.gpus,
                               lambda a: a.region)

    def cost_by_region(self) -> dict[str, float]:
        """$/h split by region (regional variants bill at their region's
        multiplied price)."""
        return group_cost_by(self.counts, self.profile.gpus,
                             lambda a: a.region)

    def cost_by_tier(self) -> dict[str, float]:
        """$/h split by price tier (spot instances bill at spot price)."""
        return group_cost_by(self.counts, self.profile.gpus,
                             lambda a: a.tier)

    def bucket_assignment(self, slice_factor: int = 8):
        """bucket index -> {gpu: fraction of bucket's slices} (for the LB)."""
        slices = self.workload.slices(slice_factor)
        out: dict[int, dict[str, float]] = {}
        names = self.solution_gpu_names
        for (bi, _), j in zip(slices, self.solution.assignment):
            d = out.setdefault(bi, {})
            g = names[j]
            d[g] = d.get(g, 0.0) + 1.0
        for bi, d in out.items():
            tot = sum(d.values())
            for g in d:
                d[g] /= tot
        return out


class Melange:
    """The allocation framework. Profiling is one-time per (model, SLO)."""

    def __init__(self, gpus: Mapping[str, Accelerator], model: ModelPerf,
                 slo_tpot_s: float,
                 engine_params: EngineModelParams = DEFAULT_ENGINE,
                 profile: Optional[Profile] = None,
                 slice_factor: int = 8,
                 buckets=None,
                 tp_degrees: Optional[Sequence[int]] = None,
                 spot_tiers: bool = False):
        from .workload import bucket_grid
        gpus = dict(gpus)
        if tp_degrees is not None:
            gpus = expand_tp_variants(gpus, tp_degrees)
        if spot_tiers:
            gpus = expand_price_tiers(gpus)
        self.gpus = gpus
        self.model = model
        self.slo = slo_tpot_s
        self.slice_factor = slice_factor
        self.buckets = buckets or bucket_grid()
        self.profile = profile or profile_catalog(
            self.gpus, self.buckets, model, slo_tpot_s, engine_params)

    def allocate(self, workload: Workload, *,
                 caps: dict[str, int] | None = None,
                 chip_caps: dict[str, int] | None = None,
                 gpu_subset: list[str] | None = None,
                 over_provision: float = 0.0,
                 min_ondemand_frac: float = 0.0,
                 replacement_delay_s: float = 0.0,
                 time_budget_s: float = 5.0,
                 tput_scale: Optional[Mapping] = None,
                 prev: Optional[Allocation] = None) -> Optional[Allocation]:
        """Derive the minimal-cost allocation (§5.4). ``over_provision``
        inflates bucket rates (§6.3's burst-absorption knob); ``caps``
        bounds instances of a named variant, ``chip_caps`` bounds chips of
        a base type shared across its TP variants (a ``"<base>:spot"`` key
        bounds only the spot sub-pool).  ``min_ondemand_frac`` /
        ``replacement_delay_s`` are the availability floor for price-tier
        catalogs (no-ops without spot variants).

        ``prev`` (a previous allocation from this instance) switches to
        the incremental re-solve: slices whose load row, price, and cap
        context are unchanged stay pinned to their previous column and
        only the drifted remainder is re-opened (falling back to a
        warm-started cold solve when nothing carries over).

        ``tput_scale`` (variant name -> scalar or per-bucket multiplier)
        corrects predicted throughput per column — the fleet health
        engine's drift feedback.  A scale change alters those columns'
        load rows, so the incremental re-solve re-opens exactly the
        drifted columns' slices."""
        wl = workload if over_provision <= 0 else Workload(
            workload.buckets, workload.rates * (1 + over_provision),
            name=workload.name + f"+op{over_provision}")
        prob = build_problem(wl, self.profile, self.slice_factor,
                             caps=caps, gpu_subset=gpu_subset,
                             chip_caps=chip_caps,
                             min_ondemand_frac=min_ondemand_frac,
                             replacement_delay_s=replacement_delay_s,
                             tput_scale=tput_scale)
        if prev is not None and prev.problem is not None:
            # incremental re-solve off the previous allocation: the tp=1
            # pre-solve is skipped — the previous solution already seeds
            # the search, and unchanged slices stay pinned
            sol = solve_incremental(
                prob, np.asarray(prev.solution.assignment, dtype=int),
                prev_prob=prev.problem, time_budget_s=time_budget_s)
            if sol is None:
                return None
            counts = sol.by_gpu(prob.gpu_names)
            return Allocation(counts, sol.cost, sol, self.profile, wl,
                              solution_gpu_names=prob.gpu_names,
                              problem=prob)
        # hierarchical warm start for TP-expanded catalogs: the tp=1
        # sub-catalog solution is a feasible point of the full problem and
        # enters the candidate pool, so the returned cost never exceeds the
        # pre-solve's — the expanded search can only improve on it even
        # when it hits its time budget.  (Both solves are any-time, so this
        # bounds against *this* pre-solve, not a separately-run fixed solve
        # that happened to get more wall clock.)
        warm = None
        main_budget = time_budget_s
        # prob.gpu_names are drawn from the profile's catalog (which may
        # differ from self.gpus when a precomputed profile was supplied)
        tp1 = [g for g in prob.gpu_names if self.profile.gpus[g].tp == 1]
        if len(tp1) not in (0, len(prob.gpu_names)):
            t0 = time.perf_counter()
            prob1 = build_problem(wl, self.profile, self.slice_factor,
                                  caps=caps, gpu_subset=tp1,
                                  chip_caps=chip_caps,
                                  min_ondemand_frac=min_ondemand_frac,
                                  replacement_delay_s=replacement_delay_s,
                                  tput_scale=tput_scale)
            sol1 = solve(prob1, time_budget_s=min(1.0, time_budget_s / 3))
            # the pre-solve spends part of the caller's budget, not extra
            main_budget = max(0.1, time_budget_s - (time.perf_counter() - t0))
            if sol1 is not None:
                col = [prob.gpu_names.index(g) for g in prob1.gpu_names]
                warm = np.array([col[j] for j in sol1.assignment])
        sol = solve(prob, time_budget_s=main_budget, warm_assign=warm)
        if sol is None:
            return None
        counts = sol.by_gpu(prob.gpu_names)
        alloc = Allocation(counts, sol.cost, sol, self.profile, wl,
                           solution_gpu_names=prob.gpu_names, problem=prob)
        return alloc

    def single_type_baseline(self, workload: Workload, gpu: str,
                             **kw) -> Optional[Allocation]:
        """§6.1 baseline: the same ILP restricted to one GPU type."""
        return self.allocate(workload, gpu_subset=[gpu], **kw)

    def all_baselines(self, workload: Workload, **kw):
        out = {}
        for g in sorted(self.gpus):
            out[g] = self.single_type_baseline(workload, g, **kw)
        return out


# ---------------------------------------------------------------------------
# Multi-model fleets: several models, per-model SLOs, one shared pool
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetAllocation:
    """Joint allocation of a multi-model fleet.

    ``per_model`` holds one ordinary :class:`Allocation` view per model
    (its own counts, cost share, solution slice, profile, and workload),
    so everything downstream that consumes an ``Allocation`` — simulators,
    autoscalers, benchmarks — works per model unchanged.  ``solution`` is
    the joint stacked solve when the allocation came from one solver run;
    partial re-solves (the fleet autoscaler's drift path) merge per-model
    views and leave it ``None``.
    """

    per_model: dict[str, Allocation]
    solution: Optional[ILPSolution] = None

    @property
    def models(self) -> list[str]:
        return list(self.per_model)

    @property
    def cost_per_hour(self) -> float:
        return sum(a.cost_per_hour for a in self.per_model.values())

    @property
    def total_instances(self) -> int:
        return sum(a.total_instances for a in self.per_model.values())

    def counts(self) -> dict[tuple[str, str], int]:
        """(model, gpu variant) -> instance count."""
        return {(m, g): n for m, a in self.per_model.items()
                for g, n in a.counts.items() if n > 0}

    def gpu_totals(self) -> dict[str, int]:
        """Instances per GPU variant summed across models (pool usage)."""
        out: dict[str, int] = {}
        for a in self.per_model.values():
            for g, n in a.counts.items():
                out[g] = out.get(g, 0) + n
        return out

    def chips_by_base(self) -> dict[str, int]:
        """Chips drawn per base-type pool, summed across models."""
        out: dict[str, int] = {}
        for a in self.per_model.values():
            for b, c in a.chips_by_base().items():
                out[b] = out.get(b, 0) + c
        return out

    def chips_by_pool(self) -> dict[str, int]:
        """Chips per pool (physical + spot sub-pools), across models."""
        out: dict[str, int] = {}
        for a in self.per_model.values():
            for p, c in a.chips_by_pool().items():
                out[p] = out.get(p, 0) + c
        return out

    def cost_by_tier(self) -> dict[str, float]:
        """Fleet $/h split by price tier, summed across models."""
        out: dict[str, float] = {}
        for a in self.per_model.values():
            for t, c in a.cost_by_tier().items():
                out[t] = out.get(t, 0.0) + c
        return out

    def summary(self) -> dict:
        """Fleet-level cost summary for logs and benchmarks."""
        return {
            "cost_per_hour": self.cost_per_hour,
            "total_instances": self.total_instances,
            "gpu_totals": self.gpu_totals(),
            "chips_by_base": self.chips_by_base(),
            "per_model": {
                m: {"cost_per_hour": a.cost_per_hour,
                    "counts": dict(a.counts),
                    "slo_tpot_s": a.profile.slo_tpot_s}
                for m, a in self.per_model.items()},
        }


class MelangeFleet:
    """Mélange for a multi-model fleet sharing one accelerator pool.

    Each :class:`ModelSpec` is profiled separately (MaxTput tables depend
    on the model and its SLO) and the fleet ILP packs all models' (model,
    bucket) slices onto (model, GPU) columns under shared pool caps — a
    GPU type can serve several models, but every instance serves one model
    and the pool is never over-committed.
    """

    def __init__(self, gpus: Mapping[str, Accelerator],
                 specs: Sequence[ModelSpec], *,
                 engine_params: EngineModelParams = DEFAULT_ENGINE,
                 slice_factor: int = 8,
                 buckets=None,
                 tp_degrees: Optional[Sequence[int]] = None,
                 spot_tiers: bool = False,
                 profiles: Optional[Mapping[str, Profile]] = None):
        if not specs:
            raise ValueError("fleet needs at least one ModelSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in fleet: {names}")
        self.specs: dict[str, ModelSpec] = {s.name: s for s in specs}
        self.members: dict[str, Melange] = {}
        for s in specs:
            self.members[s.name] = Melange(
                gpus, s.perf, s.slo_tpot_s,
                engine_params=s.engine_params or engine_params,
                profile=(profiles or {}).get(s.name),
                slice_factor=slice_factor, buckets=buckets,
                tp_degrees=tp_degrees, spot_tiers=spot_tiers)
        self.slice_factor = slice_factor
        # all members expand the same catalog identically
        self.gpus = next(iter(self.members.values())).gpus

    @property
    def models(self) -> list[str]:
        return list(self.members)

    def _workloads(self, workloads: Optional[Mapping[str, Workload]],
                   models: Optional[Sequence[str]]) -> dict[str, Workload]:
        sel = list(models) if models is not None else self.models
        unknown = [m for m in sel if m not in self.members]
        if unknown:
            raise KeyError(f"unknown fleet models: {unknown}")
        out = {}
        for m in sel:
            if workloads is not None and m in workloads:
                out[m] = workloads[m]
            else:
                out[m] = self.specs[m].workload_at(0.0)
        return out

    def _per_model_view(self, fp, sol: ILPSolution, m: str,
                        wl: Workload) -> Allocation:
        """Slice the joint solution into model ``m``'s Allocation."""
        k = fp.models.index(m)
        G = fp.n_gpus
        lo, hi = fp.slice_ranges[m]
        assign = np.asarray(sol.assignment[lo:hi], dtype=int) - k * G
        loads = fp.prob.loads[lo:hi]
        counts = np.zeros(G, dtype=int)
        for j in range(G):
            lj = loads[np.arange(hi - lo)[assign == j], k * G + j].sum()
            counts[j] = int(np.ceil(lj - 1e-9))
        member = self.members[m]
        costs = np.array([member.profile.gpus[g].price_hr
                          for g in fp.gpu_names])
        sol_m = ILPSolution(assign, counts, float(np.sum(counts * costs)),
                            sol.optimal, sol.solve_time_s, nodes=sol.nodes,
                            stats=sol.stats)
        # local view of the stacked ILP (this model's slice rows x its
        # column block) — what the next fleet allocate() diffs against to
        # pin this model's unchanged slices in the incremental re-solve
        lprob = ILPProblem(loads[:, k * G:(k + 1) * G].copy(), costs,
                           list(fp.gpu_names),
                           fp.prob.bucket_of_slice[lo:hi].copy())
        return Allocation({g: int(c) for g, c in zip(fp.gpu_names, counts)
                           if c > 0},
                          sol_m.cost, sol_m, member.profile, wl,
                          solution_gpu_names=list(fp.gpu_names),
                          problem=lprob)

    def allocate(self, workloads: Optional[Mapping[str, Workload]] = None, *,
                 models: Optional[Sequence[str]] = None,
                 caps: Optional[Mapping[str, int]] = None,
                 chip_caps: Optional[Mapping[str, int]] = None,
                 gpu_subset: Optional[list[str]] = None,
                 over_provision: float = 0.0,
                 min_ondemand_frac: float = 0.0,
                 replacement_delay_s: float = 0.0,
                 time_budget_s: float = 5.0,
                 tput_scale: Optional[Mapping] = None,
                 warm: bool = True,
                 warm_siloed: Optional[Mapping[str, Allocation]] = None,
                 prev: Optional[Mapping[str, Allocation]] = None
                 ) -> Optional[FleetAllocation]:
        """Jointly allocate the (selected) fleet against the shared pool.

        The sequential-siloed solution (when feasible) seeds the joint
        branch-and-bound as a warm start, so the shared-pool cost never
        exceeds what per-model silos would pay even when the solver hits
        its time budget.  Callers comparing against a siloed baseline they
        already solved (e.g. ``best_siloed`` with a bigger budget) should
        pass it as ``warm_siloed``: the joint solve then dominates *that
        exact* solution by construction, not just its own quick re-derive.
        ``warm_siloed`` allocations must come from the same workloads /
        slice factor / GPU subset as this call.

        ``prev`` (model -> its previous per-model :class:`Allocation`,
        from an earlier fleet allocate over the same models and catalog)
        switches to the incremental re-solve: the previous stacked loads /
        costs / assignment are reconstructed from the per-model views and
        slices with unchanged rows stay pinned to their previous column
        (cap pins only apply when this call carries no caps — with caps
        the previous assignment still seeds a warm full solve).  A prev
        that no longer matches the problem shape is silently ignored."""
        wls = self._workloads(workloads, models)
        if over_provision > 0:
            wls = {m: Workload(w.buckets, w.rates * (1 + over_provision),
                               name=w.name + f"+op{over_provision}")
                   for m, w in wls.items()}
        fp = build_fleet_problem(
            {m: (self.members[m].profile, w) for m, w in wls.items()},
            self.slice_factor, caps=caps, gpu_subset=gpu_subset,
            chip_caps=chip_caps, min_ondemand_frac=min_ondemand_frac,
            replacement_delay_s=replacement_delay_s,
            tput_scale=tput_scale)
        if prev is not None and set(prev) >= set(fp.models):
            G = fp.n_gpus
            usable = all(
                prev[m].problem is not None
                and prev[m].problem.loads.shape
                == (fp.slice_ranges[m][1] - fp.slice_ranges[m][0], G)
                and list(prev[m].solution_gpu_names) == list(fp.gpu_names)
                and len(prev[m].solution.assignment)
                == fp.slice_ranges[m][1] - fp.slice_ranges[m][0]
                for m in fp.models)
            if usable:
                N, Mtot = fp.prob.loads.shape
                prev_loads = np.full((N, Mtot), np.inf)
                prev_costs = np.empty(Mtot)
                prev_assign = np.empty(N, dtype=int)
                for k, m in enumerate(fp.models):
                    lo, hi = fp.slice_ranges[m]
                    p = prev[m].problem
                    prev_loads[lo:hi, k * G:(k + 1) * G] = p.loads
                    prev_costs[k * G:(k + 1) * G] = p.costs
                    prev_assign[lo:hi] = (
                        np.asarray(prev[m].solution.assignment, dtype=int)
                        + k * G)
                sol = solve_incremental(
                    fp.prob, prev_assign,
                    prev_loads=prev_loads, prev_costs=prev_costs,
                    caps_clean=not caps and not chip_caps,
                    time_budget_s=time_budget_s)
                if sol is None:
                    return None
                per_model = {m: self._per_model_view(fp, sol, m, wls[m])
                             for m in fp.models}
                return FleetAllocation(per_model, solution=sol)
        warm_assign = None
        main_budget = time_budget_s
        siloed: Optional[Mapping[str, Allocation]] = warm_siloed
        if siloed is None and warm and len(wls) > 1:
            # best sequential-siloed order as the incumbent: on stacked
            # problems the joint branch-and-bound is any-time, so the
            # warm start is the floor of what allocate() returns
            t0 = time.perf_counter()
            siloed = self.best_siloed(
                wls, models=list(wls), caps=caps, chip_caps=chip_caps,
                gpu_subset=gpu_subset,
                min_ondemand_frac=min_ondemand_frac,
                replacement_delay_s=replacement_delay_s,
                time_budget_s=min(1.0, time_budget_s / 3),
                tput_scale=tput_scale)
            main_budget = max(0.1, time_budget_s - (time.perf_counter() - t0))
        if siloed is not None:
            if set(siloed) != set(fp.models) or any(
                    len(siloed[m].solution.assignment)
                    != fp.slice_ranges[m][1] - fp.slice_ranges[m][0]
                    or list(siloed[m].solution_gpu_names) != fp.gpu_names
                    for m in fp.models):
                raise ValueError(
                    "warm_siloed does not match this fleet problem "
                    "(models, slice counts, or GPU catalog differ)")
            warm_assign = np.concatenate([
                np.asarray(siloed[m].solution.assignment, dtype=int)
                + fp.models.index(m) * fp.n_gpus
                for m in fp.models])
        sol = solve(fp.prob, time_budget_s=main_budget,
                    warm_assign=warm_assign)
        if sol is None:
            return None
        per_model = {m: self._per_model_view(fp, sol, m, wls[m])
                     for m in fp.models}
        return FleetAllocation(per_model, solution=sol)

    def allocate_siloed(self,
                        workloads: Optional[Mapping[str, Workload]] = None, *,
                        models: Optional[Sequence[str]] = None,
                        order: Optional[Sequence[str]] = None,
                        caps: Optional[Mapping[str, int]] = None,
                        chip_caps: Optional[Mapping[str, int]] = None,
                        gpu_subset: Optional[list[str]] = None,
                        over_provision: float = 0.0,
                        min_ondemand_frac: float = 0.0,
                        replacement_delay_s: float = 0.0,
                        time_budget_s: float = 5.0,
                        tput_scale: Optional[Mapping] = None
                        ) -> Optional[dict[str, Allocation]]:
        """The no-coordination baseline: each model is allocated alone, in
        ``order``, consuming pool capacity as it goes (later silos see only
        what the earlier ones left).  Returns None when some silo is
        infeasible under the depleted caps."""
        wls = self._workloads(workloads, models)
        seq = list(order) if order is not None else list(wls)
        budget = max(0.1, time_budget_s / max(1, len(seq)))
        rem_caps = dict(caps) if caps else {}
        rem_chips = ({k: float(v) for k, v in chip_caps.items()}
                     if chip_caps else {})
        out: dict[str, Allocation] = {}
        for m in seq:
            member = self.members[m]
            alloc = member.allocate(
                wls[m], caps=rem_caps or None, chip_caps=rem_chips or None,
                gpu_subset=gpu_subset, over_provision=over_provision,
                min_ondemand_frac=min_ondemand_frac,
                replacement_delay_s=replacement_delay_s,
                time_budget_s=budget, tput_scale=tput_scale)
            if alloc is None:
                return None
            out[m] = alloc
            for g, n in alloc.counts.items():
                if g in rem_caps:
                    rem_caps[g] = max(0, rem_caps[g] - n)
            if rem_chips:
                used_by_pool = alloc.chips_by_pool()
                for key in list(rem_chips):
                    pool = pool_key(key, member.profile.gpus)
                    used = used_by_pool.get(pool, 0)
                    rem_chips[key] = max(0.0, rem_chips[key] - used)
        return out

    def best_siloed(self, workloads: Optional[Mapping[str, Workload]] = None,
                    **kw) -> Optional[dict[str, Allocation]]:
        """Cheapest sequential-siloed outcome over all model orders (the
        strongest uncoordinated baseline a fleet operator could reach by
        picking the luckiest deployment order).  Beyond 3 models the n!
        order space is sampled with rate-sorted heuristics.

        ``time_budget_s`` is the budget for the *whole* order sweep (it is
        divided across orders), so callers — ``allocate``'s warm-start
        phase in particular — can bound wall time regardless of n!."""
        import itertools as _it
        wls = self._workloads(workloads, kw.pop("models", None))
        if len(wls) <= 3:
            orders = [list(o) for o in _it.permutations(wls)]
        else:
            by_rate = sorted(wls, key=lambda m: wls[m].total_rate)
            orders = [list(wls), list(reversed(list(wls))),
                      by_rate, list(reversed(by_rate))]
        kw["time_budget_s"] = max(
            0.05, kw.get("time_budget_s", 5.0) / len(orders))
        best: Optional[dict[str, Allocation]] = None
        for order in orders:
            got = self.allocate_siloed(wls, models=list(wls),
                                       order=list(order), **kw)
            if got is None:
                continue
            cost = sum(a.cost_per_hour for a in got.values())
            if best is None or cost < sum(a.cost_per_hour
                                          for a in best.values()) - 1e-12:
                best = got
        return best
