"""The port's copy of ``src/repro/core/loadmatrix.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and
``tests/test_torch_control.py`` holds the two to the same results.
The original's docstring follows.

Load matrix construction (§5.4.2): L[i,j] = r_i / MaxTput(G_j, s_i, SLO).

Columns may be TP-degree variants of a base GPU type (``A10Gx2``) and/or
price-tier variants (``A100:spot``).  Cap families:

  * ``caps`` — per-*instance* caps on a named column (B_j ≤ cap_j);
  * ``chip_caps`` — per-*chip* caps on a pool.  A key naming a base type
    (or any of its on-demand/TP variants) caps the *physical* pool shared
    by every tier and TP degree (Σ tp·B ≤ cap across on-demand and spot
    alike); a key naming a spot entry (``"A100:spot"``) caps only the spot
    *market* sub-pool, so on-demand stays rentable for backfill.

Price tiers (spot variants) change the matrix two ways:

  * **availability discount** — a spot column's expected *surviving*
    throughput is MaxTput x (1 − preemption_rate x replacement_delay):
    each reclaim loses one instance for the replacement boot window, so on
    average that fraction of instance-hours serves nothing.  The load a
    slice puts on a spot column is inflated accordingly.
  * **on-demand floor** (``min_ondemand_frac``) — per bucket, at least
    ⌈frac x n_slices⌉ of the bucket's slices have every spot column masked
    infeasible, pinning that share of the bucket's SLO-critical capacity
    onto non-preemptible instances.  Because slices of one bucket are
    interchangeable (identical load rows), masking a fixed subset is
    *exactly* equivalent to the counting constraint "≤ (1−frac)·n slices
    on spot columns" — so every solver layer (greedy, local search,
    branch-and-bound, brute force) enforces the floor by construction,
    simply by never assigning a slice to an infeasible column.

Multi-model fleets (``build_fleet_problem``) stack several models' load
matrices into one problem: items are (model, bucket) slices, columns are
(model, GPU variant) pairs — an instance serves exactly one model — and
both cap families become *shared-pool* rows spanning every model's columns
(Σ_m Σ_tp tp·B_{m,g,tp} ≤ cap_g), so the solver can reuse a GPU type for
several models without ever exceeding the physical pool.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from .accelerators import Accelerator, is_spot_pool, pool_key
from .ilp import ILPProblem
from .profiler import Profile
from .workload import Workload


def availability(acc: Accelerator, replacement_delay_s: float) -> float:
    """Expected fraction of a spot instance's hours that actually serve:
    1 − preemption_rate [1/h] x replacement delay [h], floored at 0 (a
    pool reclaimed faster than it can be replaced contributes nothing).
    On-demand instances are never preempted: always 1."""
    if not acc.is_spot:
        return 1.0
    return max(0.0, 1.0 - acc.preemption_rate * replacement_delay_s / 3600.0)


def _ondemand_quota(workload: Workload, slice_factor: int,
                    min_ondemand_frac: float) -> dict[int, int]:
    """bucket index -> number of its slices pinned to on-demand columns."""
    if not 0.0 <= min_ondemand_frac <= 1.0:
        raise ValueError(
            f"min_ondemand_frac must be in [0, 1], got {min_ondemand_frac}")
    if min_ondemand_frac <= 0:
        return {}
    quota: dict[int, int] = {}
    for bi, _ in workload.slices(slice_factor):
        quota[bi] = quota.get(bi, 0) + 1
    return {bi: int(math.ceil(min_ondemand_frac * n - 1e-9))
            for bi, n in quota.items()}


def _tput_scale_matrix(tput_scale, gpu_names: list[str],
                       n_buckets: int) -> np.ndarray | None:
    """``tput_scale`` -> a (B, M) multiplier matrix (None when a no-op).

    ``tput_scale`` maps a column (variant) name to either a scalar
    multiplier or a per-bucket sequence — observed/predicted throughput
    correction factors (dimensionless) from e.g. the fleet health
    engine's drift detector.  Unknown names are ignored so a caller may
    pass corrections keyed by a superset of the active columns.
    """
    if not tput_scale:
        return None
    scale = np.ones((n_buckets, len(gpu_names)))
    hit = False
    for j, g in enumerate(gpu_names):
        s = tput_scale.get(g)
        if s is None:
            continue
        col = np.asarray(s, dtype=float)
        if col.ndim == 0:
            col = np.full(n_buckets, float(col))
        elif col.shape != (n_buckets,):
            raise ValueError(
                f"tput_scale[{g!r}] has shape {col.shape}, "
                f"want scalar or ({n_buckets},)")
        if np.any(col <= 0) or not np.all(np.isfinite(col)):
            raise ValueError(
                f"tput_scale[{g!r}] must be finite and positive")
        scale[:, j] = col
        hit = True
    return scale if hit else None


def build_problem(workload: Workload, profile: Profile,
                  slice_factor: int = 8,
                  caps: dict[str, int] | None = None,
                  gpu_subset: list[str] | None = None,
                  chip_caps: dict[str, int] | None = None,
                  min_ondemand_frac: float = 0.0,
                  replacement_delay_s: float = 0.0,
                  tput_scale: Mapping | None = None) -> ILPProblem:
    gpu_names = sorted(gpu_subset or profile.gpus)
    slices = workload.slices(slice_factor)
    N, M = len(slices), len(gpu_names)
    accs = [profile.gpus[g] for g in gpu_names]
    quota = _ondemand_quota(workload, slice_factor, min_ondemand_frac)
    seen: dict[int, int] = {}
    bucket_of = np.zeros(N, dtype=int)
    rate_of = np.zeros(N)
    pinned_of = np.zeros(N, dtype=bool)
    for i, (bi, rate) in enumerate(slices):
        bucket_of[i] = bi
        rate_of[i] = rate
        pinned_of[i] = seen.get(bi, 0) < quota.get(bi, 0)
        seen[bi] = seen.get(bi, 0) + 1
    # vectorized row assembly: tput per (bucket, column) computed once,
    # then one masked divide — bit-identical to the old per-entry
    # ``rate / tput`` loop (same two operands per element)
    avail = np.array([availability(acc, replacement_delay_s)
                      for acc in accs])
    spot_mask = np.array([acc.is_spot for acc in accs])
    tput = (np.stack([np.asarray(profile.max_tput[g], dtype=float)
                      for g in gpu_names], axis=1) * avail)   # (B, M)
    # drift corrections scale predicted throughput per (bucket, column),
    # exactly like the spot availability discount above
    scale = _tput_scale_matrix(tput_scale, gpu_names, tput.shape[0])
    if scale is not None:
        tput = tput * scale
    ok = tput[bucket_of] > 0
    ok &= ~(pinned_of[:, None] & spot_mask[None, :])  # floor: on-demand only
    loads = np.full((N, M), np.inf)
    np.divide(rate_of[:, None], tput[bucket_of], out=loads, where=ok)
    costs = np.array([acc.price_hr for acc in accs])
    caps_arr = None
    if caps is not None:
        caps_arr = np.array([float(caps.get(g, np.inf)) for g in gpu_names])
    (chip_weight, chip_group, group_caps,
     rows, row_caps) = pool_cap_constraints(accs, chip_caps, profile.gpus)
    spot_col = np.array([a.is_spot for a in accs])
    region_col = np.array([a.region for a in accs])
    return ILPProblem(loads, costs, gpu_names, bucket_of, caps_arr,
                      chip_weight=chip_weight, chip_group=chip_group,
                      group_caps=group_caps,
                      group_rows=np.stack(rows) if rows else None,
                      group_row_caps=np.asarray(row_caps) if rows else None,
                      spot_col=spot_col if spot_col.any() else None,
                      region_col=region_col if (region_col != "").any()
                      else None)


def pool_cap_constraints(accs: list[Accelerator],
                         chip_caps: Mapping[str, float] | None,
                         gpus: Mapping[str, Accelerator]):
    """Pool-level chip caps for a column set -> ILP constraint arrays
    ``(chip_weight, chip_group, group_caps, rows, row_caps)``.

    Physical pools (one per column: every tier of a base type — and, with
    regions, of a (base, region) pair — shares the silicon) go through the
    ``chip_group`` machinery; spot market sub-pools overlap the physical
    pools (a spot column sits in both), so they become general group rows.
    Shared by the single-model, fleet, and region problem builders."""
    chip_weight = chip_group = group_caps = None
    rows: list[np.ndarray] = []
    row_caps: list[float] = []
    if chip_caps:
        norm = _normalize_chip_caps(chip_caps, gpus)
        base_pools = sorted(p for p in norm if not is_spot_pool(p))
        if base_pools:
            pool_idx = {p: k for k, p in enumerate(base_pools)}
            chip_weight = np.array([float(a.chips) for a in accs])
            chip_group = np.array([pool_idx.get(a.base_name, -1)
                                   for a in accs])
            group_caps = np.array([norm[p] for p in base_pools])
        for p in sorted(p for p in norm if is_spot_pool(p)):
            w = np.array([float(a.chips) if a.market_pool == p else 0.0
                          for a in accs])
            rows.append(w)
            row_caps.append(float(norm[p]))
    return chip_weight, chip_group, group_caps, rows, row_caps


def _normalize_chip_caps(chip_caps: Mapping[str, float],
                         gpus: Mapping[str, object]) -> dict[str, float]:
    """A cap naming any catalog entry binds that entry's *pool*: on-demand
    / TP variants bind the physical base pool ('A10Gx2' -> 'A10G'), spot
    variants bind the spot market sub-pool ('A100:spotx2' -> 'A100:spot').
    Duplicate keys keep the tightest cap.  Single source of the rule for
    the single-model and fleet builders alike."""
    norm: dict[str, float] = {}
    for key, cap in chip_caps.items():
        pool = pool_key(key, gpus)
        norm[pool] = min(norm.get(pool, np.inf), float(cap))
    return norm


@dataclasses.dataclass
class FleetProblem:
    """A stacked multi-model ILP plus the bookkeeping to read it back.

    Column ``k * n_gpus + j`` is (model k, GPU j); slice rows are grouped
    per model in ``slice_ranges`` order.  ``prob.gpu_names`` carry
    ``"model:gpu"`` labels so solver debug output stays readable.
    """

    prob: ILPProblem
    models: list[str]                        # model order (column-major)
    gpu_names: list[str]                     # shared per-model column order
    slice_ranges: dict[str, tuple[int, int]]  # model -> [lo, hi) slice rows

    @property
    def n_gpus(self) -> int:
        return len(self.gpu_names)

    def col(self, model: str, gpu: str) -> int:
        return (self.models.index(model) * self.n_gpus
                + self.gpu_names.index(gpu))

    def col_model(self, j: int) -> str:
        return self.models[j // self.n_gpus]

    def col_gpu(self, j: int) -> str:
        return self.gpu_names[j % self.n_gpus]


def build_fleet_problem(members: Mapping[str, tuple[Profile, Workload]],
                        slice_factor: int = 8,
                        caps: Mapping[str, int] | None = None,
                        gpu_subset: list[str] | None = None,
                        chip_caps: Mapping[str, int] | None = None,
                        min_ondemand_frac: float = 0.0,
                        replacement_delay_s: float = 0.0,
                        tput_scale: Mapping | None = None
                        ) -> FleetProblem:
    """Stack each model's §5.4.2 load matrix into one shared-pool problem.

    ``members`` maps model name -> (its MaxTput profile, its workload); all
    profiles must cover one common accelerator catalog (they are allowed to
    differ in SLO and throughput numbers — that is the point).  ``caps``
    and ``chip_caps`` are *pool-level*: an instance cap on ``A100`` bounds
    the total A100 instances across every model, a chip cap on a base type
    bounds Σ models Σ variants chips (and a cap on ``"A100:spot"`` bounds
    only the spot sub-pool across models).  ``min_ondemand_frac`` pins the
    floor per (model, bucket); ``replacement_delay_s`` discounts every
    model's spot columns identically.
    """
    models = list(members)
    if not models:
        raise ValueError("fleet needs at least one model")
    first_profile = members[models[0]][0]
    gpu_names = sorted(gpu_subset or first_profile.gpus)
    for m in models:
        missing = [g for g in gpu_names if g not in members[m][0].gpus]
        if missing:
            raise ValueError(
                f"model '{m}' profile lacks catalog entries {missing}: fleet "
                "members must share one accelerator catalog")
    G = len(gpu_names)
    M = len(models) * G
    accs = [first_profile.gpus[g] for g in gpu_names]

    slice_rows: list[np.ndarray] = []
    bucket_of: list[int] = []
    slice_ranges: dict[str, tuple[int, int]] = {}
    bucket_offset = 0
    for k, m in enumerate(models):
        profile, workload = members[m]
        quota = _ondemand_quota(workload, slice_factor, min_ondemand_frac)
        seen: dict[int, int] = {}
        lo = len(slice_rows)
        # vectorized row assembly, same recipe as build_problem: tput per
        # (bucket, column) once, then a masked ``rate / tput`` divide with
        # the identical operands the old per-entry loop used
        m_accs = [profile.gpus[g] for g in gpu_names]
        avail = np.array([availability(a, replacement_delay_s)
                          for a in m_accs])
        m_spot = np.array([a.is_spot for a in m_accs])
        tput = (np.stack([np.asarray(profile.max_tput[g], dtype=float)
                          for g in gpu_names], axis=1) * avail)   # (B, G)
        # drift corrections apply per (bucket, column), shared across
        # models — the physical GPU type drifted, not one model's view
        mscale = _tput_scale_matrix(tput_scale, gpu_names, tput.shape[0])
        if mscale is not None:
            tput = tput * mscale
        for bi, rate in workload.slices(slice_factor):
            pinned = seen.get(bi, 0) < quota.get(bi, 0)
            seen[bi] = seen.get(bi, 0) + 1
            row = np.full(M, np.inf)
            ok = tput[bi] > 0
            if pinned:
                ok &= ~m_spot
            np.divide(rate, tput[bi], out=row[k * G:(k + 1) * G], where=ok)
            slice_rows.append(row)
            # per-model bucket-id offset: slices of different models are
            # never interchangeable even when their load rows coincide
            bucket_of.append(bucket_offset + bi)
        slice_ranges[m] = (lo, len(slice_rows))
        bucket_offset += len(profile.buckets)

    loads = (np.stack(slice_rows) if slice_rows
             else np.zeros((0, M)))
    costs = np.tile(np.array([a.price_hr for a in accs]), len(models))

    # pool-level caps -> shared group rows spanning all models' columns
    rows: list[np.ndarray] = []
    row_caps: list[float] = []
    if caps:
        for g, cap in sorted(caps.items()):
            if g not in gpu_names:
                continue
            w = np.zeros(M)
            for k in range(len(models)):
                w[k * G + gpu_names.index(g)] = 1.0
            rows.append(w)
            row_caps.append(float(cap))
    if chip_caps:
        norm = _normalize_chip_caps(chip_caps, first_profile.gpus)
        for pool, cap in sorted(norm.items()):
            w = np.zeros(M)
            for j, acc in enumerate(accs):
                # a physical pool key spans every tier of the base type; a
                # ":spot" key spans only the spot columns of that base
                if pool in (acc.base_name, acc.market_pool):
                    for k in range(len(models)):
                        w[k * G + j] = float(acc.chips)
            if w.any():
                rows.append(w)
                row_caps.append(float(cap))
    spot_col = np.tile(np.array([a.is_spot for a in accs]), len(models))
    region_col = np.tile(np.array([a.region for a in accs]), len(models))
    prob = ILPProblem(
        loads, costs,
        [f"{m}:{g}" for m in models for g in gpu_names],
        np.asarray(bucket_of, dtype=int),
        group_rows=np.stack(rows) if rows else None,
        group_row_caps=np.asarray(row_caps) if rows else None,
        spot_col=spot_col if spot_col.any() else None,
        region_col=region_col if (region_col != "").any() else None)
    return FleetProblem(prob, models, gpu_names, slice_ranges)
