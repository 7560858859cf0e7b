"""The port's copy of ``src/repro/core/ilp.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and
``tests/test_torch_control.py`` holds the two to the same results.
The original's docstring follows.

Cost-aware bin-packing ILP (§5.4.3) and an exact solver.

    min  Σ_j c_j · B_j
    s.t. Σ_j A_ij = 1            (every slice assigned once)
         Σ_i A_ij · L_ij ≤ B_j   (capacity)
         A ∈ {0,1},  B ∈ Z≥0     (+ optional availability caps B_j ≤ cap_j)
         Σ_{j∈group g} w_j · B_j ≤ cap_g   (grouped chip capacity)
         Σ_j W_kj · B_j ≤ cap_k            (general shared-resource rows)

The grouped constraint is the TP-degree extension: columns are
(type, tp-degree) variants, w_j is the chips one instance of variant j
consumes, and availability bounds *chips of the base type*, shared across
all of its TP variants (an ``A10Gx4`` draws 4 chips from the same pool as
four ``A10G``s).  The general rows (``group_rows``) are the multi-model
extension: fleet problems carry one column per (model, GPU variant) pair,
and a physical pool — a variant's instances or a base type's chips — is a
row spanning every model's columns that draw on it.  Price tiers reuse
both: a spot column sits in its base type's physical chip-pool row *and*
in a spot-market sub-pool row, so tp x tier x model caps all compose.
All cap families are enforced at every layer: greedy warm start, local
search, branch-and-bound (monotone along a DFS path, so a violated prefix
prunes soundly), and the brute-force reference.

The availability floor (``min_ondemand_frac``, see ``loadmatrix.py``) is
*structural*: the floored share of each bucket's interchangeable slices
arrives with every spot column masked inf, which is exactly equivalent to
the counting constraint "at most (1−frac)·n of the bucket's slices on
spot columns" — so all four solver layers enforce it by construction.
``spot_col`` records which columns are preemptible so tests and the
cross-check harness can verify the floor on any layer's output without
re-deriving tier information from column names.

No off-the-shelf ILP solver is installed in this environment, so we exploit
the problem's structure (an optimal B is always B_j = ceil(load_j)):

  * LP relaxation is *separable*: relaxing the ceil, the optimum assigns each
    slice to argmin_j c_j·L_ij, giving the lower bound
        LB = Σ_i min_j c_j·L_ij.
  * Branch-and-bound over slices (sorted by decreasing cost spread), pruning
    with  fractional-partial-cost + remaining-LB ≥ incumbent.  Slices of the
    same bucket are interchangeable, so assignments are canonicalized
    (symmetry breaking) by forcing non-decreasing GPU index within a bucket
    group.
  * A greedy + local-search warm start provides the initial incumbent, so
    the solver emits an any-time solution under a time budget.

Solutions carry an ``optimal`` flag; tests verify exactness against brute
force on small instances.

Fast path (PR 8): the greedy and local-search hot loops are vectorized
over columns (the scalar originals are retained as
``_greedy_reference``/``_local_search_reference`` and byte-identical
parity is property-tested); ``solve`` runs a dominance pre-pass
(``core/dominance.py``) that drops columns provably absent from some
optimum; and the branch-and-bound stops on a deterministic *stall
cutoff* — ``stall_nodes``/``stall_comps`` without an incumbent
improvement — because on large stacked problems the polished warm start
is almost always already optimal and the search otherwise burns the
whole deadline proving it.  A stalled solve reports ``optimal=False``.
``solve_incremental`` re-solves a drifted problem by pinning every
slice whose loads/costs/caps context is unchanged to its previous
column (the same structural inf-mask mechanism as the on-demand floor,
so all four layers enforce the pins by construction) and warm-starting
from the previous assignment.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import time
from typing import Optional, Sequence

import numpy as np

INFEASIBLE = float("inf")
_EPS = 1e-9

# Warm-start budgeting (satellite fix: the warm phase used to inherit the
# *entire* deadline, starving branch-and-bound on big stacked problems).
_WARM_GREEDY_FRAC = 0.4         # greedy warm start alone
_WARM_TOTAL_FRAC = 0.7          # greedy + incumbent polish combined
# Deterministic stall cutoff: stop the DFS once this many nodes (or
# candidate compositions) have been expanded since the incumbent last
# improved.  Counter-based, so the decision is machine-independent.
# Sized well above what any exactness-tested instance needs to complete
# (crosscheck/golden searches finish in at most a few hundred nodes).
_STALL_NODES = 1024
_STALL_COMPS = 200_000


@dataclasses.dataclass
class ILPProblem:
    loads: np.ndarray               # (N, M) fractional load; inf = forbidden
    costs: np.ndarray               # (M,) $/h per GPU type
    gpu_names: list[str]
    bucket_of_slice: np.ndarray     # (N,) bucket group id (symmetry breaking)
    caps: Optional[np.ndarray] = None   # (M,) max instances (availability)
    # grouped chip capacity Σ_{j∈g} w_j·B_j ≤ cap_g (TP variants share the
    # base type's chip pool); chip_group[j] = -1 -> j draws from no pool
    chip_weight: Optional[np.ndarray] = None  # (M,) chips per instance
    chip_group: Optional[np.ndarray] = None   # (M,) pool id or -1
    group_caps: Optional[np.ndarray] = None   # (n_pools,) chips available
    # general shared-resource rows  Σ_j W_kj·B_j ≤ cap_k: the multi-model
    # extension, where one physical pool (a GPU type's instances or a base
    # type's chips) is drawn on by columns belonging to *different models*.
    # A column may appear in any number of rows — unlike chip_group's
    # one-pool-per-column restriction.
    group_rows: Optional[np.ndarray] = None      # (K, M) weights
    group_row_caps: Optional[np.ndarray] = None  # (K,)
    # metadata (not a constraint): which columns are preemptible spot
    # variants.  The on-demand floor itself is encoded structurally in
    # ``loads`` (see module docstring); this mask lets verification code
    # measure per-bucket spot shares of any solution.
    spot_col: Optional[np.ndarray] = None        # (M,) bool
    # metadata: serving region of each column ("" = global).  Like
    # ``spot_col``, the RTT tightening itself is structural (remote
    # columns whose effective SLO is burned through arrive masked inf);
    # this labels columns so verification and benchmarks can measure
    # cross-region serving shares without re-parsing variant names.
    region_col: Optional[np.ndarray] = None      # (M,) str

    def group_matrix(self) -> Optional[np.ndarray]:
        """(n_groups, M) weights: usage = group_matrix() @ counts.

        Stacks the chip-pool rows (chip_weight/chip_group) with the general
        ``group_rows``; caps line up via :meth:`grouped_caps`."""
        M = self.loads.shape[1]
        rows = []
        if self.group_caps is not None:
            gm = np.zeros((len(self.group_caps), M))
            for j in range(M):
                g = int(self.chip_group[j])
                if g >= 0:
                    gm[g, j] = self.chip_weight[j]
            rows.append(gm)
        if self.group_rows is not None:
            rows.append(np.asarray(self.group_rows, dtype=float))
        if not rows:
            return None
        return np.vstack(rows)

    @functools.cached_property
    def grouped_caps(self) -> Optional[np.ndarray]:
        """Caps aligned with :meth:`group_matrix` rows.  Cached: this is
        read in the greedy/local-search innermost loops and the cap
        fields are fixed for the life of the problem."""
        parts = []
        if self.group_caps is not None:
            parts.append(np.asarray(self.group_caps, dtype=float))
        if self.group_row_caps is not None:
            parts.append(np.asarray(self.group_row_caps, dtype=float))
        if not parts:
            return None
        return np.concatenate(parts)


def counts_within_caps(counts: np.ndarray, prob: ILPProblem,
                       gmat: Optional[np.ndarray] = None) -> bool:
    """All cap families: per-column B_j ≤ cap_j plus grouped shared caps."""
    if prob.caps is not None and np.any(counts > prob.caps + _EPS):
        return False
    gcaps = prob.grouped_caps
    if gcaps is not None:
        if gmat is None:
            gmat = prob.group_matrix()
        if np.any(gmat @ counts > gcaps + _EPS):
            return False
    return True


def spot_share_by_bucket(prob: ILPProblem,
                         assignment: np.ndarray) -> dict[int, float]:
    """Fraction of each bucket group's slices assigned to spot columns
    (0.0 everywhere when the problem carries no tier metadata).  The
    availability-floor invariant for a solve with ``min_ondemand_frac=f``
    is ``share <= 1 - f`` (up to the per-bucket ceiling's rounding) for
    every bucket — verified by tests on every solver layer's output."""
    out: dict[int, float] = {}
    counts: dict[int, list[int]] = {}
    spot = (prob.spot_col if prob.spot_col is not None
            else np.zeros(prob.loads.shape[1], dtype=bool))
    for i, j in enumerate(np.asarray(assignment, dtype=int)):
        b = int(prob.bucket_of_slice[i])
        tot_spot = counts.setdefault(b, [0, 0])
        tot_spot[0] += 1
        tot_spot[1] += int(bool(spot[j]))
    for b, (tot, n_spot) in counts.items():
        out[b] = n_spot / tot
    return out


@dataclasses.dataclass
class SolveStats:
    """Where a ``solve()`` call spent its budget.

    Phase wall times are measured on disjoint intervals of the same
    monotonic clock (``time.perf_counter``), so
    ``greedy_s + polish_s + bnb_s <= solve_time_s`` always holds.
    Prune accounting satisfies the conservation invariant checked by
    :meth:`consistent`: every composition considered at a branch node is
    either expanded into a child node or pruned for exactly one reason,
    so ``(nodes - 1) + Σ pruned == comps_considered``.
    """

    n_slices: int = 0
    n_columns: int = 0
    n_groups: int = 0
    # per-phase wall time (disjoint perf_counter intervals)
    greedy_s: float = 0.0
    polish_s: float = 0.0
    bnb_s: float = 0.0
    # branch-and-bound accounting
    nodes: int = 0
    comps_considered: int = 0
    pruned_lp_bound: int = 0      # separable-LP suffix bound (incl. tail break)
    pruned_cap: int = 0           # per-type or grouped-cap infeasible
    pruned_ceiling: int = 0       # committed-ceiling lower bound
    pruned_deadline: int = 0      # abandoned when the time budget expired
    pruned_stall: int = 0         # abandoned when the stall cutoff tripped
    deadline_hit: bool = False
    stalled: bool = False         # stopped by stall cutoff (=> optimal False)
    restricted: bool = False      # branching sets cut to cheapest types
    restricted_retry: bool = False  # unrestricted retry after cap-infeasible
    warm_budget_s: float = 0.0    # budget cap handed to greedy + polish
    cols_dominated: int = 0       # columns dropped by the dominance pre-pass
    # incremental re-solve accounting (solve_incremental)
    incremental: bool = False
    pinned_slices: int = 0        # slices pinned to their previous column
    reopened_slices: int = 0      # slices left free to move
    nodes_by_depth: list[int] = dataclasses.field(default_factory=list)
    # (t_since_solve_start_s, cost) every time the incumbent improved
    incumbents: list[tuple[float, float]] = dataclasses.field(
        default_factory=list)

    @property
    def phase_total_s(self) -> float:
        return self.greedy_s + self.polish_s + self.bnb_s

    @property
    def pruned_total(self) -> int:
        return (self.pruned_lp_bound + self.pruned_cap
                + self.pruned_ceiling + self.pruned_deadline
                + self.pruned_stall)

    def consistent(self) -> bool:
        """Conservation check: children expanded + prunes == considered."""
        if self.nodes == 0:
            return self.comps_considered == 0 and self.pruned_total == 0
        return (self.nodes - 1 + self.pruned_total
                == self.comps_considered)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["incumbents"] = [[float(t), float(c)] for t, c in self.incumbents]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SolveStats":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        kw["incumbents"] = [(float(t), float(c))
                            for t, c in kw.get("incumbents", [])]
        return cls(**kw)


@dataclasses.dataclass
class ILPSolution:
    assignment: np.ndarray          # (N,) gpu index per slice
    counts: np.ndarray              # (M,) B_j
    cost: float
    optimal: bool
    solve_time_s: float
    nodes: int = 0
    stats: Optional[SolveStats] = None

    def by_gpu(self, names: Sequence[str]) -> dict[str, int]:
        return {n: int(c) for n, c in zip(names, self.counts) if c > 0}


def _counts_cost(loads_sum: np.ndarray, costs: np.ndarray) -> float:
    return float(np.sum(costs * np.ceil(loads_sum - _EPS)))


def _local_search_reference(prob: ILPProblem, assign: np.ndarray,
                            load: np.ndarray,
                            gmat: Optional[np.ndarray],
                            max_sweeps: int = 50,
                            deadline: Optional[float] = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Scalar reference for :func:`_local_search`.

    Kept verbatim (modulo the historical rebind-instead-of-mutate bug)
    so property tests can assert the vectorized fast path is
    byte-identical.  Not a solver layer — production calls go through
    ``_local_search``."""
    N, M = prob.loads.shape
    improved = True
    it = 0
    while improved and it < max_sweeps:
        improved = False
        it += 1
        for i in range(N):
            if deadline is not None and i % 64 == 0 \
                    and time.perf_counter() > deadline:
                return assign, load
            cur = assign[i]
            for j in range(M):
                if j == cur or not np.isfinite(prob.loads[i, j]):
                    continue
                new_load = load.copy()
                new_load[cur] -= prob.loads[i, cur]
                new_load[j] += prob.loads[i, j]
                if not counts_within_caps(np.ceil(new_load - _EPS), prob,
                                          gmat):
                    continue
                if _counts_cost(new_load, prob.costs) < _counts_cost(
                        load, prob.costs) - _EPS:
                    assign[i] = j
                    load = new_load
                    improved = True
                    break
    return assign, load


def _greedy_reference(prob: ILPProblem,
                      deadline: Optional[float] = None
                      ) -> Optional[np.ndarray]:
    """Scalar reference for :func:`_greedy` (see
    :func:`_local_search_reference`)."""
    N, M = prob.loads.shape
    gmat = prob.group_matrix()
    assign = np.full(N, -1, dtype=int)
    load = np.zeros(M)
    order = np.argsort(-np.nanmax(
        np.where(np.isfinite(prob.loads), prob.loads, np.nan), axis=1))
    for i in order:
        best_j, best_inc = -1, INFEASIBLE
        counts = np.ceil(load - _EPS)
        for j in range(M):
            lij = prob.loads[i, j]
            if not np.isfinite(lij):
                continue
            new_load = load[j] + lij
            cand = counts.copy()
            cand[j] = math.ceil(new_load - _EPS)
            if not counts_within_caps(cand, prob, gmat):
                continue
            inc = (math.ceil(new_load - _EPS) - math.ceil(load[j] - _EPS)
                   ) * prob.costs[j] + prob.costs[j] * lij * 1e-6
            if inc < best_inc - _EPS:
                best_inc, best_j = inc, j
        if best_j < 0:
            return None
        assign[i] = best_j
        load[best_j] += prob.loads[i, best_j]
    assign, _ = _local_search_reference(prob, assign, load, gmat,
                                        deadline=deadline)
    return assign


def _local_search(prob: ILPProblem, assign: np.ndarray, load: np.ndarray,
                  gmat: Optional[np.ndarray],
                  max_sweeps: int = 50,
                  deadline: Optional[float] = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Single-slice improving moves until a local optimum (in place).

    Vectorized over columns: each slice's M candidate moves are scored
    with O(1) incremental ceil deltas against running ``counts`` /
    group-usage state instead of a full load-vector copy and two O(M)
    cost sums per candidate.  Moves are accepted exactly like the scalar
    reference (first improving column in index order), so assignments
    match ``_local_search_reference`` byte for byte.

    Both ``assign`` and ``load`` ARE mutated in place — the caller's
    arrays always equal the returned ones (which are the same objects).

    ``deadline`` (absolute ``time.perf_counter()`` value — monotonic, so
    an NTP step can't blow or negate the budget) bounds the polish on
    large stacked problems so solve() honours its caller's time budget;
    the interim assignment is always feasible, so stopping early is safe.
    """
    N, M = prob.loads.shape
    if gmat is None:
        gmat = prob.group_matrix()
    if N == 0 or M <= 1:
        return assign, load
    caps = prob.caps
    gcaps = prob.grouped_caps
    costs = prob.costs
    # running state: counts == ceil(load - eps) and usage == gmat @ counts
    # at all times.  All quantities are integer-valued float64 well below
    # 2**53, so the incremental updates are exact — identical to the
    # reference's from-scratch recomputation.
    counts = np.ceil(load - _EPS)
    usage = gmat @ counts if gmat is not None else None
    improved = True
    it = 0
    while improved and it < max_sweeps:
        improved = False
        it += 1
        for i in range(N):
            if deadline is not None and i % 64 == 0 \
                    and time.perf_counter() > deadline:
                return assign, load
            cur = int(assign[i])
            lrow = prob.loads[i]
            fin = np.isfinite(lrow)
            lrow_safe = np.where(fin, lrow, 0.0)
            # removing slice i from its current column (count can only drop)
            cur_load = load[cur] - lrow[cur]
            cur_count = np.ceil(cur_load - _EPS)
            d_cur = cur_count - counts[cur]
            # adding it to each candidate column j
            cand_counts = np.ceil(load + lrow_safe - _EPS)
            d_j = cand_counts - counts
            delta = costs[cur] * d_cur + costs * d_j
            ok = fin.copy()
            ok[cur] = False
            ok &= delta < -_EPS
            if ok.any() and caps is not None:
                ok &= cand_counts <= caps + _EPS
            if ok.any() and gmat is not None:
                base = usage + gmat[:, cur] * d_cur
                cand_usage = base[:, None] + gmat * d_j[None, :]
                ok &= (cand_usage <= gcaps[:, None] + _EPS).all(axis=0)
            if not ok.any():
                continue
            j = int(np.argmax(ok))          # first improving feasible column
            load[cur] -= prob.loads[i, cur]
            load[j] += prob.loads[i, j]
            if gmat is not None:
                usage += gmat[:, cur] * d_cur \
                    + gmat[:, j] * (cand_counts[j] - counts[j])
            counts[cur] = cur_count
            counts[j] = cand_counts[j]
            assign[i] = j
            improved = True
    return assign, load


def _greedy(prob: ILPProblem,
            deadline: Optional[float] = None) -> Optional[np.ndarray]:
    """Warm start: assign to argmin marginal-cost, then local moves.

    Vectorized over columns — per slice, the marginal-cost increments and
    all cap families are evaluated for every column in one batch against
    running counts/usage state; the winner is picked by the same
    running-min-with-epsilon fold as ``_greedy_reference``, so the
    result is byte-identical."""
    N, M = prob.loads.shape
    gmat = prob.group_matrix()
    caps = prob.caps
    gcaps = prob.grouped_caps
    costs = prob.costs
    assign = np.full(N, -1, dtype=int)
    load = np.zeros(M)
    counts = np.zeros(M)
    usage = np.zeros(gmat.shape[0]) if gmat is not None else None
    # counts only grow, so if even the empty fleet violates a cap (a
    # negative cap from a stockout) no candidate can ever pass — exactly
    # the reference's behaviour of rejecting every column.
    if N and not counts_within_caps(counts, prob, gmat):
        return None
    order = np.argsort(-np.nanmax(
        np.where(np.isfinite(prob.loads), prob.loads, np.nan), axis=1))
    for i in order:
        lrow = prob.loads[i]
        fin = np.isfinite(lrow)
        lrow_safe = np.where(fin, lrow, 0.0)
        new_counts = np.ceil(load + lrow_safe - _EPS)
        dc = new_counts - counts
        ok = fin.copy()
        if caps is not None:
            ok &= new_counts <= caps + _EPS
        if gmat is not None:
            cand_usage = usage[:, None] + gmat * dc[None, :]
            ok &= (cand_usage <= gcaps[:, None] + _EPS).all(axis=0)
        inc = dc * costs + (costs * lrow_safe) * 1e-6
        best_j, best_inc = -1, INFEASIBLE
        for j in np.nonzero(ok)[0]:
            if inc[j] < best_inc - _EPS:
                best_inc, best_j = inc[j], j
        if best_j < 0:
            return None
        best_j = int(best_j)
        assign[i] = best_j
        load[best_j] += prob.loads[i, best_j]
        if gmat is not None:
            usage += gmat[:, best_j] * dc[best_j]
        counts[best_j] = new_counts[best_j]
    assign, _ = _local_search(prob, assign, load, gmat, deadline=deadline)
    return assign


def _compositions(m: int, k: int):
    """All ways to write m as an ordered sum of k non-negatives."""
    if k == 1:
        yield (m,)
        return
    for first in range(m + 1):
        for rest in _compositions(m - first, k - 1):
            yield (first,) + rest


@functools.lru_cache(maxsize=256)
def _compositions_cached(m: int, k: int) -> np.ndarray:
    """(n_comps, k) int64 array, cached: the list->array conversion was
    a measurable share of solve time on stacked problems (~6.5k rows per
    multiplicity-32 group).  Read-only — callers fancy-index copies."""
    arr = np.array(list(_compositions(m, k)), dtype=np.int64).reshape(-1, k)
    arr.setflags(write=False)
    return arr


def solve(prob: ILPProblem, time_budget_s: float = 5.0,
          max_types_per_group: int = 8,
          warm_assign: Optional[np.ndarray] = None,
          prune_dominated: bool = True,
          stall_nodes: Optional[int] = _STALL_NODES,
          stall_comps: Optional[int] = _STALL_COMPS
          ) -> Optional[ILPSolution]:
    """Exact branch-and-bound at bucket-group granularity.

    Slices within a bucket are identical, so the search assigns *counts* per
    (group, gpu) — compositions of the group's multiplicity — rather than
    permutations of individual slices.  Separable-LP suffix bound + strong
    warm starts (greedy+LS, LP rounding, single-type) give an any-time
    solution; ``optimal`` reports whether the search completed.

    With TP-expanded catalogs M can reach 16+; compositions of a
    multiplicity-8 group over 16 types are ~500k nodes, so each group's
    branching set is restricted to its ``max_types_per_group`` cheapest
    (by fractional unit cost) feasible types.  When the restriction is
    active the search is a (high-quality) heuristic and ``optimal`` is
    reported False; small instances — all exactness tests — are unaffected.

    ``prune_dominated`` runs the :mod:`repro.core.dominance` pre-pass and
    solves the reduced catalog (answers provably unchanged; cross-checked
    against brute force).  ``stall_nodes``/``stall_comps`` stop the DFS
    once that many nodes / candidate compositions have been expanded with
    no incumbent improvement — pass ``None`` to disable either and search
    to the deadline.  Stall cutoffs are pure counters, so whether a given
    problem stalls is machine-independent; a stalled solve keeps the
    incumbent and reports ``optimal=False``.
    """
    t0 = time.perf_counter()
    N, M = prob.loads.shape
    stats = SolveStats(n_slices=N, n_columns=M)
    gmat = prob.group_matrix()
    gcaps = prob.grouped_caps
    if N == 0:
        return ILPSolution(np.zeros(0, int), np.zeros(M, int), 0.0, True, 0.0,
                           stats=stats)

    finite = np.isfinite(prob.loads)
    if not finite.any(axis=1).all():
        return None                                    # some slice fits nowhere

    # ---- dominance pre-pass: drop columns that provably appear in no
    # optimum, solve the reduced catalog (recursing through this same
    # layer, so every constraint field is still enforced here), and map
    # the solution back to original column indices.
    if prune_dominated and M > 1:
        from .dominance import reduce_problem
        red = reduce_problem(prob)
        if red is not None:
            wa_red = (red.map_assignment(warm_assign)
                      if warm_assign is not None else None)
            remaining = max(0.05, time_budget_s
                            - (time.perf_counter() - t0))
            sub = solve(red.problem, time_budget_s=remaining,
                        max_types_per_group=max_types_per_group,
                        warm_assign=wa_red, prune_dominated=False,
                        stall_nodes=stall_nodes, stall_comps=stall_comps)
            if sub is None:
                return None
            return red.expand_solution(sub, M,
                                       time.perf_counter() - t0)

    # ---- warm starts: caller-provided (e.g. the tp=1 sub-catalog optimum),
    # greedy+local-search, LP rounding, single-type
    candidates: list[np.ndarray] = []
    if warm_assign is not None:
        wa = np.asarray(warm_assign, dtype=int)
        # defensive: a stale warm start (solved on another catalog or
        # slice set) must be ignored, not crash the incumbent polish with
        # out-of-range column indices
        if wa.shape == (N,) and len(wa) and ((wa >= 0) & (wa < M)).all():
            candidates.append(wa)
    # the warm phase gets a *fraction* of the budget (it used to inherit
    # the whole deadline and could starve branch-and-bound entirely)
    stats.warm_budget_s = _WARM_TOTAL_FRAC * time_budget_s
    warm = _greedy(prob, deadline=t0 + _WARM_GREEDY_FRAC * time_budget_s)
    stats.greedy_s = time.perf_counter() - t0
    if warm is not None:
        candidates.append(warm)
    # LP-relaxation rounding: each slice to argmin c_j L_ij
    lp = np.argmin(np.where(finite, prob.loads * prob.costs, np.inf), axis=1)
    candidates.append(lp)
    # single-type solutions (the paper's baselines are feasible points)
    for j in range(M):
        if finite[:, j].all():
            total = prob.loads[:, j].sum()
            single = np.zeros(M)
            single[j] = math.ceil(total - _EPS)
            if counts_within_caps(single, prob, gmat):
                candidates.append(np.full(N, j, dtype=int))

    best_cost, best_assign, best_load = INFEASIBLE, None, None
    for cand in candidates:
        load_c = np.array([prob.loads[np.arange(N)[cand == j], j].sum()
                           for j in range(M)])
        if not np.isfinite(load_c).all():
            continue
        counts_c = np.ceil(load_c - _EPS)
        if not counts_within_caps(counts_c, prob, gmat):
            continue
        c = _counts_cost(load_c, prob.costs)
        if c < best_cost:
            best_cost, best_assign, best_load = c, cand.copy(), load_c
    # polish the incumbent with local moves: on large stacked problems
    # (multi-model fleets) the branch-and-bound below is effectively an
    # any-time heuristic, so incumbent quality is what the caller gets
    if best_assign is not None:
        t_polish = time.perf_counter()
        best_assign, best_load = _local_search(
            prob, best_assign, best_load, gmat,
            deadline=t0 + _WARM_TOTAL_FRAC * time_budget_s)
        best_cost = _counts_cost(best_load, prob.costs)
        stats.polish_s = time.perf_counter() - t_polish
        stats.incumbents.append((time.perf_counter() - t0, best_cost))
    # (no feasible warm start is not proof of infeasibility once grouped
    # caps are present — the branch-and-bound below still searches)

    # ---- group interchangeable slices: same bucket id + identical rows
    groups: list[dict] = []
    key_of = {}
    for i in range(N):
        row = prob.loads[i]
        key = (int(prob.bucket_of_slice[i]),
               tuple(np.round(np.where(np.isfinite(row), row, -1.0), 12)))
        if key not in key_of:
            key_of[key] = len(groups)
            groups.append({"row": row, "idx": []})
        groups[key_of[key]]["idx"].append(i)
    G = len(groups)
    rows = np.stack([g["row"] for g in groups])          # (G, M)
    mult = np.array([len(g["idx"]) for g in groups])
    gfinite = np.isfinite(rows)
    cost_g = np.where(gfinite, rows * prob.costs, np.inf)

    # search order: largest total-load, biggest spread first
    if M > 1:
        spread = np.where(gfinite.sum(axis=1) > 1,
                          np.sort(cost_g, axis=1)[:, 1] - cost_g.min(axis=1),
                          0.0)
    else:
        spread = np.zeros(G)
    size_key = np.nanmax(np.where(gfinite, rows, np.nan), axis=1) * mult
    gorder = np.lexsort((-size_key, -spread))
    rows_o = rows[gorder]
    mult_o = mult[gorder]
    min_unit = cost_g.min(axis=1)[gorder] * mult_o
    suffix_lb = np.concatenate([np.cumsum(min_unit[::-1])[::-1], [0.0]])

    # per-group branching sets, restricted to the cheapest unit-cost types
    # when the catalog is wide (TP expansion); restriction => heuristic.
    # Compositions and their fractional costs depend only on the group, not
    # the search path, so they are enumerated and cost-sorted ONCE here.
    restricted = False
    comp_cache: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for gi in range(G):
        feas = [j for j in range(M) if gfinite[gorder[gi]][j]]
        if len(feas) > max_types_per_group:
            feas = sorted(feas,
                          key=lambda j: cost_g[gorder[gi]][j]
                          )[:max_types_per_group]
            restricted = True
        comps = _compositions_cached(int(mult_o[gi]), len(feas))
        unit = cost_g[gorder[gi]][feas]
        inc = comps @ unit
        order = np.argsort(inc, kind="stable")
        comp_cache.append((comps[order], inc[order], np.asarray(feas)))

    nodes = 0
    timeout = False
    stalled = False
    improve_node = 0
    improve_comps = 0
    best_counts_per_group = None
    cur_counts: list[Optional[tuple]] = [None] * G
    stats.n_groups = G
    stats.restricted = restricted
    stats.nodes_by_depth = [0] * (G + 1)

    def dfs(gi: int, load: np.ndarray, frac: float):
        nonlocal nodes, timeout, stalled, best_cost, best_counts_per_group
        nonlocal improve_node, improve_comps
        if timeout or stalled:
            return
        nodes += 1
        stats.nodes_by_depth[gi] += 1
        if nodes % 64 == 0 and time.perf_counter() - t0 > time_budget_s:
            timeout = True
            return
        # deterministic stall cutoff: only once an incumbent exists (a
        # feasible answer in hand), stop after stall_nodes nodes or
        # stall_comps candidate compositions without an improvement —
        # on large stacked problems the polished warm start is usually
        # already optimal and the search would burn the whole deadline.
        if best_assign is not None or best_counts_per_group is not None:
            if (stall_nodes is not None
                    and nodes - improve_node > stall_nodes) \
                    or (stall_comps is not None
                        and stats.comps_considered - improve_comps
                        > stall_comps):
                stalled = True
                return
        if gi == G:
            cost = _counts_cost(load, prob.costs)
            if cost < best_cost - 1e-9:
                best_cost = cost
                best_counts_per_group = [c for c in cur_counts]
                improve_node = nodes
                improve_comps = stats.comps_considered
                stats.incumbents.append(
                    (time.perf_counter() - t0, best_cost))
            return
        # pre-sorted by fractional cost (see comp_cache construction)
        comps, incs, feas = comp_cache[gi]
        stats.comps_considered += len(incs)
        row_feas = rows_o[gi][feas]
        # comps sorted by inc => everything at/after the cutoff is pruned
        # by the separable-LP suffix bound (incumbent may improve below,
        # which only shrinks the cutoff further — rechecked per branch).
        # Cost-cutoff search in the sorted composition costs — not
        # request bucketization.
        n_ok = int(np.searchsorted(incs,  # lint: allow[bucket-edges]
                                   best_cost - 1e-7 - frac - suffix_lb[gi + 1]))
        stats.pruned_lp_bound += len(incs) - n_ok
        if n_ok == 0:
            return
        # vectorized feasibility + committed-ceiling bound over all
        # candidate compositions at once: only the feas columns change
        load_feas = load[feas]
        ceil_feas = np.ceil(load_feas + comps[:n_ok] * row_feas - _EPS)
        base_counts = np.ceil(load - _EPS)
        fixed_cost = float(np.dot(prob.costs, base_counts)
                           - np.dot(prob.costs[feas], base_counts[feas]))
        # counts only grow along a DFS path, so a violation here (per-type
        # or grouped chips) can never heal deeper: prune those branches.
        ok = np.ones(n_ok, dtype=bool)
        if prob.caps is not None:
            ok &= (ceil_feas <= prob.caps[feas] + _EPS).all(axis=1)
        if gmat is not None:
            base_usage = gmat @ base_counts - gmat[:, feas] @ base_counts[feas]
            usage = base_usage[:, None] + gmat[:, feas] @ ceil_feas.T
            ok &= (usage <= gcaps[:, None] + _EPS).all(axis=0)
        ok_idx = np.nonzero(ok)[0]
        stats.pruned_cap += n_ok - len(ok_idx)
        # committed-ceiling lower bound per composition
        lb_ceil = fixed_cost + ceil_feas @ prob.costs[feas]
        for pos, ci in enumerate(ok_idx):
            inc = float(incs[ci])
            if frac + inc + suffix_lb[gi + 1] >= best_cost - 1e-7:
                # incumbent improved: prune the whole sorted tail
                stats.pruned_lp_bound += len(ok_idx) - pos
                break
            if lb_ceil[ci] >= best_cost - 1e-7:
                stats.pruned_ceiling += 1
                continue
            add = np.zeros(M)
            add[feas] = comps[ci] * row_feas
            full = np.zeros(M, dtype=int)
            full[feas] = comps[ci]
            cur_counts[gi] = tuple(full)
            dfs(gi + 1, load + add, frac + inc)
            cur_counts[gi] = None
            if timeout:
                # budget expired mid-loop: the rest of this node's
                # candidates are abandoned, not bound-pruned
                stats.pruned_deadline += len(ok_idx) - pos - 1
                return
            if stalled:
                stats.pruned_stall += len(ok_idx) - pos - 1
                return

    t_bnb = time.perf_counter()
    dfs(0, np.zeros(M), 0.0)
    stats.bnb_s = time.perf_counter() - t_bnb
    stats.nodes = nodes
    stats.deadline_hit = timeout
    stats.stalled = stalled

    if best_counts_per_group is not None:
        best_assign = np.empty(N, dtype=int)
        for gi_o, comp in enumerate(best_counts_per_group):
            g = groups[gorder[gi_o]]
            pos = 0
            for j in range(M):
                for _ in range(comp[j]):
                    best_assign[g["idx"][pos]] = j
                    pos += 1

    if best_assign is None:        # nothing feasible found (caps too tight)
        # the cheapest-types restriction may have excluded the only
        # cap-feasible columns: retry unrestricted before declaring
        # infeasibility (bounded by the leftover budget)
        remaining = time_budget_s - (time.perf_counter() - t0)
        if restricted and remaining > 0.05:
            retry = solve(prob, time_budget_s=remaining,
                          max_types_per_group=M,
                          prune_dominated=prune_dominated,
                          stall_nodes=stall_nodes, stall_comps=stall_comps)
            if retry is not None:
                # the retry's stats are self-consistent on their own; only
                # stretch the clock to cover the abandoned first attempt
                retry.solve_time_s = time.perf_counter() - t0
                if retry.stats is not None:
                    retry.stats.restricted_retry = True
            return retry
        return None
    counts = np.zeros(M, dtype=int)
    for j in range(M):
        lj = prob.loads[np.arange(N)[best_assign == j], j].sum()
        counts[j] = int(math.ceil(lj - _EPS))
    return ILPSolution(best_assign, counts, float(np.sum(counts * prob.costs)),
                       optimal=not timeout and not restricted and not stalled,
                       solve_time_s=time.perf_counter() - t0,
                       nodes=nodes, stats=stats)


def solve_brute_force(prob: ILPProblem) -> Optional[ILPSolution]:
    """Exhaustive reference for tests (tiny N only).  Enforces the same
    constraint set as ``solve``: per-type caps *and* grouped chip caps.

    Enumerates only each slice's *feasible* columns — forbidden (inf)
    assignments could never win, so skipping them changes nothing except
    the node count.  This keeps fleet problems tractable: a (model, bucket)
    slice is finite only on its own model's columns, so the product space
    stays |gpus|^N rather than (n_models·|gpus|)^N."""
    N, M = prob.loads.shape
    gmat = prob.group_matrix()
    feasible = [np.nonzero(np.isfinite(prob.loads[i]))[0] for i in range(N)]
    if any(len(f) == 0 for f in feasible):
        return None
    best = None
    t0 = time.perf_counter()
    for combo in itertools.product(*feasible):
        load = np.zeros(M)
        for i, j in enumerate(combo):
            load[j] += prob.loads[i, j]
        counts = np.ceil(load - _EPS)
        if not counts_within_caps(counts, prob, gmat):
            continue
        cost = float(np.sum(counts * prob.costs))
        if best is None or cost < best.cost - 1e-12:
            best = ILPSolution(np.array(combo), counts.astype(int), cost,
                               True, time.perf_counter() - t0)
    return best


def _cap_dirty_columns(prob: ILPProblem, prev: ILPProblem
                       ) -> tuple[bool, np.ndarray]:
    """Which columns' *cap context* changed between two same-width
    problems.  Returns ``(clean, dirty)``: ``clean`` is True when every
    cap family is identical; ``dirty[j]`` marks columns whose caps may
    have moved (conservatively all columns when a family's structure
    changed shape or appeared/disappeared)."""
    M = prob.loads.shape[1]
    dirty = np.zeros(M, dtype=bool)

    def _same(a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        a = np.asarray(a, dtype=float)
        b = np.asarray(b, dtype=float)
        return a.shape == b.shape \
            and bool(np.isclose(a, b, rtol=0.0, atol=0.0).all())

    # per-column availability caps: exact per-column dirt
    if (prob.caps is None) != (prev.caps is None):
        dirty[:] = True
    elif prob.caps is not None and not _same(prob.caps, prev.caps):
        dirty |= ~np.isclose(np.asarray(prob.caps, dtype=float),
                             np.asarray(prev.caps, dtype=float),
                             rtol=0.0, atol=0.0)
    # chip pools: any change re-opens every pooled column
    if not (_same(prob.chip_weight, prev.chip_weight)
            and _same(prob.chip_group, prev.chip_group)
            and _same(prob.group_caps, prev.group_caps)):
        if (prob.group_caps is None) != (prev.group_caps is None) \
                or prob.chip_group is None:
            dirty[:] = True
        else:
            dirty |= np.asarray(prob.chip_group) >= 0
            if prev.chip_group is not None \
                    and len(prev.chip_group) == M:
                dirty |= np.asarray(prev.chip_group) >= 0
    # general shared-resource rows: columns touched by a changed row
    if (prob.group_rows is None) != (prev.group_rows is None):
        dirty[:] = True
    elif prob.group_rows is not None:
        gr_new = np.asarray(prob.group_rows, dtype=float)
        gr_old = np.asarray(prev.group_rows, dtype=float)
        caps_new = (None if prob.group_row_caps is None
                    else np.asarray(prob.group_row_caps, dtype=float))
        caps_old = (None if prev.group_row_caps is None
                    else np.asarray(prev.group_row_caps, dtype=float))
        shapes_differ = gr_new.shape != gr_old.shape \
            or (caps_new is None) != (caps_old is None) \
            or (caps_new is not None and caps_new.shape != caps_old.shape)
        if shapes_differ:
            dirty[:] = True
        else:
            row_diff = ~np.isclose(gr_new, gr_old,
                                   rtol=0.0, atol=0.0).all(axis=1)
            if caps_new is not None:
                row_diff |= ~np.isclose(caps_new, caps_old,
                                        rtol=0.0, atol=0.0)
            if row_diff.any():
                dirty |= (np.abs(gr_new[row_diff]) > 0).any(axis=0)
                dirty |= (np.abs(gr_old[row_diff]) > 0).any(axis=0)
    return bool(not dirty.any()), dirty


def solve_incremental(prob: ILPProblem,
                      prev_assign: Optional[np.ndarray],
                      *,
                      prev_prob: Optional[ILPProblem] = None,
                      prev_loads: Optional[np.ndarray] = None,
                      prev_costs: Optional[np.ndarray] = None,
                      caps_clean: bool = False,
                      time_budget_s: float = 5.0,
                      max_types_per_group: int = 8
                      ) -> Optional[ILPSolution]:
    """Per-column incremental re-solve, warm-started from ``prev_assign``.

    Generalizes the ``FleetAutoscaler``'s per-model partial re-solve:
    compare the drifted problem against the previous one (``prev_prob``,
    or raw ``prev_loads``/``prev_costs`` plus a ``caps_clean`` flag for
    stacked fleet problems whose previous caps aren't reconstructable)
    and *pin* every slice whose load row is unchanged and which cannot
    use any column whose price or cap context changed: its row is masked
    ``inf`` everywhere except the previously assigned column.  (A dirty
    column re-opens every slice that could use it, so a price drop
    elsewhere is always allowed to steal otherwise-unchanged slices —
    the controllers' price-chasing behavior survives pinning.)  Pinning
    uses the same structural inf-mask mechanism as the on-demand floor,
    so all four solver layers enforce the pins by construction, and the
    pinned problem still carries the NEW problem's full cap set — the
    reduced solve can never emit a cap-violating allocation.  If the
    pinned problem is infeasible (caps tightened underneath a pin), fall
    back to a cold warm-started solve of the full problem.

    Any solve with pinned slices is a restriction of the true problem,
    so the returned solution conservatively reports ``optimal=False``.
    Stats carry ``incremental`` / ``pinned_slices`` / ``reopened_slices``.
    """
    t0 = time.perf_counter()
    N, M = prob.loads.shape

    def _mark(sol: Optional[ILPSolution], pinned: int) -> \
            Optional[ILPSolution]:
        if sol is not None:
            sol.solve_time_s = time.perf_counter() - t0
            if sol.stats is not None:
                sol.stats.incremental = True
                sol.stats.pinned_slices = pinned
                sol.stats.reopened_slices = N - pinned
        return sol

    def _cold(wa: Optional[np.ndarray]) -> Optional[ILPSolution]:
        remaining = max(0.05, time_budget_s - (time.perf_counter() - t0))
        return _mark(solve(prob, time_budget_s=remaining,
                           max_types_per_group=max_types_per_group,
                           warm_assign=wa), 0)

    a: Optional[np.ndarray] = None
    if prev_assign is not None:
        a = np.asarray(prev_assign, dtype=int)
        if a.shape != (N,) or (N and not ((a >= 0) & (a < M)).all()):
            a = None
    if a is None or N == 0:
        return _cold(a)

    if prev_prob is not None:
        if prev_prob.loads.shape != prob.loads.shape \
                or list(prev_prob.gpu_names) != list(prob.gpu_names):
            return _cold(None)          # different catalog: nothing carries
        prev_loads = prev_prob.loads
        prev_costs = prev_prob.costs
        caps_clean, cap_dirty = _cap_dirty_columns(prob, prev_prob)
    else:
        if prev_loads is None or prev_costs is None \
                or np.asarray(prev_loads).shape != prob.loads.shape \
                or np.asarray(prev_costs).shape != prob.costs.shape:
            return _cold(a)
        prev_loads = np.asarray(prev_loads, dtype=float)
        prev_costs = np.asarray(prev_costs, dtype=float)
        cap_dirty = np.zeros(M, dtype=bool)
        if not caps_clean:
            cap_dirty[:] = True

    dirty_col = cap_dirty | ~np.isclose(prob.costs, prev_costs,
                                        rtol=0.0, atol=0.0)
    row_clean = np.isclose(prob.loads, prev_loads,
                           rtol=0.0, atol=0.0).all(axis=1)
    # a dirty column (price or cap context changed) re-opens every slice
    # that could *use* it, not just the slices assigned to it — a price
    # drop elsewhere must be allowed to steal an otherwise-unchanged slice
    pinned = row_clean \
        & ~(np.isfinite(prob.loads) & dirty_col[None, :]).any(axis=1) \
        & np.isfinite(prob.loads[np.arange(N), a])
    n_pin = int(pinned.sum())
    if n_pin == 0:
        return _cold(a)

    ploads = prob.loads.copy()
    pin_idx = np.nonzero(pinned)[0]
    kept = ploads[pin_idx, a[pin_idx]]
    ploads[pin_idx, :] = np.inf
    ploads[pin_idx, a[pin_idx]] = kept
    pinned_prob = dataclasses.replace(prob, loads=ploads)
    sol = solve(pinned_prob, time_budget_s=time_budget_s,
                max_types_per_group=max_types_per_group, warm_assign=a)
    if sol is None:
        # pins made the new cap set unreachable: re-open everything
        return _cold(a)
    # pinned rows keep their true load value at the assigned column, so
    # counts/cost computed on the pinned loads equal the real problem's
    sol.optimal = False
    return _mark(sol, n_pin)
