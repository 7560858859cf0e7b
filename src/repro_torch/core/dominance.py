"""The port's copy of ``src/repro/core/dominance.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and
``tests/test_torch_control.py`` holds the two to the same results.
The original's docstring follows.

Dominated-column pruning for the Mélange ILP (the solver fast path).

A column ``j`` can be dropped before the search when some other column
``k`` is *at least as good everywhere* it matters:

  1. ``costs[k] <= costs[j]`` — k is no more expensive per instance;
  2. every slice row finite on j is finite on k with
     ``loads[i, k] <= loads[i, j]`` — k can absorb anything j serves at
     no more fractional load (this implies weakly-better $/throughput
     on every finite bucket row);
  3. k's weight in every cap row of :meth:`ILPProblem.group_matrix` is
     ``<=`` j's (weaker-than-or-identical cap-group membership);
  4. k carries no finite per-column availability cap.

Safety: take any optimal solution that uses j and move all of j's
slices onto k.  The added fractional load ``L`` satisfies
``L <= load_j``, so k's count grows by
``ceil(load_k + L) - ceil(load_k) <= ceil(L) <= count_j`` while j's
count drops to zero.  With (1) the cost change is
``c_k * d - c_j * count_j <= c_j * (d - count_j) <= 0``, with (3) every
cap row's usage change is ``w_rk * d - w_rj * count_j <= 0``, and (4)
removes the only cap k itself could hit — the move is feasible and no
more expensive, so some optimum avoids j entirely.  The relation is
transitive, so chained prunes resolve to a kept *representative* that
still dominates.  ``crosscheck.run_dominance_crosschecks`` proves the
"never changes the optimal cost" claim against brute force.

Note the pure fractional $/throughput rule from the paper discussion is
NOT safe under the ceil objective (a slightly-cheaper-per-token column
can still lose after rounding); conditions (1)–(4) are the sound
strengthening.

Structured as a *problem-to-problem* reduction consumed by
``solve()`` recursing into itself on the reduced catalog, so the PR 7
``solver-layer-parity`` lint still sees every constraint field enforced
inside each layer's own call chain.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .ilp import ILPProblem, ILPSolution


def dominance_mask(prob: ILPProblem) -> tuple[np.ndarray, np.ndarray]:
    """Compute which columns are dominated.

    Returns ``(pruned, dominator)``: ``pruned[j]`` marks dropped
    columns and ``dominator[j]`` is the *kept* column absorbing j's
    slices (``-1`` for kept columns).  Exactly one column of a
    mutually-dominating (duplicate) set survives.
    """
    loads, costs = prob.loads, prob.costs
    N, M = loads.shape
    pruned = np.zeros(M, dtype=bool)
    dominator = np.full(M, -1, dtype=int)
    if M < 2 or N == 0:
        return pruned, dominator
    finite = np.isfinite(loads)
    gm = prob.group_matrix()
    caps = prob.caps
    unlimited = (np.ones(M, dtype=bool) if caps is None
                 else ~np.isfinite(np.asarray(caps, dtype=float)))
    for j in range(M):
        # NB: comparisons are strict <= with NO epsilon slack — a
        # dominator even epsilon-worse on one row could flip a ceil
        # boundary and change the optimal cost.
        cand = unlimited & (costs <= costs[j]) & ~pruned
        cand[j] = False
        if gm is not None:
            cand &= (gm <= gm[:, [j]]).all(axis=0)
        if not cand.any():
            continue
        rows_j = np.nonzero(finite[:, j])[0]
        cand_idx = np.nonzero(cand)[0]
        if len(rows_j):
            # inf <= finite is False, so this also requires k finite
            # wherever j is
            ok = (loads[np.ix_(rows_j, cand_idx)]
                  <= loads[rows_j, j][:, None]).all(axis=0)
            cand_idx = cand_idx[ok]
        if len(cand_idx):
            pruned[j] = True
            dominator[j] = int(cand_idx[0])
    # resolve dominator chains: a dominator chosen early may itself be
    # pruned later — follow to the kept representative (transitivity
    # guarantees it still dominates)
    for j in np.nonzero(pruned)[0]:
        k = int(dominator[j])
        while pruned[k]:
            k = int(dominator[k])
        dominator[j] = k
    return pruned, dominator


@dataclasses.dataclass
class DominanceReduction:
    """A reduced problem plus the index maps to undo the reduction."""

    problem: ILPProblem
    keep: np.ndarray           # (M_red,) original column per kept column
    dominator: np.ndarray      # (M,) kept original column per pruned col
    n_pruned: int

    def map_assignment(self, assign: np.ndarray) -> Optional[np.ndarray]:
        """Original-index assignment -> reduced-index assignment (for
        warm starts).  Slices on pruned columns move to the column's
        kept representative.  Returns None on an unusable assignment."""
        a = np.asarray(assign, dtype=int)
        M = len(self.dominator)
        if a.ndim != 1 or (len(a) and not ((a >= 0) & (a < M)).all()):
            return None
        rep = np.where(self.dominator >= 0, self.dominator, np.arange(M))
        pos = np.full(M, -1, dtype=int)
        pos[self.keep] = np.arange(len(self.keep))
        return pos[rep[a]]

    def expand_solution(self, sub: ILPSolution, n_columns: int,
                        solve_time_s: float) -> ILPSolution:
        """Map a reduced-catalog solution back to original columns."""
        assignment = self.keep[np.asarray(sub.assignment, dtype=int)]
        counts = np.zeros(n_columns, dtype=int)
        counts[self.keep] = sub.counts
        stats = sub.stats
        if stats is not None:
            stats.n_columns = n_columns
            stats.cols_dominated = self.n_pruned
        return ILPSolution(assignment, counts, sub.cost, sub.optimal,
                           solve_time_s, nodes=sub.nodes, stats=stats)


def reduce_problem(prob: ILPProblem) -> Optional[DominanceReduction]:
    """Build the dominance-reduced problem, or None when nothing prunes."""
    pruned, dominator = dominance_mask(prob)
    n_pruned = int(pruned.sum())
    if n_pruned == 0:
        return None
    keep = np.nonzero(~pruned)[0]

    def _cols(arr, dtype=None):
        if arr is None:
            return None
        a = np.asarray(arr)
        return a[keep] if dtype is None else a[keep].astype(dtype)

    reduced = dataclasses.replace(
        prob,
        loads=prob.loads[:, keep],
        costs=prob.costs[keep],
        gpu_names=[prob.gpu_names[int(j)] for j in keep],
        caps=_cols(prob.caps),
        chip_weight=_cols(prob.chip_weight),
        chip_group=_cols(prob.chip_group),
        group_rows=(None if prob.group_rows is None
                    else np.asarray(prob.group_rows)[:, keep]),
        spot_col=_cols(prob.spot_col),
        region_col=_cols(prob.region_col),
    )
    return DominanceReduction(problem=reduced, keep=keep,
                              dominator=dominator, n_pruned=n_pruned)
