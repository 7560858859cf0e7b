"""The port's copy of ``src/repro/core/workload.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

LLM service workloads: request-size histograms, buckets, slices (§5.1,
§5.4.1) and the three evaluation datasets of §6.1 / App. A.1.

A workload is a 2-D histogram over (input length, output length) whose bucket
values are request rates (req/s).  The exact Arena / PubMed datasets are not
downloadable offline, so the generators below are synthetic distributions
matching the paper's descriptions (Fig. 10): Arena skews short (<2000
tokens), PubMed has long document inputs with short summaries, Mixed samples
80% Arena / 20% PubMed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

import numpy as np

# Paper §6.1: "10 input length ranges and 6 output length ranges (60 buckets)"
INPUT_EDGES = (1, 25, 100, 250, 500, 1000, 2000, 4000, 8000, 16000, 32000)
OUTPUT_EDGES = (1, 25, 100, 250, 500, 1000, 2000)

DEFAULT_SLICE_FACTOR = 8


@dataclasses.dataclass(frozen=True)
class Bucket:
    i_lo: int
    i_hi: int
    o_lo: int
    o_hi: int

    @property
    def rep_input(self) -> int:
        """Representative (conservative: upper-mid) request size.

        The 75th-percentile point of the range, not the midpoint: profiling
        MaxTput at an under-sized representative inflates the table and
        breaks SLO attainment for the bucket's larger-than-average requests
        (§5.3 picks the representative conservatively for the same reason).
        """
        return int((self.i_lo + 3 * self.i_hi) / 4)

    @property
    def rep_output(self) -> int:
        return int((self.o_lo + 3 * self.o_hi) / 4)

    @property
    def max_tokens(self) -> int:
        return self.i_hi + self.o_hi


def bucket_grid(input_edges=INPUT_EDGES, output_edges=OUTPUT_EDGES):
    out = []
    for a, b in zip(input_edges[:-1], input_edges[1:]):
        for c, d in zip(output_edges[:-1], output_edges[1:]):
            out.append(Bucket(a, b, c, d))
    return out


def edge_bucket(values, edges) -> np.ndarray:
    """Half-open bucketing along one axis: value v lands in bucket k iff
    ``edges[k] <= v < edges[k+1]`` — a value sitting exactly on a shared
    interior edge belongs to the *upper* bucket only, never both.  The two
    boundary buckets absorb out-of-range values (v < edges[0] -> bucket 0;
    v >= edges[-1] -> last bucket), so every value lands in exactly one
    bucket and histogram mass is conserved.

    This is the single bucketing rule for the whole stack: workload
    histograms, the load balancer's routing buckets, and per-window
    telemetry all share it, so a request can never be double-counted into
    two adjacent buckets by drifting implementations."""
    e = np.asarray(edges)
    return np.clip(np.searchsorted(e, values, side="right") - 1,
                   0, len(e) - 2).astype(int)


def bucket_indices(inputs, outputs, input_edges=INPUT_EDGES,
                   output_edges=OUTPUT_EDGES) -> np.ndarray:
    """Flat bucket index (input-major, matching ``bucket_grid`` order) for
    each (input_len, output_len) pair, under ``edge_bucket`` semantics."""
    no = len(output_edges) - 1
    bi = edge_bucket(inputs, input_edges)
    bo = edge_bucket(outputs, output_edges)
    return bi * no + bo


def grid_edges(buckets: "list[Bucket]") -> tuple[tuple, tuple]:
    """Recover the (input_edges, output_edges) of a ``bucket_grid``-shaped
    bucket list — so trace realizations and telemetry windows can histogram
    onto the *same* grid a profile was built over (custom coarse grids
    included), instead of silently assuming the default 60-bucket grid."""
    in_edges = sorted({b.i_lo for b in buckets} | {b.i_hi for b in buckets})
    out_edges = sorted({b.o_lo for b in buckets} | {b.o_hi for b in buckets})
    if bucket_grid(in_edges, out_edges) != list(buckets):
        raise ValueError(
            "bucket list is not a bucket_grid over its own edges — cannot "
            "derive histogram edges for it")
    return tuple(in_edges), tuple(out_edges)


@dataclasses.dataclass
class Workload:
    """Histogram workload: bucket -> request rate (req/s)."""

    buckets: list[Bucket]
    rates: np.ndarray                      # (n_buckets,) req/s
    name: str = "workload"

    @property
    def total_rate(self) -> float:
        return float(self.rates.sum())

    def scaled(self, total_rate: float) -> "Workload":
        cur = self.total_rate
        f = total_rate / cur if cur > 0 else 0.0
        # display-only workload label ("chat@5.0"); never names a pool
        return Workload(self.buckets, self.rates * f,
                        name=f"{self.name}@{total_rate}")  # lint: allow[pool-key-literals]

    def slices(self, slice_factor: int = DEFAULT_SLICE_FACTOR):
        """§5.4.1: split each non-empty bucket into `slice_factor` slices.

        Returns (bucket_index, slice_rate) pairs.
        """
        out = []
        for bi, r in enumerate(self.rates):
            if r <= 0:
                continue
            for _ in range(slice_factor):
                out.append((bi, r / slice_factor))
        return out

    def nonzero(self):
        return [(b, float(r)) for b, r in zip(self.buckets, self.rates)
                if r > 0]


@dataclasses.dataclass
class ModelSpec:
    """One model of a multi-model fleet: engine-model parameters, its own
    TPOT SLO, and its traffic (a static ``Workload`` snapshot and/or a
    time-varying trace for the orchestrator).

    The fleet allocator (``MelangeFleet``) profiles each spec separately —
    MaxTput tables depend on (model, SLO) — and packs all specs' (model,
    bucket) slices onto one shared accelerator pool.
    """

    name: str
    perf: object                 # ModelPerf (engine-model parameters)
    slo_tpot_s: float
    workload: Optional[Workload] = None
    trace: Optional[object] = None     # repro.traces.WorkloadTrace
    engine_params: Optional[object] = None  # EngineModelParams override

    def __post_init__(self):
        if self.slo_tpot_s <= 0:
            raise ValueError(f"model '{self.name}': slo_tpot_s must be > 0")

    def workload_at(self, t: float, *, seed: Optional[int] = None) -> Workload:
        """The spec's provisioning workload at trace time ``t`` (falls back
        to the static snapshot when no trace is attached)."""
        if self.trace is not None:
            return self.trace.workload_at(t, seed=seed)
        if self.workload is None:
            raise ValueError(
                f"model '{self.name}' carries neither a workload nor a trace")
        return self.workload


def workload_from_samples(inputs: Sequence[int], outputs: Sequence[int],
                          total_rate: float, name: str = "sampled",
                          input_edges=INPUT_EDGES,
                          output_edges=OUTPUT_EDGES) -> Workload:
    buckets = bucket_grid(input_edges, output_edges)
    counts = np.zeros(len(buckets))
    if len(inputs):
        flat = bucket_indices(np.asarray(inputs), np.asarray(outputs),
                              input_edges, output_edges)
        np.add.at(counts, flat, 1.0)
    rates = counts / max(1, len(inputs)) * total_rate
    return Workload(buckets, rates, name=name)


# ---------------------------------------------------------------------------
# Synthetic dataset samplers (App. A.1 stand-ins)
# ---------------------------------------------------------------------------
def _lognormal(rng, median, sigma, size, lo, hi):
    x = rng.lognormal(mean=math.log(median), sigma=sigma, size=size)
    return np.clip(x, lo, hi).astype(int)


def sample_arena(rng: np.random.Generator, n: int):
    """Short-context chat: inputs & outputs < 2000, output-skewed."""
    i = _lognormal(rng, median=90, sigma=1.3, size=n, lo=1, hi=2000)
    o = _lognormal(rng, median=210, sigma=0.9, size=n, lo=1, hi=2000)
    return i, o


def sample_pubmed(rng: np.random.Generator, n: int):
    """Document summarization: long inputs (papers), short outputs."""
    i = _lognormal(rng, median=3200, sigma=0.55, size=n, lo=200, hi=32000)
    o = _lognormal(rng, median=230, sigma=0.45, size=n, lo=30, hi=1200)
    return i, o


def sample_mixed(rng: np.random.Generator, n: int):
    """80% Arena + 20% PubMed (paper's synthetic mixed workload)."""
    n_a = int(round(0.8 * n))
    ia, oa = sample_arena(rng, n_a)
    ip, op = sample_pubmed(rng, n - n_a)
    i = np.concatenate([ia, ip])
    o = np.concatenate([oa, op])
    perm = rng.permutation(n)
    return i[perm], o[perm]


DATASETS = {
    "arena": sample_arena,
    "pubmed": sample_pubmed,
    "mixed": sample_mixed,
}


def make_workload(dataset: str, total_rate: float, *, n_samples: int = 20_000,
                  seed: int = 0) -> Workload:
    rng = np.random.default_rng(seed)
    i, o = DATASETS[dataset](rng, n_samples)
    return workload_from_samples(i, o, total_rate, name=dataset)


def sample_requests(dataset: str, n: int, *, seed: int = 0):
    """(input_len, output_len) pairs for the simulator."""
    rng = np.random.default_rng(seed)
    return DATASETS[dataset](rng, n)
