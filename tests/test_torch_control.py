"""The port's control plane (repro_torch.core: the allocator, the ILP
solver with its dominance pre-pass, the load matrix and the simulator)
against the JAX package's originals in repro.core on the same inputs, and
the two example twins (examples/serve_heterogeneous_torch.py,
examples/train_small_torch.py) run in subprocesses on the CPU.

``solve`` is any-time: a search cut by its wall-clock budget may return
another assignment from run to run. So the allocation cases are ones that
both packages solve to optimality, asserted; the JAX example's own input
(llama2-7b, arena at 4 req/s) stops at the solver's stall cutoff in both,
a pure node counter, so its comparison asserts that neither solve hit its
clock.
"""
import dataclasses
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
SERVE_TWIN = ROOT / "examples" / "serve_heterogeneous_torch.py"
TRAIN_TWIN = ROOT / "examples" / "train_small_torch.py"
SLO = 0.12
# a coarser grid (the one tests/test_spot_tiers.py-sized problems use):
# small problems the branch-and-bound finishes
IN_EDGES = (1, 128, 512, 2048, 8192)
OUT_EDGES = (1, 64, 256, 1024, 4096)
QWEN2 = "qwen2-1.5b"
# (model, grid, Melange options, dataset, rate, allocate options)
CASES = {
    "qwen2-arena-32": (QWEN2, "full", {}, "arena", 32.0, {}),
    "qwen2-pubmed-4": (QWEN2, "full", {}, "pubmed", 4.0, {}),
    "qwen2-mixed-16": (QWEN2, "full", {}, "mixed", 16.0, {}),
    "llama-arena-16": ("llama2-7b", "small", {}, "arena", 16.0, {}),
    "llama-pubmed-16": ("llama2-7b", "small", {}, "pubmed", 16.0, {}),
    "qwen2-mixed-4": (QWEN2, "small", {}, "mixed", 4.0, {}),
    "tp-degrees": (QWEN2, "small", {"tp_degrees": (1, 2)}, "pubmed", 4.0,
                   {}),
    "spot-tiers": ("llama2-7b", "small", {"spot_tiers": True}, "pubmed",
                   4.0, {"min_ondemand_frac": 0.5,
                         "replacement_delay_s": 600.0}),
}


def _perf(lib, model):
    if model == "llama2-7b":
        return lib.ModelPerf.llama2_7b()
    return lib.ModelPerf(**dataclasses.asdict(
        P.ModelPerf.from_config(get_config(model))))


def _workload(lib, grid, dataset, rate):
    if grid == "full":
        return lib.make_workload(dataset, rate)
    i, o = lib.workload.DATASETS[dataset](np.random.default_rng(0), 2000)
    return lib.workload_from_samples(i, o, rate, name=dataset,
                                     input_edges=IN_EDGES,
                                     output_edges=OUT_EDGES)


def _allocate(lib, model, grid, opts, dataset, rate, alloc_opts,
              time_budget_s=5.0):
    buckets = None if grid == "full" else lib.bucket_grid(IN_EDGES,
                                                          OUT_EDGES)
    mel = lib.Melange(lib.PAPER_GPUS, _perf(lib, model), SLO,
                      buckets=buckets, **opts)
    return mel, mel.allocate(_workload(lib, grid, dataset, rate),
                             over_provision=0.1, time_budget_s=time_budget_s,
                             **alloc_opts)


def _same_allocation(a, b):
    assert a.counts == b.counts
    assert a.cost_per_hour == b.cost_per_hour
    assert a.solution.optimal == b.solution.optimal
    assert np.array_equal(a.solution.assignment, b.solution.assignment)
    assert a.solution_gpu_names == b.solution_gpu_names


@pytest.mark.parametrize("case", sorted(CASES))
def test_allocation_equal(case):
    (_, j), (_, p) = (_allocate(lib, *CASES[case]) for lib in (J, P))
    assert j.solution.optimal and p.solution.optimal
    _same_allocation(p, j)


def test_example_allocation_equal():
    """The JAX example's input: equal allocations; both stop at the stall
    cutoff (a node counter, so the same in both), neither at the clock."""
    runs = [_allocate(lib, "llama2-7b", "full", {}, "arena", 4.0, {},
                      time_budget_s=1.5)[1] for lib in (J, P)]
    for a in runs:
        assert a.solution.stats.stalled and not a.solution.stats.deadline_hit
    _same_allocation(runs[1], runs[0])
    assert runs[1].counts == {"A100": 1}


def _small_problem(lib, rng):
    """A random small ILPProblem (tests/test_ilp.py's recipe)."""
    N, M = int(rng.integers(3, 9)), int(rng.integers(2, 4))
    loads = rng.uniform(0.05, 0.9, size=(N, M))
    loads = np.where(rng.random((N, M)) < 0.15, np.inf, loads)
    loads[:, 0] = np.where(np.isfinite(loads[:, 0]), loads[:, 0], 0.5)
    costs = rng.uniform(0.5, 8.0, size=M)
    buckets = np.sort(rng.integers(0, 3, size=N))
    caps = (rng.integers(2, 6, size=M).astype(float)
            if rng.random() < 0.5 else None)
    return lib.ILPProblem(loads, costs, [f"g{j}" for j in range(M)],
                          buckets, caps)


@pytest.mark.parametrize("seed", range(4))
def test_solvers_equal_on_small_problems(seed):
    """``solve`` (optimal, asserted) and ``solve_brute_force`` of the port
    against the originals on the same random problems."""
    for k in range(6):
        pj, pp = (_small_problem(lib, np.random.default_rng((seed, k)))
                  for lib in (J, P))
        for fn in ("solve_brute_force", "solve"):
            kw = {"time_budget_s": 10.0} if fn == "solve" else {}
            sj, sp = getattr(J, fn)(pj, **kw), getattr(P, fn)(pp, **kw)
            assert (sj is None) == (sp is None)
            if sj is None:
                continue
            assert sj.optimal and sp.optimal
            assert np.array_equal(sp.assignment, sj.assignment)
            assert np.array_equal(sp.counts, sj.counts)
            assert sp.cost == sj.cost


@pytest.mark.parametrize("case", ["example", "qwen2-arena-32"])
def test_simulate_equal(case):
    """``simulate`` of an allocation, 300 requests: every field of the
    SimResult and of each request equal."""
    args = (("llama2-7b", "full", {}, "arena", 4.0, {}) if case == "example"
            else CASES[case])
    model, _, _, dataset, rate, _ = args
    out = []
    for lib in (J, P):
        mel, alloc = _allocate(lib, *args, time_budget_s=1.5)
        assert not alloc.solution.stats.deadline_hit
        out.append(lib.simulate(alloc.counts, mel.profile, mel.model,
                                dataset, rate=rate, n_requests=300, seed=3))
    j, p = out
    assert len(p.requests) == len(j.requests) == 300
    assert [dataclasses.astuple(r) for r in p.requests] == \
        [dataclasses.astuple(r) for r in j.requests]
    for f in ("duration_s", "cost", "slo_tpot_s", "n_dropped",
              "slo_attainment"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.tpot_percentiles() == j.tpot_percentiles()
    assert 0.0 < p.slo_attainment <= 1.0


# -- the example twins ----------------------------------------------------------

# runs a script as __main__ with the arguments after it, then lists the
# jax / repro modules it loaded
WRAP = ("import json, runpy, sys\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "print('loaded: ' + json.dumps(sorted(n for n in sys.modules if "
        "n.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")


def _run_twin(path, *args):
    proc = subprocess.run(
        [sys.executable, "-c", WRAP, str(path), *args], capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "loaded: []"
    return lines[:-1]


def test_serving_twin_on_cpu():
    """The serving twin with small arguments: its [alloc] and [slo] lines
    equal the ones repro.core gives for the same arguments, every request
    completes or is rejected, and no jax or repro module was loaded."""
    n_req, n_sim, rate = 8, 200, 4.0
    lines = _run_twin(SERVE_TWIN, "--device", "cpu", "--requests",
                      str(n_req), "--sim-requests", str(n_sim))
    model = J.ModelPerf.llama2_7b()
    mel = J.Melange(J.PAPER_GPUS, model, SLO)
    alloc = mel.allocate(J.make_workload("arena", rate), over_provision=0.1,
                         time_budget_s=1.5)
    res = J.simulate(alloc.counts, mel.profile, model, "arena", rate=rate,
                     n_requests=n_sim, seed=3)
    pct = res.tpot_percentiles((50, 90, 99, 99.5))
    assert lines[0] == f"[alloc] {alloc.counts} -> " \
        f"${alloc.cost_per_hour:.2f}/h"
    assert lines[3] == (
        f"[slo]   attainment={res.slo_attainment*100:.2f}% "
        f"(TPOT p50={pct[50]*1e3:.1f}ms p99={pct[99]*1e3:.1f}ms "
        f"p99.5={pct[99.5]*1e3:.1f}ms; SLO=120ms) "
        f"cost=${res.cost:.2f} for {res.duration_s:.0f}s")
    fields = dict(kv.split("=") for kv in lines[1].split()[1:4])
    assert int(fields["completed"]) + int(fields["rejected"]) == n_req
    assert lines[2].startswith("[serve] per-instance request counts: ")


def test_training_twin_on_cpu(tmp_path):
    """The training twin, 4 steps of the reduced internlm2-1.8b: the two
    lines, finite losses, nothing of jax or repro loaded."""
    lines = _run_twin(TRAIN_TWIN, "--device", "cpu", "--steps", "4",
                      "--ckpt-dir", str(tmp_path / "ckpt"))
    assert lines[0].startswith("training internlm2-1.8b-reduced: ")
    assert lines[0].endswith("M params, 4 steps")
    first, _, last = lines[1].split(" (")[0].split()[1:]
    assert np.isfinite(float(first)) and np.isfinite(float(last))
    assert lines[1].endswith("(resumed_from=None)")


@pytest.mark.parametrize("path,argv", [
    (SERVE_TWIN, ["--requests", "1"]), (TRAIN_TWIN, ["--steps", "1"])])
def test_twins_raise_without_cuda(monkeypatch, path, argv):
    """Without ``--device cpu`` a twin asks for CUDA and raises where it is
    missing, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(str(path))["main"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_serving_twin_refuses_vision(capsys):
    """The engine's own refusal of a vision config reaches the twin."""
    main = runpy.run_path(str(SERVE_TWIN))["main"]
    with pytest.raises(NotImplementedError, match="vision"):
        main(["--device", "cpu", "--arch", "llama-3.2-vision-11b",
              "--requests", "1", "--sim-requests", "10"])
    assert capsys.readouterr().out.startswith("[alloc] ")


def test_core_exports_match():
    """repro_torch.core exports every name of repro.core but the
    autoscaler's, each the port's own object."""
    autoscaler = {"AllocationDiff", "Autoscaler", "FleetAutoscaler",
                  "allocation_diff"}
    names = {n for n in vars(J) if not n.startswith("_")
             and not isinstance(getattr(J, n), type(J))}
    ported = {n for n in vars(P) if not n.startswith("_")
              and not isinstance(getattr(P, n), type(P))}
    assert ported == names - autoscaler
    for n in ported:
        mod = getattr(getattr(P, n), "__module__", None)
        assert mod is None or mod.startswith("repro_torch."), n
