"""The port's tensor-parallel serving path on 4 gloo ranks on the CPU,
against the JAX package's single-device prefill and decode.

One spawn of 4 ranks a module (``torch.multiprocessing``, a ``FileStore``
under the test's temporary directory: no TCP port, so xdist workers can run
files side by side). The JAX references are computed in the parent and
handed over as numpy; this module imports nothing at its top that imports
JAX (the ranks import it to find ``_rank``). Reduced qwen2-1.5b and
gemma2-27b (4 query / 2 kv heads, d_model 64, gemma2's window 32) run
with weights cut by ``from_jax_params(..., mesh=)`` from shared numpy
weights on three layouts:

  * mesh 1x4, max_seq 128: kv heads 2 do not divide 4, so the cache is
    sharded by sequence (32 rows a rank): prompts of 40, 23, 64 and 95
    tokens put gemma2's window across shard edges, leave shards empty, and
    put new tokens at position 64 and 96, the first row of a shard;
  * mesh 2x2, max_seq 128: the cache by kv heads, the batch over "data";
  * mesh 1x4, max_seq 130: 130 does not divide 4, so the cache is
    replicated and each rank's query head reads its one kv head.

Prefill logits and caches and 3 committed and 3 append-mode decode steps
are held to JAX within 2e-5 in fp32 (tests/test_kernels.py::_tol) of the
reference's magnitude where it exceeds 1 (gemma2's logits reach ~16 here,
where the one-process port already differs from JAX by 2.3e-5: fp32 sums
in another order), the
collectives of every step to ``Transformer.step_collectives``, and greedy
tokens of the engine on mesh 1x4 to the one-process port engine's, equal
on every rank.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.engine import serving_rules
from repro_torch.tree import named, nest

TOL = 2e-5
WORLD = 4
ARCHS = ("qwen2-1.5b", "gemma2-27b")
B, LENS, STEPS = 4, (40, 23, 64, 95), 3
LAYOUTS = (("1x4", 1, 128), ("2x2", 2, 128), ("1x4r", 1, 130))
ECFG = EngineConfig(max_batch=4, max_seq=128)
PROMPTS = (30, 9, 61, 17, 44)         # engine prompt lengths
NEW = 6
# dry-run records on mesh 1x4 (reduced, seq 64): the four-card cells
RECORDS = (("qwen2-1.5b", "decode_32k"), ("qwen2-1.5b", "prefill_32k"),
           ("gemma2-27b", "decode_32k"), ("gemma2-27b", "long_500k"))
# the cell the dry-run CLI records on its own 4 gloo ranks (--cards 4)
CLI_CELL = RECORDS[0]
SRC = Path(__file__).resolve().parents[1] / "src"


def _weights(cfg, seed):
    """Numpy weights for every port parameter (the JAX structure by
    ``nest``): norms near 1, biases non-zero, matrices scaled by fan-in."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in T.Transformer(cfg, device="meta").named_parameters():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in name:
            x = 1.0 + 0.1 * x
        elif leaf in ("bq", "bk", "bv"):
            x = 0.1 * x
        elif leaf in ("embed", "lm_head"):
            x = 0.5 * x
        else:
            fan_in = int(np.prod(p.shape[1:-1])) if leaf == "wo" \
                else p.shape[1]
            x = x / np.sqrt(fan_in)
        out[name] = x
    return nest(out)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, max(LENS)))
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B))
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in PROMPTS]
    return tokens, steps, prompts


def _cache_leaves(cache):
    """{dotted leaf name: leaf} of a cache tree (the port's or JAX's)."""
    return named(cache)


def _rank(rank, store_path, out_dir, weights):
    """One rank: every arch and layout, then the engine; writes its
    results to ``out_dir/rank{rank}.npz`` (and the counts as json)."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (1, 2)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        tokens, steps, prompts = _inputs(cfg, 1)
        for name, data, max_seq in LAYOUTS:
            mesh = meshes[data]
            key = f"{arch}/{name}"
            rules = ST.rules_for(cfg, ShapeCase("t", "decode", max_seq, B),
                                 mesh)
            model = T.from_jax_params(cfg, weights[arch], device="cpu",
                                      mesh=mesh, rules=rules)
            SH.reset_collectives()
            lt, pf = model.prefill(torch.from_numpy(tokens))
            counts[f"{key}/prefill"] = [SH.collectives()["calls"],
                                        model.step_collectives()]
            out[f"{key}/prefill_logits"] = model.gather_logits(lt, B)
            (b0, bl), _ = model.layout.ranges(("batch", "seq"),
                                              tokens.shape)
            tp = model.tp
            for leaf, v in _cache_leaves(pf).items():
                out[f"{key}/prefill_cache/{leaf}"] = v
            out[f"{key}/prefill_cache_rows"] = np.array(
                [b0, bl, tp.kv0, tp.kvl])
            for mode in ("committed", "append"):
                cache = T.init_cache(cfg, B, max_seq, device="cpu",
                                     mesh=mesh, rules=rules)
                for b, n in enumerate(LENS):
                    _, pf1 = model.prefill(torch.from_numpy(tokens[b:b + 1]))
                    T.cache_insert(cfg, cache, pf1, b, n)
                lengths = np.array(LENS)
                for i in range(STEPS):
                    SH.reset_collectives()
                    lg, cache = model.decode_step(
                        cache, torch.from_numpy(steps[i]),
                        torch.from_numpy(lengths), append=mode == "append")
                    counts[f"{key}/{mode}/{i}"] = [
                        SH.collectives()["calls"],
                        model.step_collectives(cache)]
                    out[f"{key}/{mode}/{i}"] = model.gather_logits(lg, B)
                    lengths = lengths + 1
                ranges = cache.layout.ranges(
                    ("layers",) + T.L.CACHE_AXES,
                    (1, B, max_seq, cfg.n_kv_heads, cfg.head_dim))
                out[f"{key}/{mode}/cache_ranges"] = np.array(ranges)
                for leaf, v in _cache_leaves(cache).items():
                    out[f"{key}/{mode}/cache/{leaf}"] = v
        rules = serving_rules(cfg, ECFG, meshes[1])
        model = T.from_jax_params(cfg, weights[arch], device="cpu",
                                  mesh=meshes[1], rules=rules)
        eng = ServingEngine(cfg, model, ECFG, device="cpu", mesh=meshes[1])
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        out[f"{arch}/engine"] = np.array(
            [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    for arch, shape in RECORDS:
        dryrun.run_cell(arch, shape, os.path.join(out_dir, "records"),
                        device="cpu", reduced=True, seq_len=64,
                        mesh=meshes[1])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --cards 4 --mesh 1x4 --device
    cpu`` for CLI_CELL, reduced at seq 64, started before ``runs``' spawn
    so that the two overlap: (its output directory, the process)."""
    out = tmp_path_factory.mktemp("cli")
    arch, shape = CLI_CELL
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cards",
         str(WORLD), "--mesh", f"1x{WORLD}", "--device", "cpu", "--reduced",
         "--seq-len", "64", "--arch", arch, "--shape", shape, "--out",
         str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cli):
    """(the JAX references and the one-process engine's tokens, each
    rank's results)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JT

    j_prefill = jax.jit(JT.prefill, static_argnums=0)
    j_decode = jax.jit(lambda cfg, p, c, t, l, a: JT.decode_step(
        cfg, p, c, t, l, append=a), static_argnums=(0, 5))
    weights, ref = {}, {}
    for seed, arch in enumerate(ARCHS):
        cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        weights[arch] = _weights(cfg, seed)
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, steps, prompts = _inputs(cfg, 1)
        logits, pf = j_prefill(cfg_j, params, jnp.asarray(tokens))
        ref[f"{arch}/prefill_logits"] = np.asarray(logits)
        ref[f"{arch}/prefill_cache"] = {
            k: np.asarray(v) for k, v in _cache_leaves(pf).items()}
        for mode in ("committed", "append"):
            cache, _ = JT.init_cache(cfg_j, B, 128)
            for b, n in enumerate(LENS):
                row = jax.tree.map(lambda x: x[:, b:b + 1], pf)
                cache = JT.cache_insert(cfg_j, cache, row, b, n)
            lengths = np.array(LENS)
            for i in range(STEPS):
                lg, cache = j_decode(cfg_j, params, cache,
                                     jnp.asarray(steps[i]),
                                     jnp.asarray(lengths), mode == "append")
                ref[f"{arch}/{mode}/{i}"] = np.asarray(lg)
                lengths = lengths + 1
            ref[f"{arch}/{mode}/cache"] = {
                k: np.asarray(v) for k, v in _cache_leaves(cache).items()}
        model = T.from_jax_params(cfg, weights[arch], device="cpu")
        eng = ServingEngine(cfg, model, ECFG, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        ref[f"{arch}/engine"] = np.array(
            [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    out_dir = tmp_path_factory.mktemp("ranks")
    torch.multiprocessing.spawn(
        _rank, args=(str(out_dir / "store"), str(out_dir), weights),
        nprocs=WORLD, join=True)
    records = {(r["arch"], r["shape"]): r for r in (
        json.loads(f.read_text())
        for f in sorted((out_dir / "records").glob("*.json")))}
    ranks = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            counts = json.load(f)
        ranks.append((dict(np.load(out_dir / f"rank{r}.npz")), counts))
    return ref, ranks, records


def _close(got, want) -> bool:
    """Within TOL of the reference, scaled by its magnitude above 1."""
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got) - want),
                        initial=0.0)) <= TOL * scale


CASES = [(arch, name) for arch in ARCHS for name, _, _ in LAYOUTS]


@pytest.mark.parametrize("arch,layout", CASES)
def test_prefill_matches_jax(runs, arch, layout):
    """Gathered prefill logits on every rank, and each rank's prefill cache
    (its batch rows, its kv heads) against JAX's prefill."""
    ref, ranks, _ = runs
    key = f"{arch}/{layout}"
    for out, _ in ranks:
        assert _close(out[f"{key}/prefill_logits"],
                      ref[f"{arch}/prefill_logits"])
        b0, bl, k0, kl = out[f"{key}/prefill_cache_rows"]
        for leaf, want in ref[f"{arch}/prefill_cache"].items():
            got = out[f"{key}/prefill_cache/{leaf}"]
            assert _close(got, want[:, b0:b0 + bl, :, k0:k0 + kl]), leaf


@pytest.mark.parametrize("arch,layout", CASES)
@pytest.mark.parametrize("mode", ["committed", "append"])
def test_decode_matches_jax(runs, arch, layout, mode):
    """3 decode steps from the slot cache each prompt was inserted into:
    gathered logits on every rank against JAX's decode_step (max_seq 128;
    the replicated layout's 130 only adds masked rows), and each rank's
    cache shard after them against the same slice of JAX's cache."""
    ref, ranks, _ = runs
    key = f"{arch}/{layout}/{mode}"
    for out, _ in ranks:
        for i in range(STEPS):
            assert _close(out[f"{key}/{i}"], ref[f"{arch}/{mode}/{i}"])
        _, (b0, bl), (s0, sl), (k0, kl), _ = out[f"{key}/cache_ranges"]
        for leaf, want in ref[f"{arch}/{mode}/cache"].items():
            got = out[f"{key}/cache/{leaf}"]
            want = want[:, b0:b0 + bl, s0:min(s0 + sl, 128), k0:k0 + kl]
            assert _close(got[:, :, :want.shape[2]], want), leaf
            assert not np.any(got[:, :, want.shape[2]:]), leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_follow_the_formula(runs, arch):
    """Every prefill and decode step made exactly the collectives of
    ``Transformer.step_collectives``, which has them where the layout
    needs them: the sequence-sharded decode gathers queries and partials,
    the other layouts only all-reduce."""
    _, ranks, _ = runs
    for _, counts in ranks:
        for key, (got, want) in counts.items():
            if key.startswith(arch):
                assert got == want, key
    layers = get_config(arch).reduced().n_layers
    _, counts = ranks[0]
    assert counts[f"{arch}/1x4/append/0"][1] == {
        "all-reduce": 1 + 2 * layers, "all-gather": 2 * layers}
    assert counts[f"{arch}/2x2/append/0"][1] == {
        "all-reduce": 1 + 2 * layers}
    assert counts[f"{arch}/1x4r/committed/0"][1] == {
        "all-reduce": 1 + 2 * layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_on_every_rank(runs, arch):
    """Greedy tokens of the engine on mesh 1x4 equal the one-process port
    engine's on every rank."""
    ref, ranks, _ = runs
    for out, _ in ranks:
        np.testing.assert_array_equal(out[f"{arch}/engine"],
                                      ref[f"{arch}/engine"])


@pytest.mark.parametrize("arch,shape", RECORDS)
def test_mesh_records(runs, arch, shape):
    """``run_cell(..., mesh=)`` on the CPU: one record a cell (rank 0's),
    ok, 4 devices, one card's operations (fewer than the one-card step's,
    at least a quarter of them), the collectives of one step equal to the
    formula, and long_500k's cache by sequence with wk replicated."""
    *_, records = runs
    rec = records[(arch, shape)]
    assert rec["ok"] is True and rec["devices"] == WORLD
    assert rec["mesh"] == "cpu_1x4" and "not_measured" in rec
    assert rec["collectives"]["calls"] == rec["collectives_formula"]
    case = dryrun.get_shape(shape)
    cut = dryrun.dataclasses.replace(case, global_batch=rec["global_batch"],
                                     seq_len=64)
    one = dryrun.count_flops(get_config(arch).reduced(), cut,
                             rec["variant"])
    assert one / WORLD <= rec["flops"] < one
    if shape == "long_500k":
        assert rec["rules"]["kv_seq"] == ["pod", "data", "model"]
        assert "kv_heads" not in rec["rules"]         # replicated


def test_cli_mesh_record_equals_run_cell(runs, cli, tmp_path):
    """The CLI's mesh mode writes one record, under the name and with the
    fields (batch, collectives, operations, bytes, mesh: every field, as
    nothing is timed on the CPU) of the spawn's ``run_cell(mesh=)``."""
    out, proc = cli
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    *_, records = runs
    want = records[CLI_CELL]
    dryrun._write(tmp_path, want)
    assert [f.name for f in out.iterdir()] == \
        [f.name for f in tmp_path.iterdir()]
    got = json.loads(next(out.iterdir()).read_text())
    assert got == want
    assert got["mesh"] == f"cpu_1x{WORLD}" and got["devices"] == WORLD
    arch, shape = CLI_CELL
    assert stdout.startswith(f"[OK] {arch} x {shape} on cpu_1x{WORLD}: ")
    assert len(stdout.splitlines()) == 1          # rank 0 prints
