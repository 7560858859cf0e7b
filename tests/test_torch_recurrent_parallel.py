"""The port's Mamba and RWKV-6 layers on 4 gloo ranks on the CPU (the
"d_inner" and "rwkv_heads" sharding of ``repro_torch.models.ssm`` on a
("data", "model") mesh), against the JAX package on one CPU device.

One spawn of 4 ranks for the module (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory: no TCP port), handed
the shared numpy weights; the JAX references are jitted in the parent while
the ranks run and handed over as numpy. This module imports nothing at its
top that imports JAX (the ranks import it to find ``_rank``). JAX's RWKV
paths are traced with its sequential scan oracles (``ops`` impl "naive"):
its CPU default for WKV6 clips its exponents (ROADMAP C-ref-5).

Reduced rwkv6-1.6b (2 layers, 4 heads of 16, AdamW) and reduced Jamba's
first 4 layers (Mamba + dense, Mamba + MoE, Mamba + dense, attention +
MoE; d_inner 128, Adafactor), weights cut by ``from_jax_params(...,
mesh=)``:

  * prefill logits and 3 committed and 3 append-mode decode steps on mesh
    1x4 and 2x2, from slot caches filled by ``cache_insert`` of one-row
    prefills at each prompt's exact length; the collectives of every step
    equal to ``Transformer.step_collectives``;
  * under ``seqpar`` (the residual stream's sequence over "model"): the
    batch's prefill at 24 tokens and one-row prefills at 24 (the sequence
    cut) and 17 (not cut), and 3 committed decode steps from their states,
    on 1x4 and 2x2;
  * every leaf's gradient of one whole-batch ``value_and_grad`` and two
    train steps (n_micro 4, from count 99) on meshes 2x2, 4x1 and 1x4 (and
    rwkv6's under ``fsdp`` on 2x2), and under ``seqpar`` on 2x2 and 1x4
    (rwkv6's under ``fsdp+seqpar`` on 2x2): the metrics, every parameter
    and the optimizer state (AdamW's moments, Adafactor's factors with
    ``vc`` of the paired ``in_proj``) gathered whole; the collectives of
    each step equal to ``steps.train_step_collectives``;
  * the engine on 1x4 (and rwkv6's on 2x2): greedy tokens equal to the
    one-process port engine's on every rank;
  * reduced dry-run records (rwkv6 decode_32k and long_500k on 1x4,
    train_4k on 2x2; Jamba decode_32k on 1x4) at seq 64;
  * Jamba's ``to_jax_params`` on 1x4 equal to the weights it was cut from
    (``in_proj`` is cut piece by piece), and a checkpoint written on 1x4
    after a step, restored on 2x2 and in the parent on one process, bit
    for bit.

Tolerance: fp32's 2e-5 (tests/test_kernels.py::_tol) of the reference's
magnitude where it exceeds 1.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.engine import serving_rules
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named
from test_torch_distributed import _weights

WORLD = 4
TOL = 2e-5
ARCHS = ("rwkv6-1.6b", "jamba-1.5-large-398b")
B, LENS, MAX_SEQ, STEPS = 4, (24, 17, 24, 17), 64, 3
SERVE = (("1x4", 1), ("2x2", 2))
TB, TS, COUNT, N_MICRO, TSTEPS = 8, 32, 99, 4, 2
TRAIN = (("2x2", 2, "baseline"), ("4x1", 4, "baseline"),
         ("1x4", 1, "baseline"), ("2x2", 2, "fsdp"),
         ("2x2", 2, "seqpar"), ("1x4", 1, "seqpar"),
         ("2x2", 2, "fsdp+seqpar"))
METRICS = ("loss", "grad_norm", "lr", "ce", "z", "lb_loss", "z_loss")
ECFG = EngineConfig(max_batch=4, max_seq=64)
PROMPTS = (30, 9, 21, 17, 12)
NEW = 4
ENGINES = (("rwkv6-1.6b", "1x4", 1), ("rwkv6-1.6b", "2x2", 2),
           ("jamba-1.5-large-398b", "1x4", 1))
RECORDS = (("rwkv6-1.6b", "decode_32k", 1), ("rwkv6-1.6b", "long_500k", 1),
           ("rwkv6-1.6b", "train_4k", 2),
           ("jamba-1.5-large-398b", "decode_32k", 1))
CKPT = "jamba-1.5-large-398b"


def _cfg(arch):
    """Reduced ``arch``; Jamba cut to the first 4 layers of its period and
    a capacity factor no token overflows (tests/test_torch_model.py)."""
    cfg = get_config(arch).reduced()
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, groups=((cfg.groups[0][0][:4], 1),),
                                  capacity_factor=16.0)
    return cfg


def _train_cases(arch):
    return [(m, d, v) for m, d, v in TRAIN
            if "fsdp" not in v or arch.startswith("rwkv")]


def _inputs(cfg, seed=1):
    """Prompt tokens (B, max(LENS)), decode tokens (STEPS, B), two train
    batches of TB x TS, the engine's prompts."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, max(LENS)))
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B))
    batches = []
    for _ in range(TSTEPS):
        x = rng.integers(0, cfg.vocab_size, size=(TB, TS + 1))
        batches.append({"tokens": x[:, :-1].astype(np.int32),
                        "labels": x[:, 1:].astype(np.int32)})
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in PROMPTS]
    return tokens, steps, batches, prompts


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _spec(specs, name):
    node = specs
    for p in name.split("."):
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def _build(cfg, variant, weights, mesh):
    """(model, opt state at count 99, train step, param specs, opt specs)
    of the train cell on ``mesh`` (None: one process)."""
    case = ShapeCase("t", "train", TS, TB)
    out = ST.build_cell(cfg, case, "cpu", variant, mesh=mesh)
    rules = out[3] if mesh is not None else None
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    st = ST.init_opt_state(model)
    st["count"] = torch.tensor(COUNT, dtype=torch.int32)
    if mesh is None:
        return model, st, out[0], None, None
    return model, st, out[0], out[4]["params"], out[4]["opt_state"]


def _serve(cfg, weights, mesh, tokens, steps, out, counts, key):
    """Prefill and decode on ``mesh``: gathered logits into ``out``, each
    step's collectives and formula into ``counts``."""
    rules = ST.rules_for(cfg, ShapeCase("t", "decode", MAX_SEQ, B), mesh)
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    SH.reset_collectives()
    lt, _ = model.prefill(torch.from_numpy(tokens))
    counts[f"{key}/prefill"] = [SH.collectives()["calls"],
                                model.step_collectives(
                                    batch=B, seq=tokens.shape[1])]
    out[f"{key}/prefill"] = model.gather_logits(lt, B)
    rows = [model.prefill(torch.from_numpy(tokens[b:b + 1, :n]))[1]
            for b, n in enumerate(LENS)]
    for mode in ("committed", "append"):
        cache = T.init_cache(cfg, B, MAX_SEQ, device="cpu", mesh=mesh,
                             rules=rules)
        for b, n in enumerate(LENS):
            T.cache_insert(cfg, cache, rows[b], b, n)
        lengths = np.array(LENS)
        for i in range(STEPS):
            SH.reset_collectives()
            lg, cache = model.decode_step(
                cache, torch.from_numpy(steps[i]), torch.from_numpy(lengths),
                append=mode == "append")
            counts[f"{key}/{mode}/{i}"] = [SH.collectives()["calls"],
                                           model.step_collectives(cache)]
            out[f"{key}/{mode}/{i}"] = model.gather_logits(lg, B)
            lengths = lengths + 1


def _serve_sp(cfg, weights, mesh, tokens, steps, out, counts, key):
    """Under ``seqpar``: the batch's prefill at 24 tokens and the one-row
    prefills at each prompt's exact length (24 cuts the sequence on both
    meshes, 17 on none), then 3 committed decode steps from slot caches
    filled from the one-row prefills: gathered logits into ``out``, each
    step's collectives and formula into ``counts``."""
    rules = ST.rules_for(cfg, ShapeCase("t", "decode", MAX_SEQ, B), mesh,
                         "seqpar")
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    SH.reset_collectives()
    lt, _ = model.prefill(torch.from_numpy(tokens))
    counts[f"{key}/prefill"] = [SH.collectives()["calls"],
                                model.step_collectives(
                                    batch=B, seq=tokens.shape[1])]
    out[f"{key}/prefill"] = model.gather_logits(lt, B)
    rows = []
    for b, n in enumerate(LENS):
        SH.reset_collectives()
        lr, row = model.prefill(torch.from_numpy(tokens[b:b + 1, :n]))
        counts[f"{key}/row{b}"] = [SH.collectives()["calls"],
                                   model.step_collectives(batch=1, seq=n),
                                   model.seq_plan(1, n).sp is not None]
        out[f"{key}/row{b}"] = model.gather_logits(lr, 1)
        rows.append(row)
    cache = T.init_cache(cfg, B, MAX_SEQ, device="cpu", mesh=mesh,
                         rules=rules)
    for b, n in enumerate(LENS):
        T.cache_insert(cfg, cache, rows[b], b, n)
    lengths = np.array(LENS)
    for i in range(STEPS):
        SH.reset_collectives()
        lg, cache = model.decode_step(cache, torch.from_numpy(steps[i]),
                                      torch.from_numpy(lengths))
        counts[f"{key}/committed/{i}"] = [SH.collectives()["calls"],
                                          model.step_collectives(cache)]
        out[f"{key}/committed/{i}"] = model.gather_logits(lg, B)
        lengths = lengths + 1


def _train(cfg, weights, rank, mesh, variant, batches, out, counts, key):
    """One whole-batch gradient, then two train steps on ``mesh``; the
    gradients, metrics, parameters and state gathered whole on rank 0."""
    model, st, fn, p_specs, o_specs = _build(cfg, variant, weights, mesh)
    _, metrics, grads = ST.value_and_grad(model.cfg, model,
                                          _t(batches[0]), n_micro=1)
    out[f"{key}/vg"] = np.array([float(metrics[k]) for k in
                                 ("ce", "z", "lb_loss", "z_loss")])
    for n, g in grads.items():
        whole = SH.gather_whole(g, model.layout, _spec(p_specs, n))
        if rank == 0:
            out[f"{key}/g/{n}"] = whole.numpy().copy()
    del grads
    for i, batch in enumerate(batches):
        SH.reset_collectives()
        st, m = fn(model, st, _t(batch))
        out[f"{key}/metrics{i}"] = np.array([float(m[k]) for k in METRICS])
        counts[f"{key}/{i}"] = [SH.collectives()["calls"],
                                ST.train_step_collectives(model, TB, N_MICRO,
                                                          TS)]
    params = T.to_jax_params(model)
    tree = OPT.state_to_tree(st, model.cfg.optimizer, specs=o_specs,
                             layout=model.layout)
    if rank != 0:
        return
    for n, p in named(params).items():
        out[f"{key}/p/{n}"] = p
    for n, t in named({k: v for k, v in tree.items()
                       if k != "count"}).items():
        out[f"{key}/s/{n}"] = t.numpy()
    out[f"{key}/count"] = np.array(int(tree["count"]))


def _state_tree(model, st):
    return {"params": T.param_tree(model),
            "opt": OPT.state_to_tree(st, model.cfg.optimizer)}


def _spec_tree(p_specs, o_specs, kind):
    return {"params": p_specs, "opt": OPT.state_to_tree(o_specs, kind)}


def _whole(model, st, o_specs, rank, out, key):
    """The model's parameters and state gathered whole into ``out`` on
    rank 0."""
    params = T.to_jax_params(model)
    tree = OPT.state_to_tree(st, model.cfg.optimizer, specs=o_specs,
                             layout=model.layout)
    if rank != 0:
        return
    for n, p in named(params).items():
        out[f"{key}/p/{n}"] = p.copy()
    for n, t in named({k: v for k, v in tree.items()
                       if k != "count"}).items():
        out[f"{key}/s/{n}"] = t.numpy().copy()


def _checkpoint(rank, out, out_dir, meshes, weights, batches):
    """Jamba on mesh 1x4: ``to_jax_params`` right after the cut, one step,
    a save; restored on mesh 2x2, gathered whole again."""
    cfg = _cfg(CKPT)
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"), async_save=False)
    model, st, fn, p_specs, o_specs = _build(cfg, "baseline", weights,
                                             meshes[1])
    params = T.to_jax_params(model)
    if rank == 0:
        for n, p in named(params).items():
            out[f"ckpt/cut/{n}"] = p.copy()
    st, _ = fn(model, st, _t(batches[0]))
    ckpt.save(1, _state_tree(model, st),
              shardings=_spec_tree(p_specs, o_specs, cfg.optimizer),
              mesh=meshes[1])
    _whole(model, st, o_specs, rank, out, "ckpt/1x4")
    model, st, fn, p_specs, o_specs = _build(cfg, "baseline", weights,
                                             meshes[2])
    restored = ckpt.restore(
        1, _state_tree(model, st),
        shardings=_spec_tree(p_specs, o_specs, cfg.optimizer),
        mesh=meshes[2])
    for n, p in model.named_parameters():
        p.data.copy_(named(restored["params"])[n])
    st = OPT.state_from_tree(restored["opt"], cfg.optimizer)
    _whole(model, st, o_specs, rank, out, "ckpt/2x2")


def _rank(rank, store_path, out_dir, weights):
    """One rank: serving and training of both configs, the engines, the
    records and the checkpoint; writes ``rank{rank}.npz`` and its
    counts."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (4, 2, 1)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tokens, steps, batches, _ = _inputs(cfg)
        for mname, d in SERVE:
            _serve(cfg, weights[arch], meshes[d], tokens, steps, out,
                   counts, f"serve/{arch}/{mname}")
            _serve_sp(cfg, weights[arch], meshes[d], tokens, steps, out,
                      counts, f"sp/{arch}/{mname}")
        for mname, d, variant in _train_cases(arch):
            _train(cfg, weights[arch], rank, meshes[d], variant, batches,
                   out, counts, f"{arch}/{mname}/{variant}")
    for arch, mname, d in ENGINES:
        cfg = _cfg(arch)
        rules = serving_rules(cfg, ECFG, meshes[d])
        model = T.from_jax_params(cfg, weights[arch], device="cpu",
                                  mesh=meshes[d], rules=rules)
        eng = ServingEngine(cfg, model, ECFG, device="cpu", mesh=meshes[d])
        for i, p in enumerate(_inputs(cfg)[3]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        out[f"engine/{arch}/{mname}"] = np.array(
            [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    for arch, shape, d in RECORDS:
        dryrun.run_cell(arch, shape, os.path.join(out_dir, "records"),
                        device="cpu", reduced=True, seq_len=64,
                        mesh=meshes[d])
    _checkpoint(rank, out, out_dir, meshes, weights[CKPT],
                _inputs(_cfg(CKPT))[2])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


def _naive(jops, fn):
    """``fn`` traced (and run) with JAX's sequential scan oracles."""
    @functools.wraps(fn)
    def inner(*a, **kw):
        prev = jops._DEFAULT_IMPL
        jops.set_default_impl("naive")
        try:
            return fn(*a, **kw)
        finally:
            jops.set_default_impl(prev)
    return inner


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX and one-process references, each rank's results and
    counts, the records, the weights, the ranks' directory)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.kernels import ops as jops
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.training import optimizer as JOPT

    weights = {arch: _weights(_cfg(arch), seed)
               for seed, arch in enumerate(ARCHS)}
    out_dir = tmp_path_factory.mktemp("ranks")
    ranks_run = torch.multiprocessing.spawn(
        _rank, args=(str(out_dir / "store"), str(out_dir), weights),
        nprocs=WORLD, join=False)
    j_prefill = jax.jit(_naive(jops, JT.prefill), static_argnums=0)
    j_decode = jax.jit(lambda cfg, p, c, t, l, a: JT.decode_step(
        cfg, p, c, t, l, append=a), static_argnums=(0, 5))
    ref = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        cfg_j = jax_get_config(arch).reduced()
        cfg_j = dataclasses.replace(cfg_j, groups=cfg.groups,
                                    capacity_factor=cfg.capacity_factor)
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, steps, batches, _ = _inputs(cfg)
        logits, _ = j_prefill(cfg_j, params, jnp.asarray(tokens))
        ref[f"{arch}/prefill"] = np.asarray(logits)
        rows = []
        for b, n in enumerate(LENS):
            lr, row = j_prefill(cfg_j, params,
                                jnp.asarray(tokens[b:b + 1, :n]))
            ref[f"{arch}/row{b}"] = np.asarray(lr)
            rows.append(row)
        for mode in ("committed", "append"):
            cache, _ = JT.init_cache(cfg_j, B, MAX_SEQ)
            for b, n in enumerate(LENS):
                cache = JT.cache_insert(cfg_j, cache, rows[b], b, n)
            lengths = np.array(LENS)
            for i in range(STEPS):
                lg, cache = j_decode(cfg_j, params, cache,
                                     jnp.asarray(steps[i]),
                                     jnp.asarray(lengths), mode == "append")
                ref[f"{arch}/{mode}/{i}"] = np.asarray(lg)
                lengths = lengths + 1
        (_, m), g = jax.jit(_naive(jops, jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True)))(
            params, jax.tree.map(jnp.asarray, batches[0]))
        ref[(arch, "vg")] = np.array(
            [float(m[k]) for k in ("ce", "z", "lb_loss", "z_loss")])
        ref[(arch, "g")] = named(jax.tree.map(np.asarray, g))
        p = params
        st = JOPT.init(p, cfg_j.optimizer)
        st["count"] = jnp.int32(COUNT)
        step = jax.jit(_naive(jops, JS.build_train_step(cfg_j,
                                                        n_micro=N_MICRO)))
        for i, batch in enumerate(batches):
            p, st, m = step(p, st, jax.tree.map(jnp.asarray, batch))
            ref[(arch, i)] = np.array([float(m[k]) for k in METRICS])
        ref[(arch, "p")] = named(jax.tree.map(np.asarray, p))
        ref[(arch, "s")] = named(jax.tree.map(
            np.asarray, {k: st[k] for k in ("fac", "m", "v") if k in st}))
        ref[(arch, "count")] = int(st["count"])
    for arch, mname, _ in ENGINES:
        if (arch, "engine") in ref:
            continue
        cfg = _cfg(arch)
        model = T.from_jax_params(cfg, weights[arch], device="cpu")
        eng = ServingEngine(cfg, model, ECFG, device="cpu")
        for i, p in enumerate(_inputs(cfg)[3]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        ref[(arch, "engine")] = np.array(
            [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    while not ranks_run.join():
        pass
    records = {(r["arch"], r["shape"]): r for r in (
        json.loads(f.read_text())
        for f in sorted((out_dir / "records").glob("*.json")))}
    ranks = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            counts = json.load(f)
        ranks.append((dict(np.load(out_dir / f"rank{r}.npz")), counts))
    return ref, ranks, records, weights, out_dir


def _close(got, want, tol=TOL) -> bool:
    """Within ``tol`` of the reference, scaled by its magnitude above 1."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - want),
                        initial=0.0)) <= tol * scale


SERVE_CASES = [(a, m) for a in ARCHS for m, _ in SERVE]


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_prefill_matches_jax(runs, arch, mesh):
    """Gathered prefill logits on every rank against JAX's prefill."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        assert _close(out[f"serve/{arch}/{mesh}/prefill"],
                      ref[f"{arch}/prefill"])


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
@pytest.mark.parametrize("mode", ["committed", "append"])
def test_decode_matches_jax(runs, arch, mesh, mode):
    """3 decode steps from slot caches filled by one-row prefills at each
    prompt's exact length (the recurrent states of the card's channels or
    heads): gathered logits on every rank against JAX's decode_step."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        for i in range(STEPS):
            assert _close(out[f"serve/{arch}/{mesh}/{mode}/{i}"],
                          ref[f"{arch}/{mode}/{i}"]), i


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_collectives_follow_the_formula(runs, arch):
    """Every prefill and decode step made exactly the collectives of
    ``Transformer.step_collectives``: per Mamba layer two all-reduces,
    per RWKV layer one all-reduce, a reduce-scatter and an all-gather."""
    _, ranks, *_ = runs
    for _, counts in ranks:
        keys = [k for k in counts if k.startswith(f"serve/{arch}/")]
        assert len(keys) == len(SERVE) * (1 + 2 * STEPS)
        for key in keys:
            got, want = counts[key]
            assert got == want, key
    cfg = _cfg(arch)
    got = ranks[0][1][f"serve/{arch}/1x4/committed/0"][0]
    kinds = [s.kind for s in cfg.layer_specs()]
    if arch.startswith("rwkv"):
        assert got["reduce-scatter"] == kinds.count("rwkv")
    else:
        assert got["all-reduce"] >= 2 * kinds.count("mamba")


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_seqpar_prefill_and_decode_match_jax(runs, arch, mesh):
    """Under ``seqpar``: the batch's prefill at 24 tokens and the one-row
    prefills at 24 (the sequence cut) and 17 (not cut) against JAX's
    prefills, and 3 committed decode steps from the one-row prefills'
    states (the scans and shifts ran over the gathered sequence, so the
    states are the baseline's) against JAX's decode_step: gathered logits
    on every rank; every step's collectives the formula's, the cut
    prefill's without an all-reduce but Mamba's ``x_proj``."""
    ref, ranks, *_ = runs
    key = f"sp/{arch}/{mesh}"
    n_mamba = [s.kind for s in _cfg(arch).layer_specs()].count("mamba")
    for out, counts in ranks:
        assert _close(out[f"{key}/prefill"], ref[f"{arch}/prefill"])
        for b in range(B):
            assert _close(out[f"{key}/row{b}"], ref[f"{arch}/row{b}"]), b
        for i in range(STEPS):
            assert _close(out[f"{key}/committed/{i}"],
                          ref[f"{arch}/committed/{i}"]), i
        keys = [k for k in counts if k.startswith(f"{key}/")]
        assert len(keys) == 1 + B + STEPS
        for k in keys:
            got, want, *_ = counts[k]
            assert got == want, k
        assert [counts[f"{key}/row{b}"][2] for b in range(B)] == [
            n % 2 == 0 for n in LENS]
        got = counts[f"{key}/prefill"][0]
        assert got.get("all-reduce", 0) == n_mamba
        assert got["reduce-scatter"] > 0


TRAIN_CASES = [(a, m, v) for a in ARCHS for m, _, v in _train_cases(a)]


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_gradients_match_jax(runs, arch, mesh, variant):
    """Every leaf's gradient of the whole batch's loss on the mesh (the
    sharded in_proj, x_proj, dt, A and the scans' inputs; RWKV's replicated
    ddlerp, decay and group-norm leaves summed over "model"), reduced and
    gathered, against ``jax.value_and_grad`` of JAX's ``loss_fn``; the loss
    terms on every rank."""
    ref, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for out, _ in ranks:
        assert _close(out[f"{key}/vg"], ref[(arch, "vg")])
    out = ranks[0][0]
    want = ref[(arch, "g")]
    assert {k.split("/g/", 1)[1] for k in out
            if k.startswith(f"{key}/g/")} == set(want)
    for name, g in want.items():
        assert _close(out[f"{key}/g/{name}"], g), name
        assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_step_matches_jax(runs, arch, mesh, variant):
    """Two sharded steps against JAX's ``build_train_step`` (n_micro 4,
    from count 99): every metric of each step on every rank (equal on
    all), then every parameter and the optimizer state (rwkv6's AdamW
    moments, Jamba's Adafactor vr / vc / v, ``in_proj``'s vc included)
    gathered whole."""
    ref, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for i in range(TSTEPS):
        got = [out[f"{key}/metrics{i}"] for out, _ in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), i
        for j, name in enumerate(METRICS):
            assert _close(got[0][j], ref[(arch, i)][j]), (i, name)
    out = ranks[0][0]
    assert int(out[f"{key}/count"]) == ref[(arch, "count")] == \
        COUNT + TSTEPS
    for part in ("p", "s"):
        want = ref[(arch, part)]
        assert {k.split(f"/{part}/", 1)[1] for k in out
                if k.startswith(f"{key}/{part}/")} == set(want)
        for name, w in want.items():
            assert _close(out[f"{key}/{part}/{name}"], w), (part, name)
    if arch.startswith("jamba"):
        assert any("in_proj" in n and n.endswith("vc")
                   for n in ref[(arch, "s")])


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_collectives_follow_the_formula(runs, arch, mesh, variant):
    """Every step on every rank made exactly the collectives of
    ``steps.train_step_collectives``: the recurrent layers' forward,
    backward and remat recompute, the optimizer's."""
    _, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for _, counts in ranks:
        for i in range(TSTEPS):
            got, want = counts[f"{key}/{i}"]
            assert got == want, (key, i)


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, m, _ in ENGINES])
def test_engine_tokens_equal_one_process(runs, arch, mesh):
    """Greedy tokens of the engine on the mesh (exact-length prefills, the
    states inserted on the card that holds the slot) equal the one-process
    port engine's on every rank."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        np.testing.assert_array_equal(out[f"engine/{arch}/{mesh}"],
                                      ref[(arch, "engine")])


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in RECORDS])
def test_mesh_records(runs, arch, shape):
    """``run_cell(..., mesh=)`` on the CPU, reduced at seq 64: ok, 4
    devices, collectives of one step equal to the formula; the train
    record's losses finite."""
    _, _, records, *_ = runs
    rec = records[(arch, shape)]
    assert rec["ok"] is True and rec["devices"] == WORLD
    assert rec["collectives"]["calls"] == rec["collectives_formula"]
    assert rec["flops"] > 0
    if shape == "train_4k":
        assert rec["mesh"] == "cpu_2x2"
        assert np.isfinite(rec["losses"]).all()
    if shape == "long_500k":
        assert rec["global_batch"] == 1


def test_in_proj_cut_and_checkpoint_across_meshes(runs):
    """Jamba's parameters gathered on mesh 1x4 right after the cut equal
    the weights bit for bit (``in_proj``'s x_in and z columns of each
    card's channels joined back in place); a checkpoint written on 1x4
    after a step, restored on 2x2 and on one process, gives the same
    parameters and Adafactor state bit for bit."""
    _, ranks, _, weights, out_dir = runs
    out = ranks[0][0]
    for name, w in named(weights[CKPT]).items():
        np.testing.assert_array_equal(out[f"ckpt/cut/{name}"],
                                      np.asarray(w, np.float32))
    keys = sorted(k.split("/", 2)[2] for k in out
                  if k.startswith("ckpt/1x4/"))
    assert any("in_proj" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(out[f"ckpt/2x2/{k}"],
                                      out[f"ckpt/1x4/{k}"])
    cfg = _cfg(CKPT)
    model, st, *_ = _build(cfg, "baseline", weights[CKPT], None)
    restored = Checkpointer(out_dir / "ckpt").restore(
        1, _state_tree(model, st))
    for n, p in named(restored["params"]).items():
        np.testing.assert_array_equal(p.numpy(), out[f"ckpt/1x4/p/{n}"])
    state = OPT.state_from_tree(restored["opt"], cfg.optimizer)
    tree = OPT.state_to_tree(state, cfg.optimizer)
    for n, t in named({k: v for k, v in tree.items()
                       if k != "count"}).items():
        np.testing.assert_array_equal(t.numpy(), out[f"ckpt/1x4/s/{n}"])


@pytest.mark.parametrize("shape,chunk", [((3, 5, 4), 7), ((3, 5, 4), 40),
                                         ((6, 10), 7), ((2, 3, 7, 4), 60)])
def test_sharded_adafactor_in_pieces(monkeypatch, shape, chunk):
    """The sharded Adafactor worked through in pieces of whole rows (rows
    of one leading index a piece, or several leading indices a piece)
    against the whole-leaf update of one card: the parameter and both
    factors, from a non-zero state; the gradient is left as it was."""
    lay = SH.Layout({"data": 1, "model": 1}, {"data": 0, "model": 0},
                    SH.ShardingRules())
    axes = ("layers",) * (len(shape) - 2) + ("model_d", "ff")
    f, _ = ST._factor_leaf(lay, lay, axes, shape)
    rng = np.random.default_rng(3)
    p0, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(2))
    st0 = {"vr": torch.rand(shape[:-1]), "vc": torch.rand(
        shape[:-2] + shape[-1:])}
    p1, st1 = p0.clone(), {k: v.clone() for k, v in st0.items()}
    OPT._adafactor_update(p1, g, st1, 0.01, 0.99)
    monkeypatch.setattr(OPT, "FACTOR_CHUNK", chunk)
    assert len(list(OPT._chunks(int(np.prod(shape[:-2])), *shape[-2:]))) > 1
    p2, st2 = p0.clone(), {k: v.clone() for k, v in st0.items()}
    g_before = g.clone()
    OPT._adafactor_sharded(p2, g, st2, 0.01, 0.99, f)
    assert torch.equal(g, g_before)
    torch.testing.assert_close(p2, p1, rtol=1e-6, atol=1e-7)
    for k in ("vr", "vc"):
        torch.testing.assert_close(st2[k], st1[k], rtol=1e-6, atol=1e-12)
