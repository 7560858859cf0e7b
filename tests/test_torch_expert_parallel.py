"""The port's expert parallelism on 4 gloo ranks on the CPU (the MoE layers
of ``repro_torch.models.moe`` on a ("data", "model") mesh, the sharded
Adafactor of ``repro_torch.training.optimizer``), against the JAX package
on one CPU device.

One spawn of 4 ranks for the module (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory: no TCP port), handed
the shared numpy weights; the JAX references are jitted in the parent while
the ranks run, one per config and shape, and handed over as numpy. This
module imports nothing at its top that imports JAX (the ranks import it to
find ``_rank``).

Reduced granite-moe-1b-a400m (2 layers, 8 experts, top 2, d_model 64,
AdamW) and reduced kimi-k2 (its dense layer and 2 MoE layers, Adafactor),
both at capacity factor 0.5 so that tokens drop (asserted), with weights
cut by ``from_jax_params(..., mesh=)``:

  * prefill logits and 3 committed and 3 append-mode decode steps on mesh
    1x4 (2 kv heads: the cache by sequence, 16 rows a card) and 2x2 (the
    batch over "data", the cache by kv heads); the collectives of every
    step equal to ``Transformer.step_collectives``;
  * the train step (n_micro 4, two steps from count 99) on meshes 2x2, 4x1
    (two rows a microbatch over 4 cards: each card routes its slice of the
    flat tokens) and 1x4, and under ``expdata`` and ``fsdp`` on 2x2, and
    granite's under ``blockdispatch`` (32 dispatch blocks, the reference's
    group capacity; kimi-k2's would add ~11 s of JAX compiles for the same
    code) on 2x2: every leaf's gradient of one whole-batch ``value_and_grad``
    (router, w_gate, w_up, w_down, attention, embedding, norms), the
    metrics of each step, every parameter and the optimizer state after the
    two steps (AdamW's moments; kimi-k2's Adafactor factors against JAX's
    ``update``), gathered whole; the collectives of each step equal to
    ``steps.train_step_collectives``;
  * granite's engine on meshes 1x4 and 2x2 (greedy tokens equal to the
    one-process port engine's on every rank) and its dry-run records at
    decode_32k (1x4) and train_4k (2x2), reduced at seq 64.

Tolerance: fp32's 2e-5 (tests/test_kernels.py::_tol) of the reference's
magnitude where it exceeds 1.
"""
import dataclasses
import json
import os

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
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named, nest
from test_torch_distributed import _weights

WORLD = 4
TOL = 2e-5
ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
CF = 0.5                   # capacity factor: tokens drop
B, LENS, MAX_SEQ, STEPS = 4, (40, 23, 60, 47), 64, 3
SERVE = (("1x4", 1), ("2x2", 2))
TB, TS, COUNT, N_MICRO, TSTEPS = 8, 64, 99, 4, 2
TRAIN = (("2x2", 2, "baseline"), ("4x1", 4, "baseline"),
         ("1x4", 1, "baseline"), ("2x2", 2, "expdata"),
         ("2x2", 2, "fsdp"), ("2x2", 2, "blockdispatch"))
# the variant whose JAX reference is a config of its own, run for granite
BLOCKS = "blockdispatch"
METRICS = ("loss", "grad_norm", "lr", "ce", "z", "lb_loss", "z_loss")
ECFG = EngineConfig(max_batch=4, max_seq=64)
PROMPTS = (30, 9, 50, 17, 44)
NEW = 4
RECORDS = (("decode_32k", 1), ("train_4k", 2))     # granite's, (shape, data)


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               capacity_factor=CF)


def _ep_weights(cfg, seed):
    """``_weights`` with each expert matrix (L, E, in, out) scaled by its
    own fan-in."""
    w = named(_weights(cfg, seed))
    rng = np.random.default_rng(seed + 100)
    for name, x in w.items():
        if ".mlp." in name and x.ndim == 4:
            w[name] = (rng.standard_normal(x.shape) / np.sqrt(x.shape[2])
                       ).astype(np.float32)
    return nest(w)


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
    cfg_v = ST.apply_variant_config(cfg, variant, mesh)
    rules = out[3] if mesh is not None else None
    model = T.from_jax_params(cfg_v, weights, device="cpu", mesh=mesh,
                              rules=rules)
    st = ST.init_opt_state(model)
    st["count"] = torch.tensor(COUNT, dtype=torch.int32)
    if mesh is None:
        return model, st, out[0], None, None
    return model, st, out[0], out[4]["params"], out[4]["opt_state"]


def _serve(cfg, weights, rank, mesh, tokens, steps, out, counts, key):
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
    for mode in ("committed", "append"):
        cache = T.init_cache(cfg, B, MAX_SEQ, device="cpu", mesh=mesh,
                             rules=rules)
        for b, n in enumerate(LENS):
            _, pf1 = model.prefill(torch.from_numpy(tokens[b:b + 1]))
            T.cache_insert(cfg, cache, pf1, b, n)
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


def _rank(rank, store_path, out_dir, weights):
    """One rank: serving and training of both configs, granite's engine
    and records; writes ``rank{rank}.npz`` and its counts."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (4, 2, 1)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tokens, steps, batches, prompts = _inputs(cfg)
        for mname, d in SERVE:
            _serve(cfg, weights[arch], rank, meshes[d], tokens, steps, out,
                   counts, f"serve/{arch}/{mname}")
        for mname, d, variant in TRAIN:
            if variant != BLOCKS or arch == ARCHS[0]:
                _train(cfg, weights[arch], rank, meshes[d], variant,
                       batches, out, counts, f"{arch}/{mname}/{variant}")
    cfg = _cfg(ARCHS[0])
    prompts = _inputs(cfg)[3]
    for mname, d in SERVE:
        rules = serving_rules(cfg, ECFG, meshes[d])
        model = T.from_jax_params(cfg, weights[ARCHS[0]], device="cpu",
                                  mesh=meshes[d], rules=rules)
        eng = ServingEngine(cfg, model, ECFG, device="cpu", mesh=meshes[d])
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        out[f"engine/{mname}"] = np.array(
            [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    for shape, d in RECORDS:
        dryrun.run_cell(ARCHS[0], shape, os.path.join(out_dir, "records"),
                        device="cpu", reduced=True, seq_len=64,
                        mesh=meshes[d])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


def _drops(cfg, weights, tokens, batch):
    """Dropped (token, choice) entries of the one-process port's MoE calls
    in a prefill of ``tokens`` and a train microbatch of ``batch``."""
    from repro_torch.kernels import ops
    route, dropped = ops.moe_route, []

    def spy(logits, top_k, *, cap, nb, impl=None):
        out = route(logits, top_k, cap=cap, nb=nb, impl=impl)
        dropped.append(int((out[2] == cfg.n_experts * cap).sum()))
        return out

    model = T.from_jax_params(cfg, weights, device="cpu")
    ops.moe_route = spy
    try:
        model.prefill(torch.from_numpy(tokens))
        n_prefill = sum(dropped)
        mb = {k: v[:TB // N_MICRO] for k, v in _t(batch).items()}
        T.loss_fn(cfg, model, mb)
    finally:
        ops.moe_route = route
    return n_prefill, sum(dropped) - n_prefill


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX and one-process references, each rank's results and
    counts, the records)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.training import optimizer as JOPT

    weights = {arch: _ep_weights(_cfg(arch), seed)
               for seed, arch in enumerate(ARCHS)}
    out_dir = tmp_path_factory.mktemp("ranks")
    ranks_run = torch.multiprocessing.spawn(
        _rank, args=(str(out_dir / "store"), str(out_dir), weights),
        nprocs=WORLD, join=False)
    j_prefill = jax.jit(JT.prefill, static_argnums=0)
    j_decode = jax.jit(lambda cfg, p, c, t, l, a: JT.decode_step(
        cfg, p, c, t, l, append=a), static_argnums=(0, 5))
    ref = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
                                    capacity_factor=CF)
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, steps, batches, prompts = _inputs(cfg)
        ref[f"{arch}/drops"] = _drops(cfg, weights[arch], tokens,
                                      batches[0])
        logits, _ = j_prefill(cfg_j, params, jnp.asarray(tokens))
        ref[f"{arch}/prefill"] = np.asarray(logits)
        rows = [j_prefill(cfg_j, params, jnp.asarray(tokens[b:b + 1]))[1]
                for b in range(B)]
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
        for bd in (False, True)[:2 if arch == ARCHS[0] else 1]:
            c = dataclasses.replace(cfg_j, moe_block_dispatch=32) if bd \
                else cfg_j
            (_, m), g = jax.jit(jax.value_and_grad(
                lambda p, b, c=c: JT.loss_fn(c, p, b), has_aux=True))(
                params, jax.tree.map(jnp.asarray, batches[0]))
            ref[(arch, bd, "vg")] = np.array(
                [float(m[k]) for k in ("ce", "z", "lb_loss", "z_loss")])
            ref[(arch, bd, "g")] = named(jax.tree.map(np.asarray, g))
            p = params
            st = JOPT.init(p, c.optimizer)
            st["count"] = jnp.int32(COUNT)
            step = jax.jit(JS.build_train_step(c, n_micro=N_MICRO))
            for i, batch in enumerate(batches):
                p, st, m = step(p, st, jax.tree.map(jnp.asarray, batch))
                ref[(arch, bd, i)] = np.array([float(m[k]) for k in
                                               METRICS])
            ref[(arch, bd, "p")] = named(jax.tree.map(np.asarray, p))
            ref[(arch, bd, "s")] = named(jax.tree.map(
                np.asarray, {k: st[k] for k in ("fac", "m", "v")
                             if k in st}))
            ref[(arch, bd, "count")] = int(st["count"])
    cfg = _cfg(ARCHS[0])
    model = T.from_jax_params(cfg, weights[ARCHS[0]], device="cpu")
    eng = ServingEngine(cfg, model, ECFG, device="cpu")
    for i, p in enumerate(_inputs(cfg)[3]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    ref["engine"] = np.array(
        [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)])
    while not ranks_run.join():
        pass
    records = {r["shape"]: r for r in (
        json.loads(f.read_text())
        for f in sorted((out_dir / "records").glob("*.json")))}
    ranks = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            counts = json.load(f)
        ranks.append((dict(np.load(out_dir / f"rank{r}.npz")), counts))
    return ref, ranks, records


def _close(got, want, tol=TOL) -> bool:
    """Within ``tol`` of the reference, scaled by its magnitude above 1."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - want),
                        initial=0.0)) <= tol * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_drop(runs, arch):
    """Capacity factor 0.5 drops tokens in the prefill and in a train
    microbatch, so the global GShard order is exercised."""
    ref, *_ = runs
    n_prefill, n_train = ref[f"{arch}/drops"]
    assert n_prefill > 0 and n_train > 0


SERVE_CASES = [(a, m) for a in ARCHS for m, _ in SERVE]


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_prefill_matches_jax(runs, arch, mesh):
    """Gathered prefill logits on every rank against JAX's prefill."""
    ref, ranks, _ = runs
    for out, _ in ranks:
        assert _close(out[f"serve/{arch}/{mesh}/prefill"],
                      ref[f"{arch}/prefill"])


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
@pytest.mark.parametrize("mode", ["committed", "append"])
def test_decode_matches_jax(runs, arch, mesh, mode):
    """3 decode steps from slot caches filled by one-row prefills:
    gathered logits on every rank against JAX's decode_step."""
    ref, ranks, _ = runs
    for out, _ in ranks:
        for i in range(STEPS):
            assert _close(out[f"serve/{arch}/{mesh}/{mode}/{i}"],
                          ref[f"{arch}/{mode}/{i}"]), i


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_collectives_follow_the_formula(runs, arch):
    """Every prefill and decode step made exactly the collectives of
    ``Transformer.step_collectives``: on 2x2 each MoE layer gathers its
    tokens over "data", reduce-scatters its combine back and all-reduces
    it over "model"; on 1x4 it only all-reduces."""
    _, ranks, _ = runs
    for _, counts in ranks:
        keys = [k for k in counts if k.startswith(f"serve/{arch}/")]
        assert len(keys) == len(SERVE) * (1 + 2 * STEPS)
        for key in keys:
            got, want = counts[key]
            assert got == want, key
    cfg = _cfg(arch)
    moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
    got = ranks[0][1][f"serve/{arch}/2x2/append/0"][1]
    assert got["reduce-scatter"] == moe and got["all-gather"] == moe


TRAIN_CASES = [(a, m, v) for a in ARCHS for m, _, v in TRAIN
               if v != BLOCKS or a == ARCHS[0]]


def _ref_key(variant):
    return variant == BLOCKS


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_gradients_match_jax(runs, arch, mesh, variant):
    """Every leaf's gradient of the whole batch's loss on the mesh (the
    router's aux and combine parts, the experts' d_ff slices, attention,
    embedding, norms), reduced over the mesh and gathered, against
    ``jax.value_and_grad`` of JAX's ``loss_fn``; the loss terms on every
    rank."""
    ref, ranks, _ = runs
    bd = _ref_key(variant)
    key = f"{arch}/{mesh}/{variant}"
    for out, _ in ranks:
        assert _close(out[f"{key}/vg"], ref[(arch, bd, "vg")])
    out = ranks[0][0]
    want = ref[(arch, bd, "g")]
    assert {k.split("/g/", 1)[1] for k in out
            if k.startswith(f"{key}/g/")} == set(want)
    for name, g in want.items():
        assert _close(out[f"{key}/g/{name}"], g), name
    assert any(".mlp.router" in n and np.abs(g).max() > 0
               for n, g in want.items())


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_step_matches_jax(runs, arch, mesh, variant):
    """Two sharded steps against JAX's ``build_train_step`` (n_micro 4,
    from count 99): every metric of each step on every rank (equal on
    all), then every parameter and the optimizer state (AdamW's m and v;
    kimi-k2's Adafactor vr / vc / v) gathered whole."""
    ref, ranks, _ = runs
    bd = _ref_key(variant)
    key = f"{arch}/{mesh}/{variant}"
    for i in range(TSTEPS):
        got = [out[f"{key}/metrics{i}"] for out, _ in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), i
        for j, name in enumerate(METRICS):
            assert _close(got[0][j], ref[(arch, bd, i)][j]), (i, name)
    out = ranks[0][0]
    assert int(out[f"{key}/count"]) == ref[(arch, bd, "count")] == \
        COUNT + TSTEPS
    for part in ("p", "s"):
        want = ref[(arch, bd, part)]
        assert {k.split(f"/{part}/", 1)[1] for k in out
                if k.startswith(f"{key}/{part}/")} == set(want)
        for name, w in want.items():
            assert _close(out[f"{key}/{part}/{name}"], w), (part, name)
    if arch.startswith("kimi"):
        assert any(n.startswith("fac.") for n in ref[(arch, bd, "s")])


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_collectives_follow_the_formula(runs, arch, mesh, variant):
    """Every step on every rank made exactly the collectives of
    ``steps.train_step_collectives``: the MoE layers' token gathers and
    combine sums (forward, backward, remat recompute), the optimizer's."""
    _, ranks, _ = runs
    key = f"{arch}/{mesh}/{variant}"
    for _, counts in ranks:
        for i in range(TSTEPS):
            got, want = counts[f"{key}/{i}"]
            assert got == want, (key, i)
    got = ranks[0][1][f"{key}/0"][0]
    assert ("reduce-scatter" in got) == (mesh != "1x4")


@pytest.mark.parametrize("mesh", [m for m, _ in SERVE])
def test_engine_tokens_equal_one_process(runs, mesh):
    """Greedy tokens of granite's engine on the mesh equal the one-process
    port engine's on every rank."""
    ref, ranks, _ = runs
    for out, _ in ranks:
        np.testing.assert_array_equal(out[f"engine/{mesh}"], ref["engine"])


@pytest.mark.parametrize("shape", [s for s, _ in RECORDS])
def test_mesh_records(runs, shape):
    """``run_cell(..., mesh=)`` for granite on the CPU: ok, 4 devices,
    collectives of one step equal to the formula; the train record's
    losses finite."""
    *_, records = runs
    rec = records[shape]
    assert rec["ok"] is True and rec["devices"] == WORLD
    assert rec["collectives"]["calls"] == rec["collectives_formula"]
    assert rec["flops"] > 0
    if shape == "train_4k":
        assert rec["mesh"] == "cpu_2x2"
        assert np.isfinite(rec["losses"]).all()
