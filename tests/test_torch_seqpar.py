"""The port's sequence parallelism (``seqpar``: the residual stream's
sequence over "model") on 4 gloo ranks on the CPU, against the JAX
package's unsharded model on one CPU device.

One spawn of 4 ranks for the module (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory: no TCP port), started
with ``join=False`` so that the parent jits the JAX references while the
ranks run, handed over as numpy. This module imports nothing at its top
that imports JAX (the ranks import it to find ``_rank``).

Reduced qwen2-1.5b (tied embeddings, biases, 4 / 2 heads), gemma2-27b
(post norms, a window, softcaps) and granite-moe-1b-a400m (capacity factor
0.5, so tokens drop in the global GShard order), with weights cut by
``from_jax_params(..., mesh=)`` under ``rules_for(..., "seqpar")``:

  * prefill logits on meshes 1x4 and 2x2 at S = 32, which divides "model"
    (the sequence cut, its collectives the formula's reduce-scatters and
    all-gathers), and at S = 31, which does not (the collectives equal a
    baseline model's: the rule does nothing);
  * 2 committed and 2 append decode steps from a cache filled from the
    seqpar prefill's rows (decode is the baseline's, S = 1);
  * the loss terms and every leaf's gradient (the norms and
    ``final_norm``, whose gradients are summed over "model", included) of
    one whole-batch ``value_and_grad``, and two train steps (n_micro 4,
    from count 99) on 2x2 and 1x4 under ``seqpar``, on 2x2 under
    ``fsdp+seqpar``, qwen2's ``micro8+bf16grad+seqpar`` and granite's
    ``expdata+seqpar``: every metric, parameter and moment, the
    collectives of each step equal to ``steps.train_step_collectives``;
  * a layer whose heads and d_ff, and a vocabulary, that do not cut over
    4 cards (qwen2 at 6 heads, d_ff 130, vocab 130 on 1x4: every card
    computes them whole and keeps its rows) against the one-process port;
  * qwen2's reduced train_4k record under ``seqpar`` on 2x2;
  * rwkv6, Jamba, vision and musicgen building their seqpar train cells
    (their layers on a mesh: tests/test_torch_recurrent_parallel.py and
    tests/test_torch_modality_parallel.py).

Tolerance: fp32's 2e-5 and, under ``bf16grad``, bf16's 2e-2
(tests/test_kernels.py::_tol) of the reference's magnitude where it
exceeds 1.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named
from test_torch_distributed import _weights
from test_torch_expert_parallel import _ep_weights

WORLD = 4
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py
ARCHS = ("qwen2-1.5b", "gemma2-27b", "granite-moe-1b-a400m")
MESHES = (("1x4", 1), ("2x2", 2))                # name, data
B, MAX_SEQ, STEPS = 4, 40, 2
PROMPTS = (32, 31)           # divides "model" on both meshes; divides none
LENS = (32, 20, 27, 32)      # each row's prompt in the decode cache
TB, TS, COUNT, TSTEPS = 8, 32, 99, 2
TRAIN = {arch: (("2x2", "seqpar"), ("1x4", "seqpar"),
                ("2x2", "fsdp+seqpar")) for arch in ARCHS}
TRAIN["qwen2-1.5b"] += (("2x2", "micro8+bf16grad+seqpar"),)
TRAIN["granite-moe-1b-a400m"] += (("2x2", "expdata+seqpar"),)
METRICS = ("loss", "grad_norm", "lr", "ce", "z")
ITEM_4B = ("rwkv6-1.6b", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
           "musicgen-large")


def _cfg(arch):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    return cfg


def _uncut_cfg():
    """qwen2 with 6 heads, d_ff 130 and vocab 130: none cuts over 4."""
    return dataclasses.replace(get_config("qwen2-1.5b").reduced(vocab=130),
                               n_heads=6, d_ff=130)


def _family(variant):
    """The JAX reference a variant is held to: (n_micro, grad dtype)."""
    return (8, "bfloat16") if "micro8" in variant else (4, "float32")


def _inputs(cfg, seed=1):
    """Prompt tokens (B, 32), decode tokens (STEPS, B), two train batches
    of TB x TS."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, PROMPTS[0]))
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B))
    batches = []
    for _ in range(TSTEPS):
        x = rng.integers(0, cfg.vocab_size, size=(TB, TS + 1))
        batches.append({"tokens": x[:, :-1].astype(np.int32),
                        "labels": x[:, 1:].astype(np.int32)})
    return tokens, steps, batches


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _spec(specs, name):
    node = specs
    for p in name.split("."):
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def _row(cache, b0, bl, b):
    """Slot ``b``'s one-row prefill cache out of this card's rows [b0, b0
    + bl) (any row where another card holds the slot: unread)."""
    j = b - b0 if b0 <= b < b0 + bl else 0
    return {g: tuple({"mixer": {k: v[:, j:j + 1] for k, v in
                                layer["mixer"].items()}} for layer in layers)
            for g, layers in cache.items()}


def _baseline_formula(cfg, mesh, batch, seq):
    """A baseline model's prefill collectives on ``mesh``'s layout (the
    meta device: no process group)."""
    lay = SH.Layout.of(mesh, SH.ShardingRules())
    model = T.Transformer(cfg, device="meta",
                          mesh=SH.Layout(lay.sizes, lay.coords, lay.rules))
    return model.step_collectives(batch=batch, seq=seq)


def _serve(cfg, weights, mesh, tokens, steps, out, counts, key):
    """seqpar prefills at both prompt lengths, then decode from the S = 32
    prefill's rows: gathered logits into ``out``, each step's collectives
    and formula into ``counts``."""
    rules = ST.rules_for(cfg, ShapeCase("t", "decode", MAX_SEQ, B), mesh,
                         "seqpar")
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    for S in PROMPTS[::-1]:          # the decode cache: S = 32's rows
        SH.reset_collectives()
        lt, pf = model.prefill(torch.from_numpy(tokens[:, :S]))
        counts[f"{key}/prefill{S}"] = [
            SH.collectives()["calls"],
            model.step_collectives(batch=B, seq=S),
            _baseline_formula(cfg, mesh, B, S)]
        out[f"{key}/prefill{S}"] = model.gather_logits(lt, B)
    (b0, bl), = model.layout.ranges(("batch",), (B,))
    for mode in ("committed", "append"):
        cache = T.init_cache(cfg, B, MAX_SEQ, device="cpu", mesh=mesh,
                             rules=rules)
        for b, n in enumerate(LENS):
            T.cache_insert(cfg, cache, _row(pf, b0, bl, b), b, n)
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


def _build(cfg, variant, weights, mesh):
    """(model, opt state at count 99, train step, param specs, opt specs)
    of the train cell on ``mesh``."""
    case = ShapeCase("t", "train", TS, TB)
    out = ST.build_cell(cfg, case, "cpu", variant, mesh=mesh)
    model = T.from_jax_params(ST.apply_variant_config(cfg, variant, mesh),
                              weights, device="cpu", mesh=mesh, rules=out[3])
    st = ST.init_opt_state(model)
    st["count"] = torch.tensor(COUNT, dtype=torch.int32)
    return model, st, out[0], out[4]["params"], out[4]["opt_state"]


def _grads(cfg, weights, rank, mesh, batch, out, key):
    """One whole-batch ``value_and_grad`` under seqpar: the loss terms on
    every rank, every gradient gathered whole on rank 0."""
    model, _, _, p_specs, _ = _build(cfg, "seqpar", weights, mesh)
    _, metrics, grads = ST.value_and_grad(cfg, model, _t(batch), n_micro=1)
    out[f"{key}/vg"] = np.array([float(metrics[k]) for k in
                                 ("ce", "z", "lb_loss", "z_loss")])
    for n, g in grads.items():
        whole = SH.gather_whole(g, model.layout, _spec(p_specs, n))
        if rank == 0:
            out[f"{key}/g/{n}"] = whole.numpy().copy()


def _train(cfg, weights, rank, mesh, variant, batches, out, counts, key):
    """Two train steps of ``variant`` on ``mesh``: metrics by step, the
    collectives and their formula, then every parameter and moment
    gathered whole on rank 0."""
    model, st, fn, _, o_specs = _build(cfg, variant, weights, mesh)
    nm = _family(variant)[0]
    for i, batch in enumerate(batches):
        SH.reset_collectives()
        st, m = fn(model, st, _t(batch))
        out[f"{key}/metrics{i}"] = np.array([float(m[k]) for k in METRICS])
        counts[f"{key}/{i}"] = [SH.collectives()["calls"],
                                ST.train_step_collectives(model, TB, nm, TS)]
    params = T.to_jax_params(model)
    tree = OPT.state_to_tree(st, cfg.optimizer, specs=o_specs,
                             layout=model.layout)
    if rank != 0:
        return
    for n, p in named(params).items():
        out[f"{key}/p/{n}"] = p
    for part in ("m", "v"):
        for n, t in named(tree[part]).items():
            out[f"{key}/{part}/{n}"] = t.numpy()
    out[f"{key}/count"] = np.array(int(tree["count"]))


def _uncut(weights, rank, mesh, out, counts):
    """The uncut config on ``mesh`` under seqpar: prefill logits and one
    whole-batch ``value_and_grad`` (gradients gathered on rank 0), with
    their collectives and formulas."""
    cfg = _uncut_cfg()
    tokens, _, batches = _inputs(cfg)
    model, _, _, p_specs, _ = _build(cfg, "seqpar", weights, mesh)
    assert model.tp.heads is None and model.tp.ff is None
    assert model._embed_vocab[0] is None
    SH.reset_collectives()
    lt, _ = model.prefill(torch.from_numpy(tokens))
    counts["uncut/prefill"] = [SH.collectives()["calls"],
                               model.step_collectives(batch=B,
                                                      seq=PROMPTS[0])]
    out["uncut/prefill"] = model.gather_logits(lt, B)
    SH.reset_collectives()
    loss, _, grads = ST.value_and_grad(cfg, model, _t(batches[0]))
    plan = ST.mesh_plan(model)
    want = T.train_collectives(model, TB, TS)
    want["all-reduce"] = want.get("all-reduce", 0) + sum(
        bool(r) for r in plan.seq_reduce.values())
    counts["uncut/grads"] = [SH.collectives()["calls"], want]
    out["uncut/loss"] = np.array(float(loss))
    for n, g in grads.items():
        whole = SH.gather_whole(g, model.layout, _spec(p_specs, n))
        if rank == 0:
            out[f"uncut/g/{n}"] = whole.numpy().copy()


def _rank(rank, store_path, out_dir, weights):
    """One rank: every config's serving and training cases, the uncut
    config and the record; writes ``rank{rank}.npz`` and its counts."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (1, 2)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tokens, steps, batches = _inputs(cfg)
        for mname, d in MESHES:
            _serve(cfg, weights[arch], meshes[d], tokens, steps, out, counts,
                   f"serve/{arch}/{mname}")
            _grads(cfg, weights[arch], rank, meshes[d], batches[0], out,
                   f"{arch}/{mname}")
        for mname, variant in TRAIN[arch]:
            _train(cfg, weights[arch], rank, meshes[dict(MESHES)[mname]],
                   variant, batches, out, counts,
                   f"{arch}/{mname}/{variant}")
    _uncut(weights["uncut"], rank, meshes[1], out, counts)
    dryrun.run_cell("qwen2-1.5b", "train_4k",
                    os.path.join(out_dir, "records"), device="cpu",
                    reduced=True, seq_len=64, mesh=meshes[2],
                    variant="seqpar")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX and one-process references, each rank's results and
    counts, the record)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.training import optimizer as JOPT

    weights = {arch: (_ep_weights if _cfg(arch).n_experts else _weights)(
        _cfg(arch), seed) for seed, arch in enumerate(ARCHS)}
    weights["uncut"] = _weights(_uncut_cfg(), 7)
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
                                    capacity_factor=cfg.capacity_factor)
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, steps, batches = _inputs(cfg)
        for S in PROMPTS[::-1]:      # the decode cache: S = 32's rows
            logits, pf = j_prefill(cfg_j, params, jnp.asarray(tokens[:, :S]))
            ref[f"{arch}/prefill{S}"] = np.asarray(logits)
        for mode in ("committed", "append"):
            cache, _ = JT.init_cache(cfg_j, B, MAX_SEQ)
            for b, n in enumerate(LENS):
                cache = JT.cache_insert(cfg_j, cache, jax.tree.map(
                    lambda x, b=b: x[:, b:b + 1], pf), b, n)
            lengths = np.array(LENS)
            for i in range(STEPS):
                lg, cache = j_decode(cfg_j, params, cache,
                                     jnp.asarray(steps[i]),
                                     jnp.asarray(lengths), mode == "append")
                ref[f"{arch}/{mode}/{i}"] = np.asarray(lg)
                lengths = lengths + 1
        (_, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True))(
            params, jax.tree.map(jnp.asarray, batches[0]))
        ref[f"{arch}/vg"] = np.array([float(m.get(k, 0.0)) for k in
                                      ("ce", "z", "lb_loss", "z_loss")])
        ref[f"{arch}/g"] = named(jax.tree.map(np.asarray, g))
        for nm, gd in sorted({_family(v) for _, v in TRAIN[arch]}):
            p = params
            st = JOPT.init(p, cfg_j.optimizer)
            st["count"] = jnp.int32(COUNT)
            step = jax.jit(JS.build_train_step(
                cfg_j, n_micro=nm, grad_dtype=getattr(jnp, gd)))
            for i, batch in enumerate(batches):
                p, st, m = step(p, st, jax.tree.map(jnp.asarray, batch))
                ref[(arch, nm, i)] = np.array([float(m[k]) for k in
                                               METRICS])
            ref[(arch, nm, "p")] = named(jax.tree.map(np.asarray, p))
            for part in ("m", "v"):
                ref[(arch, nm, part)] = named(jax.tree.map(np.asarray,
                                                           st[part]))
            ref[(arch, nm, "count")] = int(st["count"])
    cfg = _uncut_cfg()
    model = T.from_jax_params(cfg, weights["uncut"], device="cpu")
    tokens, _, batches = _inputs(cfg)
    ref["uncut/prefill"] = model.prefill(torch.from_numpy(tokens))[0].numpy()
    loss, _, grads = ST.value_and_grad(cfg, model, _t(batches[0]))
    ref["uncut/loss"] = float(loss)
    ref["uncut/g"] = {n: g.numpy() for n, g in grads.items()}
    while not ranks_run.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            counts = json.load(f)
        ranks.append((dict(np.load(out_dir / f"rank{r}.npz")), counts))
    record, = [json.loads(f.read_text())
               for f in (out_dir / "records").glob("*.json")]
    return ref, ranks, record


def _close(got, want, tol=TOL["float32"]) -> bool:
    """Within ``tol`` of the reference, scaled by its magnitude above 1."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - want),
                        initial=0.0)) <= tol * scale


SERVE_CASES = [(a, m) for a in ARCHS for m, _ in MESHES]


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_prefill_matches_jax(runs, arch, mesh, S):
    """Gathered seqpar prefill logits on every rank against JAX's prefill;
    the collectives the formula's, which at S = 32 cut the sequence
    (reduce-scatters, no all-reduce) and at S = 31 are a baseline
    model's."""
    ref, ranks, _ = runs
    for out, counts in ranks:
        assert _close(out[f"serve/{arch}/{mesh}/prefill{S}"],
                      ref[f"{arch}/prefill{S}"])
        got, want, baseline = counts[f"serve/{arch}/{mesh}/prefill{S}"]
        assert got == want
        if S % 4:
            assert got == baseline
        else:
            assert "all-reduce" not in got and got["reduce-scatter"] > 0


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_decode_after_seqpar_prefill_matches_jax(runs, arch, mesh):
    """2 committed and 2 append decode steps from slot caches filled from
    the seqpar prefill's rows, against JAX's decode from its prefill's:
    gathered logits on every rank; decode's collectives the formula's
    (the baseline's: S = 1 does not cut)."""
    ref, ranks, _ = runs
    for out, counts in ranks:
        for mode in ("committed", "append"):
            for i in range(STEPS):
                key = f"serve/{arch}/{mesh}/{mode}/{i}"
                assert _close(out[key], ref[f"{arch}/{mode}/{i}"]), key
                got, want = counts[key]
                assert got == want, key


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_gradients_match_jax(runs, arch, mesh):
    """Every leaf's gradient of the whole batch's loss under seqpar (the
    norms and final_norm summed over "model", the embedding, attention,
    MLP or experts and router), reduced over the mesh and gathered,
    against ``jax.value_and_grad`` of JAX's ``loss_fn``; the loss terms
    on every rank."""
    ref, ranks, _ = runs
    key = f"{arch}/{mesh}"
    for out, _ in ranks:
        assert _close(out[f"{key}/vg"], ref[f"{arch}/vg"])
    out = ranks[0][0]
    want = ref[f"{arch}/g"]
    assert {k.split("/g/", 1)[1] for k in out
            if k.startswith(f"{key}/g/")} == set(want)
    assert {"final_norm", "g0.0.norm1", "g0.0.norm2"} <= set(want)
    for name, g in want.items():
        assert _close(out[f"{key}/g/{name}"], g), name


TRAIN_CASES = [(a, m, v) for a in ARCHS for m, v in TRAIN[a]]


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_steps_match_jax(runs, arch, mesh, variant):
    """Two seqpar train steps against JAX's single-device
    ``build_train_step``: every metric of each step on every rank (equal
    on all), every parameter and both moments gathered whole; each step's
    collectives equal to ``steps.train_step_collectives``."""
    ref, ranks, _ = runs
    nm, gd = _family(variant)
    tol = TOL[gd]
    key = f"{arch}/{mesh}/{variant}"
    for i in range(TSTEPS):
        got = [out[f"{key}/metrics{i}"] for out, _ in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), i
        for j, name in enumerate(METRICS):
            assert _close(got[0][j], ref[(arch, nm, i)][j], tol), (i, name)
        for _, counts in ranks:
            calls, formula = counts[f"{key}/{i}"]
            assert calls == formula and calls["reduce-scatter"] > 0, i
    out = ranks[0][0]
    assert int(out[f"{key}/count"]) == ref[(arch, nm, "count")] == \
        COUNT + TSTEPS
    for part in ("p", "m", "v"):
        want = ref[(arch, nm, part)]
        assert {k.split(f"/{part}/", 1)[1] for k in out
                if k.startswith(f"{key}/{part}/")} == set(want)
        for name, w in want.items():
            assert _close(out[f"{key}/{part}/{name}"], w, tol), (part, name)


def test_uncut_heads_ff_and_vocab_keep_their_rows(runs):
    """6 heads, d_ff 130 and vocab 130 do not cut over 4 cards: each card
    computes those parts on the gathered sequence and keeps its rows; the
    prefill logits, loss and every gradient equal the one-process port's,
    the collectives the formula's (all-gathers only, and the gradients'
    sums)."""
    ref, ranks, _ = runs
    for out, counts in ranks:
        assert _close(out["uncut/prefill"], ref["uncut/prefill"])
        assert _close(out["uncut/loss"], ref["uncut/loss"])
        for what in ("prefill", "grads"):
            got, want = counts[f"uncut/{what}"]
            assert got == want, what
        assert set(counts["uncut/prefill"][0]) == {"all-gather"}
    out = ranks[0][0]
    for name, g in ref["uncut/g"].items():
        assert _close(out[f"uncut/g/{name}"], g), name


def test_seqpar_record(runs):
    """``run_cell(..., mesh=, variant="seqpar")`` for qwen2's train_4k on
    2x2 on the CPU: ok, 4 devices, the seqpar rule, collectives of one
    step equal to the formula, finite losses; named apart from a
    baseline record."""
    *_, rec = runs
    assert rec["ok"] is True and rec["devices"] == WORLD
    assert rec["variant"] == "seqpar" and rec["rules"]["seq"] == ["model"]
    assert rec["collectives"]["calls"] == rec["collectives_formula"]
    assert rec["collectives"]["calls"]["reduce-scatter"] > 0
    assert rec["flops"] > 0 and np.isfinite(rec["losses"]).all()


@pytest.mark.parametrize("arch", ITEM_4B)
def test_recurrent_and_modality_configs_wait_for_item_4b(arch):
    """ROADMAP A9c item 4b, done: seqpar on a config with a Mamba, RWKV,
    cross or codebook layer builds its train_4k cell on the meta device
    (the tokens' spec ("data", "model"): the sequence over "model"), and
    a model built with the rule cuts a pass of 32 tokens over 4 cards and
    not one of 31."""
    sizes = {"data": 1, "model": 4}
    lay = SH.Layout(sizes, {"data": 0, "model": 0}, SH.ShardingRules())
    cfg = get_config(arch)
    assert ST.apply_variant_config(cfg, "seqpar", lay) == cfg
    _, _, _, rules, ins, _ = ST.build_cell(cfg, SHAPES["train_4k"], "meta",
                                           "seqpar", mesh=lay)
    assert rules.rules["seq"] == ("model",)
    assert ins["batch"]["tokens"][:2] == ("data", "model")
    rules = ST.rules_for(cfg, SHAPES["prefill_32k"], lay, "seqpar")
    model = T.Transformer(cfg.reduced(), device="meta",
                          mesh=lay.with_rules(rules))
    assert model.seq_plan(1, 31) is model.tp
    assert model.seq_plan(1, 32).sp == "model"
