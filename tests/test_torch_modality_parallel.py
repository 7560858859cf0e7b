"""The port's cross-attention (llama-3.2-vision-11b) and codebook
(musicgen-large) layers on 4 gloo ranks on the CPU (a ("data", "model")
mesh), against the JAX package on one CPU device.

One spawn of 4 ranks for the module (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory: no TCP port), handed
the shared numpy weights; the JAX references are jitted in the parent while
the ranks run and handed over as numpy. This module imports nothing at its
top that imports JAX (the ranks import it to find ``_rank``).

Reduced vision (10 layers: two periods of one cross and four
self-attention layers, d_model 64, 4 / 2 heads of 16, 16 vision tokens)
and reduced musicgen (2 layers, C = 4 codebooks, vocab 128), weights cut by
``from_jax_params(..., mesh=)``:

  * prefill logits and 3 committed and 3 append-mode decode steps, from
    slot caches filled by ``cache_insert`` of one-row prefills, on mesh 1x4
    (2 kv heads over 4 cards: ``wk`` / ``wv`` replicated, every cache cut
    by rows, the cross caches' 16 vision tokens 4 a card) and 2x2 (the kv
    heads cut); vision also at batch 1 on 2x2, every cache cut by rows
    over all 4 cards; the collectives of every step equal to
    ``Transformer.step_collectives``;
  * under ``seqpar`` (the residual stream's sequence over "model") on
    1x4 and 2x2: the prefill at 24 tokens (cut) and 23 (not cut) and 3
    committed decode steps from the cut prefill's caches; musicgen at
    vocab 130 on 1x4 (the codebook tables whole on every card: the
    lookups' sum keeps the card's rows), its prefill and gradients;
  * every leaf's gradient (``vision_proj`` and the ``(C, V, D)`` /
    ``(C, D, V)`` leaves included) of one whole-batch ``value_and_grad``
    and two train steps (n_micro 4, from count 99) on meshes 2x2, 4x1 and
    1x4, and vision's under ``fsdp`` on 2x2, and under ``seqpar`` on 2x2
    and 1x4 (vision's under ``fsdp+seqpar`` on 2x2): the metrics, every
    parameter and AdamW moment gathered whole; the collectives of each
    step equal to ``steps.train_step_collectives``;
  * reduced dry-run records at seq 64: vision decode_32k on 1x4 (the
    bytes of its card's rows of the cross caches) and musicgen train_4k
    on 2x2;
  * musicgen's ``to_jax_params`` on 1x4 equal to the weights it was cut
    from, and a checkpoint written on 1x4 after a step, restored on 2x2,
    bit for bit.

Tolerance: fp32's 2e-5 (tests/test_kernels.py::_tol) of the reference's
magnitude where it exceeds 1.
"""
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
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named
from test_torch_distributed import _weights
from test_torch_recurrent_parallel import (_build, _close, _spec,
                                           _spec_tree, _state_tree, _t,
                                           _whole)

WORLD = 4
VISION, MUSIC = "llama-3.2-vision-11b", "musicgen-large"
ARCHS = (VISION, MUSIC)
B, P, LENS, MAX_SEQ, STEPS = 4, 24, (24, 17, 24, 13), 64, 3
# (name, data axis size, batch): 1x4 and 2x2 at batch 4; vision at batch 1
# on 2x2, where the decode rules cut every cache by rows over all 4 cards
SERVE = (("1x4", 1, B), ("2x2", 2, B))
SERVE_B1 = ("2x2b1", 2, 1)
TB, TS, COUNT, N_MICRO, TSTEPS = 8, 32, 99, 4, 2
TRAIN = (("2x2", 2, "baseline"), ("4x1", 4, "baseline"),
         ("1x4", 1, "baseline"), ("2x2", 2, "fsdp"),
         ("2x2", 2, "seqpar"), ("1x4", 1, "seqpar"),
         ("2x2", 2, "fsdp+seqpar"))
# seqpar prompts: P cuts the sequence on both meshes, P - 1 on none
SP_PROMPTS = (P, P - 1)
# musicgen at a vocabulary that does not cut over "model" (1x4)
MUSIC_UNCUT = 130
METRICS = ("loss", "grad_norm", "lr", "ce", "z", "lb_loss", "z_loss")
RECORDS = ((VISION, "decode_32k", 1), (MUSIC, "train_4k", 2))
CKPT = MUSIC


def _cfg(arch):
    return get_config(arch).reduced()


def _serve_cases(arch):
    return SERVE + ((SERVE_B1,) if arch == VISION else ())


def _train_cases(arch):
    return [(m, d, v) for m, d, v in TRAIN
            if "fsdp" not in v or arch == VISION]


def _music_uncut():
    return get_config(MUSIC).reduced(vocab=MUSIC_UNCUT)


def _inputs(cfg, seed=1):
    """Prompt tokens (B, P[, C]), vision embeddings (B, Nv, D) or None,
    decode tokens (STEPS, B[, C]), two train batches of TB x TS (with
    vision embeddings)."""
    rng = np.random.default_rng(seed)
    C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tokens = rng.integers(0, cfg.vocab_size, size=(B, P) + C)
    vision = (rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model))
              .astype(np.float32) if cfg.n_vision_tokens else None)
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B) + C)
    batches = []
    for _ in range(TSTEPS):
        x = rng.integers(0, cfg.vocab_size, size=(TB, TS + 1) + C)
        batch = {"tokens": x[:, :-1].astype(np.int32),
                 "labels": x[:, 1:].astype(np.int32)}
        if cfg.n_vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (TB, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        batches.append(batch)
    return tokens, vision, steps, batches


def _serve(cfg, weights, mesh, batch, out, counts, key):
    """Prefill and decode of the first ``batch`` rows on ``mesh``:
    gathered logits into ``out``, each step's collectives and formula into
    ``counts``. The slot caches take one-row prefills of all P tokens, cut
    to each row's length by ``cache_insert`` (causal: the same K/V as a
    prefill of that length)."""
    tokens, vision, steps, _ = _inputs(cfg)
    tokens, steps = torch.from_numpy(tokens[:batch]), steps[:, :batch]
    vision = None if vision is None else torch.from_numpy(vision[:batch])
    rules = ST.rules_for(cfg, ShapeCase("t", "decode", MAX_SEQ, batch), mesh)
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    SH.reset_collectives()
    lt, _ = model.prefill(tokens, vision_embeds=vision)
    counts[f"{key}/prefill"] = [SH.collectives()["calls"],
                                model.step_collectives(batch=batch, seq=P)]
    out[f"{key}/prefill"] = model.gather_logits(lt, batch)
    rows = [model.prefill(tokens[b:b + 1], vision_embeds=None if vision is
                          None else vision[b:b + 1])[1] for b in range(batch)]
    for mode in ("committed", "append"):
        cache = T.init_cache(cfg, batch, MAX_SEQ, device="cpu", mesh=mesh,
                             rules=rules)
        for b in range(batch):
            T.cache_insert(cfg, cache, rows[b], b, LENS[b])
        lengths = np.array(LENS[:batch])
        for i in range(STEPS):
            SH.reset_collectives()
            lg, cache = model.decode_step(
                cache, torch.from_numpy(steps[i]), torch.from_numpy(lengths),
                append=mode == "append")
            counts[f"{key}/{mode}/{i}"] = [SH.collectives()["calls"],
                                           model.step_collectives(cache)]
            out[f"{key}/{mode}/{i}"] = model.gather_logits(lg, batch)
            lengths = lengths + 1


def _serve_sp(cfg, weights, mesh, out, counts, key):
    """Under ``seqpar``: the batch's prefill at both ``SP_PROMPTS`` (causal:
    the shorter one's logits are the longer one's first rows), then 3
    committed decode steps from slot caches filled from the rows of the
    P-token prefill's cache (the sequence cut), each cut to its row's
    length by ``cache_insert``: gathered logits into ``out``, each step's
    collectives, formula and whether the sequence was cut into
    ``counts``."""
    tokens, vision, steps, _ = _inputs(cfg)
    tokens = torch.from_numpy(tokens)
    vision = None if vision is None else torch.from_numpy(vision)
    rules = ST.rules_for(cfg, ShapeCase("t", "decode", MAX_SEQ, B), mesh,
                         "seqpar")
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    for S in SP_PROMPTS[::-1]:            # the decode cache: P's rows
        SH.reset_collectives()
        lt, pf = model.prefill(tokens[:, :S], vision_embeds=vision)
        counts[f"{key}/prefill{S}"] = [
            SH.collectives()["calls"], model.step_collectives(batch=B, seq=S),
            model.seq_plan(B, S).sp is not None]
        out[f"{key}/prefill{S}"] = model.gather_logits(lt, B)
    cache = T.init_cache(cfg, B, MAX_SEQ, device="cpu", mesh=mesh,
                         rules=rules)
    (b0, bl), = model.layout.ranges(("batch",), (B,))
    for b in range(B):
        j = b - b0 if b0 <= b < b0 + bl else 0     # another card's: unread
        row = {g: tuple({"mixer": {k: v[:, j:j + 1] for k, v in
                                   layer["mixer"].items()}}
                        for layer in layers) for g, layers in pf.items()}
        T.cache_insert(cfg, cache, row, b, LENS[b])
    lengths = np.array(LENS)
    for i in range(STEPS):
        SH.reset_collectives()
        lg, cache = model.decode_step(cache, torch.from_numpy(steps[i]),
                                      torch.from_numpy(lengths))
        counts[f"{key}/committed/{i}"] = [SH.collectives()["calls"],
                                          model.step_collectives(cache)]
        out[f"{key}/committed/{i}"] = model.gather_logits(lg, B)
        lengths = lengths + 1


def _music_uncut_case(weights, rank, mesh, out, counts):
    """musicgen at vocab 130 on 1x4 under ``seqpar``: the codebook
    embedding and head whole on every card (130 does not cut over 4), the
    C lookups' sum kept at the card's rows; prefill logits and one
    whole-batch ``value_and_grad`` (every gradient gathered on rank 0),
    with their collectives and formulas."""
    cfg = _music_uncut()
    tokens, _, _, batches = _inputs(cfg)
    model, _, _, p_specs, _ = _build(cfg, "seqpar", weights, mesh)
    assert model._embed_vocab[0] is None
    SH.reset_collectives()
    lt, _ = model.prefill(torch.from_numpy(tokens))
    counts["uncut/prefill"] = [SH.collectives()["calls"],
                               model.step_collectives(batch=B, seq=P)]
    out["uncut/prefill"] = model.gather_logits(lt, B)
    SH.reset_collectives()
    _, metrics, grads = ST.value_and_grad(cfg, model, _t(batches[0]))
    want = T.train_collectives(model, TB, TS)
    want["all-reduce"] = want.get("all-reduce", 0) + sum(
        bool(r) for r in ST.mesh_plan(model).seq_reduce.values())
    counts["uncut/grads"] = [SH.collectives()["calls"], want]
    out["uncut/vg"] = np.array([float(metrics[k]) for k in
                                ("ce", "z", "lb_loss", "z_loss")])
    for n, g in grads.items():
        whole = SH.gather_whole(g, model.layout, _spec(p_specs, n))
        if rank == 0:
            out[f"uncut/g/{n}"] = whole.numpy().copy()


def _train(cfg, weights, rank, mesh, variant, batches, out, counts, key):
    """One whole-batch gradient, then two train steps on ``mesh``; the
    gradients, metrics, parameters and moments gathered whole on rank 0."""
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
    _whole(model, st, o_specs, rank, out, key)


def _checkpoint(rank, out, out_dir, meshes, weights, batches):
    """musicgen on mesh 1x4: ``to_jax_params`` right after the cut, one
    step, a save; restored on mesh 2x2, gathered whole again."""
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
    """One rank: serving and training of both configs, the records and the
    checkpoint; writes ``rank{rank}.npz`` and its counts."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (4, 2, 1)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        for mname, d, batch in _serve_cases(arch):
            _serve(cfg, weights[arch], meshes[d], batch, out, counts,
                   f"serve/{arch}/{mname}")
        for mname, d, _ in SERVE:
            _serve_sp(cfg, weights[arch], meshes[d], out, counts,
                      f"sp/{arch}/{mname}")
        batches = _inputs(cfg)[3]
        for mname, d, variant in _train_cases(arch):
            _train(cfg, weights[arch], rank, meshes[d], variant, batches,
                   out, counts, f"{arch}/{mname}/{variant}")
    for arch, shape, d in RECORDS:
        dryrun.run_cell(arch, shape, os.path.join(out_dir, "records"),
                        device="cpu", reduced=True, seq_len=64,
                        mesh=meshes[d])
    _checkpoint(rank, out, out_dir, meshes, weights[CKPT],
                _inputs(_cfg(CKPT))[3])
    _music_uncut_case(weights["uncut"], rank, meshes[1], out, counts)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX references, each rank's results and counts, the records,
    the weights, the ranks' directory)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.training import optimizer as JOPT

    weights = {arch: _weights(_cfg(arch), seed)
               for seed, arch in enumerate(ARCHS)}
    weights["uncut"] = _weights(_music_uncut(), 7)
    out_dir = tmp_path_factory.mktemp("ranks")
    ranks_run = torch.multiprocessing.spawn(
        _rank, args=(str(out_dir / "store"), str(out_dir), weights),
        nprocs=WORLD, join=False)
    j_prefill = jax.jit(lambda cfg, p, t, v: JT.prefill(
        cfg, p, t, vision_embeds=v), static_argnums=0)
    j_decode = jax.jit(lambda cfg, p, c, t, l, a: JT.decode_step(
        cfg, p, c, t, l, append=a), static_argnums=(0, 5))
    ref = {}
    for arch in ARCHS:
        cfg_j = jax_get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, weights[arch])
        tokens, vision, steps, batches = _inputs(_cfg(arch))

        def vis(rows):
            return None if vision is None else jnp.asarray(vision[rows])

        logits, _ = j_prefill(cfg_j, params, jnp.asarray(tokens),
                              vis(slice(None)))
        ref[f"{arch}/{B}/prefill"] = np.asarray(logits)
        filled, _ = JT.init_cache(cfg_j, B, MAX_SEQ)
        for b in range(B):
            _, row = j_prefill(cfg_j, params, jnp.asarray(tokens[b:b + 1]),
                               vis(slice(b, b + 1)))
            filled = JT.cache_insert(cfg_j, filled, row, b, LENS[b])
        for mode in ("committed", "append"):
            cache, lengths = filled, np.array(LENS)
            for i in range(STEPS):
                lg, cache = j_decode(cfg_j, params, cache,
                                     jnp.asarray(steps[i]),
                                     jnp.asarray(lengths), mode == "append")
                ref[f"{arch}/{B}/{mode}/{i}"] = np.asarray(lg)
                lengths = lengths + 1
        # a row's prefill and decode do not depend on the other rows: the
        # batch-1 case is held to row 0 of the batch's
        for k in [k for k in ref if isinstance(k, str)
                  and k.startswith(f"{arch}/{B}/")]:
            ref[k.replace(f"/{B}/", "/1/")] = ref[k][:1]
        (_, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True))(
            params, jax.tree.map(jnp.asarray, batches[0]))
        ref[(arch, "vg")] = np.array(
            [float(m[k]) for k in ("ce", "z", "lb_loss", "z_loss")])
        ref[(arch, "g")] = named(jax.tree.map(np.asarray, g))
        p = params
        st = JOPT.init(p, cfg_j.optimizer)
        st["count"] = jnp.int32(COUNT)
        step = jax.jit(JS.build_train_step(cfg_j, n_micro=N_MICRO))
        for i, batch in enumerate(batches):
            p, st, m = step(p, st, jax.tree.map(jnp.asarray, batch))
            ref[(arch, i)] = np.array([float(m[k]) for k in METRICS])
        ref[(arch, "p")] = named(jax.tree.map(np.asarray, p))
        ref[(arch, "s")] = named(jax.tree.map(
            np.asarray, {k: st[k] for k in ("m", "v")}))
        ref[(arch, "count")] = int(st["count"])
    cfg_j = jax_get_config(MUSIC).reduced(vocab=MUSIC_UNCUT)
    params = jax.tree.map(jnp.asarray, weights["uncut"])
    tokens, _, _, batches = _inputs(_music_uncut())
    ref["uncut/prefill"] = np.asarray(j_prefill(
        cfg_j, params, jnp.asarray(tokens), None)[0])
    (_, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batches[0]))
    ref["uncut/vg"] = np.array(
        [float(m[k]) for k in ("ce", "z", "lb_loss", "z_loss")])
    ref["uncut/g"] = named(jax.tree.map(np.asarray, g))
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


SERVE_CASES = [(a, m, n) for a in ARCHS for m, _, n in _serve_cases(a)]


@pytest.mark.parametrize("arch,mesh,batch", SERVE_CASES)
def test_prefill_matches_jax(runs, arch, mesh, batch):
    """Gathered prefill logits ((B, P, V), or (B, P, C, V)) on every rank
    against JAX's prefill with the same vision embeddings."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        got = out[f"serve/{arch}/{mesh}/prefill"]
        assert got.shape == ref[f"{arch}/{batch}/prefill"].shape
        assert _close(got, ref[f"{arch}/{batch}/prefill"])


@pytest.mark.parametrize("arch,mesh,batch", SERVE_CASES)
@pytest.mark.parametrize("mode", ["committed", "append"])
def test_decode_matches_jax(runs, arch, mesh, batch, mode):
    """3 decode steps from slot caches filled by one-row prefills (a cross
    layer's cache written whole, or its card's rows of it): gathered
    logits on every rank against JAX's decode_step."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        for i in range(STEPS):
            assert _close(out[f"serve/{arch}/{mesh}/{mode}/{i}"],
                          ref[f"{arch}/{batch}/{mode}/{i}"]), i


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_collectives_follow_the_formula(runs, arch):
    """Every prefill and decode step made exactly the collectives of
    ``Transformer.step_collectives``: one all-reduce for the codebooks'
    summed lookups, one after every attention layer's ``wo`` (cross ones
    included), and over caches cut by rows the query heads' and the
    partials' all-gathers, a cross layer's too."""
    _, ranks, *_ = runs
    cfg = _cfg(arch)
    for _, counts in ranks:
        keys = [k for k in counts if k.startswith(f"serve/{arch}/")]
        assert len(keys) == len(_serve_cases(arch)) * (1 + 2 * STEPS)
        for key in keys:
            got, want = counts[key]
            assert got == want, key
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    got = ranks[0][1][f"serve/{arch}/1x4/committed/0"][0]
    # the embedding, then wo and w_down a layer; the query heads and the
    # partials a layer
    assert got == {"all-reduce": 1 + 2 * n_attn, "all-gather": 2 * n_attn}


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS
                                       for m, _, _ in SERVE])
def test_seqpar_prefill_and_decode_match_jax(runs, arch, mesh):
    """Under ``seqpar``: the prefill at P tokens (the sequence cut; a
    cross layer's queries over the gathered rows, its K/V the card's batch
    rows of the vision tokens, whole) and at P - 1 (not cut), and 3
    committed decode steps from one-row seqpar prefills' caches, against
    JAX: gathered logits on every rank; every step's collectives the
    formula's, the cut prefill's without an all-reduce."""
    ref, ranks, *_ = runs
    key = f"sp/{arch}/{mesh}"
    for out, counts in ranks:
        for S in SP_PROMPTS:
            assert _close(out[f"{key}/prefill{S}"],
                          ref[f"{arch}/{B}/prefill"][:, :S]), S
            got, want, cut = counts[f"{key}/prefill{S}"]
            assert got == want and cut == (S == P), S
        assert "all-reduce" not in counts[f"{key}/prefill{P}"][0]
        for i in range(STEPS):
            k = f"{key}/committed/{i}"
            assert _close(out[k], ref[f"{arch}/{B}/committed/{i}"]), i
            got, want = counts[k]
            assert got == want, k


def test_codebooks_keep_their_rows_where_the_vocab_is_whole(runs):
    """musicgen at vocab 130 on 1x4 under ``seqpar``: the (C, V, D)
    embedding is whole on every card, so the C lookups' sum is computed
    for every row and the card keeps its rows of the sequence; prefill
    logits, the loss terms and every gradient against JAX, the
    collectives the formula's."""
    ref, ranks, *_ = runs
    for out, counts in ranks:
        assert out["uncut/prefill"].shape == ref["uncut/prefill"].shape
        assert _close(out["uncut/prefill"], ref["uncut/prefill"])
        assert _close(out["uncut/vg"], ref["uncut/vg"])
        for what in ("prefill", "grads"):
            got, want = counts[f"uncut/{what}"]
            assert got == want, what
    out = ranks[0][0]
    assert {k.split("/g/", 1)[1] for k in out
            if k.startswith("uncut/g/")} == set(ref["uncut/g"])
    for name, g in ref["uncut/g"].items():
        assert _close(out[f"uncut/g/{name}"], g), name


TRAIN_CASES = [(a, m, v) for a in ARCHS for m, _, v in _train_cases(a)]


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_gradients_match_jax(runs, arch, mesh, variant):
    """Every leaf's gradient of the whole batch's loss on the mesh, reduced
    and gathered, against ``jax.value_and_grad`` of JAX's ``loss_fn``:
    ``vision_proj``'s (through each card's kv heads, summed over "model"),
    the cross layers' replicated ``wk`` / ``wv`` parts, the codebook
    embedding and head; the loss terms on every rank."""
    ref, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for out, _ in ranks:
        assert _close(out[f"{key}/vg"], ref[(arch, "vg")])
    out = ranks[0][0]
    want = ref[(arch, "g")]
    assert {k.split("/g/", 1)[1] for k in out
            if k.startswith(f"{key}/g/")} == set(want)
    assert ("vision_proj" in want) == (arch == VISION)
    for name, g in want.items():
        assert _close(out[f"{key}/g/{name}"], g), name
        assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_step_matches_jax(runs, arch, mesh, variant):
    """Two sharded steps against JAX's ``build_train_step`` (n_micro 4,
    from count 99; vision embeddings split with the tokens): every metric
    of each step on every rank (equal on all), then every parameter and
    AdamW moment gathered whole."""
    ref, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for i in range(TSTEPS):
        got = [out[f"{key}/metrics{i}"] for out, _ in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), i
        for j, name in enumerate(METRICS):
            assert _close(got[0][j], ref[(arch, i)][j]), (i, name)
    out = ranks[0][0]
    assert int(ref[(arch, "count")]) == COUNT + TSTEPS
    for part in ("p", "s"):
        want = ref[(arch, part)]
        assert {k.split(f"/{part}/", 1)[1] for k in out
                if k.startswith(f"{key}/{part}/")} == set(want)
        for name, w in want.items():
            assert _close(out[f"{key}/{part}/{name}"], w), (part, name)


@pytest.mark.parametrize("arch,mesh,variant", TRAIN_CASES)
def test_train_collectives_follow_the_formula(runs, arch, mesh, variant):
    """Every step on every rank made exactly the collectives of
    ``steps.train_step_collectives``: the cross layers' as the self
    layers', the vision tokens' gradient all-reduce, the vocab-parallel
    codebook loss."""
    _, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for _, counts in ranks:
        for i in range(TSTEPS):
            got, want = counts[f"{key}/{i}"]
            assert got == want, (key, i)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in RECORDS])
def test_mesh_records(runs, arch, shape):
    """``run_cell(..., mesh=)`` on the CPU, reduced at seq 64: ok, 4
    devices, collectives of one step equal to the formula. The vision
    decode record reads a card's rows of each cross cache (16 vision
    tokens cut by rows over "model": 4 a card) beside its rows of each
    self cache, every kv head; the musicgen train record's losses are
    finite."""
    _, _, records, *_ = runs
    rec = records[(arch, shape)]
    assert rec["ok"] is True and rec["devices"] == WORLD
    assert rec["collectives"]["calls"] == rec["collectives_formula"]
    assert rec["flops"] > 0
    cfg = _cfg(arch)
    if shape == "decode_32k":
        assert rec["mesh"] == "cpu_1x4"
        n_cross = sum(s.attn_type == "cross" for s in cfg.layer_specs())
        n_self = cfg.n_layers - n_cross
        kv_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 4
        rows = 64 // WORLD
        assert rec["bytes_by_part"]["kv"] == rec["global_batch"] * kv_tok * (
            n_self * (rows + 1) + n_cross * cfg.n_vision_tokens // WORLD)
    else:
        assert rec["mesh"] == "cpu_2x2"
        assert np.isfinite(rec["losses"]).all()


def test_codebook_cut_and_checkpoint_across_meshes(runs):
    """musicgen's parameters gathered on mesh 1x4 right after the cut equal
    the weights bit for bit (the (C, V, D) embedding and (C, D, V) head
    cut over vocab per codebook); a checkpoint written on 1x4 after a
    step, restored on 2x2, gives the same parameters and AdamW moments
    bit for bit."""
    _, ranks, _, weights, _ = runs
    out = ranks[0][0]
    for name, w in named(weights[CKPT]).items():
        np.testing.assert_array_equal(out[f"ckpt/cut/{name}"],
                                      np.asarray(w, np.float32))
    keys = sorted(k.split("/", 2)[2] for k in out
                  if k.startswith("ckpt/1x4/"))
    assert "p/embed" in keys and "p/lm_head" in keys
    for k in keys:
        np.testing.assert_array_equal(out[f"ckpt/2x2/{k}"],
                                      out[f"ckpt/1x4/{k}"])
