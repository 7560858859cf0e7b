"""The port's sharded train step on 4 gloo ranks on the CPU, against the JAX
package's single-device ``build_train_step``.

One spawn of 4 ranks for the module (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory: no TCP port), handed
the shared numpy weights. The JAX references are jitted in the parent
while the ranks run, one per config and variant family (qwen2's n_micro 4
in fp32 and n_micro 8 with bf16 accumulators, gemma2's n_micro 4); this
module imports nothing at its top that imports JAX (the ranks import it to
find ``_rank``).

Reduced qwen2-1.5b (tied embeddings, biases, 4 / 2 heads) and gemma2-27b
(local and global layers, softcaps, post norms) at B 8, S 32 take two steps
from count 99 (lr at its peak, so the 1e-5-scale parameter bound bites) on
the meshes 4x1, 2x2 and 1x4 (1x4: 2 kv heads over 4 cards, ``wk`` / ``wv``
replicated and their gradients summed over "model"), under ``baseline``,
``fsdp`` (qwen2 and gemma2) and ``micro8+bf16grad`` (qwen2). Held to JAX:
the loss and grad norm of each step (the same on every rank), every
parameter and both moments after the two steps, gathered whole, within
fp32's 2e-5 and, under ``bf16grad``, bf16's 2e-2 (tests/test_kernels.py::
_tol) of the reference's magnitude where it exceeds 1; the collectives of
each step equal to ``steps.train_step_collectives``.

Also: each differentiable collective's forward and backward against its
definition over the ranks' inputs; the vocab-parallel loss (vocab 120
padded to 128, gemma2's final softcap) and its gradients against the
one-process ``loss_fn``; 4x1 at B 16 (one row a card a microbatch) against
the one-process port; a checkpoint written on mesh 2x2 restored on mesh
1x4 and on one process, which continue with equal losses, and read by
JAX's ``Checkpointer``: qwen2's with AdamW moments, and reduced kimi-k2's
(expert leaves, Adafactor factors sliced over the mesh).
"""
import dataclasses
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
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named, nest
from test_torch_distributed import _weights

WORLD = 4
B, S, STEPS, COUNT = 8, 32, 2, 99
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py
ARCHS = ("qwen2-1.5b", "gemma2-27b")
MESHES = (("4x1", 4), ("2x2", 2), ("1x4", 1))    # name, data
VARIANTS = {"qwen2-1.5b": ("baseline", "fsdp", "micro8+bf16grad"),
            "gemma2-27b": ("baseline", "fsdp")}
METRICS = ("loss", "grad_norm", "lr", "ce", "z")
# the differentiable collectives, each over these entries of mesh 2x2
FUNCTIONS = ("copy_to", "reduce_from", "gather_from", "gather_scatter",
             "reduce_scatter")
ENTRIES = ("model", "data", ("data", "model"))
LOSS_MESHES = (("2x2", 2), ("1x4", 1))
CKPT_STEP = 1
CKPT_ARCHS = ("qwen2-1.5b", "kimi-k2-1t-a32b")   # AdamW, Adafactor


def _family(variant):
    """The JAX reference a variant is held to: (n_micro, grad dtype)."""
    return (8, "bfloat16") if "micro8" in variant else (4, "float32")


def _batches(cfg, n=B, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.integers(0, cfg.vocab_size, size=(n, S + 1))
        out.append({"tokens": x[:, :-1].astype(np.int32),
                    "labels": x[:, 1:].astype(np.int32)})
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_cfg():
    """gemma2's reduced config with a padded vocabulary: 120 rows padded
    to 128 (16 or 32 a card), its final softcap kept."""
    return dataclasses.replace(get_config("gemma2-27b").reduced(),
                               vocab_size=120, vocab_pad_to=128)


def _build(cfg, variant, weights, mesh, batch=B):
    """(model, opt state at count 99, train step, opt specs) of the train
    cell on ``mesh`` (None: one process)."""
    case = ShapeCase("t", "train", S, batch)
    out = ST.build_cell(cfg, case, "cpu", variant, mesh=mesh)
    rules = out[3] if mesh is not None else None
    model = T.from_jax_params(cfg, weights, device="cpu", mesh=mesh,
                              rules=rules)
    st = ST.init_opt_state(model)
    st["count"] = torch.tensor(COUNT, dtype=torch.int32)
    o_specs = out[4]["opt_state"] if mesh is not None else None
    p_specs = out[4]["params"] if mesh is not None else None
    return model, st, out[0], p_specs, o_specs


def _whole(model, st, p_specs, o_specs):
    """{name: whole parameter}, {"m"/"v": {name: whole moment}} (every
    rank gathers: a collective); the whole moments cut back by
    ``state_from_tree`` are the card's own."""
    cfg = model.cfg
    params = {n: SH.gather_whole(p.detach(), model.layout,
                                 _spec(p_specs, n))
              for n, p in model.named_parameters()}
    tree = OPT.state_to_tree(st, cfg.optimizer, specs=o_specs,
                             layout=model.layout)
    back = OPT.state_from_tree(tree, cfg.optimizer, specs=o_specs,
                               layout=model.layout)
    assert all(torch.equal(back[k][n], st[k][n]) for k in ("m", "v")
               for n in st[k]), "state_from_tree(state_to_tree(...))"
    return params, {k: named(tree[k]) for k in ("m", "v")}


def _spec(specs, name):
    node = specs
    for p in name.split("."):
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def _collective(fn, x, lay, entry):
    return {"copy_to": lambda: SH.copy_to(x, lay, entry),
            "reduce_from": lambda: SH.reduce_from(x, lay, entry),
            "gather_from": lambda: SH.gather_from(x, lay, entry, 1),
            "gather_scatter": lambda: SH.gather_from(x, lay, entry, 1,
                                                     scatter=True),
            "reduce_scatter": lambda: SH.reduce_scatter(x, lay, entry, 1),
            }[fn]()


def _rank(rank, store_path, out_dir, weights):
    """One rank: the train cells, the collectives, the loss, the 4x1 B 16
    run and the checkpoint; writes ``rank{rank}.npz`` and its counts."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    meshes = {d: MESH.make_mesh(WORLD, d, device="cpu") for d in (4, 2, 1)}
    out, counts = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        batches = _batches(cfg)
        for mname, d in MESHES:
            for variant in VARIANTS[arch]:
                key = f"{arch}/{mname}/{variant}"
                model, st, fn, p_specs, o_specs = _build(
                    cfg, variant, weights[arch], meshes[d])
                for i, batch in enumerate(batches):
                    SH.reset_collectives()
                    st, m = fn(model, st, _t(batch))
                    out[f"{key}/metrics{i}"] = np.array(
                        [float(m[k]) for k in METRICS])
                    counts[f"{key}/{i}"] = [
                        SH.collectives()["calls"],
                        ST.train_step_collectives(model, B,
                                                  _family(variant)[0])]
                params, moments = _whole(model, st, p_specs, o_specs)
                if rank == 0:
                    for n, p in params.items():
                        out[f"{key}/p/{n}"] = p.float().numpy().copy()
                    for k, leaves in moments.items():
                        for n, t in leaves.items():
                            out[f"{key}/{k}/{n}"] = t.numpy()
                    out[f"{key}/count"] = np.array(int(st["count"]))
    # the differentiable collectives on mesh 2x2
    lay = SH.Layout.of(meshes[2])
    g = torch.Generator().manual_seed(rank)
    for fn in FUNCTIONS:
        for ei, entry in enumerate(ENTRIES):
            x = torch.randn((2, 8, 3), generator=g).requires_grad_(True)
            y = _collective(fn, x, lay, entry)
            w = torch.randn(y.shape, generator=g)
            (y * w).sum().backward()
            for k, v in (("x", x), ("y", y), ("w", w), ("dx", x.grad)):
                out[f"coll/{fn}/{ei}/{k}"] = v.detach().numpy()
    # the vocab-parallel loss
    cfg = _loss_cfg()
    batch = _t(_batches(cfg, seed=9)[0])
    for mname, d in LOSS_MESHES:
        model, _, _, p_specs, _ = _build(cfg, "baseline", weights["loss"],
                                         meshes[d])
        loss, metrics, grads = ST.value_and_grad(cfg, model, batch)
        out[f"loss/{mname}/metrics"] = np.array(
            [float(loss), float(metrics["ce"]), float(metrics["z"])])
        for n, gr in grads.items():
            out[f"loss/{mname}/g/{n}"] = SH.gather_whole(
                gr, model.layout, _spec(p_specs, n)).numpy()
    # 4x1 at B 16: a row a card a microbatch
    cfg = get_config("qwen2-1.5b").reduced()
    model, st, fn, p_specs, o_specs = _build(
        cfg, "baseline", weights["qwen2-1.5b"], meshes[4], batch=16)
    for i, batch in enumerate(_batches(cfg, n=16, seed=11)):
        st, m = fn(model, st, _t(batch))
        out[f"b16/metrics{i}"] = np.array([float(m[k]) for k in METRICS])
    params, _ = _whole(model, st, p_specs, o_specs)
    for n, p in params.items():
        out[f"b16/p/{n}"] = p.numpy().copy()
    for arch in CKPT_ARCHS:
        _checkpoint(rank, out, out_dir, meshes, weights[arch], arch)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


def _state_tree(model, st):
    return {"params": T.param_tree(model),
            "opt": OPT.state_to_tree(st, model.cfg.optimizer)}


def _spec_tree(p_specs, o_specs, kind):
    return {"params": p_specs, "opt": OPT.state_to_tree(o_specs, kind)}


def _load(model, st, restored):
    """The restored tree into ``model``'s parameters and a state."""
    for n, p in model.named_parameters():
        p.data.copy_(named(restored["params"])[n])
    return OPT.state_from_tree(restored["opt"], model.cfg.optimizer)


def _checkpoint(rank, out, out_dir, meshes, weights, arch):
    """``arch`` on mesh 2x2: one step, a save from the mesh, a second step;
    the save restored on mesh 1x4, which takes the second step too."""
    cfg = get_config(arch).reduced()
    b1, b2 = _batches(cfg, seed=13)
    ckpt = Checkpointer(os.path.join(out_dir, f"ckpt-{arch}"),
                        async_save=False)
    model, st, fn, p_specs, o_specs = _build(cfg, "baseline", weights,
                                             meshes[2])
    st, _ = fn(model, st, _t(b1))
    ckpt.save(CKPT_STEP, _state_tree(model, st),
              shardings=_spec_tree(p_specs, o_specs, cfg.optimizer),
              mesh=meshes[2])
    params = T.to_jax_params(model)
    if rank == 0:
        for n, p in named(params).items():
            out[f"ckpt/{arch}/p/{n}"] = p.copy()   # before the next step
    _, m = fn(model, st, _t(b2))
    out[f"ckpt/{arch}/loss/2x2"] = np.array(float(m["loss"]))
    model, st, fn, p_specs, o_specs = _build(cfg, "baseline", weights,
                                             meshes[1])
    restored = ckpt.restore(
        CKPT_STEP, _state_tree(model, st),
        shardings=_spec_tree(p_specs, o_specs, cfg.optimizer),
        mesh=meshes[1])
    st = _load(model, st, restored)
    _, m = fn(model, st, _t(b2))
    out[f"ckpt/{arch}/loss/1x4"] = np.array(float(m["loss"]))
    out[f"ckpt/{arch}/count"] = np.array(int(restored["opt"]["count"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX and one-process references, each rank's results and
    counts, the checkpoint's directory)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import steps as JS
    from repro.training import optimizer as JOPT

    weights = {arch: _weights(get_config(arch).reduced(), seed)
               for seed, arch in enumerate(ARCHS)}
    weights["loss"] = _weights(_loss_cfg(), 7)
    weights["kimi-k2-1t-a32b"] = _weights(
        get_config("kimi-k2-1t-a32b").reduced(), 8)
    out_dir = tmp_path_factory.mktemp("ranks")
    # the ranks run while the parent computes the references
    ranks_run = torch.multiprocessing.spawn(
        _rank, args=(str(out_dir / "store"), str(out_dir), weights),
        nprocs=WORLD, join=False)
    ref = {}
    for arch in ARCHS:
        cfg_j = jax_get_config(arch).reduced()
        batches = _batches(get_config(arch).reduced())
        families = {_family(v) for v in VARIANTS[arch]}
        for nm, gd in sorted(families):
            params = jax.tree.map(jnp.asarray, weights[arch])
            st = JOPT.init(params, "adamw")
            st["count"] = jnp.int32(COUNT)
            step = jax.jit(JS.build_train_step(
                cfg_j, n_micro=nm, grad_dtype=getattr(jnp, gd)))
            for i, batch in enumerate(batches):
                params, st, m = step(params, st, jax.tree.map(jnp.asarray,
                                                              batch))
                ref[(arch, nm, i)] = np.array([float(m[k]) for k in
                                               METRICS])
            ref[(arch, nm, "p")] = named(jax.tree.map(np.asarray, params))
            ref[(arch, nm, "m")] = named(jax.tree.map(np.asarray, st["m"]))
            ref[(arch, nm, "v")] = named(jax.tree.map(np.asarray, st["v"]))
            ref[(arch, nm, "count")] = int(st["count"])
    # one-process port references: the loss, 4x1 at B 16
    cfg = _loss_cfg()
    model, *_ = _build(cfg, "baseline", weights["loss"], None)
    loss, metrics, grads = ST.value_and_grad(
        cfg, model, _t(_batches(cfg, seed=9)[0]))
    ref["loss"] = (np.array([float(loss), float(metrics["ce"]),
                             float(metrics["z"])]),
                   {n: g.numpy() for n, g in grads.items()})
    cfg = get_config("qwen2-1.5b").reduced()
    model, st, fn, *_ = _build(cfg, "baseline", weights["qwen2-1.5b"], None,
                               batch=16)
    for i, batch in enumerate(_batches(cfg, n=16, seed=11)):
        st, m = fn(model, st, _t(batch))
        ref[("b16", i)] = np.array([float(m[k]) for k in METRICS])
    ref["b16/p"] = {n: p.detach().numpy().copy()
                    for n, p in model.named_parameters()}
    while not ranks_run.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            counts = json.load(f)
        ranks.append((dict(np.load(out_dir / f"rank{r}.npz")), counts))
    return ref, ranks, weights, out_dir


def _close(got, want, tol) -> bool:
    """Within ``tol`` of the reference, scaled by its magnitude above 1."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64) - want),
                        initial=0.0)) <= tol * scale


CASES = [(arch, m, v) for arch in ARCHS for m, _ in MESHES
         for v in VARIANTS[arch]]


@pytest.mark.parametrize("arch,mesh,variant", CASES)
def test_train_step_matches_jax(runs, arch, mesh, variant):
    """Two sharded steps against JAX's single-device ``build_train_step``:
    loss, grad norm, lr, ce and z of each step on every rank (equal on
    all), then every parameter and both moments, gathered whole."""
    ref, ranks, *_ = runs
    nm, gd = _family(variant)
    tol = TOL[gd]
    key = f"{arch}/{mesh}/{variant}"
    for i in range(STEPS):
        got = [out[f"{key}/metrics{i}"] for out, _ in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), i
        for j, name in enumerate(METRICS):
            assert _close(got[0][j], ref[(arch, nm, i)][j], tol), (i, name)
    assert float(ref[(arch, nm, 0)][1]) > 1.0     # the clip is exercised
    out = ranks[0][0]
    assert int(out[f"{key}/count"]) == ref[(arch, nm, "count")] == \
        COUNT + STEPS
    for part in ("p", "m", "v"):
        want = ref[(arch, nm, part)]
        assert {k.split("/", 4)[-1] for k in out
                if k.startswith(f"{key}/{part}/")} == set(want)
        for name, w in want.items():
            assert _close(out[f"{key}/{part}/{name}"], w, tol), (part, name)


@pytest.mark.parametrize("arch,mesh,variant", CASES)
def test_train_collectives_follow_the_formula(runs, arch, mesh, variant):
    """Every step on every rank made exactly the collectives of
    ``steps.train_step_collectives``: none of a kind the layout does not
    need (4x1 all-reduces no activation; 1x4 reduce-scatters nothing)."""
    _, ranks, *_ = runs
    key = f"{arch}/{mesh}/{variant}"
    for _, counts in ranks:
        for i in range(STEPS):
            got, want = counts[f"{key}/{i}"]
            assert got == want, (key, i)
    got = ranks[0][1][f"{key}/0"][0]
    assert ("reduce-scatter" in got) == (variant == "fsdp"
                                         and mesh != "1x4")


def _groups(entry):
    """The ranks of mesh 2x2 (rank = 2 data + model) in each group along
    ``entry``, each in shard order."""
    axes = SH.entry_axes(entry)
    if axes == ("model",):
        return [[0, 1], [2, 3]]
    if axes == ("data",):
        return [[0, 2], [1, 3]]
    return [[0, 1, 2, 3]]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_collective_backward(runs, fn):
    """Each differentiable collective over "model", "data" and both axes
    of mesh 2x2: its output and its input's gradient, for the loss
    sum(w_r * y_r), against its definition over the ranks' x_r and w_r."""
    _, ranks, *_ = runs
    for ei, entry in enumerate(ENTRIES):
        def get(r, k):
            return ranks[r][0][f"coll/{fn}/{ei}/{k}"]

        for group in _groups(entry):
            k = len(group)
            xs = np.stack([get(r, "x") for r in group])
            ws = [get(r, "w") for r in group]
            for i, r in enumerate(group):
                n = xs.shape[2]       # the cut dim (1) of x
                if fn == "copy_to":
                    y, dx = xs[i], sum(ws)
                elif fn == "reduce_from":
                    y, dx = xs.sum(0), ws[i]
                elif fn == "gather_from":
                    y = np.concatenate(list(xs), axis=1)
                    dx = ws[i][:, i * n:(i + 1) * n]
                elif fn == "gather_scatter":
                    y = np.concatenate(list(xs), axis=1)
                    dx = sum(w[:, i * n:(i + 1) * n] for w in ws)
                else:
                    m = n // k
                    y = xs.sum(0)[:, i * m:(i + 1) * m]
                    dx = np.concatenate(ws, axis=1)
                np.testing.assert_allclose(get(r, "y"), y, rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(get(r, "dx"), dx, rtol=1e-6,
                                           atol=1e-6)


@pytest.mark.parametrize("mesh", [m for m, _ in LOSS_MESHES])
def test_vocab_parallel_loss_matches_one_process(runs, mesh):
    """``loss_fn`` over logits sharded by vocab (120 rows padded to 128,
    the final softcap before the max) and every gradient, reduced over the
    mesh and gathered, against the one-process loss and gradients."""
    ref, ranks, *_ = runs
    want, grads = ref["loss"]
    for out, _ in ranks:
        assert _close(out[f"loss/{mesh}/metrics"], want, TOL["float32"])
    out = ranks[0][0]
    for name, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        got = out[f"loss/{mesh}/g/{name}"]
        assert float(np.abs(got - g).max()) <= TOL["float32"] * max(
            1.0, scale), name


def test_data_parallel_rows_match_one_process(runs):
    """Mesh 4x1 at B 16: a row a card in each of the 4 microbatches (rank
    r's row i is global row 4 i + r), two steps against one process."""
    ref, ranks, *_ = runs
    for out, _ in ranks:
        for i in range(STEPS):
            assert _close(out[f"b16/metrics{i}"], ref[("b16", i)],
                          TOL["float32"]), i
    out = ranks[0][0]
    for name, p in ref["b16/p"].items():
        assert _close(out[f"b16/p/{name}"], p, TOL["float32"]), name


def test_checkpoint_across_meshes(runs):
    """A checkpoint saved on mesh 2x2 after one step holds whole leaves
    (JAX's ``Checkpointer`` reads them: the parameters equal the mesh's,
    gathered, and the optimizer state has the reference's structure);
    restored on mesh 1x4 and on one process, the second step's loss equals
    the one mesh 2x2 took on. qwen2 with AdamW moments; reduced kimi-k2
    with its experts over "model" and Adafactor's factors sliced."""
    from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
    _, ranks, weights, out_dir = runs
    out = ranks[0][0]
    for arch in CKPT_ARCHS:
        ckpt_dir = out_dir / f"ckpt-{arch}"
        cfg = get_config(arch).reduced()
        want = float(out[f"ckpt/{arch}/loss/2x2"])
        for o, _ in ranks:
            assert np.array_equal(o[f"ckpt/{arch}/loss/2x2"],
                                  out[f"ckpt/{arch}/loss/2x2"])
            assert abs(float(o[f"ckpt/{arch}/loss/1x4"]) - want) <= \
                TOL["float32"] * max(1.0, abs(want))
            assert int(o[f"ckpt/{arch}/count"]) == COUNT + CKPT_STEP
        model, st, fn, *_ = _build(cfg, "baseline", weights[arch], None)
        st = _load(model, st, Checkpointer(ckpt_dir).restore(
            CKPT_STEP, _state_tree(model, st)))
        _, b2 = _batches(cfg, seed=13)
        _, m = fn(model, st, _t(b2))
        assert abs(float(m["loss"]) - want) <= TOL["float32"] * max(
            1.0, abs(want))
        zeros = {n: np.zeros(p.shape, np.float32) for n, p in
                 model.named_parameters()}
        state = OPT.init({n: torch.from_numpy(z) for n, z in zeros.items()},
                         cfg.optimizer)
        like = {"params": nest(zeros),
                "opt": OPT.state_to_tree(
                    {k: ({n: {s: t.numpy() for s, t in v.items()}
                          for n, v in st_k.items()}
                         if cfg.optimizer == "adafactor" else
                         {n: t.numpy() for n, t in st_k.items()})
                     if k != "count" else np.zeros((), np.int32)
                     for k, st_k in state.items()}, cfg.optimizer)}
        got = JCheckpointer(ckpt_dir).restore(CKPT_STEP, like)
        assert int(got["opt"]["count"]) == COUNT + CKPT_STEP
        for name, p in named(got["params"]).items():
            np.testing.assert_array_equal(np.asarray(p),
                                          out[f"ckpt/{arch}/p/{name}"])
