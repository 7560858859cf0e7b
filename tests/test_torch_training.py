"""The port's training path (repro_torch: trainable attention, routing and
MoE gradients, loss_fn, optimizers, the train step, the data copy, the
train loop) vs the JAX package on shared numpy inputs, on the CPU.

Tolerances: the attention twin's outputs, lse and gradients 1e-4 against
JAX's ``flash_attention_trainable`` (tests/test_kernels.py's
``test_flash_vjp_matches_naive_autodiff`` bound); the routing gradient and
the dispatch / combine gradients 1e-5 (fp32, sums in another order);
``loss_fn`` within 1e-5 and every gradient within 1e-5 of the largest
magnitude of its leaf; the optimizers 1e-6 over 5 updates; the train step
1e-5. MoE configs route discretely, so their tests first check that no
router choice sits within ``ROUTER_MARGIN`` of a tie (test_torch_model).

The JAX references are jitted once per config and shared through module
fixtures: XLA compiles are most of this file's time. Tests that need an
NVIDIA card are marked ``cuda`` and skip elsewhere.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.data as j_data
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.launch import steps as JS
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import train as j_train
import repro_torch.training.data as p_data
from repro_torch.tree import named
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import build_train_step
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import TrainConfig, train
from test_torch_core import _code
from test_torch_model import (_check_routes, _numpy_params,  # noqa: F401
                              router_margins)

ATTN_TOL = 1e-4
GRAD_TOL = 1e-5
OPT_TOL = 1e-6
B, S = 2, 16                 # loss_fn / train step batch


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# Attention twin vs flash_attention_trainable
# ---------------------------------------------------------------------------
# B, Sq, Skv, H, KVH, Dh, causal, window, softcap, q_block, kv_block
ATTN_CASES = [
    (2, 64, 64, 4, 2, 16, True, None, None, 16, 32),     # GQA, nq=4, nk=2
    (1, 64, 64, 4, 1, 16, True, 24, None, 16, 16),       # window, nk=4
    (2, 32, 32, 4, 4, 16, True, None, 2.0, 16, 16),      # softcap
    (1, 64, 64, 6, 2, 16, False, 20, 3.0, 32, 16),       # both, not causal
    (1, 64, 32, 4, 2, 16, True, 8, None, 16, 16),        # rows 39.. masked
]


@functools.lru_cache(maxsize=None)
def _j_attention(causal, window, softcap, qb, kb):
    def fwd_vjp(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_trainable(
            q, k, v, causal, window, softcap, qb, kb), q, k, v)
        _, lse = jref._blockwise_fwd_impl(q, k, v, causal, window, softcap,
                                          qb, kb)
        return out, lse, vjp(do)
    return jax.jit(fwd_vjp)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_twin_matches_jax(case):
    Bq, Sq, Skv, H, KVH, Dh, causal, window, cap, qb, kb = case
    rng = np.random.default_rng(Sq + H)
    q = rng.standard_normal((Bq, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((Bq, Skv, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, Skv, KVH, Dh)).astype(np.float32)
    do = rng.standard_normal((Bq, Sq, H, Dh)).astype(np.float32)
    out_j, lse_j, grads_j = _j_attention(causal, window, cap, qb, kb)(
        q, k, v, do)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = ref.FlashAttentionTrainable.apply(qt, kt, vt, causal, window, cap,
                                            qb, kb)
    out.backward(_t(do))
    _, lse = ref.blockwise_fwd_lse(_t(q), _t(k), _t(v), causal=causal,
                                   window=window, softcap=cap, q_block=qb,
                                   kv_block=kb)
    assert _err(out.detach(), out_j) < ATTN_TOL
    assert _err(lse, lse_j) < ATTN_TOL
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert _err(got, want) < ATTN_TOL
    if Sq > Skv:        # rows past Skv + window - 1 attend to nothing
        dead = Skv + window - 1
        assert bool((lse[..., dead:] == ref.NEG_INF).all())
        assert bool((out[:, dead:] == 0).all())
        assert bool((qt.grad[:, dead:] == 0).all())


def test_trainable_attention_dispatch():
    """ops.flash_attention takes the twin only where it is differentiable
    and dense and the blocks divide; under no_grad, or for inputs without
    a gradient, the served path runs as before."""
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((1, 48, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 48, 2, 16)).astype(np.float32))
    qg = q.clone().requires_grad_(True)
    served = ops.flash_attention(q, k, k)
    assert served.grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(qg, k, k).grad_fn is None
    twin = ops.flash_attention(qg, k, k)
    assert type(twin.grad_fn).__name__ == "FlashAttentionTrainableBackward"
    torch.testing.assert_close(twin.detach(), served, rtol=0, atol=1e-6)
    # 600 = 512 + 88 does not divide into 512-row blocks: on the plain path
    # autograd through the blockwise path, as the reference's jnp dispatch
    # does; the trainable path's own forward takes a ragged last block
    q6 = _t(rng.standard_normal((1, 600, 2, 16)).astype(np.float32))
    out6 = ops.flash_attention(q6.requires_grad_(True), q6[:, :, :1].detach(),
                               q6[:, :, :1].detach())
    assert type(out6.grad_fn).__name__ != "FlashAttentionTrainableBackward"
    q6 = q6.detach()
    out_r, lse_r = ref.blockwise_fwd_lse(q6, q6, q6)
    torch.testing.assert_close(out_r, ref.blockwise_attention(q6, q6, q6),
                               rtol=0, atol=1e-5)
    assert lse_r.shape == (1, 2, 1, 600) and bool(torch.isfinite(lse_r).all())


# ---------------------------------------------------------------------------
# Routing gradient
# ---------------------------------------------------------------------------
def _route_loss_j(logits, c, top_k):
    w, _, aux = jref.topk_gating(logits, top_k)
    return jnp.sum(w * c) + aux["lb_loss"] + aux["z_loss"]


j_route_grad = jax.jit(jax.grad(_route_loss_j), static_argnums=2)


@pytest.mark.parametrize("entry,T_,E,k,nb", [
    ("route", 64, 8, 2, 1), ("route", 96, 16, 4, 2), ("gating", 40, 8, 3, 1)])
def test_routing_gradient_matches_jax(entry, T_, E, k, nb):
    rng = np.random.default_rng(T_)
    lg = (rng.standard_normal((T_, E)) * 2).astype(np.float32)
    c = rng.standard_normal((T_, k)).astype(np.float32)
    want = j_route_grad(lg, c, k)
    lt = _t(lg).requires_grad_(True)
    if entry == "route":
        w, *_, aux = ops.moe_route(lt, k, cap=8, nb=nb)
    else:
        w, _, aux = ops.moe_gating(lt, k)
    assert type(w.grad_fn).__name__ == "_RoutedBackward"
    (torch.sum(w * _t(c)) + aux["lb_loss"] + aux["z_loss"]).backward()
    assert _err(lt.grad, want) < GRAD_TOL


# ---------------------------------------------------------------------------
# Gather-only dispatch / combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nb", [None, 3])
def test_dispatch_combine_gradients_match_jax(nb):
    """The reference's custom VJPs, on the capacity path (one block) and
    vmapped over nb blocks, with a cap that drops entries."""
    Tb, K, E, D, cap = 24, 2, 4, 8, 8
    N = nb or 1
    rng = np.random.default_rng(N)
    idx = np.stack([rng.integers(0, E, size=(Tb, K)) for _ in range(N)])
    idx[..., 1] = (idx[..., 0] + 1 + idx[..., 1] % (E - 1)) % E   # distinct
    maps = ref.dispatch_indices(_t(idx), E, cap)
    assert int((maps[0] == E * cap).sum()) > 0          # some entries drop
    x = rng.standard_normal((N, Tb + 1, D)).astype(np.float32)
    x[:, Tb] = 0
    y = rng.standard_normal((N, E * cap + 1, D)).astype(np.float32)
    y[:, E * cap] = 0
    w = rng.random((N, Tb, K)).astype(np.float32)
    d_disp = rng.standard_normal((N, E * cap + 1, D)).astype(np.float32)
    d_out = rng.standard_normal((N, Tb, D)).astype(np.float32)
    slot_of, tos, tks = (np.asarray(m, np.int32) for m in maps)

    def j_both(x, y, w, slot_of, tos, tks):
        disp = JM._dispatch(x, tos, slot_of)
        out = JM._combine(y, w, slot_of, tos, tks)
        return jnp.sum(disp * d_disp[0]) + jnp.sum(out * d_out[0])

    def j_grads(x, y, w):
        if nb is None:
            return jax.grad(j_both, argnums=(0, 1, 2))(
                x[0], y[0], w[0], slot_of[0], tos[0], tks[0])
        f = jax.vmap(lambda x, y, w, s, t, tk, dd, do: jax.grad(
            lambda x, y, w: jnp.sum(JM._dispatch(x, t, s) * dd)
            + jnp.sum(JM._combine(y, w, s, t, tk) * do),
            argnums=(0, 1, 2))(x, y, w))
        return f(x, y, w, slot_of, tos, tks, d_disp, d_out)

    want = jax.jit(j_grads)(x, y, w)
    xt, yt, wt = (_t(a).requires_grad_(True) for a in (x, y, w))
    disp = M._dispatch(xt, maps[1], maps[0])
    out = M._combine(yt, wt, maps[0], maps[1], maps[2])
    (torch.sum(disp * _t(d_disp)) + torch.sum(out * _t(d_out))).backward()
    for got, exp in zip((xt.grad, yt.grad, wt.grad), want):
        assert _err(got.reshape(np.shape(exp)), exp) < GRAD_TOL


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
def _batch(vocab, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(B, S + 1))
    return {"tokens": x[:, :-1].astype(np.int32),
            "labels": x[:, 1:].astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True))


def _port_value_and_grad(cfg, np_params, batch):
    model = T.from_jax_params(cfg, np_params, device="cpu")
    model.requires_grad_(True)
    loss, metrics = T.loss_fn(cfg, model, {k: _t(v) for k, v in
                                           batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, metrics, dict(zip(names, grads))


def _check_loss_and_grads(got, want):
    (loss, metrics, grads), ((loss_j, metrics_j), grads_j) = got, want
    assert abs(float(loss.detach()) - float(loss_j)) < GRAD_TOL
    for k in ("ce", "z", "lb_loss", "z_loss"):
        assert abs(float(metrics[k].detach()) - float(metrics_j[k])) < \
            GRAD_TOL * max(1.0, abs(float(metrics_j[k]))), k
    flat_j = {k: np.asarray(v) for k, v in
              named(jax.tree.map(np.asarray, grads_j)).items()}
    assert set(flat_j) == set(grads)
    for name, g in grads.items():
        scale = max(float(np.abs(flat_j[name]).max()), 1e-30)
        assert _err(g, flat_j[name]) < GRAD_TOL * scale, name


@pytest.fixture(scope="module")
def granite():
    """Reduced granite, its numpy weights and batch, and JAX's loss and
    gradients for the capacity config and the dense oracle."""
    base = jax_get_config("granite-moe-1b-a400m").reduced()
    cfg_c = base
    cfg_d = dataclasses.replace(base, moe_impl="dense")
    params = _numpy_params(base, 4)
    batch = _batch(base.vocab_size)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return {"params": params, "batch": batch,
            "capacity": _j_value_and_grad(cfg_c)(jp, jb),
            "dense": _j_value_and_grad(cfg_d)(jp, jb)}


def test_loss_fn_matches_jax_qwen2():
    cfg_j = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    params = _numpy_params(cfg_j, 3)
    batch = _batch(cfg.vocab_size)
    want = _j_value_and_grad(cfg_j)(jax.tree.map(jnp.asarray, params),
                                    {k: jnp.asarray(v) for k, v in
                                     batch.items()})
    _check_loss_and_grads(_port_value_and_grad(cfg, params, batch), want)


@pytest.mark.parametrize("variant", ["capacity", "capacity16_vs_dense",
                                     "dense"])
def test_loss_fn_matches_jax_granite(variant, granite, router_margins):
    """The capacity path against JAX's; capacity_factor=16 (no token
    dropped) and the dense path against JAX's dense oracle."""
    base = get_config("granite-moe-1b-a400m").reduced()
    cfg = {"capacity": base,
           "capacity16_vs_dense": dataclasses.replace(base,
                                                      capacity_factor=16.0),
           "dense": dataclasses.replace(base, moe_impl="dense")}[variant]
    got = _port_value_and_grad(cfg, granite["params"], granite["batch"])
    _check_routes(cfg, router_margins)
    _check_loss_and_grads(got, granite["capacity" if variant == "capacity"
                                       else "dense"])


def test_check_trainable_raises_for_recurrent_configs():
    """What was a refusal (no scan backward) is now training: check_trainable
    passes every config, the recurrent, vision and codebook ones included;
    a recurrent model's serving prefill (under no_grad) is unchanged, and
    carries no graph, with the parameters' gradients on; a scan with a
    gradient refuses ``state_out`` (training never writes a state in
    place), on the model's call as on ops'."""
    for arch in list_archs():
        T.check_trainable(get_config(arch))
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        cfg = get_config(arch).reduced()
        model = T.Transformer(cfg, device="cpu")
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(1, 12)))
        before, cache_before = model.prefill(tok)
        model.requires_grad_(True)
        after, cache_after = model.prefill(tok)
        assert after.grad_fn is None and torch.equal(before, after)
        flat_b, flat_a = named(cache_before), named(cache_after)
        assert all(torch.equal(flat_b[k], flat_a[k]) for k in flat_b)
        # the train pass writes no state: a recurrent layer's state_out
        # with a gradient raises
        spec = next(iter(cfg.layer_specs()))
        views = model.g0[0].per_layer()[0]
        h = torch.randn(1, 12, cfg.d_model, requires_grad=True)
        state = SSM.init_state(cfg, spec, 1, torch.float32, "cpu")
        mixer = (SSM.mamba_forward if spec.kind == "mamba"
                 else SSM.rwkv_time_mix)
        with pytest.raises(ValueError, match="state_out"):
            mixer(cfg, views["mixer"], h, state, in_place=True)
        out, new = mixer(cfg, views["mixer"], h, state)
        assert out.grad_fn is not None
        assert not any(t.any() for t in state.values())
    T.check_trainable(get_config("granite-moe-1b-a400m"))


def test_serving_unchanged_with_gradients_on():
    """prefill and decode_step run under no_grad: turning the parameters'
    gradients on (as the train step does) changes no logit, and nothing
    they return carries a graph."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = T.from_jax_params(cfg, _numpy_params(
        jax_get_config("granite-moe-1b-a400m").reduced(), 0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 24)))
    before, _ = model.prefill(tok)
    model.requires_grad_(True)
    after, cache = model.prefill(tok)
    assert after.grad_fn is None and torch.equal(before, after)
    step, _ = model.decode_step(T.init_cache(cfg, 1, 32, device="cpu"),
                                tok[:, 0], torch.zeros(1, dtype=torch.int64))
    assert step.grad_fn is None


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_jax(kind):
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": (3,), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = JOPT.init(pj, kind)
    pt = {k: _t(v.copy()) for k, v in params.items()}
    st = OPT.init(pt, kind)
    upd = jax.jit(functools.partial(JOPT.update, kind=kind, lr=0.05))
    for g in grads:
        pj, sj = upd(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj)
        st = OPT.update(pt, {k: _t(v) for k, v in g.items()}, st, kind, 0.05)
    assert int(st["count"]) == int(sj["count"]) == 5
    for k in shapes:
        assert _err(pt[k], pj[k]) < OPT_TOL, k
    tree = OPT.state_to_tree(st, kind)
    flat_j = named(jax.tree.map(np.asarray, sj))
    flat_t = named(tree)
    assert set(flat_j) == set(flat_t)
    for k in flat_j:
        assert _err(flat_t[k], flat_j[k]) < OPT_TOL, k
    back = named(OPT.state_from_tree(tree, kind))
    assert back.keys() == named(st).keys()
    assert all(back[k] is v for k, v in named(st).items())


def test_lr_schedule_matches_jax():
    for step in (0, 1, 50, 100, 101, 5000, 10_000, 20_000):
        want = float(JOPT.lr_schedule(step))
        assert math.isclose(float(OPT.lr_schedule(step)), want,
                            rel_tol=1e-6), step
    assert math.isclose(float(OPT.lr_schedule(torch.tensor(
        100, dtype=torch.int32))), 3e-4, rel_tol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def test_train_step_matches_jax():
    """One step at n_micro 2, from count 99 (lr at its 3e-4 peak, so the
    update is ~1e-4 and the 1e-5 bound on the parameters is a real one)."""
    cfg_j = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    params = _numpy_params(cfg_j, 6)
    batch = _batch(cfg.vocab_size, seed=7)
    pj = jax.tree.map(jnp.asarray, params)
    sj = JOPT.init(pj, "adamw")
    sj["count"] = jnp.int32(99)
    pj, sj, mj = jax.jit(JS.build_train_step(cfg_j, n_micro=2))(
        pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
    model = T.from_jax_params(cfg, params, device="cpu")
    st = OPT.init(dict(model.named_parameters()), "adamw")
    st["count"] = torch.tensor(99, dtype=torch.int32)
    st, m = build_train_step(cfg, n_micro=2)(
        model, st, {k: _t(v) for k, v in batch.items()})
    assert set(m) == {"loss", "grad_norm", "lr", "ce", "z", "lb_loss",
                      "z_loss"} == set(mj)
    for k in ("loss", "grad_norm", "lr", "ce", "z"):      # z ~ 176: relative
        assert abs(float(m[k]) - float(mj[k])) < \
            GRAD_TOL * max(1.0, abs(float(mj[k]))), k
    assert float(m["grad_norm"]) > 1.0            # the clip is exercised
    flat_j = named(jax.tree.map(np.asarray, pj))
    before = named(params)
    after = named(T.to_jax_params(model))     # the JAX params structure
    assert after.keys() == flat_j.keys()
    moved = 0.0
    for name, p in after.items():
        assert _err(p, flat_j[name]) < GRAD_TOL, name
        moved = max(moved, _err(p, before[name]))
    assert moved > 1e-4
    assert int(st["count"]) == int(sj["count"]) == 100


# ---------------------------------------------------------------------------
# The data copy and the train loop
# ---------------------------------------------------------------------------
def test_data_copy_equals_original():
    assert _code(p_data) == _code(j_data)
    assert "src/repro/training/data.py" in p_data.__doc__
    for kw in ({}, {"seed": 3, "structure": False},
               {"n_codebooks": 2, "seed": 1}):
        dc = dict(vocab_size=50, seq_len=12, global_batch=4, **kw)
        dj = j_data.SyntheticDataset(j_data.DataConfig(**dc), 1, 2)
        dp = p_data.SyntheticDataset(p_data.DataConfig(**dc), 1, 2)
        for step in (0, 7):
            bj, bp = dj.batch(step), dp.batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(bp[k], bj[k])


def test_train_loop_first_losses_match_jax():
    """JAX's train() and the port's from the same initial weights (JAX's
    init from PRNGKey(seed), handed over as numpy): the same data stream,
    the first 3 losses within 1e-5."""
    cfg_j = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    tc = dict(steps=3, global_batch=4, seq_len=16, log_every=100)
    want = j_train(cfg_j, JTrainConfig(**tc), log_fn=lambda s: None)
    init = jax.tree.map(np.asarray, JT.init_params(cfg_j,
                                                   jax.random.PRNGKey(0)))
    got = train(cfg, TrainConfig(**tc), device="cpu", init_params=init,
                log_fn=lambda s: None)
    assert got["steps_run"] == 3 and got["step_timer"] == "host_clock"
    assert _err(got["losses"], want["losses"]) < GRAD_TOL
    assert all(np.isfinite(got["step_ms"]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_lse_matches_plain(cuda_device, dtype):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    for H, KVH, Dh, Sq, Skv, window, cap in [
            (12, 2, 128, 1024, 1024, None, None), (16, 8, 64, 1024, 1024,
                                                   128, 30.0),
            (4, 2, 64, 256, 64, 16, None)]:
        q = torch.randn(1, Sq, H, Dh, generator=gen, device=cuda_device
                        ).to(dtype)
        k, v = (torch.randn(1, Skv, KVH, Dh, generator=gen,
                            device=cuda_device).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention(q, k, v, window=window, softcap=cap,
                                      lse=True)
        out_p, lse_p = ref.blockwise_fwd_lse(q, k, v, window=window,
                                             softcap=cap)
        assert float((out.float() - out_p.float()).abs().max()) < tol
        assert float((lse - lse_p).abs().max()) < tol


@pytest.mark.cuda
def test_cuda_attention_function_grads(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.randn(1, 1024, 16, 64, generator=gen, device=cuda_device)
    k, v = (torch.randn(1, 1024, 8, 64, generator=gen, device=cuda_device)
            for _ in range(2))
    do = torch.randn(1, 1024, 16, 64, generator=gen, device=cuda_device)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*got).backward(do)
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention_naive(*want).backward(do)
    for a, b in zip(got, want):
        assert float((a.grad - b.grad).abs().max()) < 1e-4
