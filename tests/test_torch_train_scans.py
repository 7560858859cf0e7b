"""Training through the recurrent layers (repro_torch: the trainable WKV6
and Mamba scans, ``loss_fn`` of rwkv6 and Jamba, the train step) against
the JAX package on shared numpy inputs and weights, on the CPU.

Tolerances: the scan Functions' gradients within 1e-5 of each gradient's
largest magnitude, against ``jax.vjp`` through the sequential oracles
(fp32; the port sums in chunks and segments, JAX step by step); ``loss_fn``
and every parameter gradient, and the train step, as
tests/test_torch_training.py (``GRAD_TOL``).

The JAX references are traced with their sequential scan oracles (ops
impl "naive"): JAX's CPU default for WKV6, ``ref.rwkv6_chunked``, clips
its exponents at +-60 and moved the reduced rwkv6 model's logits by 0.0122
(ROADMAP C-ref-5). Each is jitted once and traced inside ``_naive``,
which restores the default in a ``finally``: xdist reuses worker
processes. Tests that need an NVIDIA card are marked ``cuda`` and skip
elsewhere.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.tree import named
from test_torch_model import (_check_routes, _numpy_params,  # noqa: F401
                              _reduced, router_margins)
from test_torch_training import (GRAD_TOL, _batch, _check_loss_and_grads,
                                 _err, _port_value_and_grad, _t)



def _naive(fn):
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


# ---------------------------------------------------------------------------
# The scan Functions' gradients against jax.vjp through the oracles
# ---------------------------------------------------------------------------
def _rwkv_inputs(rng, strong, T):
    """tests/test_kernels.py::test_rwkv6_kernel's distributions; strong
    decays w = exp(-exp(N(0, 1) + 1.5)), median ~0.011 (C1's record),
    down to subnormal numbers."""
    B, H, K = 2, 2, 16         # K: the WKV6 kernel takes 16, 32 and 64
    r, k, v = (rng.standard_normal((B, T, H, K)) * 0.5 for _ in range(3))
    z = rng.standard_normal((B, T, H, K))
    w = np.exp(-np.exp(z + 1.5 if strong else z * 0.5 - 1))
    u = rng.standard_normal((H, K)) * 0.3
    s = rng.standard_normal((B, H, K, K)) * 0.1
    return [x.astype(np.float32) for x in (r, k, v, w, u, s)]


def _ssm_inputs(rng, T):
    B, Din, N = 2, 8, 4
    x = rng.standard_normal((B, T, Din))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Din)))) * 0.1
    A = -np.exp(rng.standard_normal((Din, N)) * 0.3)
    Bm, Cm = (rng.standard_normal((B, T, N)) for _ in range(2))
    D = rng.standard_normal(Din)
    h0 = rng.standard_normal((B, Din, N)) * 0.1
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D, h0)]


@functools.lru_cache(maxsize=None)
def _j_scan_vjp(which):
    fn = {"rwkv": jref.rwkv6_sequential, "ssm": jref.ssm_sequential}[which]

    def vjp(args, d_out, d_state):
        outs, pull = jax.vjp(fn, *args)
        return outs, pull((d_out, d_state))
    return jax.jit(vjp)


# scan, decays, T: 300 is two segments (256 + a ragged 44), 45 one segment
# that is no multiple of a chunk (16, 32, 256)
SCAN_CASES = [("ssm", None, 300), ("ssm", None, 45), ("rwkv", "mild", 300),
              ("rwkv", "strong", 300), ("rwkv", "strong", 45)]


def _scan_inputs(which, decay, T, seed):
    rng = np.random.default_rng(seed)
    return rng, (_rwkv_inputs(rng, decay == "strong", T) if which == "rwkv"
                 else _ssm_inputs(rng, T))


@pytest.mark.parametrize("which,decay,T", SCAN_CASES)
def test_scan_function_gradients_match_jax(which, decay, T):
    rng, args = _scan_inputs(which, decay, T, T + (decay == "strong"))
    d_out = rng.standard_normal(args[2 if which == "rwkv" else 0].shape
                                ).astype(np.float32)
    d_state = rng.standard_normal(args[-1].shape).astype(np.float32)
    (out_j, state_j), grads_j = _j_scan_vjp(which)(tuple(args), d_out,
                                                   d_state)
    fn = {"rwkv": ref.RWKV6ScanTrainable,
          "ssm": ref.SSMScanTrainable}[which]
    leaves = [_t(a).requires_grad_(True) for a in args]
    out, state = fn.apply(*leaves)
    assert _err(out.detach(), out_j) < GRAD_TOL
    assert _err(state.detach(), state_j) < GRAD_TOL
    torch.autograd.backward((out, state), (_t(d_out), _t(d_state)))
    for i, (leaf, want) in enumerate(zip(leaves, grads_j)):
        scale = float(np.abs(want).max())
        assert _err(leaf.grad, want) < GRAD_TOL * scale, i


def test_scan_dispatch_with_a_gradient():
    """ops sends differentiable scans through the Functions (the oracle
    stays autograd for impl="naive") and refuses ``state_out`` there;
    under no_grad the serving paths run as before, ``state_out`` in
    place included."""
    rng = np.random.default_rng(3)
    rw = [_t(a) for a in _rwkv_inputs(rng, False, 45)]
    ss = [_t(a) for a in _ssm_inputs(rng, 45)]
    for scan, args, name in ((ops.rwkv6_scan, rw, "RWKV6ScanTrainable"),
                             (ops.ssm_scan, ss, "SSMScanTrainable")):
        grad = [a.clone().requires_grad_(True) for a in args]
        out, _ = scan(*grad)
        assert type(out.grad_fn).__name__ == f"{name}Backward"
        naive, _ = scan(*grad, impl="naive")
        assert "Trainable" not in type(naive.grad_fn).__name__
        for impl in (None, "naive"):
            with pytest.raises(ValueError, match="state_out"):
                scan(*grad, impl=impl, state_out=torch.empty_like(args[-1]))
        served, st = scan(*args)
        assert served.grad_fn is None
        torch.testing.assert_close(out.detach(), served, rtol=0, atol=1e-6)
        state = args[-1].clone()
        with torch.no_grad():
            _, st2 = scan(*grad[:-1], state, state_out=state)
        assert st2 is state and torch.equal(state, st)


# ---------------------------------------------------------------------------
# loss_fn and the train step of the recurrent configs
# ---------------------------------------------------------------------------
RECURRENT = ["rwkv6-1.6b", "jamba-1.5-large-398b"]


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(cfg):
    return jax.jit(_naive(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True)))


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_fn_matches_jax_recurrent(arch, router_margins):
    """Reduced rwkv6 (2 layers) and Jamba's first 4 layers (Mamba + dense,
    Mamba + MoE, Mamba + dense, attention + MoE; capacity 16): the loss,
    its metrics and every parameter gradient."""
    cfg_j = _reduced(jax_get_config(arch))
    cfg = _reduced(get_config(arch))
    params = _numpy_params(cfg_j, 7)
    batch = _batch(cfg.vocab_size, seed=8)
    want = _j_value_and_grad(cfg_j)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = _port_value_and_grad(cfg, params, batch)
    _check_routes(cfg, router_margins)
    _check_loss_and_grads(got, want)


def test_train_step_matches_jax_rwkv6():
    """One step of reduced rwkv6 at n_micro 2 from count 99 (lr at its
    peak), as tests/test_torch_training.py::test_train_step_matches_jax
    does for qwen2: metrics and every parameter after the update."""
    cfg_j = jax_get_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    params = _numpy_params(cfg_j, 9)
    batch = _batch(cfg.vocab_size, seed=10)
    pj = jax.tree.map(jnp.asarray, params)
    sj = JOPT.init(pj, "adamw")
    sj["count"] = jnp.int32(99)
    pj, sj, mj = jax.jit(_naive(JS.build_train_step(cfg_j, n_micro=2)))(
        pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
    model = T.from_jax_params(cfg, params, device="cpu")
    st = OPT.init(dict(model.named_parameters()), "adamw")
    st["count"] = torch.tensor(99, dtype=torch.int32)
    st, m = build_train_step(cfg, n_micro=2)(
        model, st, {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr", "ce", "z"):
        assert abs(float(m[k]) - float(mj[k])) < \
            GRAD_TOL * max(1.0, abs(float(mj[k]))), k
    flat_j = named(jax.tree.map(np.asarray, pj))
    after = named(T.to_jax_params(model))
    assert after.keys() == flat_j.keys()
    moved = 0.0
    for name, p in after.items():
        assert _err(p, flat_j[name]) < GRAD_TOL, name
        moved = max(moved, _err(p, named(params)[name]))
    assert moved > 1e-4
    assert int(st["count"]) == int(sj["count"]) == 100


# ---------------------------------------------------------------------------
# On the card: the kernel forward inside the Functions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which,decay,T", SCAN_CASES)
def test_cuda_scan_function_gradients(cuda_device, which, decay, T):
    """The Functions with the kernel forward (ops on CUDA tensors) against
    autograd through the port's sequential oracles, fp32, 1e-4 of each
    gradient's largest magnitude (chip_smoke.py's gate)."""
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssm_scan as ss
    _, args = _scan_inputs(which, decay, T, 11)
    fn, kernel, oracle = {
        "rwkv": (ref.RWKV6ScanTrainable, rk.rwkv6_scan, ref.rwkv6_sequential),
        "ssm": (ref.SSMScanTrainable, ss.ssm_scan, ref.ssm_sequential)}[which]
    got = [_t(a).to(cuda_device).requires_grad_(True) for a in args]
    want = [_t(a).to(cuda_device).requires_grad_(True) for a in args]
    outs = fn.apply(*got, kernel)
    ref_outs = oracle(*want)
    cot = [torch.randn_like(o) for o in outs]
    torch.autograd.backward(outs, cot)
    torch.autograd.backward(ref_outs, cot)
    for a, b in zip(got, want):
        scale = float(b.grad.abs().max())
        assert float((a.grad - b.grad).abs().max()) < 1e-4 * scale


@pytest.mark.cuda
def test_cuda_train_step_rwkv6_kernel_vs_plain(cuda_device):
    cfg = get_config("rwkv6-1.6b").reduced()
    batch = {k: _t(v).to(cuda_device) for k, v in
             _batch(cfg.vocab_size).items()}
    losses = []
    for impl in ("cuda", "plain"):
        model = T.Transformer(cfg, device=cuda_device).requires_grad_(True)
        loss, _ = T.loss_fn(cfg, model, batch, impl=impl)
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) < GRAD_TOL * abs(losses[1])
