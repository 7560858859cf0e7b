"""Training the vision and codebook configs (repro_torch: the trainable
attention with a ragged last block, ``loss_fn`` of llama-3.2-vision-11b
and musicgen-large, the train step, the train loop's vision embeddings)
against the JAX package on shared numpy inputs and weights, on the CPU.

Reduced configs as tests/test_torch_modality.py's: vision has 10 layers
(two periods of one cross and four self-attention layers) and 16 vision
tokens; musicgen 2 layers and C = 4 codebook streams, its labels (B, S,
C) against logits (B, S, C, V).

Tolerances: the attention gradients ``ATTN_TOL``, ``loss_fn``, every
parameter gradient and the train step ``GRAD_TOL``
(tests/test_torch_training.py). The JAX references are jitted once per
config or shape. Tests that need an NVIDIA card are marked ``cuda`` and
skip elsewhere.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import train as j_train
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import (TrainConfig, train,
                                             vision_embeddings)
from repro_torch.tree import named
from test_torch_model import MODALITY_ARCHS, _numpy_params
from test_torch_training import (ATTN_TOL, GRAD_TOL, _check_loss_and_grads,
                                 _err, _j_value_and_grad,
                                 _port_value_and_grad, _t)

B, S = 2, 16


def _batch(cfg, seed):
    """Tokens and next-token labels (B, S), or (B, S, C) with codebooks,
    and a vision config's embeddings (B, Nv, D) fp32, from one rng."""
    rng = np.random.default_rng(seed)
    C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    x = rng.integers(0, cfg.vocab_size, size=(B, S + 1) + C).astype(np.int32)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# The trainable attention with a ragged last block
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _j_blockwise_vjp():
    def vjp(q, k, v, do):
        out, pull = jax.vjp(lambda q, k, v: jref.blockwise_attention(
            q, k, v, causal=False), q, k, v)
        return out, pull(do)
    return jax.jit(vjp)


@pytest.mark.parametrize("Sq,Skv", [(48, 1600), (48, 1601), (600, 1601)])
def test_ragged_block_attention_gradient_matches_jax(Sq, Skv):
    """The trainable attention at the training blocks (512 queries, 1024
    keys) where they do not divide: the vision cross layers' Skv = 1600,
    1601, and a ragged q block too; non-causal, against autodiff of JAX's
    blockwise path (which its dispatch takes there)."""
    rng = np.random.default_rng(Skv + Sq)
    q = rng.standard_normal((1, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, Skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((1, Sq, 4, 16)).astype(np.float32)
    out_j, grads_j = _j_blockwise_vjp()(q, k, v, do)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = ref.FlashAttentionTrainable.apply(
        *leaves, False, None, None, ops.TRAIN_Q_BLOCK, ops.TRAIN_KV_BLOCK)
    out.backward(_t(do))
    assert _err(out.detach(), out_j) < ATTN_TOL
    for leaf, want in zip(leaves, grads_j):
        assert _err(leaf.grad, want) < ATTN_TOL


# ---------------------------------------------------------------------------
# loss_fn and the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_loss_fn_matches_jax_modality(arch):
    """Reduced vision with numpy vision_embeds, reduced musicgen with C = 4
    labels: the loss, its metrics and every parameter gradient, the
    vision projection and the codebook embed and head included."""
    cfg_j = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = _numpy_params(cfg_j, 12)
    batch = _batch(cfg, 13)
    want = _j_value_and_grad(cfg_j)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = _port_value_and_grad(cfg, params, batch)
    _check_loss_and_grads(got, want)
    extra = "vision_proj" if cfg.n_vision_tokens else "lm_head"
    assert float(got[2][extra].abs().max()) > 0


def test_train_step_matches_jax_vision():
    """One step of reduced vision at n_micro 2 (the vision embeddings split
    with the tokens) from count 99, as test_train_step_matches_jax does
    for qwen2: metrics and every parameter after the update."""
    cfg_j = jax_get_config("llama-3.2-vision-11b").reduced()
    cfg = get_config("llama-3.2-vision-11b").reduced()
    params = _numpy_params(cfg_j, 14)
    batch = _batch(cfg, 15)
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
    for k in ("loss", "grad_norm", "lr", "ce", "z"):
        assert abs(float(m[k]) - float(mj[k])) < \
            GRAD_TOL * max(1.0, abs(float(mj[k]))), k
    flat_j = named(jax.tree.map(np.asarray, pj))
    after = named(T.to_jax_params(model))
    assert after.keys() == flat_j.keys()
    for name, p in after.items():
        assert _err(p, flat_j[name]) < GRAD_TOL, name
    assert _err(after["vision_proj"], named(params)["vision_proj"]) > 1e-4
    assert int(st["count"]) == int(sj["count"]) == 100


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------
def test_train_loop_first_losses_match_jax_musicgen():
    """Codebook batches come from the copied data stream, so the port's
    train() and JAX's agree from the same initial weights: the first 3
    losses within 1e-5."""
    cfg_j = jax_get_config("musicgen-large").reduced()
    cfg = get_config("musicgen-large").reduced()
    tc = dict(steps=3, global_batch=2, seq_len=8, log_every=100)
    want = j_train(cfg_j, JTrainConfig(**tc), log_fn=lambda s: None)
    init = jax.tree.map(np.asarray, JT.init_params(cfg_j,
                                                   jax.random.PRNGKey(0)))
    got = train(cfg, TrainConfig(**tc), device="cpu", init_params=init,
                log_fn=lambda s: None)
    assert _err(got["losses"], want["losses"]) < GRAD_TOL


def test_train_loop_vision_embeddings():
    """The train loop draws each step's vision embeddings (global_batch,
    Nv, D) in the config's dtype from (seed, step): the same draw again
    for the same step (a resumed run sees what the uninterrupted one saw),
    another for the next. JAX draws from jax.random, so the loop is
    compared per train step above, not here: it trains, losses finite."""
    cfg = get_config("llama-3.2-vision-11b").reduced()
    tc = TrainConfig(steps=2, global_batch=2, seq_len=8, log_every=100)
    a, b = (vision_embeddings(cfg, tc, 1, "cpu") for _ in range(2))
    assert a.shape == (2, cfg.n_vision_tokens, cfg.d_model)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, vision_embeddings(cfg, tc, 2, "cpu"))
    out = train(cfg, tc, device="cpu", log_fn=lambda s: None)
    assert out["steps_run"] == 2 and all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Skv", [1600, 1601])
def test_cuda_ragged_block_attention_gradient(cuda_device, Skv):
    """The kernel forward with lse inside the trainable attention at the
    vision cross shape, against autograd through ref.attention_naive
    (fp32, 1e-4: chip_smoke.py's attention gradient gate)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(Skv)
    q = torch.randn(1, 512, 32, 128, generator=gen, device=cuda_device)
    k, v = (torch.randn(1, Skv, 8, 128, generator=gen, device=cuda_device)
            for _ in range(2))
    do = torch.randn_like(q)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*got, causal=False).backward(do)
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention_naive(*want, causal=False).backward(do)
    for a, b in zip(got, want):
        assert float((a.grad - b.grad).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_cuda_loss_kernel_vs_plain(cuda_device, arch):
    """Reduced, with heads of 64 (the flash kernel takes 64 and 128): the
    differentiable loss on the kernel path against the plain path."""
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    batch = {k: _t(v).to(cuda_device) for k, v in _batch(cfg, 16).items()}
    losses = []
    for impl in ("cuda", "plain"):
        model = T.Transformer(cfg, device=cuda_device).requires_grad_(True)
        losses.append(float(T.loss_fn(cfg, model, batch, impl=impl)[0]))
    assert abs(losses[0] - losses[1]) < GRAD_TOL * abs(losses[1])
