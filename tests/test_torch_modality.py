"""The port's cross-attention (llama-3.2-vision-11b) and codebook
(musicgen-large) paths against the JAX package's, on the CPU, on shared
numpy weights, tokens and vision embeddings.

Reduced configs: vision has 10 layers (two periods of one cross and four
self-attention layers), d_model 64, 4/2 heads of 16, 16 vision tokens,
vocab 128; musicgen has 2 layers and C = 4 codebook streams.

Tolerances are tests/test_torch_model.py's: 1e-4 max abs on fp32 logits
and cache leaves, where the two packages reduce in different orders; the
attention functions alone 2e-5 (tests/test_kernels.py::_tol). The JAX
entry points are jitted, one compile a shape: every prefill here runs at
(1, P) and every decode at batch 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import accelerators as j_acc
from repro.core import profiler as j_prof
from repro.core import workload as j_wl
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core import accelerators as p_acc
from repro_torch.core import profiler as p_prof
from repro_torch.core import workload as p_wl
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.serving import (EngineConfig, ServingCluster, ServingEngine)
from repro_torch.tree import named

from test_torch_model import MODALITY_ARCHS, _both, _err, _inputs

TOL = 1e-4          # logits and cache leaves (tests/test_torch_model.py)
KERNEL_TOL = 2e-5   # one attention call (tests/test_kernels.py::_tol)
P, LENS, MAX_SEQ, STEPS = 20, (20, 13), 32, 4
SLO = 0.12
j_prefill = jax.jit(lambda cfg, p, t, v: JT.prefill(cfg, p, t,
                                                    vision_embeds=v),
                    static_argnums=0)
j_decode = jax.jit(JT.decode_step, static_argnums=(0, 5))


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _leaves(cache):
    """{(group, position, leaf name): tensor} of a cache in either
    package's structure."""
    return {(g, li, name): leaf
            for g, layers in cache.items()
            for li, layer in enumerate(layers)
            for name, leaf in layer["mixer"].items()}


def _cross_leaves(cfg):
    return [(f"g{gi}", li, name)
            for gi, (period, _) in enumerate(cfg.groups)
            for li, spec in enumerate(period) if spec.attn_type == "cross"
            for name in ("k", "v")]


# ---------------------------------------------------------------------------
# the two attention calls at the cross layers' shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Skv,q_block,kv_block", [
    (20, 16, 20, 16),       # a reduced vision prefill: Sq != Skv
    (64, 48, 32, 16),       # several q and kv tiles
])
def test_plain_cross_attention_matches_jax(Sq, Skv, q_block, kv_block):
    """Non-causal attention with Sq != Skv, the cross layers' prefill: the
    port's plain path (ref.blockwise_attention) against JAX's Pallas kernel
    in interpret mode and JAX's own dispatch on the CPU."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_pallas = jax_flash(jq, jk, jv, causal=False, q_block=q_block,
                         kv_block=kv_block, interpret=True)
    o_jnp = jops.flash_attention(jq, jk, jv, causal=False)
    o_plain = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=False)
    assert _err(o_plain, o_pallas) < KERNEL_TOL
    assert _err(o_plain, o_jnp) < KERNEL_TOL


def test_plain_cross_decode_matches_jax():
    """One token over a whole static cache (every length the vision
    tokens), the cross layers' decode: the port's plain path against JAX's
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7)
    B, Nv, H, KVH, Dh = 2, 16, 4, 2, 16
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, Nv, KVH, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, Nv, KVH, Dh)).astype(np.float32)
    lens = np.full(B, Nv, np.int32)
    o_jax = jax_decode(*map(jnp.asarray, (q, kc, vc, lens)), interpret=True)
    o_plain = ops.decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)))
    assert _err(o_plain, o_jax) < KERNEL_TOL


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_from_jax_params_carries_every_leaf(arch):
    """Every JAX leaf, the vision projection (D, D), the codebook embed
    (C, V, D) and head (C, D, V) included, lands in the port's parameter
    of the same name, shape and value."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=6)
    given = {name: np.asarray(leaf) for name, leaf in
             named(jax.tree.map(np.asarray, params_j)).items()}
    own = dict(model.named_parameters())
    assert set(own) == set(given)
    for name, arr in given.items():
        assert tuple(own[name].shape) == arr.shape, name
        assert np.array_equal(own[name].numpy(), arr), name
    if cfg_t.n_vision_tokens:
        assert own["vision_proj"].shape == (cfg_t.d_model, cfg_t.d_model)
    else:
        C, V, D = cfg_t.n_codebooks, cfg_t.vocab_size, cfg_t.d_model
        assert own["embed"].shape == (C, V, D)
        assert own["lm_head"].shape == (C, D, V)


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_prefill_matches_jax(arch):
    """Prefill logits ((1, P, V), or (1, P, C, V)) and every prefill cache
    leaf, the cross layers' (1, Nv, KVH, Dh) K/V included."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=2)
    tokens, vision = _inputs(cfg_j, np.random.default_rng(3), 1, P)
    lj, cj = j_prefill(cfg_j, params_j, jnp.asarray(tokens), _jnp(vision))
    lt, ct = model.prefill(torch.from_numpy(tokens),
                           vision_embeds=_torch(vision))
    assert lt.shape == lj.shape
    assert _err(lt, lj) < TOL
    leaves_j, leaves_t = _leaves(cj), _leaves(ct)
    assert set(leaves_t) == set(leaves_j)
    for key, leaf in leaves_t.items():
        assert leaf.shape == leaves_j[key].shape, key
        assert _err(leaf, leaves_j[key]) < TOL, key
    for key in _cross_leaves(cfg_t):
        assert leaves_t[key].shape[2] == cfg_t.n_vision_tokens


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_decode_matches_jax(arch, append):
    """Two sequences prefilled one by one (each with its own vision
    embeddings) and inserted into a slot cache, the second cut to 13 of its
    20 tokens: cache_insert writes the cross leaves whole, which seeds the
    cross cache as tests/test_models_smoke.py::_copy_cross does. Then
    STEPS decode steps on fixed tokens ((2,) or (2, C)) against JAX's
    decode_step in the same mode: logits at every step, every cache leaf
    at the end (the cross leaves unchanged by decode)."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=4)
    rng = np.random.default_rng(5)
    cache_j, _ = JT.init_cache(cfg_j, 2, MAX_SEQ)
    cache_t = T.init_cache(cfg_t, 2, MAX_SEQ, device="cpu")
    for slot, L in enumerate(LENS):
        tokens, vision = _inputs(cfg_j, rng, 1, P)
        _, pf_j = j_prefill(cfg_j, params_j, jnp.asarray(tokens),
                            _jnp(vision))
        _, pf_t = model.prefill(torch.from_numpy(tokens),
                                vision_embeds=_torch(vision))
        cache_j = JT.cache_insert(cfg_j, cache_j, pf_j, slot, L)
        T.cache_insert(cfg_t, cache_t, pf_t, slot, L)
    cross_before = {key: _leaves(cache_t)[key].clone()
                    for key in _cross_leaves(cfg_t)}
    lengths = np.asarray(LENS)
    C = cfg_j.n_codebooks
    for _ in range(STEPS):
        toks = rng.integers(0, cfg_j.vocab_size, size=(2, C) if C else 2)
        lj, cache_j = j_decode(cfg_j, params_j, cache_j,
                               jnp.asarray(toks, jnp.int32),
                               jnp.asarray(lengths, jnp.int32), append)
        lt, cache_t = model.decode_step(cache_t, torch.from_numpy(toks),
                                        torch.from_numpy(lengths),
                                        append=append)
        assert lt.shape == lj.shape
        assert _err(lt, lj) < TOL
        lengths = lengths + 1
    leaves_j, leaves_t = _leaves(cache_j), _leaves(cache_t)
    assert set(leaves_t) == set(leaves_j)
    for key, leaf in leaves_t.items():
        assert _err(leaf, leaves_j[key]) < TOL, key
    for key, before in cross_before.items():
        assert torch.equal(leaves_t[key], before), key


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_cache_insert_of_a_cross_leaf(arch):
    """A prefill cache inserted into slot 1 of a zeroed batch-3 cache: a
    cross leaf is written whole (every vision token, however short the
    prompt), a self-attention leaf only up to the prompt's length, and
    slots 0 and 2 stay zero; the same cache as JAX's cache_insert gives."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=8)
    tokens, vision = _inputs(cfg_j, np.random.default_rng(9), 1, P)
    _, pf = model.prefill(torch.from_numpy(tokens),
                          vision_embeds=_torch(vision))
    L = 7
    cache = T.init_cache(cfg_t, 3, MAX_SEQ, device="cpu")
    T.cache_insert(cfg_t, cache, pf, 1, L)
    cache_j, _ = JT.init_cache(cfg_j, 3, MAX_SEQ)
    pf_np = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pf)
    want = _leaves(JT.cache_insert(cfg_j, cache_j, pf_np, 1, L))
    src, got = _leaves(pf), _leaves(cache)
    cross = set(_cross_leaves(cfg_t))
    for key, leaf in got.items():
        assert np.array_equal(leaf.numpy(), np.asarray(want[key])), key
        assert not leaf[:, 0].any() and not leaf[:, 2].any(), key
        if key in cross:
            assert torch.equal(leaf[:, 1], src[key][:, 0]), key
        else:
            assert torch.equal(leaf[:, 1, :L], src[key][:, 0, :L]), key
            assert not leaf[:, 1, L:].any(), key
    # one cross position a period: its k and v, stacked over 2 repeats
    assert len(cross) == (2 if cfg_t.n_vision_tokens else 0)


def test_vision_prefill_needs_embeds():
    """As the reference asserts: a vision model's prefill without
    vision_embeds raises."""
    _, cfg, _, model = _both("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="vision_embeds"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the one-card dry-run record and the engine
# ---------------------------------------------------------------------------
CPU_SEQ = 64        # the CPU run's context length (the case's is 32768)


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_run_cell_decode_32k(arch, tmp_path):
    """run_cell at decode_32k on the CPU: the record's operation count
    equals, exactly, 2 x the matmul parameters a decode step uses x batch
    (a cross layer projects only q and its output: its K/V is cached; the
    unembed C x D x V) + per self-attention layer 4 H Dh S + 2 H Dh and per
    cross layer 4 H Dh Nv a sequence; its bytes read each cross layer's Nv
    cached tokens and write C logits rows a sequence; and it feeds both
    packages' profile_from_dryrun alike."""
    rec = dryrun.run_cell(arch, "decode_32k", tmp_path, device="cpu",
                          reduced=True, seq_len=CPU_SEQ)
    cfg = get_config(arch).reduced()
    assert rec["ok"] is True and rec["kind"] == "decode"
    assert rec["reduced"] == {"seq_len": [32768, CPU_SEQ]}
    assert rec["n_params"] == jax_get_config(arch).reduced().param_count()
    B, S = rec["global_batch"], rec["seq_len"]
    H, Dh, Nv = cfg.n_heads, cfg.head_dim, cfg.n_vision_tokens
    C = max(cfg.n_codebooks, 1)
    Vp = T._padded_vocab(cfg)
    model = T.Transformer(cfg, device="meta")
    matmul = C * cfg.d_model * Vp                      # the unembed
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] not in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                             "w_down"):
            continue
        spec = cfg.groups[int(parts[0][1:])][0][int(parts[1])]
        if not (parts[-1] in ("wk", "wv") and spec.attn_type == "cross"):
            matmul += p.numel()
    n_self = sum(s.kind == "attn" and s.attn_type != "cross"
                 for s in cfg.layer_specs())
    n_cross = sum(s.attn_type == "cross" for s in cfg.layer_specs())
    want = 2 * matmul * B + n_self * B * (4 * H * Dh * S + 2 * H * Dh) \
        + n_cross * B * 4 * H * Dh * Nv
    assert rec["flops"] == rec["flops_tc"] == want
    kv_tok = 2 * cfg.n_kv_heads * Dh * 4                # fp32 K and V
    parts = rec["bytes_by_part"]
    assert parts["kv"] == B * kv_tok * (n_self * (S + 1) + n_cross * Nv)
    assert parts["logits"] == B * C * Vp * 4
    assert n_cross == (2 if cfg.n_vision_tokens else 0)
    jp = j_prof.profile_from_dryrun(j_acc.PAPER_GPUS, j_wl.bucket_grid(),
                                    jax_get_config(arch).reduced(), rec, SLO)
    pp = p_prof.profile_from_dryrun(p_acc.PAPER_GPUS, p_wl.bucket_grid(),
                                    cfg, rec, SLO)
    assert pp.to_json() == jp.to_json()
    assert pp.max_tput["H100"].any()


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_engine_refuses(arch):
    """The reference engine can serve neither config (its prefill takes no
    vision_embeds, it samples one token a step), so the port's engine and
    cluster refuse both at construction, on any device."""
    cfg = get_config(arch).reduced()
    model = T.Transformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="reference engine"):
        ServingEngine(cfg, model, EngineConfig(max_batch=2, max_seq=32),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="reference engine"):
        ServingCluster(cfg, model, {"H100": 1}, None,
                       EngineConfig(max_batch=2, max_seq=32), device="cpu")
