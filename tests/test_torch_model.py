"""Port model (repro_torch.models) vs the JAX package's model on shared
numpy weights and tokens, on the CPU, at the reduced configs.

Tolerance 1e-4 max abs on fp32 logits: the two CPU paths reduce in
different orders (matmul blocking, online vs one-pass softmax, chunked vs
associative scans). MoE configs route discretely, so their tests first
check that no router choice in the port's run sits within ROUTER_MARGIN of
a tie: a choice that flips between the two packages would fail as a router
near-tie, not as a float error.

Jamba is reduced to the first 4 layers of its period, the prefix that
chip_smoke.py serves at full width (Mamba with a dense MLP, Mamba with MoE,
Mamba with a dense MLP, attention with MoE: every layer kind it has), with
capacity_factor=16 as in tests/test_models_smoke.py so prefill and decode
drop no token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

TOL = 1e-4
ROUTER_MARGIN = 1e-5     # >> the ~1e-7 the packages' router probs differ by
PARITY_ARCHS = ["qwen2-1.5b", "internlm2-1.8b", "gemma2-27b", "minitron-4b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
RECURRENT_ARCHS = ["rwkv6-1.6b", "jamba-1.5-large-398b"]
# cross-attention over vision tokens; codebook streams (JAX decode parity:
# tests/test_torch_modality.py)
MODALITY_ARCHS = ["llama-3.2-vision-11b", "musicgen-large"]
PREFILL_LENS = (40, 23)   # prompt lengths of the slot-cache tests
# the JAX entry points, jitted (config static): one compile per shape
j_forward = jax.jit(lambda cfg, p, t, v=None: JT.forward(
    cfg, p, t, vision_embeds=v)[0], static_argnums=0)
j_prefill = jax.jit(JT.prefill, static_argnums=0)
j_decode = jax.jit(lambda cfg, p, c, t, l: JT.decode_step(
    cfg, p, c, t, l, append=False), static_argnums=0)


def _prefill_sequential_scans(cfg, params, tokens):
    """JAX's prefill with its sequential scan oracles (ops impl "naive",
    set while the function is traced). Its default CPU path for RWKV6,
    ref.rwkv6_chunked, clips its exponents at +-60 and is wrong under
    strong decays (ROADMAP C1), which the port's plain path does not copy."""
    prev = jops._DEFAULT_IMPL
    jops.set_default_impl("naive")
    try:
        return JT.prefill(cfg, params, tokens)
    finally:
        jops.set_default_impl(prev)


j_prefill_oracle = jax.jit(_prefill_sequential_scans, static_argnums=0)


def jax_prefill(cfg, params, tokens):
    """The JAX prefill the port is held to: ``j_prefill``, or for configs
    with RWKV6 layers ``j_prefill_oracle``."""
    rwkv = any(spec.kind == "rwkv" for spec in cfg.layer_specs())
    return (j_prefill_oracle if rwkv else j_prefill)(cfg, params, tokens)


def _numpy_params(cfg, seed):
    """Random weights shaped like the JAX init, drawn from numpy: norms
    near 1, biases non-zero (the JAX init zeroes them), matrices scaled by
    fan-in."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        x = rng.standard_normal(shape).astype(np.float32)
        if "norm" in name:
            return 1.0 + 0.1 * x
        if any(b in name for b in ("'bq'", "'bk'", "'bv'")):
            return 0.1 * x
        if "embed" in name or "lm_head" in name:
            return 0.5 * x
        fan_in = int(np.prod(shape[1:-1])) if "'wo'" in name else shape[1]
        if "'mlp'" in name and len(shape) == 4:      # experts (L,E,in,out)
            fan_in = shape[2]
        return x / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _reduced(cfg):
    """``cfg.reduced()``; jamba also cut to the first 4 layers of its period
    (see the module docstring)."""
    if cfg.name.startswith("jamba"):
        period = cfg.groups[0][0]
        return dataclasses.replace(cfg.reduced(), groups=((period[:4], 1),),
                                   capacity_factor=16.0)
    return cfg.reduced()


def _both(arch, seed=0):
    cfg_j = _reduced(jax_get_config(arch))
    cfg_t = _reduced(get_config(arch))
    np_params = _numpy_params(cfg_j, seed)
    params_j = jax.tree.map(jnp.asarray, np_params)
    model = T.from_jax_params(cfg_t, np_params, device="cpu")
    return cfg_j, cfg_t, params_j, model


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _inputs(cfg, rng, B, S):
    """Tokens (B, S), or (B, S, C) with codebooks, and for a vision config
    vision embeddings (B, Nv, D) fp32 (else None), drawn from ``rng`` in
    that order."""
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, size=shape)
    vision = (rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model))
              .astype(np.float32) if cfg.n_vision_tokens else None)
    return tokens, vision


@pytest.fixture
def router_margins(monkeypatch):
    """Per gating call of the port (ops.moe_route on the capacity paths,
    ops.moe_gating on the dense one): the smallest gap between the k-th and
    (k+1)-th router probability of any token."""
    margins = []
    gating, route = ops.moe_gating, ops.moe_route

    def record(logits, top_k):
        probs = torch.softmax(logits.float(), -1).sort(-1, descending=True)[0]
        margins.append(float((probs[:, top_k - 1] - probs[:, top_k]).min()))

    def spy_gating(logits, top_k, *, impl=None):
        record(logits, top_k)
        return gating(logits, top_k, impl=impl)

    def spy_route(logits, top_k, **kw):
        record(logits, top_k)
        return route(logits, top_k, **kw)

    monkeypatch.setattr(ops, "moe_gating", spy_gating)
    monkeypatch.setattr(ops, "moe_route", spy_route)
    return margins


def _check_routes(cfg, margins):
    if cfg.n_experts:
        assert margins and min(margins) > ROUTER_MARGIN, \
            f"router near-tie: margins {sorted(margins)[:3]}"


@pytest.mark.parametrize("arch", PARITY_ARCHS + MOE_ARCHS + RECURRENT_ARCHS
                         + MODALITY_ARCHS)
def test_forward_logits_match_jax(arch, router_margins):
    cfg_j, cfg_t, params_j, model = _both(arch)
    rng = np.random.default_rng(1)
    tokens, vision = _inputs(cfg_j, rng, 2, 40)
    logits_j = j_forward(cfg_j, params_j, jnp.asarray(tokens),
                         None if vision is None else jnp.asarray(vision))
    logits_t = model(torch.from_numpy(tokens), vision_embeds=None
                     if vision is None else torch.from_numpy(vision))
    _check_routes(cfg_t, router_margins)
    assert logits_t.shape == logits_j.shape
    assert _err(logits_t, logits_j) < TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b",
                                  "gemma2-27b", "granite-moe-1b-a400m"]
                         + RECURRENT_ARCHS)
def test_prefill_then_decode_matches_jax(arch, router_margins):
    """Two sequences prefilled one by one into a slot cache, the second
    cut to fewer tokens (causal prefill makes its first 23 positions those
    of a 23-token prompt), then three committed decode steps on fixed
    tokens. gemma2's local layers cross their 32-token window. A recurrent
    state holds every token it was given, so configs with Mamba or RWKV
    layers prefill each prompt at its exact length instead. Every cache
    leaf, K/V and recurrent states alike, must match at the end. RWKV6 is
    held to JAX's sequential WKV6 oracle (``jax_prefill``)."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=2)
    rng = np.random.default_rng(3)
    lens, max_seq, steps = list(PREFILL_LENS), 48, 3
    cache_j, _ = JT.init_cache(cfg_j, 2, max_seq)
    cache_t = T.init_cache(cfg_t, 2, max_seq, device="cpu")
    for slot, L in enumerate(lens):
        prompt = rng.integers(0, cfg_j.vocab_size, size=(1, max(lens)))
        if T.is_recurrent(cfg_t):
            prompt = prompt[:, :L]
        lj, pf_j = jax_prefill(cfg_j, params_j, jnp.asarray(prompt))
        lt, pf_t = model.prefill(torch.from_numpy(prompt))
        _check_routes(cfg_t, router_margins)
        assert _err(lt, lj) < TOL
        cache_j = JT.cache_insert(cfg_j, cache_j, pf_j, slot, L)
        T.cache_insert(cfg_t, cache_t, pf_t, slot, L)
    lengths = np.asarray(lens)
    for _ in range(steps):
        toks = rng.integers(0, cfg_j.vocab_size, size=2)
        lj, cache_j = j_decode(cfg_j, params_j, cache_j,
                               jnp.asarray(toks, jnp.int32),
                               jnp.asarray(lengths, jnp.int32))
        lt, cache_t = model.decode_step(cache_t, torch.from_numpy(toks),
                                        torch.from_numpy(lengths))
        _check_routes(cfg_t, router_margins)
        assert _err(lt, lj) < TOL
        lengths = lengths + 1
    for gi in range(len(cfg_t.groups)):
        for li, layer in enumerate(cache_t[f"g{gi}"]):
            leaves_j = cache_j[f"g{gi}"][li]["mixer"]
            assert set(layer["mixer"]) == set(leaves_j)
            for name, leaf in layer["mixer"].items():
                assert _err(leaf, np.asarray(leaves_j[name])) < TOL, \
                    (gi, li, name)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b",
                                  "granite-moe-1b-a400m"] + RECURRENT_ARCHS
                         + MODALITY_ARCHS)
def test_append_decode_matches_committed(arch):
    """Append-mode decode_step (attention reads the cache as it was and
    merges the token; one batched K/V commit per stacked leaf after each
    group) against committed decode_step, token by token from the same
    prefilled slot cache: logits within 1e-5 (fp32), and every cache leaf
    within 1e-5 after each step's commit (a layer's K/V deltas depend on
    the hidden state, which the two modes sum in different orders).
    gemma2's local layers cross their 32-token window; the vision
    config's cross layers read their static cache whole in both modes, and
    musicgen decodes (2, C) tokens."""
    _, cfg, _, model = _both(arch, seed=4)
    rng = np.random.default_rng(5)
    caches = [T.init_cache(cfg, 2, 48, device="cpu") for _ in range(2)]
    for slot, L in enumerate(PREFILL_LENS):
        prompt, vision = _inputs(cfg, rng, 1, L)
        _, pf = model.prefill(torch.from_numpy(prompt), vision_embeds=None
                              if vision is None else torch.from_numpy(vision))
        for cache in caches:
            T.cache_insert(cfg, cache, pf, slot, L)
    lengths = torch.tensor(PREFILL_LENS)
    leaves = [torch.utils._pytree.tree_leaves(c) for c in caches]
    C = cfg.n_codebooks
    for _ in range(4):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             size=(2, C) if C else 2))
        committed, _ = model.decode_step(caches[0], toks, lengths)
        appended, _ = model.decode_step(caches[1], toks, lengths,
                                        append=True)
        assert _err(appended, committed) < 1e-5
        for a, b in zip(*leaves):
            assert _err(a, b) < 1e-5
        lengths = lengths + 1


def test_append_decode_matches_jax_forward():
    """tests/test_models_smoke.py::test_decode_append_mode_exact for the
    port: reduced gemma2 decoded token by token in append mode from an
    empty cache equals JAX's full forward at 1e-4 (the tokens and weights of
    test_forward_logits_match_jax, whose forward shape is compiled)."""
    cfg_j, cfg_t, params_j, model = _both("gemma2-27b")
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab_size,
                                               size=(2, 40))
    full = j_forward(cfg_j, params_j, jnp.asarray(tokens), None)
    cache = T.init_cache(cfg_t, 2, 41, device="cpu")
    steps = [model.decode_step(cache, torch.from_numpy(tokens[:, t]),
                               torch.full((2,), t), append=True)[0]
             for t in range(tokens.shape[1])]
    assert _err(torch.stack(steps, dim=1), full) < TOL


def test_param_names_and_count_match_jax():
    for arch in PARITY_ARCHS + ["granite-moe-1b-a400m"] + RECURRENT_ARCHS \
            + MODALITY_ARCHS:
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count(), arch
    granite = "granite-moe-1b-a400m"
    assert get_config(granite).active_param_count() == \
        jax_get_config(granite).active_param_count()
    # bf16: the router and the recurrent layers' constants stay fp32; the
    # vision projection and the codebook embed and head keep their names
    for arch in ("gemma2-27b", granite) + tuple(RECURRENT_ARCHS
                                                + MODALITY_ARCHS):
        cfg = dataclasses.replace(_reduced(get_config(arch)),
                                  param_dtype="bfloat16")
        cfg_j = dataclasses.replace(_reduced(jax_get_config(arch)),
                                    param_dtype="bfloat16")
        shapes = jax.eval_shape(
            lambda c=cfg_j: JT.init_params(c, jax.random.PRNGKey(0)))
        jax_names = {
            ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
        model = T.Transformer(cfg, device="meta")
        ours = dict(model.named_parameters())
        assert set(jax_names) == set(ours), arch
        for name, leaf in jax_names.items():
            assert str(ours[name].dtype).split(".")[-1] == leaf.dtype.name



def test_unported_configs_raise():
    """What the port still refuses: training the vision and codebook
    configs (ROADMAP A7b) and the recurrent ones (no scan backward, A10),
    through check_trainable and train_forward; decode lengths outside the
    self-attention cache (a vision config's capacity is its self-attention
    cache's, not its cross cache's Nv rows)."""
    assert set(PARITY_ARCHS + MOE_ARCHS + RECURRENT_ARCHS
               + MODALITY_ARCHS) == set(list_archs())
    for arch in MODALITY_ARCHS + RECURRENT_ARCHS:
        cfg = get_config(arch).reduced()
        why = "A7b" if arch in MODALITY_ARCHS else "scan backward"
        with pytest.raises(NotImplementedError, match=why):
            T.check_trainable(cfg)
        model = T.Transformer(cfg, device="cpu")
        tokens, _ = _inputs(cfg, np.random.default_rng(0), 1, 8)
        with pytest.raises(NotImplementedError, match=why):
            model.train_forward(torch.from_numpy(tokens))
    cfg = get_config("llama-3.2-vision-11b").reduced()
    model = T.Transformer(cfg, device="cpu")
    cache = T.init_cache(cfg, 1, 24, device="cpu")
    assert cfg.n_vision_tokens == 16
    logits, _ = model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                                  torch.tensor([20]), append=True)
    assert logits.shape == (1, cfg.vocab_size)
    with pytest.raises(ValueError):
        model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([24]))
    cfg = get_config("qwen2-1.5b").reduced()
    model = T.Transformer(cfg, device="cpu")
    cache = T.init_cache(cfg, 1, 16, device="cpu")
    for append in (False, True):                # past the cache's capacity
        with pytest.raises(ValueError):
            model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                              torch.tensor([16]), append=append)
    assert not any(leaf.any() for layer in cache["g0"]
                   for leaf in layer["mixer"].values())   # nothing written
    # attention-free: no capacity to pass, but lengths stay non-negative
    cfg = get_config("rwkv6-1.6b").reduced()
    model = T.Transformer(cfg, device="cpu")
    cache = T.init_cache(cfg, 1, 16, device="cpu")
    logits, _ = model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                                  torch.tensor([16]))
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError):
        model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([-1]))


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError):
        T.Transformer(cfg)
    with pytest.raises(RuntimeError):
        T.init_cache(cfg, 1, 16)
