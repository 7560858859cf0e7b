"""Port model (repro_torch.models) vs the JAX package's model on shared
numpy weights and tokens, on the CPU, at the reduced configs.

Tolerance 1e-4 max abs on fp32 logits: the two CPU paths reduce in
different orders (matmul blocking, online vs one-pass softmax). MoE configs
route discretely, so their tests first check that no router choice in the
port's run sits within ROUTER_MARGIN of a tie: a choice that flips between
the two packages would fail as a router near-tie, not as a float error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

TOL = 1e-4
ROUTER_MARGIN = 1e-5     # >> the ~1e-7 the packages' router probs differ by
PARITY_ARCHS = ["qwen2-1.5b", "internlm2-1.8b", "gemma2-27b", "minitron-4b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
# the JAX entry points, jitted (config static): one compile per shape
j_forward = jax.jit(lambda cfg, p, t: JT.forward(cfg, p, t)[0],
                    static_argnums=0)
j_prefill = jax.jit(JT.prefill, static_argnums=0)
j_decode = jax.jit(lambda cfg, p, c, t, l: JT.decode_step(
    cfg, p, c, t, l, append=False), static_argnums=0)


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


def _both(arch, seed=0):
    cfg_j = jax_get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    np_params = _numpy_params(cfg_j, seed)
    params_j = jax.tree.map(jnp.asarray, np_params)
    model = T.from_jax_params(cfg_t, np_params, device="cpu")
    return cfg_j, cfg_t, params_j, model


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture
def router_margins(monkeypatch):
    """Per ops.moe_gating call of the port: the smallest gap between the
    k-th and (k+1)-th router probability of any token."""
    margins = []
    gating = ops.moe_gating

    def spy(logits, top_k, *, impl=None):
        probs = torch.softmax(logits.float(), -1).sort(-1, descending=True)[0]
        margins.append(float((probs[:, top_k - 1] - probs[:, top_k]).min()))
        return gating(logits, top_k, impl=impl)

    monkeypatch.setattr(ops, "moe_gating", spy)
    return margins


def _check_routes(cfg, margins):
    if cfg.n_experts:
        assert margins and min(margins) > ROUTER_MARGIN, \
            f"router near-tie: margins {sorted(margins)[:3]}"


@pytest.mark.parametrize("arch", PARITY_ARCHS + MOE_ARCHS)
def test_forward_logits_match_jax(arch, router_margins):
    cfg_j, cfg_t, params_j, model = _both(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, size=(2, 40))
    logits_j = j_forward(cfg_j, params_j, jnp.asarray(tokens))
    logits_t = model(torch.from_numpy(tokens))
    _check_routes(cfg_t, router_margins)
    assert logits_t.shape == logits_j.shape
    assert _err(logits_t, logits_j) < TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b",
                                  "gemma2-27b", "granite-moe-1b-a400m"])
def test_prefill_then_decode_matches_jax(arch, router_margins):
    """Two sequences prefilled one by one into a slot cache, the second
    cut to fewer tokens (causal prefill makes its first 23 positions those
    of a 23-token prompt), then three committed decode steps on fixed
    tokens. gemma2's local layers cross their 32-token window."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=2)
    rng = np.random.default_rng(3)
    lens, max_seq, steps = [40, 23], 48, 3
    cache_j, _ = JT.init_cache(cfg_j, 2, max_seq)
    cache_t = T.init_cache(cfg_t, 2, max_seq, device="cpu")
    for slot, L in enumerate(lens):
        prompt = rng.integers(0, cfg_j.vocab_size, size=(1, max(lens)))
        lj, pf_j = j_prefill(cfg_j, params_j, jnp.asarray(prompt))
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
    k_j = np.asarray(cache_j["g0"][0]["mixer"]["k"])
    assert _err(cache_t["g0"][0]["mixer"]["k"], k_j) < TOL


def test_param_names_and_count_match_jax():
    for arch in PARITY_ARCHS + ["granite-moe-1b-a400m"]:
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count(), arch
    granite = "granite-moe-1b-a400m"
    assert get_config(granite).active_param_count() == \
        jax_get_config(granite).active_param_count()
    for arch in ("gemma2-27b", granite):      # bf16: the router stays fp32
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="bfloat16")
        cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
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
    ported = set(PARITY_ARCHS + MOE_ARCHS)
    for arch in list_archs():
        if arch in ported:
            continue
        with pytest.raises(NotImplementedError):
            T.Transformer(get_config(arch).reduced(), device="cpu")
    cfg = get_config("qwen2-1.5b").reduced()
    model = T.Transformer(cfg, device="cpu")
    cache = T.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), append=True)
    with pytest.raises(ValueError):             # past the cache's capacity
        model.decode_step(cache, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([16]))


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError):
        T.Transformer(cfg)
    with pytest.raises(RuntimeError):
        T.init_cache(cfg, 1, 16)
