"""Port model (repro_torch.models) vs the JAX package's model on shared
numpy weights and tokens, on the CPU, at the reduced configs.

Tolerance 1e-4 max abs on fp32 logits: the two CPU paths reduce in
different orders (matmul blocking, online vs one-pass softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as T

TOL = 1e-4
PARITY_ARCHS = ["qwen2-1.5b", "internlm2-1.8b", "gemma2-27b", "minitron-4b"]
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


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_forward_logits_match_jax(arch):
    cfg_j, _, params_j, model = _both(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, size=(2, 40))
    logits_j = j_forward(cfg_j, params_j, jnp.asarray(tokens))
    logits_t = model(torch.from_numpy(tokens))
    assert logits_t.shape == logits_j.shape
    assert _err(logits_t, logits_j) < TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b",
                                  "gemma2-27b"])
def test_prefill_then_decode_matches_jax(arch):
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
        assert _err(lt, lj) < TOL
        lengths = lengths + 1
    k_j = np.asarray(cache_j["g0"][0]["mixer"]["k"])
    assert _err(cache_t["g0"][0]["mixer"]["k"], k_j) < TOL


def test_param_names_and_count_match_jax():
    for arch in PARITY_ARCHS:
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count(), arch
    cfg = get_config("gemma2-27b").reduced()
    shapes = jax.eval_shape(
        lambda: JT.init_params(jax_get_config("gemma2-27b").reduced(),
                               jax.random.PRNGKey(0)))
    jax_names = {
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    model = T.Transformer(cfg, device="meta")
    assert jax_names == {n for n, _ in model.named_parameters()}


def test_unported_configs_raise():
    ported = set(PARITY_ARCHS)
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
