"""Port attention (repro_torch.kernels) vs the JAX package's kernels and
oracles on shared numpy inputs, on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them. Tolerance 2e-5 in fp32 (tests/test_kernels.py::_tol): both sides
accumulate in fp32, in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gating as mg

TOL = 2e-5
# the JAX oracles, jitted: one compile per case instead of one per op
_STATIC = ("causal", "window", "softcap")
j_attention_naive = jax.jit(jref.attention_naive, static_argnames=_STATIC)
j_blockwise = jax.jit(jref.blockwise_attention,
                      static_argnames=_STATIC + ("q_block", "kv_block"))
j_decode_naive = jax.jit(jref.decode_attention_naive,
                         static_argnames=("window", "softcap"))
j_decode_direct = jax.jit(jref.decode_attention_direct,
                          static_argnames=("window", "softcap"))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _qkv(seed, B, Sq, Skv, H, KVH, Dh):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, Sq, H, Dh)), _normal(rng, (B, Skv, KVH, Dh)),
            _normal(rng, (B, Skv, KVH, Dh)))


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,KVH,Dh,window,softcap", [
    (1, 128, 4, 4, 64, None, None),      # MHA
    (1, 128, 12, 2, 64, None, None),     # qwen2-like ratio
    (1, 128, 2, 1, 128, None, 30.0),     # MQA, Dh 128
    (1, 256, 2, 1, 64, 64, 50.0),        # window skips whole kv tiles
])
def test_plain_flash_matches_jax_kernel(B, S, H, KVH, Dh, window, softcap):
    q, k, v = _qkv(B * S + H, B, S, S, H, KVH, Dh)
    o_jax = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window, softcap=softcap,
                      interpret=True)
    o_oracle = j_attention_naive(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 window=window, softcap=softcap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o_plain = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                  softcap=softcap)         # CPU -> plain
    o_naive = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                  softcap=softcap, impl="naive")
    assert _err(o_plain, o_jax) < TOL
    assert _err(o_plain, o_oracle) < TOL
    assert _err(o_naive, o_oracle) < TOL


@pytest.mark.parametrize("Sq,Skv,causal,lens", [
    (100, 160, True, None),          # ragged, Sq != Skv
    (64, 96, False, (50, 96)),       # kv_lens, non-causal
])
def test_plain_blockwise_matches_jax_blockwise(Sq, Skv, causal, lens):
    q, k, v = _qkv(Sq + Skv, 2, Sq, Skv, 4, 2, 32)
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else torch.tensor(lens)
    o_jax = j_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, kv_lens=jl, q_block=16, kv_block=32)
    o_t = ref.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, kv_lens=tl, q_block=16,
                                  kv_block=32)
    assert _err(o_t, o_jax) < TOL


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,KVH,Dh,win,cap", [
    (2, 256, 8, 2, 64, None, None),
    (1, 256, 4, 4, 128, None, 30.0),
    (2, 256, 4, 2, 64, 64, None),
    (1, 256, 16, 2, 64, 32, 50.0),
])
def test_plain_decode_matches_jax_kernel(B, S, H, KVH, Dh, win, cap):
    rng = np.random.default_rng(S + H)
    q = _normal(rng, (B, H, Dh))
    kc = _normal(rng, (B, S, KVH, Dh))
    vc = _normal(rng, (B, S, KVH, Dh))
    lens = rng.integers(S // 4, S, size=B).astype(np.int32)
    jargs = tuple(map(jnp.asarray, (q, kc, vc, lens)))
    o_jax = jax_decode(*jargs, window=win, softcap=cap, interpret=True)
    o_oracle = j_decode_naive(*jargs, window=win, softcap=cap)
    o_direct = j_decode_direct(*jargs, window=win, softcap=cap)
    targs = tuple(map(torch.from_numpy, (q, kc, vc, lens)))
    o_plain = ops.decode_attention(*targs, window=win, softcap=cap)
    o_naive = ops.decode_attention(*targs, window=win, softcap=cap,
                                   impl="naive")
    assert _err(o_plain, o_jax) < TOL
    assert _err(o_plain, o_direct) < TOL
    assert _err(o_naive, o_oracle) < TOL


def test_plain_paths_zero_fully_masked_rows():
    """lengths 0 (decode) and rows past kv_lens (prefill) give zeros."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (2, 4, 64)))
    kc = torch.from_numpy(_normal(rng, (2, 64, 2, 64)))
    o = ops.decode_attention(q, kc, kc, torch.tensor([0, 5]))
    assert not o[0].any() and o[1].any()
    qs = torch.from_numpy(_normal(rng, (1, 8, 4, 32)))
    ks = torch.from_numpy(_normal(rng, (1, 8, 2, 32)))
    o = ops.flash_attention(qs, ks, ks, causal=False, kv_lens=torch.tensor([0]))
    assert not o.any()


# ---------------------------------------------------------------------------
# dispatch: no fallback hides the device or the kernel
# ---------------------------------------------------------------------------
def test_dispatch_rejects_what_it_cannot_run():
    before = (fa.launches, da.launches, mg.launches)
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, impl="pallas")
    with pytest.raises(ValueError):                 # CPU tensor, no fallback
        fa.flash_attention(q, k, k)
    qd = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError):
        da.decode_attention(qd, k, k, torch.tensor([3]))
    with pytest.raises(NotImplementedError):
        ops.decode_attention(qd, k, k, torch.tensor([3]),
                             k_new=torch.zeros(1, 2, 64),
                             v_new=torch.zeros(1, 2, 64))
    logits = torch.zeros(4, 32)
    with pytest.raises(ValueError):
        ops.moe_gating(logits, 8, impl="cuda")
    with pytest.raises(ValueError):                 # CPU tensor, no fallback
        mg.moe_gating_topk(logits, 8)
    assert (fa.launches, da.launches, mg.launches) == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises (a CUDA tensor would never reach a plain
    version instead), and nothing is written."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError):
        _build.build()
    assert not (tmp_path / "build").exists()
    # the cache key follows the sources, under the git-ignored build root
    assert _build.library_path().parent.name == _build._source_hash()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Kernel vs plain version on the card (chip_smoke.py runs the full
    sweep); tolerances as tests/test_kernels.py::_tol."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v = rnd(2, 200, 12, 128), rnd(2, 200, 2, 128), rnd(2, 200, 2, 128)
    for window, cap in ((None, None), (64, 30.0)):
        o = ops.flash_attention(q, k, v, window=window, softcap=cap)
        o_ref = ops.flash_attention(q, k, v, window=window, softcap=cap,
                                    impl="plain")
        assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
    qd, kc, vc = rnd(3, 12, 128), rnd(3, 300, 2, 128), rnd(3, 300, 2, 128)
    lens = torch.tensor([1, 150, 300], device=cuda_device)
    for window, cap in ((None, None), (64, 30.0)):
        o = ops.decode_attention(qd, kc, vc, lens, window=window,
                                 softcap=cap)
        o_ref = ops.decode_attention(qd, kc, vc, lens, window=window,
                                     softcap=cap, impl="plain")
        assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
