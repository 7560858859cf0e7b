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
_DECODE_SHAPES = [
    (2, 256, 8, 2, 64, None, None),
    (1, 256, 4, 4, 128, None, 30.0),
    (2, 256, 4, 2, 64, 64, None),
    (1, 256, 16, 2, 64, 32, 50.0),
]



@pytest.mark.parametrize("B,S,H,KVH,Dh,win,cap", _DECODE_SHAPES)
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


@pytest.mark.parametrize("n_splits,tile", [
    (1, 128),       # one split: the whole cache
    (3, 128),       # the kernel's tile: 2 chunks of 128 rows, 1 empty split
    (3, 32),        # three chunks of 96 rows
    (12, 32),       # more splits than the 8 kv tiles: 4 empty splits
])
@pytest.mark.parametrize("B,S,H,KVH,Dh,win,cap", _DECODE_SHAPES)
def test_split_decode_mirror_matches_jax(B, S, H, KVH, Dh, win, cap,
                                         n_splits, tile):
    """ref.decode_attention_split (the CUDA split + combine, in PyTorch) vs
    the JAX kernel (interpret mode) and its naive oracle, with lengths 0, 1
    and S. Shapes as test_plain_decode_matches_jax_kernel, so the JAX
    functions compile no new shape."""
    rng = np.random.default_rng(S + H)
    q = _normal(rng, (B, H, Dh))
    kc = _normal(rng, (B, S, KVH, Dh))
    vc = _normal(rng, (B, S, KVH, Dh))
    length_sets = ([[0, S], [1, S // 2 + 3]] if B == 2
                   else [[0], [1], [S]])
    for lens in length_sets:
        lens = np.asarray(lens, np.int32)
        jargs = tuple(map(jnp.asarray, (q, kc, vc, lens)))
        o_jax = np.asarray(jax_decode(*jargs, window=win, softcap=cap,
                                      interpret=True))
        o_split = ref.decode_attention_split(
            *map(torch.from_numpy, (q, kc, vc, lens)), n_splits=n_splits,
            window=win, softcap=cap, tile=tile).numpy()
        assert _err(o_split, o_jax) < TOL
        assert not o_split[lens == 0].any()
        # the naive oracle averages v over a fully masked row: compare the
        # rows that attend to something
        if (lens > 0).any():
            o_oracle = np.asarray(j_decode_naive(*jargs, window=win,
                                                 softcap=cap))
            assert _err(o_split[lens > 0], o_oracle[lens > 0]) < TOL


@pytest.mark.parametrize("win,cap", [(None, None), (64, None),
                                     (None, 30.0), (32, 50.0)])
def test_plain_append_decode_matches_jax(win, cap):
    """Append mode (the new token's k_new / v_new merged, the cache
    read-only with ``lengths`` old tokens) at the shapes and (window,
    softcap) cases of tests/test_kernels.py::test_decode_append_mode_parity,
    with lengths 0 too: the port's direct path, its ops dispatch (CPU:
    plain), its naive oracle and its split mirror (one split; chunks of 32
    rows, so the 32-row window sits under one split) against JAX's
    ``ref.decode_attention_direct(k_new=...)``, and against committed decode
    over the same cache with the token written at ``lengths`` and lengths
    + 1 (the reference's contract). Lengths 0 give exactly v_new."""
    B, S, H, KVH, Dh = 3, 128, 8, 2, 64
    rng = np.random.default_rng(11)
    q = _normal(rng, (B, H, Dh))
    kc, vc = _normal(rng, (B, S, KVH, Dh)), _normal(rng, (B, S, KVH, Dh))
    k_new, v_new = _normal(rng, (B, KVH, Dh)), _normal(rng, (B, KVH, Dh))
    tq, tk, tv, tkn, tvn = map(torch.from_numpy, (q, kc, vc, k_new, v_new))
    for lens in ([100, 37, S - 1], [0, 1, S - 1]):
        lens = np.asarray(lens, np.int32)
        tl = torch.from_numpy(lens)
        o_jax = np.asarray(j_decode_direct(
            *map(jnp.asarray, (q, kc, vc, lens)), window=win, softcap=cap,
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new)))
        kw = dict(window=win, softcap=cap, k_new=tkn, v_new=tvn)
        outs = {
            "direct": ref.decode_attention_direct(tq, tk, tv, tl, **kw),
            "ops": ops.decode_attention(tq, tk, tv, tl, **kw),
            "naive": ops.decode_attention(tq, tk, tv, tl, impl="naive", **kw),
            "split 1": ref.decode_attention_split(tq, tk, tv, tl,
                                                  n_splits=1, **kw),
            "split 4 x 32": ref.decode_attention_split(
                tq, tk, tv, tl, n_splits=4, tile=32, **kw),
        }
        at = torch.arange(S)[None, :, None, None] == tl.long()[:, None,
                                                               None, None]
        committed = ref.decode_attention_naive(
            tq, torch.where(at, tkn[:, None], tk),
            torch.where(at, tvn[:, None], tv), tl + 1, window=win,
            softcap=cap)
        for name, o in outs.items():
            assert _err(o, o_jax) < 1e-5, (name, lens.tolist())
            assert _err(o, committed) < 1e-5, (name, lens.tolist())
        zero = lens == 0
        if not zero.any():
            continue
        G = H // KVH
        want = np.repeat(v_new[zero], G, axis=1)       # (b, H, Dh)
        for name, o in outs.items():
            assert _err(o.numpy()[zero], want) < 1e-6, name
        assert np.array_equal(outs["direct"].numpy()[zero], want)


def test_append_mode_needs_both_deltas():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, (1, 4, 64)))
    kc = torch.from_numpy(_normal(rng, (1, 16, 2, 64)))
    kn = torch.from_numpy(_normal(rng, (1, 2, 64)))
    for fn in (ref.decode_attention_direct, ref.decode_attention_naive):
        with pytest.raises(ValueError):
            fn(q, kc, kc, torch.tensor([3]), k_new=kn)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, kc, torch.tensor([3]), v_new=kn)
    with pytest.raises(ValueError):
        ref.decode_attention_split(q, kc, kc, torch.tensor([3]), n_splits=2,
                                   k_new=kn)


@pytest.mark.parametrize("B,KVH,S,sms,want", [
    (8, 2, 2048, 132, 16),      # qwen2 serving: 16 chunks of 128 rows
    (8, 8, 2048, 132, 8),       # granite / jamba: 8 chunks of 256 rows
    (1, 1, 256, 132, 2),        # capped by the cache's tiles
    (64, 8, 2048, 132, 2),      # the (b, kv head) grid nearly fills it
    (128, 8, 2048, 132, 1),
    (3, 2, 300, 132, 3),        # ragged last tile
    (1, 2, 100, 16, 1),
])
def test_decode_split_plan(B, KVH, S, sms, want):
    """The wrapper's split count, a function of shapes and SM count only:
    each split a whole number of tiles, every row covered, no split wholly
    past S, and about BLOCKS_PER_SM blocks per SM where the cache allows."""
    n = da.plan_splits(B, KVH, S, sms)
    chunk = ref.split_chunk(S, n)
    assert n == want
    assert chunk % ref.DECODE_SPLIT_TILE == 0
    assert n * chunk >= S > (n - 1) * chunk
    tiles = -(-S // ref.DECODE_SPLIT_TILE)
    assert n * B * KVH >= min(da.BLOCKS_PER_SM * sms, tiles * B * KVH) // 2


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
    with pytest.raises(ValueError):                 # append mode too
        da.decode_attention(qd, k, k, torch.tensor([3]),
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

    # flash: ragged 200, Sq = Skv = 64 k + 1, a window under one tile + cap
    for S, window, cap in ((200, None, None), (200, 64, 30.0),
                           (193, None, None), (193, 24, 30.0)):
        q, k, v = rnd(2, S, 12, 128), rnd(2, S, 2, 128), rnd(2, S, 2, 128)
        o = ops.flash_attention(q, k, v, window=window, softcap=cap)
        o_ref = ops.flash_attention(q, k, v, window=window, softcap=cap,
                                    impl="plain")
        assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
    # decode: G 6 and 16, lengths 0 / 1 / S, a window under one split,
    # int64 and int32 lengths; also against the split mirror
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for B, S, H, lens, window, cap in (
            (3, 300, 12, [1, 150, 300], None, None),
            (3, 300, 12, [1, 150, 300], 64, 30.0),
            (4, 2048, 32, [2048, 0, 1000, 7], None, None),   # G = 16
            (4, 2048, 12, [1, 1, 1, 1], None, None),  # one split not empty
            (4, 2048, 12, [2048, 0, 1500, 129], 50, 30.0)):
        qd, kc, vc = rnd(B, H, 128), rnd(B, S, 2, 128), rnd(B, S, 2, 128)
        for ldt in (torch.int64, torch.int32):
            ln = torch.tensor(lens, dtype=ldt, device=cuda_device)
            o = ops.decode_attention(qd, kc, vc, ln, window=window,
                                     softcap=cap)
            o_ref = ops.decode_attention(qd, kc, vc, ln, window=window,
                                         softcap=cap, impl="plain")
            o_split = ref.decode_attention_split(
                qd, kc, vc, ln, window=window, softcap=cap,
                n_splits=da.plan_splits(B, 2, S, sms))
            assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
            assert _err(o.float().cpu(), o_split.float().cpu()) < tol
            assert not o[ln == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_append_decode_matches_plain(cuda_device, dtype):
    """The decode kernel in append mode (the combine pass merges k_new /
    v_new) vs its plain version, its split mirror and the committed kernel
    over the cache with the token written at lengths (lengths + 1): lengths
    0, 1 and S - 1, a window under one split and one over several, a
    softcap, G = 16, int64 and int32 lengths. Lengths 0 give v_new."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for B, S, H, lens, window, cap in (
            (3, 300, 12, [0, 1, 299], None, None),
            (3, 300, 12, [0, 150, 299], 64, 30.0),
            (4, 2048, 32, [2047, 0, 1000, 7], None, None),    # G = 16
            (4, 2048, 12, [2047, 0, 1500, 129], 50, 30.0),
            (4, 2048, 12, [2047, 1, 1500, 700], 600, None)):
        qd, kc, vc = rnd(B, H, 128), rnd(B, S, 2, 128), rnd(B, S, 2, 128)
        kn, vn = rnd(B, 2, 128), rnd(B, 2, 128)
        for ldt in (torch.int64, torch.int32):
            ln = torch.tensor(lens, dtype=ldt, device=cuda_device)
            kw = dict(window=window, softcap=cap, k_new=kn, v_new=vn)
            o = ops.decode_attention(qd, kc, vc, ln, **kw)
            o_ref = ops.decode_attention(qd, kc, vc, ln, impl="plain", **kw)
            o_split = ref.decode_attention_split(
                qd, kc, vc, ln, n_splits=da.plan_splits(B, 2, S, sms), **kw)
            bidx = torch.arange(B, device=cuda_device)
            kc2, vc2 = kc.clone(), vc.clone()
            kc2[bidx, ln.long()] = kn
            vc2[bidx, ln.long()] = vn
            o_com = ops.decode_attention(qd, kc2, vc2, ln + 1, window=window,
                                         softcap=cap)
            for want in (o_ref, o_split, o_com):
                assert _err(o.float().cpu(), want.float().cpu()) < tol
            zero = ln == 0
            assert torch.equal(o[zero], vn[zero].repeat_interleave(
                H // 2, dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dim_112_matches_plain(cuda_device, dtype):
    """Both attention kernels at kimi-k2's head dim (112, staged at 128 in
    shared memory) vs their plain versions: its 64/8 heads, ragged Sq and
    Skv, a window under one tile and one split, a softcap, lengths 0 and 1,
    int64 and int32 lengths, committed and append-mode decode."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    for B, Sq, Skv, causal, window, cap in (
            (1, 200, 200, True, None, None), (2, 129, 129, True, 24, 30.0),
            (1, 100, 161, False, None, None)):
        q, k, v = rnd(B, Sq, 64, 112), rnd(B, Skv, 8, 112), rnd(B, Skv, 8, 112)
        kw = dict(causal=causal, window=window, softcap=cap)
        o = ops.flash_attention(q, k, v, **kw)
        o_ref = ops.flash_attention(q, k, v, impl="plain", **kw)
        assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
    for B, S, lens, window, cap in ((4, 300, [0, 1, 150, 300], None, None),
                                    (4, 2048, [2048, 0, 1, 900], 50, 30.0)):
        qd, kc, vc = rnd(B, 64, 112), rnd(B, S, 8, 112), rnd(B, S, 8, 112)
        kn, vn = rnd(B, 8, 112), rnd(B, 8, 112)
        for ldt in (torch.int64, torch.int32):
            ln = torch.tensor(lens, dtype=ldt, device=cuda_device)
            for kw in (dict(), dict(k_new=kn, v_new=vn)):
                kw.update(window=window, softcap=cap)
                if kw.get("k_new") is not None:
                    ln = ln.clamp(max=S - 1)
                o = ops.decode_attention(qd, kc, vc, ln, **kw)
                o_ref = ops.decode_attention(qd, kc, vc, ln, impl="plain",
                                             **kw)
                assert _err(o.float().cpu(), o_ref.float().cpu()) < tol
