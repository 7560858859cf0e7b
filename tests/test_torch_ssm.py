"""Port recurrent layers (repro_torch.kernels scans, repro_torch.models.ssm)
vs the JAX package on shared numpy inputs, on the CPU.

The JAX Pallas scans run in interpret mode, as tests/test_kernels.py runs
them, at that file's shapes. Tolerance 1e-4 max abs, the reference's own
(test_rwkv6_kernel, test_ssm_kernel): every side keeps the state in fp32
and sums in its own order. The mixers (Mamba, RWKV time and channel mix)
are held to JAX at the reduced configs, states included, within the same
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_kernel
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_kernel
from repro.models import ssm as JS
from repro.models import transformer as TM_J
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TM
from test_torch_model import _both, j_decode

TOL = 1e-4
# the JAX references, jitted: one compile per shape instead of one per op
j_rwkv6 = {name: jax.jit(getattr(jref, name)) for name in
           ("rwkv6_sequential", "rwkv6_single_step")}
j_rwkv6["rwkv6_chunked"] = jax.jit(jref.rwkv6_chunked,
                                   static_argnames="chunk")
j_ssm = {name: jax.jit(getattr(jref, name)) for name in
         ("ssm_sequential", "ssm_single_step")}
j_ssm["ssm_chunked"] = jax.jit(jref.ssm_chunked, static_argnames="chunk")
j_mamba_conv = jax.jit(JS._mamba_conv)
j_mamba_forward = jax.jit(JS.mamba_forward, static_argnums=0)
j_time_mix = jax.jit(JS.rwkv_time_mix, static_argnums=0)
j_channel_mix = jax.jit(JS.rwkv_channel_mix, static_argnums=0)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _rwkv_inputs(B, T, H, K, seed, strong_decay=False, decay_logit=None):
    """tests/test_kernels.py::test_rwkv6_kernel's distributions, in numpy;
    ``strong_decay`` draws w = exp(-exp(N(0, 1) + 2)) instead (down to
    ~e^-20, the fast-decaying channels of trained RWKV-6 checkpoints), and
    ``decay_logit`` = (mu, sd) draws w = exp(-exp(N(mu, sd)))."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    logit = n(B, T, H, K)
    if decay_logit is not None:
        logit = logit * decay_logit[1] + decay_logit[0]
    else:
        logit = logit + 2 if strong_decay else logit * 0.5 - 1
    w = np.exp(-np.exp(logit)).astype(np.float32)
    return (n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5,
            w, n(H, K) * 0.3, n(B, H, K, K) * 0.1)


def _ssm_inputs(B, T, Din, N, seed):
    """tests/test_kernels.py::test_ssm_kernel's distributions, in numpy, with
    a non-zero initial state."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = (np.logaddexp(n(B, T, Din), 0.0) * 0.1).astype(np.float32)
    A = -np.exp(n(Din, N) * 0.3).astype(np.float32)
    return (n(B, T, Din), dt, A, n(B, T, N), n(B, T, N), n(Din),
            n(B, Din, N) * 0.1)


def _check(got, want):
    for g, w in zip(got, want):
        assert g.shape == tuple(np.shape(w))
        assert _err(g, w) < TOL


# ---------------------------------------------------------------------------
# scans: the port's twins vs JAX's references and Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,H,K", [(2, 64, 2, 16), (1, 96, 4, 32),
                                     (2, 80, 2, 16)])
def test_rwkv6_twins_match_jax(B, T, H, K):
    """(2, 80): T not a multiple of the chunk (the w = 1 pad path)."""
    args = _rwkv_inputs(B, T, H, K, seed=T + H)
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(torch.from_numpy, args))
    want = j_rwkv6["rwkv6_sequential"](*jargs)
    _check(ref.rwkv6_sequential(*targs), want)
    _check(ref.rwkv6_chunked(*targs), want)
    _check(ops.rwkv6_scan(*targs), want)         # CPU -> chunked_exact
    _check(ops.rwkv6_scan(*targs, impl="naive"), want)
    if T % 32 == 0:                 # the TPU kernel's own test shapes
        _check(ref.rwkv6_chunked(*targs),
               jax_rwkv6_kernel(*jargs, interpret=True))
    else:                           # both pad paths
        _check(ref.rwkv6_chunked(*targs), j_rwkv6["rwkv6_chunked"](*jargs))


@pytest.mark.parametrize("B,T,H,K,chunk,strong", [
    (3, 1, 4, 16, 32, False),       # T < c: decode's one step
    (2, 64, 2, 16, 64, False),      # T = c
    (1, 96, 4, 32, 32, False),      # T = 3c
    (2, 80, 2, 16, 32, False),      # T = 2c + 16
    (2, 81, 2, 16, 32, False),      # T = 2c + 17
    (1, 96, 4, 32, 32, True),       # strong decay, w down to ~e^-20
], ids=["T<c", "T=c", "T=3c", "T=2c+16", "T=2c+17", "strong-decay"])
def test_rwkv6_chunk_parallel_matches_jax(B, T, H, K, chunk, strong):
    """The CUDA kernel's three passes (chunk states, carry, outputs), as
    ref.rwkv6_chunk_parallel mirrors them, against JAX's sequential oracle
    (single step at T = 1) and, where T is a multiple of 32, the Pallas
    kernel in interpret mode; every case starts from a non-zero state.
    The strong-decay case is one that the log-space ref.rwkv6_chunked is
    not asked to pass."""
    args = _rwkv_inputs(B, T, H, K, seed=T + H + int(strong),
                        strong_decay=strong)
    jargs = tuple(map(jnp.asarray, args))
    got = ref.rwkv6_chunk_parallel(*map(torch.from_numpy, args), chunk=chunk)
    oracle = "rwkv6_single_step" if T == 1 else "rwkv6_sequential"
    _check(got, j_rwkv6[oracle](*jargs))
    if T % 32 == 0 and not strong:
        _check(got, jax_rwkv6_kernel(*jargs, interpret=True))


@pytest.mark.parametrize("B,T,H,K,decay", [
    (1, 96, 4, 32, "strong"),           # w = exp(-exp(N(2, 1))), median 6e-4
    (1, 96, 4, 32, (1.5, 0.5)),         # median w 0.011: ROADMAP C1's worst
    (2, 80, 2, 16, "strong"),           # T not whole chunks: the w = 1 pad
], ids=["strong", "w~0.011", "strong-padded"])
def test_plain_rwkv6_exact_under_strong_decays(B, T, H, K, decay):
    """ROADMAP C1: the plain path (ops.rwkv6_scan on the CPU at T > 1,
    ref.rwkv6_chunked_exact) against JAX's sequential oracle where the
    clipped log-space ref.rwkv6_chunked is off by up to 13.7."""
    strong = decay == "strong"
    args = _rwkv_inputs(B, T, H, K, seed=T + H + 1, strong_decay=strong,
                        decay_logit=None if strong else decay)
    want = j_rwkv6["rwkv6_sequential"](*map(jnp.asarray, args))
    _check(ops.rwkv6_scan(*map(torch.from_numpy, args)), want)
    _check(ops.rwkv6_scan(*map(torch.from_numpy, args), impl="plain"), want)


@pytest.mark.parametrize("B,T,H,sms,want", [
    (1, 1024, 32, 132, 64),     # rwkv6-1.6b prefill: 512 blocks
    (1, 300, 32, 132, 32),      # 5 chunks of 64 would be 160 blocks
    (1, 79, 32, 132, 16),       # the shortest served prompt: 5 chunks
    (8, 1, 32, 132, 16),        # decode: T <= c, the single pass
    (8, 200, 32, 132, 64),      # 4 chunks x 256 (b, h) = 1024 blocks
    (2, 64, 2, 132, 16),
])
def test_rwkv6_chunk_plan(B, T, H, sms, want):
    """The wrapper's chunk size, a function of shapes and SM count only:
    one of CHUNKS, the largest that keeps BLOCKS_PER_SM walk blocks per SM
    where one does."""
    c = rk.plan_chunks(B, T, H, sms)
    assert c == want and c in rk.CHUNKS
    big = max(rk.CHUNKS)
    assert (c == big) == (B * H * -(-T // big) >= rk.BLOCKS_PER_SM * sms)
    assert c == min(rk.CHUNKS) or B * H * -(-T // c) >= rk.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("B,T,Din,N,chunk", [(2, 32, 64, 8, 256),
                                             (1, 64, 128, 16, 256),
                                             (2, 50, 32, 8, 16)])
def test_ssm_twins_match_jax(B, T, Din, N, chunk):
    """(2, 50) with chunk 16: T not a multiple of the chunk (the pad
    path), four chunks of the doubling scan."""
    args = _ssm_inputs(B, T, Din, N, seed=T + Din)
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(torch.from_numpy, args))
    want = j_ssm["ssm_sequential"](*jargs)
    _check(ref.ssm_sequential(*targs), want)
    _check(ref.ssm_chunked(*targs, chunk=chunk), want)
    _check(ops.ssm_scan(*targs), want)                   # CPU -> chunked
    _check(ops.ssm_scan(*targs, impl="naive"), want)
    if chunk == 256:                # the TPU kernel's own test shapes
        _check(ref.ssm_chunked(*targs),
               jax_ssm_kernel(*jargs, d_block=32, interpret=True))
    else:                           # both pad paths
        _check(ref.ssm_chunked(*targs, chunk=chunk),
               j_ssm["ssm_chunked"](*jargs, chunk=chunk))


def test_single_step_twins_match_jax():
    """T == 1 (decode): ops takes the single-step versions on the CPU."""
    r_args = _rwkv_inputs(3, 1, 4, 16, seed=5)
    want = j_rwkv6["rwkv6_single_step"](*map(jnp.asarray, r_args))
    t_args = tuple(map(torch.from_numpy, r_args))
    _check(ref.rwkv6_single_step(*t_args), want)
    _check(ops.rwkv6_scan(*t_args), want)
    _check(ref.rwkv6_sequential(*t_args), want)
    s_args = _ssm_inputs(3, 1, 32, 8, seed=6)
    want = j_ssm["ssm_single_step"](*map(jnp.asarray, s_args))
    t_args = tuple(map(torch.from_numpy, s_args))
    _check(ref.ssm_single_step(*t_args), want)
    _check(ops.ssm_scan(*t_args), want)
    _check(ref.ssm_sequential(*t_args), want)


def test_scan_dispatch_rejects_what_it_cannot_run():
    """No fallback: impl='cuda' on CPU tensors raises, the wrappers take
    CUDA tensors only, and nothing counts a launch."""
    before = (rk.launches, ss.launches)
    r_args = tuple(map(torch.from_numpy, _rwkv_inputs(1, 4, 2, 16, 0)))
    s_args = tuple(map(torch.from_numpy, _ssm_inputs(1, 4, 32, 8, 0)))
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*r_args, impl="cuda")
    with pytest.raises(ValueError):
        ops.ssm_scan(*s_args, impl="cuda")
    with pytest.raises(ValueError):
        ops.ssm_scan(*s_args, impl="pallas")
    with pytest.raises(ValueError):                 # CPU tensor, no fallback
        rk.rwkv6_scan(*r_args)
    with pytest.raises(ValueError):
        ss.ssm_scan(*s_args)
    assert (rk.launches, ss.launches) == before


def test_plain_scans_write_state_out():
    """state_out on the plain paths: the final state is copied into it and
    returned in it, aliasing the input state included."""
    r_args = tuple(map(torch.from_numpy, _rwkv_inputs(2, 1, 2, 16, 7)))
    want = ops.rwkv6_scan(*r_args)
    state = r_args[-1].clone()
    got = ops.rwkv6_scan(*r_args[:-1], state, state_out=state)
    assert got[1] is state
    _check(got, want)
    s_args = tuple(map(torch.from_numpy, _ssm_inputs(2, 5, 32, 8, 8)))
    for impl in (None, "naive"):
        want = ops.ssm_scan(*s_args, impl=impl)
        h = s_args[-1].clone()
        got = ops.ssm_scan(*s_args[:-1], h, state_out=h, impl=impl)
        assert got[1] is h
        _check(got, want)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_decode_step_writes_recurrent_state_in_place(arch, monkeypatch):
    """A decode step hands each scan its cache slot as state_out, leaves
    every cache leaf in its storage (data_ptr unchanged) and still matches
    JAX's committed decode, logits and every leaf, from random recurrent
    states (reduced configs; jamba on the first 4 layers of its period)."""
    cfg_j, cfg_t, params_j, model = _both(arch, seed=2)
    rng = np.random.default_rng(4)
    cache_t = TM.init_cache(cfg_t, 2, 48, device="cpu")
    for layers in cache_t.values():
        for layer in layers:
            for name, t in layer["mixer"].items():
                if name not in ("k", "v"):
                    t.copy_(torch.from_numpy(0.3 * rng.standard_normal(
                        tuple(t.shape)).astype(np.float32)))

    def port_leaf(path, leaf):
        """The port's value of a recurrent leaf; attention K/V stay zero."""
        keys = [getattr(key, "key", getattr(key, "idx", None))
                for key in path]
        if keys[-1] in ("k", "v"):
            return jnp.zeros(leaf.shape, leaf.dtype)
        node = cache_t
        for key in keys:
            node = node[key]
        return jnp.array(node.numpy(), copy=True)   # the port writes node

    cache_j = jax.tree_util.tree_map_with_path(
        port_leaf,
        jax.eval_shape(lambda: TM_J.init_cache(cfg_j, 2, 48)[0]))
    def storage():
        return {(g, li, name): t.untyped_storage().data_ptr()
                for g, layers in cache_t.items()
                for li, layer in enumerate(layers)
                for name, t in layer["mixer"].items()}

    ptrs = storage()
    seen = []
    for name in ("rwkv6_scan", "ssm_scan"):
        scan = getattr(ops, name)

        def spy(*args, scan=scan, **kw):
            seen.append(kw.get("state_out"))
            return scan(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    toks, lengths = rng.integers(0, cfg_j.vocab_size, size=2), np.array([5, 9])
    lj, new_j = jax.block_until_ready(j_decode(
        cfg_j, params_j, cache_j, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lengths, jnp.int32)))
    lt, new_t = model.decode_step(cache_t, torch.from_numpy(toks),
                                  torch.from_numpy(lengths))
    assert new_t is cache_t and seen and all(
        so is not None and so.untyped_storage().data_ptr() in ptrs.values()
        for so in seen)
    assert storage() == ptrs
    _check([lt], [lj])
    for g, layers in cache_t.items():
        for li, layer in enumerate(layers):
            for name, t in layer["mixer"].items():
                if name not in ("k", "v"):
                    assert _err(t, new_j[g][li]["mixer"][name]) < TOL, \
                        (li, name)


# ---------------------------------------------------------------------------
# mixers at the reduced configs
# ---------------------------------------------------------------------------
def _layer_params(jax_init, cfg, seed):
    """One layer's parameters shaped like the JAX init, drawn from numpy:
    matrices scaled by fan-in, the fp32 constants perturbed around their
    init values so every term of the mixer is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_init(cfg, jax.random.PRNGKey(0))[0])
    centre = {"A_log": np.log(np.arange(1, cfg.mamba_d_state + 1)),
              "dt_bias": np.log(np.expm1(0.01)), "Dskip": 1.0,
              "decay_base": -1.0, "ln_x_scale": 1.0}
    out = {}
    for name, leaf in shapes.items():
        x = rng.standard_normal(leaf.shape)
        if name in centre:
            x = centre[name] + 0.3 * x
        elif len(leaf.shape) >= 2 and name not in ("mu", "u"):
            x = x / np.sqrt(leaf.shape[-2] if name == "maa_w2"
                            else leaf.shape[0])
        else:
            x = 0.3 * x
        out[name] = x.astype(np.float32)
    return out


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("S_len", [7, 1], ids=["prefill", "decode"])
def test_mamba_matches_jax(S_len):
    """_mamba_conv and mamba_forward (reduced jamba: Din 128, N 8, K 4,
    dt_rank 8) from a non-zero state, new state included."""
    cfg_j = jax_get_config("jamba-1.5-large-398b").reduced()
    cfg_t = get_config("jamba-1.5-large-398b").reduced()
    p = _layer_params(JS.init_mamba, cfg_j, seed=S_len)
    rng = np.random.default_rng(10 + S_len)
    B, Din, K = 2, cfg_t.d_inner, cfg_t.mamba_conv
    x = rng.standard_normal((B, S_len, cfg_t.d_model)).astype(np.float32)
    state = {"h": 0.1 * rng.standard_normal((B, Din, cfg_t.mamba_d_state)),
             "conv": rng.standard_normal((B, K - 1, Din))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    x_in = rng.standard_normal((B, S_len, Din)).astype(np.float32)
    conv_j = j_mamba_conv(_to_jax(p), jnp.asarray(x_in),
                          jnp.asarray(state["conv"]))
    conv_t = S._mamba_conv(_to_torch(p), torch.from_numpy(x_in),
                           torch.from_numpy(state["conv"]))
    _check(conv_t, conv_j)
    out_j, st_j = j_mamba_forward(cfg_j, _to_jax(p), jnp.asarray(x),
                                  _to_jax(state))
    out_t, st_t = S.mamba_forward(cfg_t, _to_torch(p), torch.from_numpy(x),
                                  _to_torch(state))
    _check([out_t], [out_j])
    assert set(st_t) == set(st_j)
    for name in st_j:
        _check([st_t[name]], [st_j[name]])


@pytest.mark.parametrize("S_len", [7, 1], ids=["prefill", "decode"])
def test_rwkv_mixers_match_jax(S_len):
    """rwkv_time_mix (ddlerp, LoRA decay, per-head groupnorm) and
    rwkv_channel_mix (reduced rwkv6: D 64, 4 heads of 16) from a non-zero
    state, new states included."""
    cfg_j = jax_get_config("rwkv6-1.6b").reduced()
    cfg_t = get_config("rwkv6-1.6b").reduced()
    p = _layer_params(JS.init_rwkv, cfg_j, seed=20 + S_len)
    rng = np.random.default_rng(30 + S_len)
    B, D, H, K = 2, cfg_t.d_model, cfg_t.rwkv_heads, cfg_t.rwkv_head_dim
    x = rng.standard_normal((B, S_len, D)).astype(np.float32)
    state = {"wkv": 0.1 * rng.standard_normal((B, H, K, K)),
             "shift_tm": rng.standard_normal((B, D)),
             "shift_cm": rng.standard_normal((B, D))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    tm_state = {k: state[k] for k in ("wkv", "shift_tm")}
    out_j, st_j = j_time_mix(cfg_j, _to_jax(p), jnp.asarray(x),
                             _to_jax(tm_state))
    out_t, st_t = S.rwkv_time_mix(cfg_t, _to_torch(p), torch.from_numpy(x),
                                  _to_torch(tm_state))
    _check([out_t], [out_j])
    assert set(st_t) == set(st_j)
    for name in st_j:
        _check([st_t[name]], [st_j[name]])
    cm_state = {"shift_cm": state["shift_cm"]}
    out_j, st_j = j_channel_mix(cfg_j, _to_jax(p), jnp.asarray(x),
                                _to_jax(cm_state))
    out_t, st_t = S.rwkv_channel_mix(cfg_t, _to_torch(p),
                                     torch.from_numpy(x),
                                     _to_torch(cm_state))
    _check([out_t, st_t["shift_cm"]], [out_j, st_j["shift_cm"]])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk,strong", [
    (1, None, False), (64, None, False), (80, None, False),
    (200, None, False),                         # planned chunks, multi-pass
    (31, 32, False), (32, 32, False), (33, 32, False),   # chunk edges
    (63, 64, False), (64, 64, False), (65, 64, False),
    (200, None, True),                          # strong decay, multi-pass
])
def test_cuda_rwkv6_scan_matches_oracle(cuda_device, T, chunk, strong):
    """Kernel vs the sequential oracle on the card, fp32, at the
    reference's 1e-4 (chip_smoke.py runs the full case list): the single
    pass (T <= chunk) and the three chunked passes, one counted launch per
    call either way."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _rwkv_inputs(2, T, 2, 16, seed=T, strong_decay=strong)]
    before = rk.launches
    got = rk.rwkv6_scan(*args, chunk=chunk)
    assert rk.launches == before + 1
    want = ops.rwkv6_scan(*args, impl="naive")
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [(40, 64), (100, 32)])
def test_cuda_rwkv6_scan_state_out(cuda_device, T, chunk):
    """state_out: the final state written over the input state, on the
    single pass (T <= chunk) and on the chunked passes."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _rwkv_inputs(2, T, 2, 16, seed=3)]
    want = ops.rwkv6_scan(*args, impl="naive")
    state = args[-1].clone()
    got = rk.rwkv6_scan(*args[:-1], state, state_out=state, chunk=chunk)
    assert got[1] is state
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Din,N", [
    (2, 1, 64, 8), (2, 32, 64, 8), (2, 50, 64, 8),
    (2, 37, 16 * 64 + 48, 16),          # N = 16, Din not whole blocks
    (1, 70, 200, 16),
    (2, 33, 96, 5),                     # N not a power of two
])
def test_cuda_ssm_scan_matches_oracle(cuda_device, B, T, Din, N):
    """Kernel vs the sequential oracle on the card, fp32, at 1e-4, with the
    final h written in place over h0."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _ssm_inputs(B, T, Din, N, seed=T)]
    want = ops.ssm_scan(*args, impl="naive")
    before = ss.launches
    h = args[-1].clone()
    got = ss.ssm_scan(*args[:-1], h, state_out=h)
    assert ss.launches == before + 1 and got[1] is h
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < TOL
