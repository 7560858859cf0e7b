"""Port MoE (repro_torch.kernels gating, repro_torch.models.moe) vs the JAX
package on shared numpy inputs, on the CPU.

The JAX Pallas gating kernel runs in interpret mode, as
tests/test_kernels.py::test_moe_gating_kernel runs it. Ids must be equal;
weights within 1e-6 (tests/test_kernels.py's tolerance); the aux losses
within 1e-6 relative (z_loss reaches ~60 at E=384, where one fp32 ulp is
3.8e-6); MoE outputs within 1e-5 in fp32 (the two sides sum the expert
products in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.moe_gating import moe_gating_topk as jax_gating_kernel
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.kernels import moe_gating as mg
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as M

ARCH = "granite-moe-1b-a400m"
GATING_SHAPES = [(100, 32, 4), (64, 8, 3), (257, 384, 8)]
# the JAX references, jitted: one compile per case instead of one per op
j_topk_gating = jax.jit(jref.topk_gating, static_argnums=1)
j_dispatch_indices = jax.jit(JM.build_dispatch_indices, static_argnums=(1, 2))
j_moe_forward = jax.jit(JM.moe_forward, static_argnums=0)


def _logits(T, E, seed):
    return (np.random.default_rng(seed).standard_normal((T, E)) * 2).astype(
        np.float32)


def _underflow_logits():
    """Rows whose logits sit > 104 apart, so fewer than k experts keep a
    non-zero fp32 probability (exp underflows)."""
    lg = np.full((3, 16), -120.0, np.float32)
    lg[0] = -110.0 * np.arange(16)                    # one survivor
    lg[1, [3, 8, 13]] = 0.0                           # three, tied
    lg[2, 9], lg[2, 2] = 1.0, 0.5                     # two
    return lg


def _check_gating(got, want_w, want_i):
    w, i, _ = got
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    assert float(np.max(np.abs(w.numpy() - np.asarray(want_w)))) < 1e-6


@pytest.mark.parametrize("T,E,k", GATING_SHAPES)
def test_topk_gating_matches_jax(T, E, k):
    lg = _logits(T, E, T)
    w_ref, i_ref, aux_ref = j_topk_gating(jnp.asarray(lg), k)
    w_ker, i_ker = jax_gating_kernel(jnp.asarray(lg), k, t_block=64,
                                     interpret=True)
    got = ops.moe_gating(torch.from_numpy(lg), k)          # CPU -> plain
    _check_gating(got, w_ref, i_ref)
    _check_gating(got, w_ker, i_ker)
    for name, want in aux_ref.items():
        assert abs(float(got[2][name]) - float(want)) <= 1e-6 * abs(
            float(want)), name
    # the aux losses from the ids and the softmax alone
    lf = torch.from_numpy(lg)
    aux = ref.gating_aux(lf, torch.softmax(lf, -1), got[1])
    for name in aux:
        assert torch.equal(aux[name], got[2][name]), name


def test_topk_gating_underflow_ids_distinct():
    """ROADMAP C-ref-2: the TPU kernel can repeat ids here; the port is held
    to ref.topk_gating (lax.top_k), whose ids are distinct."""
    lg = _underflow_logits()
    k = 8
    w_ref, i_ref, _ = j_topk_gating(jnp.asarray(lg), k)
    got = ops.moe_gating(torch.from_numpy(lg), k, impl="plain")
    _check_gating(got, w_ref, i_ref)
    for row in got[1].tolist():
        assert len(set(row)) == k, row


@pytest.mark.parametrize("cap", [8, 80])
def test_build_dispatch_indices_matches_jax(cap):
    """E=8, K=2, T=40: 80 choices; cap 8 drops tokens, cap 80 none."""
    idx = np.random.default_rng(0).integers(0, 8, size=(40, 2)).astype(
        np.int32)
    want = j_dispatch_indices(jnp.asarray(idx), 8, cap)
    got = M.build_dispatch_indices(torch.from_numpy(idx), 8, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((got[0] == 8 * cap).sum())
    assert (dropped > 0) == (cap == 8)


# routing cases: T, E, K, cap, nb, logits (None: _logits(T, E, T))
ROUTE_CASES = {
    "granite-drops": (64, 32, 8, 8, 1, None),
    "granite-no-drops": (64, 32, 8, 64, 1, None),   # cap = T: nothing drops
    "jamba-drops": (40, 16, 2, 8, 1, "hot"),        # experts 0, 1 take all
    "nb2": (64, 32, 8, 16, 2, None),
    "ragged": (100, 32, 8, 32, 1, None),            # 100 % 3, 100 % 8 != 0
    "underflow": (3, 16, 8, 8, 1, "underflow"),
}


def _route_logits(T, E, kind):
    if kind == "underflow":
        return _underflow_logits()
    lg = _logits(T, E, T)
    if kind == "hot":               # an adversarial route: every token to 0, 1
        lg[:, :2] += 20.0
    return lg


def _check_route(got, lg, K, cap, nb):
    """got: ops.moe_route's tuple (torch) against JAX's topk_gating and
    build_dispatch_indices per block: integers equal, weights within 1e-6,
    aux within 1e-6 relative. Returns the number of dropped entries."""
    w, ids, slot_of, tos, tks, aux = got
    T, E = lg.shape
    Tb = T // nb
    w_j, ids_j, aux_j = j_topk_gating(jnp.asarray(lg), K)
    _check_gating((w, ids, aux), w_j, ids_j)
    for name, want in aux_j.items():
        assert abs(float(aux[name]) - float(want)) <= 1e-6 * abs(
            float(want)), name
    assert slot_of.shape == (nb, Tb, K) and tos.shape == (nb, E * cap + 1)
    for g in range(nb):
        want = j_dispatch_indices(ids_j[g * Tb:(g + 1) * Tb], E, cap)
        for m, wm in zip((slot_of[g], tos[g], tks[g]), want):
            assert m.dtype == torch.int64
            np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
    return int((slot_of == E * cap).sum())


@pytest.mark.parametrize("how", ["plain", "sliced-1", "sliced-3",
                                 "sliced-8"])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_moe_route_matches_jax(case, how):
    """ops.moe_route (CPU: the plain version) and ref.moe_route_sliced, the
    CUDA kernel's partition over 1, 3 and 8 CTAs, against JAX."""
    T, E, K, cap, nb, kind = ROUTE_CASES[case]
    lg = _route_logits(T, E, kind)
    x = torch.from_numpy(lg)
    if how == "plain":
        got = ops.moe_route(x, K, cap=cap, nb=nb)
    else:
        got = ref.moe_route_sliced(x, K, cap, nb, int(how.split("-")[1]))
    dropped = _check_route(got, lg, K, cap, nb)
    if case.endswith("no-drops"):
        assert dropped == 0
    elif case.endswith("drops"):
        assert dropped > 0


@pytest.mark.parametrize("Tb,K,E,want", [
    (8, 8, 32, 1),          # granite decode
    (128, 8, 32, 1),
    (129, 8, 32, 2),
    (257, 8, 384, 3),
    (1000, 2, 16, 8),       # jamba's 1000-token path prefill
    (1024, 8, 32, 8),       # granite's serving prefill
    (2048, 8, 32, 8),       # a max_seq prefill
    (8192, 8, 32, 8),       # 1024 tokens x 8 a CTA: the shared-memory limit
])
def test_plan_route(Tb, K, E, want):
    ctas = mg.plan_route(Tb, K, E)
    assert ctas == want
    assert -(-Tb // ctas) * K <= mg.MAX_CTA_ENTRIES


def test_plan_route_raises_beyond_the_kernel():
    for Tb, K, E in ((8193, 8, 32), (8, 8, 385), (8, 9, 32), (8, 4, 2)):
        with pytest.raises(NotImplementedError):
            mg.plan_route(Tb, K, E)


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return {"router": normal((D, E), D), "w_gate": normal((E, D, Fd), D),
            "w_up": normal((E, D, Fd), D), "w_down": normal((E, Fd, D), Fd)}


@pytest.mark.parametrize("kw", [
    dict(moe_impl="dense"),
    dict(capacity_factor=0.5),                    # drops tokens
    dict(capacity_factor=16.0),                   # capacity = dense oracle
    dict(capacity_factor=0.5, moe_block_dispatch=4),
    dict(capacity_factor=16.0, moe_block_dispatch=4),
], ids=["dense", "capacity-drops", "capacity-16", "block-drops", "block-16"])
def test_moe_forward_matches_jax(kw):
    cfg_j = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    p = _moe_params(cfg_t, 0)
    x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg_t.d_model)).astype(np.float32)
    out_j, aux_j = j_moe_forward(cfg_j, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                 jnp.asarray(x))
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    # ids first: a router near-tie would otherwise surface as a float error
    logits = torch.from_numpy(x).reshape(-1, cfg_t.d_model) @ pt["router"]
    _, idx, _ = ops.moe_gating(logits, cfg_t.moe_top_k)
    _, idx_j, _ = j_topk_gating(jnp.asarray(logits.numpy()),
                                cfg_t.moe_top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    out_t, aux_t = M.moe_forward(cfg_t, pt, torch.from_numpy(x))
    assert float(np.max(np.abs(out_t.numpy() - np.asarray(out_j)))) < 1e-5
    for name in aux_j:
        assert abs(float(aux_t[name]) - float(aux_j[name])) <= 1e-6 * abs(
            float(aux_j[name]))
    if cfg_t.moe_impl == "dense":
        return
    nb = cfg_t.moe_block_dispatch or 1
    T = x.shape[0] * x.shape[1]
    cap = M.capacity(cfg_t, T // nb)
    slot_of = M._dispatch_indices(idx.reshape(nb, T // nb, -1),
                                  cfg_t.n_experts, cap)[0]
    dropped = int((slot_of == cfg_t.n_experts * cap).sum())
    if cfg_t.capacity_factor < 1:
        assert dropped > 0
    else:
        assert dropped == 0
        dense = M.moe_forward(dataclasses.replace(cfg_t, moe_impl="dense"),
                              pt, torch.from_numpy(x))[0]
        assert float((out_t - dense).abs().max()) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_gating_matches_plain(cuda_device):
    """Kernel vs plain version on the card (chip_smoke.py runs the full
    case list): ids equal, weights within 1e-6, aux within 1e-6
    relative."""
    cases = [(_logits(T, E, T), k) for T, E, k in GATING_SHAPES + [
        (8, 32, 8), (1024, 32, 8), (256, 16, 2)]]
    cases.append((_underflow_logits(), 8))
    for lg, k in cases:
        x = torch.from_numpy(lg).to(cuda_device)
        before = mg.launches
        w, i, aux = ops.moe_gating(x, k)
        assert mg.launches == before + 1
        w_ref, i_ref, aux_ref = ops.moe_gating(x, k, impl="plain")
        assert torch.equal(i.cpu(), i_ref.cpu())
        assert float((w - w_ref).abs().max()) < 1e-6
        for name, want in aux_ref.items():
            assert abs(float(aux[name]) - float(want)) <= 1e-6 * abs(
                float(want)), name


@pytest.mark.cuda
def test_cuda_moe_route_matches_plain(cuda_device):
    """The routing kernel vs its plain version on the card (chip_smoke.py
    runs the served shapes): integers equal, weights within 1e-6, aux
    within 1e-6 relative, one launch a call."""
    for T, E, K, cap, nb, kind in ROUTE_CASES.values():
        x = torch.from_numpy(_route_logits(T, E, kind)).to(cuda_device)
        before = mg.launches
        got = ops.moe_route(x, K, cap=cap, nb=nb)
        assert mg.launches == before + 1
        want = ops.moe_route(x, K, cap=cap, nb=nb, impl="plain")
        for g, w in zip(got[1:5], want[1:5]):
            assert torch.equal(g.cpu(), w.cpu())
        assert float((got[0] - want[0]).abs().max()) < 1e-6
        for name, w in want[5].items():
            assert abs(float(got[5][name]) - float(w)) <= 1e-6 * abs(
                float(w)), name
