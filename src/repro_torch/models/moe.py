"""Mixture-of-Experts layer (port of ``repro/models/moe.py``).

Three paths, as in the reference:
  * ``capacity`` — top-k gating, then capacity-bounded gather-only dispatch:
    integer index maps (slot_of (T, K) token -> slot, token_of_slot /
    tk_of_slot slot -> token), and every float movement is a gather. Tokens
    above an expert's capacity are dropped in GShard order: by expert, then
    by flat index t * K + k. ``ops.moe_route`` computes the gating, the maps
    and the aux losses at once: one kernel launch on the card, integer
    sorts and scatters in the plain version.
  * ``cfg.moe_block_dispatch = nb`` — the same over nb blocks of T / nb
    tokens, each with its own capacity (GShard group capacity). The
    capacity path is this path with one block and runs through the same
    code; the reference's ``vmap`` over blocks is a leading block dim here.
  * ``cfg.moe_impl = "dense"`` — the oracle: every expert on every token.

Everything is on the device with capacities from static shapes, so a step
never waits on the host.

Training: ``_dispatch`` and ``_combine`` are ``autograd.Function``s with
the reference's gather-only backwards (its custom VJPs), so no float
scatter, and no atomic, runs in the backward either; ``ops.moe_route``
gives the router logits their gradient (``ref.topk_gating_bwd``), and
``moe_forward`` returns the aux losses for ``transformer.loss_fn``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref

Params = dict


def init_moe(cfg: ModelConfig, rep: int, init) -> Params:
    """Stacked (leading ``rep`` dim) MoE parameters; the router is fp32
    whatever the parameter dtype, as in the reference."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in = (2.0 / (D + Fd)) ** 0.5
    return {"router": init((rep, D, E), D ** -0.5, torch.float32),
            "w_gate": init((rep, E, D, Fd), s_in),
            "w_up": init((rep, E, D, Fd), s_in),
            "w_down": init((rep, E, Fd, D), s_in)}


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: capacity_factor * T * K / E, plus one,
    rounded up to a multiple of 8 (at least 8), at most T * K."""
    K, E = cfg.moe_top_k, cfg.n_experts
    cap = int(cfg.capacity_factor * T * K / E) + 1
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, T * K)


# ---------------------------------------------------------------------------
# Index maps (integers only; tiny)
# ---------------------------------------------------------------------------
# ``build_dispatch_indices`` over a leading block dim: idx (N, T, K)
_dispatch_indices = ref.dispatch_indices


def build_dispatch_indices(idx: torch.Tensor, E: int, cap: int):
    """idx: (T, K) expert choices. Returns (int64)
    slot_of: (T, K) destination slot in [0, E*cap] (E*cap = dropped),
    token_of_slot: (E*cap+1,) source token in [0, T] (T = empty slot),
    tk_of_slot: (E*cap+1,) flat (t*K+k) index in [0, T*K] (T*K = empty)."""
    return tuple(t[0] for t in _dispatch_indices(idx[None], E, cap))


# ---------------------------------------------------------------------------
# Gather-only dispatch / combine, with the reference's custom VJPs
# ---------------------------------------------------------------------------
def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (N, R, ...) gathered per block at index (N, ...) -> (N, ..., ...)."""
    blk = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (index.dim() - 1))
    return x[blk, index]


def _sum_k(terms: torch.Tensor) -> torch.Tensor:
    """terms (N, T, K, ...) summed over k one by one, as the reference's
    ``sum`` over k does."""
    out = terms[:, :, 0]
    for k in range(1, terms.shape[2]):
        out = out + terms[:, :, k]
    return out


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x (N, R, ...) with one zero row appended to each block."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1) + x.shape[2:])], 1)


class _Dispatch(torch.autograd.Function):
    """x_pad (N, T+1, D), zero pad row per block -> (N, E*cap+1, D), the
    rows ``token_of_slot`` names. Backward (the reference's
    ``_dispatch_bwd``): a token's gradient is the sum of its K slots'
    (``slot_of`` (N, T, K); a dropped entry's slot is the zero pad row)."""

    @staticmethod
    def forward(ctx, x_pad, token_of_slot, slot_of):
        ctx.save_for_backward(slot_of)
        return _rows(x_pad, token_of_slot)

    @staticmethod
    def backward(ctx, dy):
        (slot_of,) = ctx.saved_tensors
        return _pad_row(_sum_k(_rows(dy, slot_of))), None, None


class _Combine(torch.autograd.Function):
    """y_pad (N, E*cap+1, D) zero pad row, w (N, T, K) in the activation
    dtype -> (N, T, D): each token's K expert outputs weighted and summed
    in w's dtype. Backward (the reference's ``_combine_bwd``): dw from the
    gathered outputs, and a slot's dy from its one token's dout times its
    entry's weight (``token_of_slot``, ``tk_of_slot``); gathers only."""

    @staticmethod
    def forward(ctx, y_pad, w, slot_of, token_of_slot, tk_of_slot):
        ctx.save_for_backward(y_pad, w, slot_of, token_of_slot, tk_of_slot)
        return _sum_k(w[..., None] * _rows(y_pad, slot_of).to(w.dtype))

    @staticmethod
    def backward(ctx, dout):
        y_pad, w, slot_of, token_of_slot, tk_of_slot = ctx.saved_tensors
        N, T, K = w.shape
        dw = (dout[:, :, None] * _rows(y_pad, slot_of).to(dout.dtype)).sum(-1)
        w_flat = _pad_row(w.reshape(N, T * K))
        dy = (_rows(w_flat, tk_of_slot)[..., None].to(dout.dtype)
              * _rows(_pad_row(dout), token_of_slot)).to(y_pad.dtype)
        return dy, dw.to(w.dtype), None, None, None


def _dispatch(x_pad: torch.Tensor, token_of_slot: torch.Tensor,
              slot_of: torch.Tensor) -> torch.Tensor:
    return _Dispatch.apply(x_pad, token_of_slot, slot_of)


def _combine(y_pad: torch.Tensor, w: torch.Tensor, slot_of: torch.Tensor,
             token_of_slot: torch.Tensor,
             tk_of_slot: torch.Tensor) -> torch.Tensor:
    return _Combine.apply(y_pad, w, slot_of, token_of_slot, tk_of_slot)


def _expert_ffn(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D); per-expert gated FFN as batched products."""
    dt = xs.dtype
    g = torch.bmm(xs, p["w_gate"].to(dt))
    h = torch.bmm(xs, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * h, p["w_down"].to(dt))


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                impl: Optional[str] = None):
    """x: (B, S, D) -> (out (B, S, D), aux_losses dict). ``impl`` goes to
    ``ops.moe_route`` (``ops.moe_gating`` on the dense path)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    x_flat = x.reshape(T, D)
    logits = x_flat.float() @ p["router"]                       # (T, E) f32

    if cfg.moe_impl == "dense":
        weights, idx, aux = ops.moe_gating(logits, K, impl=impl)
        dt = x.dtype
        g = torch.einsum("td,edf->tef", x_flat, p["w_gate"].to(dt))
        h = torch.einsum("td,edf->tef", x_flat, p["w_up"].to(dt))
        y_all = torch.einsum("tef,efd->ted", F.silu(g) * h,
                             p["w_down"].to(dt))
        gate_full = torch.zeros((T, E), dtype=torch.float32,
                                device=x.device).scatter_add_(
            1, idx.long(), weights)
        out = torch.einsum("ted,te->td", y_all.float(), gate_full)
        return out.reshape(B, S, D).to(x.dtype), aux

    nb = cfg.moe_block_dispatch
    if not (nb and T % nb == 0 and T // nb >= E // max(1, K)):
        nb = 1                       # capacity path: one block of T tokens
    Tb = T // nb
    cap = capacity(cfg, Tb)
    weights, _, slot_of, token_of_slot, tk_of_slot, aux = ops.moe_route(
        logits, K, cap=cap, nb=nb, impl=impl)
    x_pad = _pad_row(x_flat.reshape(nb, Tb, D))
    disp = _dispatch(x_pad, token_of_slot, slot_of)[:, :-1]  # (nb,E*cap,D)
    disp = disp.reshape(nb, E, cap, D).transpose(0, 1).reshape(E, nb * cap, D)
    y = _expert_ffn(p, disp)                              # (E, nb*cap, D)
    y = y.reshape(E, nb, cap, D).transpose(0, 1).reshape(nb, E * cap, D)
    out = _combine(_pad_row(y), weights.reshape(nb, Tb, K).to(x.dtype),
                   slot_of, token_of_slot, tk_of_slot)
    return out.reshape(B, S, D), aux
