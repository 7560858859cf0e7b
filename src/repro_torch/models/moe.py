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

Expert parallelism (a model on a mesh, ``moe_forward(..., tp=, rows=)``;
the reference's rules: experts over "model", their d_ff over the data axes,
``expdata`` experts over ("data", "model"), ``fsdp`` d_ff whole and D
gathered). The reference's SPMD semantics are the unsharded model's:
capacity from the global T, drops in GShard order over every data shard,
aux losses over all T. So each card gathers the layer's tokens over the
``flat_tokens`` axes (``sharding.gather_from(..., scatter=True)``: its
backward reduce-scatters the gradient, each card's experts giving every
token a different part), routes the global T with ``ops.moe_route`` (the
same launch on every card: weights, ids, maps and aux are the reference's),
dispatches only its ``E / |experts axes|`` experts' slots, runs them at its
``expert_ff`` slice, and sums the cards' parts of the combined (T, D):
reduce-scattered over the token axes that also shard the experts or their
d_ff (back to its own tokens), all-reduced over the other expert axes
("model"). No weight moves. A token axis that holds no part of the experts
(``fsdp``'s "data") computes the same parts on each of its cards: a card
keeps its own rows. Where the batch is replicated over the token axes (a
one-sequence prefill) each card takes its slice of the flat tokens first
and gathers the output at the end, so the backward is the same as for a
sharded batch.

Under ``seqpar`` (``TPPlan.sp``: x holds this card's rows of the sequence)
the layer first gathers the sequence over "model" (before the flatten and
the token gather, so the global token order, the capacity and the drop
order are the unsharded model's; backward: this card's rows, the gradient
being whole over "model" there), and its output leaves by a reduce-scatter
of the sequence over "model" in place of the all-reduce (by this card's
rows where the experts are not cut over it).

The router's gradient has two parts: the aux losses', which every card
computes whole from the global logits, and the combine weights', which each
card has only for its experts and d_ff slice. The combine weights and the
expert path's input pass through ``sharding.copy_to`` over the all-reduced
expert axes, so both gradients come out whole over "model" (equal on its
cards, as the Megatron pair keeps the residual stream), and the train step
averages the router over the data axes as any replicated leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops, ref

Params = dict


# logical axes of one layer's leaves (the reference's ``init_moe``)
MOE_AXES = {
    "router": ("model_d", None),
    "w_gate": ("experts", "model_d", "expert_ff"),
    "w_up": ("experts", "model_d", "expert_ff"),
    "w_down": ("experts", "expert_ff", "model_d"),
}


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


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------
DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class EPPlan:
    """One MoE call's collectives on a mesh (module docstring): the token
    axes ``ft`` (the ``flat_tokens`` entry of the global T) and whether
    the rows came replicated over them (``narrow``); the token axes that
    also shard the experts or their d_ff (``rs``: the combine is
    reduce-scattered over them) or do not (``own``: a card keeps its rows);
    the other expert axes (``ar``: the gradients of the expert path's
    inputs all-reduced over them, and the output, but over the sequence
    axes ``seq``); this card's experts [e0, e0 + el). ``seq``: the
    residual stream's sequence entry under ``seqpar`` (None: whole), whose
    exit is a reduce-scatter where its axes are in ``ar`` (``seq_sum``),
    else this card's rows."""

    layout: SH.Layout
    ft: tuple
    narrow: bool
    rs: tuple
    own: tuple
    ar: tuple
    e0: int
    el: int
    seq: tuple = ()
    seq_sum: bool = False

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """This card's rows (B, S_l, D) -> the sequence whole (B, S, D)."""
        return SH.gather_from(x, self.layout, self.seq, 1)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The tokens' sums (B, S, D), but over ``seq`` -> this card's
        rows (B, S_l, D)."""
        if self.seq_sum:
            return SH.reduce_scatter(y, self.layout, self.seq, 1)
        return SH.split_to(y, self.layout, self.seq, 1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This card's flat tokens (T_l, D) -> the global (T, D)."""
        if self.narrow:
            x = SH._own_slice(x, self.layout, self.ft, 0)
        return SH.gather_from(x, self.layout, self.ft, 0, scatter=True)

    def into(self, t: torch.Tensor) -> torch.Tensor:
        """An input of this card's experts' part: its gradient summed over
        the all-reduced expert axes."""
        return SH.copy_to(t, self.layout, self.ar)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """This card's part of the combined (T, D) -> its tokens' sum over
        the cards."""
        if self.rs:
            y = SH.reduce_scatter(y, self.layout, self.rs, 0)
        elif self.own:
            y = SH._own_slice(y, self.layout, self.own, 0)
        y = SH.reduce_from(y, self.layout, tuple(
            a for a in self.ar if a not in self.seq))
        if self.narrow:
            y = SH.gather_from(y, self.layout, self.ft, 0, scatter=True)
        return y

    def collectives(self, train: bool = False,
                    recompute: int = 0, recompute_out: bool = True) -> dict:
        """The calls of one MoE layer by kind: the forward's, with
        ``train`` the backward's, and ``recompute`` forwards more (remat),
        whose collectives after the combine run only with
        ``recompute_out``."""
        ft, rs, ar, nar = bool(self.ft), bool(self.rs), bool(self.ar), \
            self.narrow
        sq, ssum = bool(self.seq), self.seq_sum
        head = {"all-gather": ft + sq}
        tail = {"reduce-scatter": rs + ssum,
                "all-reduce": any(a not in self.seq for a in self.ar),
                "all-gather": nar}
        n: dict = {}

        def add(d, k=1):
            for kind, v in d.items():
                n[kind] = n.get(kind, 0) + k * int(v)

        add(head, 1 + recompute)
        add(tail, 1 + (recompute if recompute_out else 0))
        if train:
            add({"reduce-scatter": ft + nar, "all-gather": rs + sq,
                 "all-reduce": 2 * ar})
        return {k: v for k, v in n.items() if v}


def ep_plan(cfg: ModelConfig, tp, rows, T: int,
            train: bool = False) -> EPPlan:
    """The ``EPPlan`` of a MoE call over ``T`` global tokens whose rows
    came sharded by spec entry ``rows`` (None: replicated) under the
    card's ``layers.TPPlan`` (its ``sp``: the sequence under ``seqpar``);
    ``train``: a differentiable call."""
    lay = tp.layout

    def live(entry):
        return tuple(a for a in SH.entry_axes(entry) if lay.sizes[a] > 1)

    ft = live(lay.spec(("flat_tokens",), (T,))[0])
    got = live(rows)
    if got and got != ft:
        raise NotImplementedError(f"token rows over {got} against "
                                  f"flat_tokens over {ft}")
    experts = set(live(tp.experts)) | set(live(tp.expert_ff))
    rs = tuple(a for a in ft if a in experts)
    own = tuple(a for a in ft if a not in experts)
    if rs and own:
        raise NotImplementedError(f"token axes {ft} shard the experts only "
                                  f"in part ({rs})")
    ar = tuple(a for a in lay.sizes if a in experts and a not in ft)
    if train and any(a in DATA_AXES for a in ar):
        raise NotImplementedError(
            f"T={T} does not divide over the data axes that shard the "
            "experts: their gradients would be one card's")
    seq = live(tp.sp)
    if set(seq) & set(ft):
        raise NotImplementedError(f"the sequence over {seq} against "
                                  f"flat_tokens over {ft}")
    return EPPlan(lay, ft, bool(ft) and not got, rs, own, ar, tp.e0, tp.el,
                  seq, bool(seq) and set(seq) <= set(ar))


def _local_slots(slot_of, token_of_slot, tk_of_slot, e0: int, el: int,
                 cap: int):
    """The maps of this card's experts [e0, e0 + el): the slots of every
    other expert become the pad slot (el * cap), whose row is zero."""
    lo, hi, pad = e0 * cap, (e0 + el) * cap, el * cap
    slot_of = torch.where((slot_of >= lo) & (slot_of < hi), slot_of - lo, pad)

    def mine(m):
        return torch.cat([m[:, lo:hi], m[:, -1:]], 1)

    return slot_of, mine(token_of_slot), mine(tk_of_slot)


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                impl: Optional[str] = None, tp=None, rows=None):
    """x: (B, S, D) -> (out (B, S, D), aux_losses dict). ``impl`` goes to
    ``ops.moe_route`` (``ops.moe_gating`` on the dense path). With ``tp``
    (the card's ``layers.TPPlan`` on a mesh) ``x`` is this card's rows,
    sharded by spec entry ``rows`` (None: every card has all of them), and
    ``p`` its expert shards (module docstring); under ``tp.sp`` ``x`` is
    this card's rows of the sequence, and so is the output."""
    if tp is not None and cfg.moe_impl == "dense":
        raise NotImplementedError("the dense MoE oracle runs on one card")
    ep = None
    if tp is not None:
        S = x.shape[1] * tp.layout.size(tp.sp)
        ep = ep_plan(cfg, tp, rows, x.shape[0] * S * tp.layout.size(rows),
                     train=torch.is_grad_enabled() and x.requires_grad)
        x = ep.enter(x)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    x_flat = x.reshape(B * S, D)
    if cfg.moe_impl == "dense":
        return _dense(cfg, p, x_flat, B, S, impl)
    if ep is not None:
        x_flat = ep.gather(x_flat)
    T = x_flat.shape[0]
    logits = x_flat.float() @ p["router"]                       # (T, E) f32
    nb = cfg.moe_block_dispatch
    if not (nb and T % nb == 0 and T // nb >= E // max(1, K)):
        nb = 1                       # capacity path: one block of T tokens
    Tb = T // nb
    cap = capacity(cfg, Tb)
    weights, _, slot_of, token_of_slot, tk_of_slot, aux = ops.moe_route(
        logits, K, cap=cap, nb=nb, impl=impl)
    weights = weights.reshape(nb, Tb, K).to(x.dtype)
    el = E
    if ep is not None:
        x_flat, weights = ep.into(x_flat), ep.into(weights)
        el = ep.el
        if el < E:
            slot_of, token_of_slot, tk_of_slot = _local_slots(
                slot_of, token_of_slot, tk_of_slot, ep.e0, el, cap)
    x_pad = _pad_row(x_flat.reshape(nb, Tb, D))
    disp = _dispatch(x_pad, token_of_slot, slot_of)[:, :-1]  # (nb,el*cap,D)
    disp = disp.reshape(nb, el, cap, D).transpose(0, 1).reshape(
        el, nb * cap, D)
    y = _expert_ffn(p, disp)                              # (el, nb*cap, D)
    y = y.reshape(el, nb, cap, D).transpose(0, 1).reshape(nb, el * cap, D)
    out = _combine(_pad_row(y), weights, slot_of, token_of_slot,
                   tk_of_slot).reshape(T, D)
    if ep is None:
        return out.reshape(B, S, D), aux
    return ep.leave(ep.out(out).reshape(B, S, D)), aux


def _dense(cfg: ModelConfig, p: Params, x_flat: torch.Tensor, B: int,
           S: int, impl: Optional[str]):
    """The oracle path: every expert on every token."""
    T, E, K = x_flat.shape[0], cfg.n_experts, cfg.moe_top_k
    logits = x_flat.float() @ p["router"]
    weights, idx, aux = ops.moe_gating(logits, K, impl=impl)
    dt = x_flat.dtype
    g = torch.einsum("td,edf->tef", x_flat, p["w_gate"].to(dt))
    h = torch.einsum("td,edf->tef", x_flat, p["w_up"].to(dt))
    y_all = torch.einsum("tef,efd->ted", F.silu(g) * h, p["w_down"].to(dt))
    gate_full = torch.zeros((T, E), dtype=torch.float32,
                            device=x_flat.device).scatter_add_(
        1, idx.long(), weights)
    out = torch.einsum("ted,te->td", y_all.float(), gate_full)
    return out.reshape(B, S, -1).to(dt), aux
