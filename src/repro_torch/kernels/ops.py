"""Dispatch around the attention, MoE routing, RWKV6 and Mamba scan hot spots
(port of ``repro/kernels/ops.py``).

Every model-layer call site goes through this module. The implementation
follows the tensor: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to the plain PyTorch version. An explicit ``impl=`` overrides
that:

  * ``"cuda"``  — the kernel; raises on CPU tensors.
  * ``"plain"`` — the plain version on any device (``chip_smoke.py`` holds
    each kernel to it on the card).
  * ``"naive"`` — the materializing (attention) or sequential (scans)
    oracle.

Arguments a kernel does not take raise ``NotImplementedError`` on the kernel
path; nothing falls back to the plain version behind the caller's back.

Training: where grad mode is on and an input requires a gradient,
``flash_attention`` goes through ``ref.FlashAttentionTrainable`` (its
forward the kernel with the log-sum-exp on CUDA tensors, the plain
``ref.blockwise_fwd_lse`` otherwise; its backward the plain
``ref.flash_attention_bwd`` either way; a ragged last block is handled
like the others, so the kernel path trains at any Sq and Skv),
``moe_route`` / ``moe_gating`` through ``_Routed`` (the same one launch
forward; the backward ``ref.topk_gating_bwd``), and ``ssm_scan`` /
``rwkv6_scan`` through ``ref.SSMScanTrainable`` / ``ref.RWKV6ScanTrainable``
(forward segment by segment, ``ref.SCAN_SEGMENT`` steps each: the CUDA
kernel on CUDA tensors, ``ref.ssm_chunked`` / ``ref.rwkv6_chunked_exact``
otherwise; the backward plain PyTorch either way, ``ref.ssm_scan_bwd`` /
``ref.rwkv6_scan_bwd``, as the reference differentiates its jnp scans off
the TPU). ``impl="naive"`` stays autograd through the oracles. A scan with
a gradient raises on ``state_out``: training never writes a state in
place. Under ``torch.no_grad`` nothing of this runs: serving takes the
paths below.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import decode_attention as da
from . import flash_attention as fa
from . import moe_gating as mg
from . import ref
from . import rwkv6_scan as rk
from . import ssm_scan as ss

IMPLS = (None, "cuda", "plain", "naive")


def _kernel_path(impl: Optional[str], x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; options: {IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl == "cuda" or (impl is None and x.is_cuda)


def _differentiable(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


# the trainable attention's blocks (the reference's ops.flash_attention)
TRAIN_Q_BLOCK, TRAIN_KV_BLOCK = 512, 1024


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    q_offset: int = 0, impl: Optional[str] = None):
    """GQA attention. q:(B,Sq,H,Dh) k/v:(B,Skv,KVH,Dh) -> (B,Sq,H,Dh).

    Differentiable calls (see the module docstring) take the trainable
    path: on the kernel path always, at any Sq and Skv; on the plain path
    where the reference's jnp dispatch takes its
    ``flash_attention_trainable`` (dense, the blocks dividing the
    sequences), else autograd through the blockwise path, as there."""
    kernel = _kernel_path(impl, q)
    if kernel and (kv_lens is not None or q_offset != 0):
        raise NotImplementedError(
            "the CUDA flash_attention kernel is dense prefill: kv_lens "
            "and q_offset are not supported")
    if _differentiable(q, k, v) and impl != "naive":
        Sq, Skv = q.shape[1], k.shape[1]
        fits = (Sq % min(TRAIN_Q_BLOCK, Sq) == 0
                and Skv % min(TRAIN_KV_BLOCK, Skv) == 0)
        if kernel or (fits and kv_lens is None and q_offset == 0):
            fwd = functools.partial(fa.flash_attention, lse=True) \
                if kernel else None
            return ref.FlashAttentionTrainable.apply(
                q, k, v, causal, window, softcap, TRAIN_Q_BLOCK,
                TRAIN_KV_BLOCK, fwd)
    if kernel:
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    fn = ref.attention_naive if impl == "naive" else ref.blockwise_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              kv_lens=kv_lens, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     start: int = 0, partial: bool = False,
                     impl: Optional[str] = None):
    """Single-token GQA decode. q:(B,H,Dh) cache:(B,S,KVH,Dh) lengths:(B,)
    -> (B,H,Dh).

    Committed mode: the new token's K/V is in the cache and ``lengths``
    counts it. Append mode (``k_new``, ``v_new`` of shape (B,KVH,Dh)): the
    cache is read-only with ``lengths`` old tokens and the new token is
    merged into the softmax; on CUDA tensors the kernel's combine pass
    merges it, so append mode runs the kernel too.

    A cache sharded by sequence: its rows are the global positions
    ``start`` on, and ``partial=True`` returns the (B, H, Dh + 2) fp32
    partials [m, l, o] that ``decode_merge`` combines over the cards
    (``ref.decode_attention_direct``). ``"naive"`` takes no partials."""
    if _kernel_path(impl, q):
        return da.decode_attention(q, k_cache, v_cache, lengths,
                                   window=window, softcap=softcap,
                                   k_new=k_new, v_new=v_new, start=start,
                                   partial=partial)
    if impl == "naive":
        if start or partial:
            raise NotImplementedError("the naive decode oracle takes no "
                                      "start or partials")
        return ref.decode_attention_naive(q, k_cache, v_cache, lengths,
                                          window=window, softcap=softcap,
                                          k_new=k_new, v_new=v_new)
    return ref.decode_attention_direct(
        q, k_cache, v_cache, lengths, window=window, softcap=softcap,
        k_new=k_new, v_new=v_new, start=start, partial=partial)


def decode_merge(parts, dtype, *, impl: Optional[str] = None):
    """The cards' decode partials (R, B, H, Dh + 2) merged into the (B, H,
    Dh) row in ``dtype``: on CUDA tensors the decode kernel's combine pass
    (``decode_attention.merge``), else ``ref.decode_merge``."""
    if _kernel_path(impl, parts):
        return da.merge(parts.contiguous(), dtype)
    return ref.decode_merge(parts, dtype)


class _Routed(torch.autograd.Function):
    """A gradient for the router logits through a routing call ``route(
    logits) -> (weights, ids, *maps, aux)``: the forward is the call as it
    is (on CUDA tensors, the routing kernel's one launch); the backward,
    ``ref.topk_gating_bwd``, gives d logits from d weights, d lb_loss and
    d z_loss, as autodiff of the reference's ``topk_gating`` does. The ids
    and the maps carry no gradient."""

    @staticmethod
    def forward(ctx, logits, route):
        weights, ids, *maps, aux = route(logits)
        ctx.save_for_backward(logits, ids)
        ctx.mark_non_differentiable(ids, *maps)
        return (weights, ids, *maps, aux["lb_loss"], aux["z_loss"])

    @staticmethod
    def backward(ctx, d_weights, *rest):
        logits, ids = ctx.saved_tensors
        return ref.topk_gating_bwd(logits, ids, d_weights, rest[-2],
                                   rest[-1]), None


def _routed(route, logits):
    """``route(logits)``, through ``_Routed`` when it is differentiable."""
    if not _differentiable(logits):
        return route(logits)
    *out, lb_loss, z_loss = _Routed.apply(logits, route)
    return (*out, {"lb_loss": lb_loss, "z_loss": z_loss})


def moe_gating(logits, top_k: int, *, impl: Optional[str] = None):
    """Top-k softmax gating. logits (T, E) -> (weights (T, k) f32,
    ids (T, k) i32, aux {"lb_loss", "z_loss"}).

    The kernel path is one launch of the routing kernel without its maps,
    which writes the aux losses too. ``"plain"`` and ``"naive"`` both take
    ``ref.topk_gating``.
    """
    if _kernel_path(impl, logits):
        return _routed(lambda lg: mg.moe_gating(lg.float().contiguous(),
                                                top_k), logits)
    return _routed(lambda lg: ref.topk_gating(lg, top_k), logits)


def moe_route(logits, top_k: int, *, cap: int, nb: int,
              impl: Optional[str] = None):
    """Everything an MoE layer needs between its router product and its
    dispatch gather: top-k gating of logits (T, E) and the GShard dispatch
    maps of ``nb`` blocks of T / nb tokens with ``cap`` slots per expert.
    Returns (weights (T, k) f32, ids (T, k) i32, slot_of (nb, T/nb, k),
    token_of_slot (nb, E*cap+1), tk_of_slot (nb, E*cap+1), aux
    {"lb_loss", "z_loss"} over all T); the maps are int64 with each block's
    values local to it (``ref.dispatch_indices``).

    On CUDA tensors one launch of the routing kernel computes all of it;
    ``"plain"`` and ``"naive"`` take ``ref.moe_route`` (``ref.topk_gating``
    and ``ref.dispatch_indices``)."""
    if _kernel_path(impl, logits):
        return _routed(lambda lg: mg.moe_route(lg.float().contiguous(),
                                               top_k, cap, nb), logits)
    return _routed(lambda lg: ref.moe_route(lg, top_k, cap, nb), logits)


def _into(result, state_out):
    """The plain paths' ``state_out``: copy the final state into it."""
    if state_out is None:
        return result
    out, state = result
    state_out.copy_(state)
    return out, state_out


def _scan_trains(state_out, *xs) -> bool:
    """True where a scan is differentiable; it then refuses ``state_out``
    (training never writes a state in place)."""
    if not _differentiable(*xs):
        return False
    if state_out is not None:
        raise ValueError("state_out with a gradient: training never writes "
                         "a state in place")
    return True


def rwkv6_scan(r, k, v, w, u, state, *, impl: Optional[str] = None,
               state_out: Optional[torch.Tensor] = None):
    """WKV6 recurrence. r/k/w (B, T, H, K), v (B, T, H, V), u (H, K),
    state (B, H, K, V) -> (out (B, T, H, V), final state fp32).

    A CUDA tensor goes to the kernel at every T, T == 1 included (one launch
    where the single-step version takes about eight). The plain path takes
    ``ref.rwkv6_single_step`` at T == 1 and ``ref.rwkv6_chunked_exact``
    otherwise (the reference's ``rwkv6_chunked`` clips its exponents at
    ±60 and is wrong under strong decays); ``"naive"`` the sequential
    oracle. Differentiable calls go through ``ref.RWKV6ScanTrainable``
    (the module docstring).
    ``state_out`` (fp32, the state's shape) receives the final state, which
    is then returned in it; it may be ``state`` itself."""
    kernel = _kernel_path(impl, r)
    if _scan_trains(state_out, r, k, v, w, u, state) and impl != "naive":
        return ref.RWKV6ScanTrainable.apply(
            r, k, v, w, u, state, rk.rwkv6_scan if kernel else None)
    if kernel:
        return rk.rwkv6_scan(r, k, v, w, u, state, state_out=state_out)
    if impl == "naive":
        res = ref.rwkv6_sequential(r, k, v, w, u, state)
    elif r.shape[1] == 1:
        res = ref.rwkv6_single_step(r, k, v, w, u, state)
    else:
        res = ref.rwkv6_chunked_exact(r, k, v, w, u, state)
    return _into(res, state_out)


def ssm_scan(x, dt, A, Bm, Cm, D, h0, *, impl: Optional[str] = None,
             state_out: Optional[torch.Tensor] = None):
    """Mamba selective scan. x/dt (B, T, Din), A (Din, N), Bm/Cm (B, T, N),
    D (Din,), h0 (B, Din, N) -> (y (B, T, Din), final h fp32).

    Dispatch as ``rwkv6_scan``: the kernel for CUDA tensors at every T;
    plain ``ref.ssm_single_step`` at T == 1, ``ref.ssm_chunked`` otherwise;
    ``"naive"`` the sequential oracle; differentiable calls through
    ``ref.SSMScanTrainable``. ``state_out`` as in ``rwkv6_scan`` (it may
    be ``h0`` itself)."""
    kernel = _kernel_path(impl, x)
    if _scan_trains(state_out, x, dt, A, Bm, Cm, D, h0) and impl != "naive":
        return ref.SSMScanTrainable.apply(x, dt, A, Bm, Cm, D, h0,
                                          ss.ssm_scan if kernel else None)
    if kernel:
        return ss.ssm_scan(x, dt, A, Bm, Cm, D, h0, state_out=state_out)
    if impl == "naive":
        res = ref.ssm_sequential(x, dt, A, Bm, Cm, D, h0)
    elif x.shape[1] == 1:
        res = ref.ssm_single_step(x, dt, A, Bm, Cm, D, h0)
    else:
        res = ref.ssm_chunked(x, dt, A, Bm, Cm, D, h0)
    return _into(res, state_out)
