"""Dispatch around the attention and MoE gating hot spots (port of
``repro/kernels/ops.py``).

Every model-layer call site goes through this module. The implementation
follows the tensor: a CUDA tensor goes to the hand-written CUDA kernel, a
CPU tensor to the plain PyTorch version. An explicit ``impl=`` overrides
that:

  * ``"cuda"``  — the kernel; raises on CPU tensors.
  * ``"plain"`` — the plain version on any device (``chip_smoke.py`` holds
    each kernel to it on the card).
  * ``"naive"`` — the materializing oracle.

Arguments a kernel does not take raise ``NotImplementedError`` on the kernel
path; nothing falls back to the plain version behind the caller's back.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import decode_attention as da
from . import flash_attention as fa
from . import moe_gating as mg
from . import ref

IMPLS = (None, "cuda", "plain", "naive")


def _kernel_path(impl: Optional[str], x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; options: {IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl == "cuda" or (impl is None and x.is_cuda)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    q_offset: int = 0, impl: Optional[str] = None):
    """GQA attention. q:(B,Sq,H,Dh) k/v:(B,Skv,KVH,Dh) -> (B,Sq,H,Dh)."""
    if _kernel_path(impl, q):
        if kv_lens is not None or q_offset != 0:
            raise NotImplementedError(
                "the CUDA flash_attention kernel is dense prefill: kv_lens "
                "and q_offset are not supported")
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
                     impl: Optional[str] = None):
    """Single-token GQA decode over a committed cache.
    q:(B,H,Dh) cache:(B,S,KVH,Dh) lengths:(B,) -> (B,H,Dh)."""
    if k_new is not None or v_new is not None:
        raise NotImplementedError(
            "append-mode decode (k_new/v_new) is not ported: write the "
            "token into the cache and decode in committed mode")
    if _kernel_path(impl, q):
        return da.decode_attention(q, k_cache, v_cache, lengths,
                                   window=window, softcap=softcap)
    fn = (ref.decode_attention_naive if impl == "naive"
          else ref.decode_attention_direct)
    return fn(q, k_cache, v_cache, lengths, window=window, softcap=softcap)


def moe_gating(logits, top_k: int, *, impl: Optional[str] = None):
    """Top-k softmax gating. logits (T, E) -> (weights (T, k) f32,
    ids (T, k) i32, aux {"lb_loss", "z_loss"}).

    On the kernel path the aux losses come from the kernel's ids and one
    softmax and logsumexp of the same logits; nothing selects the top k a
    second time. ``"plain"`` and ``"naive"`` both take ``ref.topk_gating``.
    """
    if _kernel_path(impl, logits):
        lf = logits.float().contiguous()
        weights, ids = mg.moe_gating_topk(lf, top_k)
        return weights, ids, ref.gating_aux(lf, torch.softmax(lf, dim=-1),
                                            ids)
    return ref.topk_gating(logits, top_k)
