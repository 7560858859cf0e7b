"""Plain PyTorch versions of the attention and MoE gating kernels (port of
the attention and gating parts of ``repro.kernels.ref``).

Two tiers per op, as in the JAX package:
  * ``*_naive``  — smallest-possible oracle, materializes everything.
  * blockwise / direct — the plain paths the dispatch in ``ops.py`` takes
    for CPU tensors, and that ``chip_smoke.py`` holds each CUDA kernel to.

Shapes:
  q    : (B, Sq, H, Dh)
  k, v : (B, Skv, KVH, Dh)    GQA with G = H // KVH

Fully masked rows give zeros in the blockwise and direct paths (the
``m_safe`` guard and ``l >= 1e-30``), exactly as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _attn_mask(q_pos, k_pos, *, causal, window, kv_lens):
    """Boolean mask (B or 1, Sq, Skv): True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    m = m[None]
    if kv_lens is not None:
        m = m & (k_pos[None, None, :] < kv_lens[:, None, None])
    return m


def attention_naive(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Materializing GQA attention oracle. Returns (B, Sq, H, Dh)."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    qf = (q.float() * (Dh ** -0.5)).reshape(B, Sq, KVH, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = _attn_mask(q_pos, k_pos, causal=causal, window=window,
                      kv_lens=kv_lens)                      # (B|1, Sq, Skv)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None,
                        q_offset: int = 0, q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """Flash-attention-structured path (online softmax over kv blocks).

    Never materializes more than (B, KVH, G, q_block, kv_block) scores.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    dev = q.device
    lens = (torch.full((B,), Skv, dtype=torch.int64, device=dev)
            if kv_lens is None else kv_lens.to(dev))
    qf = (q.float() * (Dh ** -0.5)).reshape(B, Sq, KVH, G, Dh)
    qf = qf.permute(0, 2, 3, 1, 4)                         # (B,KVH,G,Sq,Dh)
    kf = k.float().permute(0, 2, 1, 3)                     # (B,KVH,Skv,Dh)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((B, KVH, G, Sq, Dh), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, q_block):
        q_blk = qf[:, :, :, q0:q0 + q_block]
        bq = q_blk.shape[3]
        q_pos = q_offset + q0 + torch.arange(bq, device=dev)
        m_run = torch.full((B, KVH, G, bq), NEG_INF, device=dev)
        l_run = torch.zeros((B, KVH, G, bq), device=dev)
        acc = torch.zeros((B, KVH, G, bq, Dh), device=dev)
        for k0 in range(0, Skv, kv_block):
            k_blk = kf[:, :, k0:k0 + kv_block]
            v_blk = vf[:, :, k0:k0 + kv_block]
            k_pos = k0 + torch.arange(k_blk.shape[2], device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = _attn_mask(q_pos, k_pos, causal=causal, window=window,
                              kv_lens=lens)                # (B, bq, bk)
            mask = mask[:, None, None]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            # guard fully-masked rows (m_new == NEG_INF)
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            scale = torch.where(m_run <= NEG_INF / 2, 0.0,
                                torch.exp(m_run - m_safe))
            l_run = l_run * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, v_blk)
            m_run = m_new
        out[:, :, :, q0:q0 + bq] = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention_naive(q, k_cache, v_cache, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token decode oracle. q: (B, H, Dh); cache (B, S, KVH, Dh);
    lengths (B,) valid cache lengths, the new token included."""
    B, H, Dh = q.shape
    if window is None:
        out = attention_naive(q[:, None], k_cache, v_cache, causal=False,
                              softcap=softcap, kv_lens=lengths)
        return out[:, 0]
    # window anchored at position lengths-1
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qf = q.float().reshape(B, KVH, G, Dh) * (Dh ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)
    lens = lengths.to(q.device)[:, None]
    valid = (k_pos[None] < lens) & (k_pos[None] > (lens - 1 - window))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, H, Dh).to(q.dtype)


def decode_attention_direct(q, k_cache, v_cache, lengths, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token decode as one masked softmax over a committed cache
    (the new token's K/V already written; ``lengths`` counts it).

    Mirrors the reference's rounding: q is scaled in its own dtype, scores
    and sums are fp32, and the probabilities are cast to the cache dtype
    before the PV product.
    """
    B, H, Dh = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qf = (q * (Dh ** -0.5)).reshape(B, KVH, G, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qf.float(), k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)
    lens = lengths.to(q.device)[:, None]
    valid = k_pos[None] < lens
    if window is not None:
        valid &= k_pos[None] > (lens - 1 - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE top-k gating
# ---------------------------------------------------------------------------
def topk_gating(logits: torch.Tensor, top_k: int):
    """Softmax-then-topk with renormalization (Mixtral/granite convention).

    Returns (weights (T, k) f32, indices (T, k) i32, aux) where aux carries
    the load-balance and router z losses. Ties go to the lower expert index,
    as in ``lax.top_k``: ``torch.topk`` promises no order among ties, so
    this takes the first k of a stable descending sort.
    """
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)                              # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    weights = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return weights, idx.to(torch.int32), gating_aux(lf, probs, idx)


def gating_aux(logits: torch.Tensor, probs: torch.Tensor,
               idx: torch.Tensor) -> dict:
    """Switch load-balance loss E * sum_e f_e * p_e (f_e: share of the T*k
    choices routed to e, times k) and router z-loss mean(logsumexp^2), from
    fp32 logits (T, E), their softmax and the chosen ids (T, k)."""
    T, E = logits.shape
    counts = torch.zeros(E, dtype=torch.float32, device=logits.device)
    counts.scatter_add_(0, idx.reshape(-1).long(),
                        torch.ones(idx.numel(), device=logits.device))
    lb_loss = E * torch.sum(counts / T * probs.mean(0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"lb_loss": lb_loss, "z_loss": z_loss}
