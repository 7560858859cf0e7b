"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): attention, MoE gating, and the RWKV6 and Mamba
scans.

Two tiers per op, as in the JAX package:
  * ``*_naive`` / ``*_sequential`` — smallest-possible oracle, materializes
    everything or walks T one step at a time.
  * blockwise / direct / ``*_chunked`` — the plain paths the dispatch in
    ``ops.py`` takes for CPU tensors, and that ``chip_smoke.py`` holds each
    CUDA kernel to. The scans take ``*_single_step`` at T == 1.

Shapes:
  q    : (B, Sq, H, Dh)
  k, v : (B, Skv, KVH, Dh)    GQA with G = H // KVH

Fully masked rows give zeros in the blockwise and direct paths (the
``m_safe`` guard and ``l >= 1e-30``), exactly as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Trainable attention: forward with log-sum-exp, and its backward
# ---------------------------------------------------------------------------
def _train_blocks(Sq: int, Skv: int, q_block: int, kv_block: int):
    """The trainable path's blocks, ``min(q_block, Sq)`` and ``min(kv_block,
    Skv)``. Where a block does not divide its sequence, the last one is
    ragged and handled like any other (the reference asserts that they
    divide, and autodiffs its blockwise path where they do not)."""
    return min(q_block, Sq), min(kv_block, Skv)


def _block_mask(q0: int, bq: int, k0: int, bk: int, causal: bool,
                window: Optional[int], device) -> Optional[torch.Tensor]:
    """(bq, bk) mask of a block pair (True = attend), or None where the
    pair is wholly masked: it adds nothing, forward or backward."""
    if causal and k0 > q0 + bq - 1:
        return None
    if window is not None and k0 + bk - 1 <= q0 - window:
        return None
    q_pos = q0 + torch.arange(bq, device=device)
    k_pos = k0 + torch.arange(bk, device=device)
    return _attn_mask(q_pos, k_pos, causal=causal, window=window,
                      kv_lens=None)[0]


def blockwise_fwd_lse(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None, q_block: int = 512,
                      kv_block: int = 1024):
    """Port of the reference's ``_blockwise_fwd_impl``: blockwise attention
    that also returns the log-sum-exp of each query row's masked scores.
    Returns (out (B, Sq, H, Dh) in q's dtype, lse (B, KVH, G, Sq) fp32); a
    fully masked row gets out 0 and lse ``NEG_INF``. No kv_lens or q_offset:
    training batches are dense. The last q or kv block may be ragged."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    qb, kb = _train_blocks(Sq, Skv, q_block, kv_block)
    dev = q.device
    qf = (q.float() * (Dh ** -0.5)).reshape(B, Sq, KVH, G, Dh)
    qf = qf.permute(0, 2, 3, 1, 4)                         # (B,KVH,G,Sq,Dh)
    kf = k.float().permute(0, 2, 1, 3)                     # (B,KVH,Skv,Dh)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((B, KVH, G, Sq, Dh), dtype=torch.float32, device=dev)
    lse = torch.empty((B, KVH, G, Sq), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, qb):
        bq = min(qb, Sq - q0)
        q_blk = qf[:, :, :, q0:q0 + bq]
        m_run = torch.full((B, KVH, G, bq), NEG_INF, device=dev)
        l_run = torch.zeros((B, KVH, G, bq), device=dev)
        acc = torch.zeros((B, KVH, G, bq, Dh), device=dev)
        for k0 in range(0, Skv, kb):
            mask = _block_mask(q0, bq, k0, min(kb, Skv - k0), causal, window,
                               dev)
            if mask is None:
                continue
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk,
                             kf[:, :, k0:k0 + kb])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            scale = torch.where(m_run <= NEG_INF / 2, 0.0,
                                torch.exp(m_run - m_safe))
            l_run = l_run * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k0 + kb])
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        out[:, :, :, q0:q0 + bq] = acc / l_safe[..., None]
        lse[..., q0:q0 + bq] = torch.where(m_run <= NEG_INF / 2, NEG_INF,
                                           m_run + torch.log(l_safe))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_block: int = 512,
                        kv_block: int = 1024):
    """Port of the reference's ``_fat_bwd``: (dq, dk, dv) of blockwise
    attention from the saved (q, k, v, out, lse (B, KVH, G, Sq)) and dout,
    in fp32 and in the reference's blocks. Per block pair, P is recomputed
    from the lse, ``delta = sum(dO * O)`` per row stands in for the softmax
    Jacobian's row sum, and the softcap's derivative ``1 - tanh^2``
    multiplies dS. Pairs that the causal mask or the window wholly remove
    are skipped: they add exact zeros. The last q or kv block may be ragged
    (Skv = 1600 over 1024-key blocks: the vision cross layers)."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    qb, kb = _train_blocks(Sq, Skv, q_block, kv_block)
    dev = q.device
    scale = Dh ** -0.5

    def heads(x):                                          # (B,KVH,G,S,Dh)
        return x.float().reshape(B, -1, KVH, G, Dh).permute(0, 2, 3, 1, 4)

    qf = heads(q.float() * scale)
    kf = k.float().permute(0, 2, 1, 3)                     # (B,KVH,Skv,Dh)
    vf = v.float().permute(0, 2, 1, 3)
    dof, of = heads(dout), heads(out)
    delta = (dof * of).sum(dim=-1)                         # (B,KVH,G,Sq)
    lse_safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    dq = torch.empty((B, KVH, G, Sq, Dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, KVH, Skv, Dh), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, KVH, Skv, Dh), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, qb):
        bq = min(qb, Sq - q0)
        q_blk = qf[:, :, :, q0:q0 + bq]
        do_blk = dof[:, :, :, q0:q0 + bq]
        ls = lse_safe[..., q0:q0 + bq, None]
        dl = delta[..., q0:q0 + bq, None]
        dq_acc = torch.zeros_like(q_blk)
        for k0 in range(0, Skv, kb):
            mask = _block_mask(q0, bq, k0, min(kb, Skv - k0), causal, window,
                               dev)
            if mask is None:
                continue
            k_blk, v_blk = kf[:, :, k0:k0 + kb], vf[:, :, k0:k0 + kb]
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk)
            dcap = None
            if softcap is not None:
                t = torch.tanh(s / softcap)
                s = softcap * t
                dcap = 1.0 - t * t
            p = torch.where(mask, torch.exp(s - ls), 0.0)
            dv[:, :, k0:k0 + kb] += torch.einsum("bhgqk,bhgqd->bhkd", p,
                                                 do_blk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_blk, v_blk)
            ds = p * (dp - dl)
            if dcap is not None:
                ds = ds * dcap
            dq_acc = dq_acc + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_blk)
            dk[:, :, k0:k0 + kb] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                                 q_blk)
        dq[:, :, :, q0:q0 + bq] = dq_acc * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)
    dk = dk.permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


class FlashAttentionTrainable(torch.autograd.Function):
    """Twin of the reference's ``flash_attention_trainable`` (a
    ``jax.custom_vjp``): the forward keeps (q, k, v, out, lse) and the
    backward is ``flash_attention_bwd``. ``fwd`` computes (out, lse (B, KVH,
    G, Sq) fp32): ``blockwise_fwd_lse`` when None (the plain path), or the
    CUDA kernel's wrapper (``ops.flash_attention`` passes it on CUDA
    tensors). A ragged last q or kv block is a block like the others, so
    any Sq and Skv train."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_block, kv_block,
                fwd=None):
        fwd = blockwise_fwd_lse if fwd is None else fwd
        out, lse = fwd(q, k, v, causal=causal, window=window,
                       softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_block=q_block, kv_block=kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def _check_append(k_new, v_new) -> bool:
    """True in append mode; both or neither of k_new / v_new are given."""
    if (k_new is None) != (v_new is None):
        raise ValueError("append mode takes both k_new and v_new")
    return k_new is not None


def decode_attention_naive(q, k_cache, v_cache, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token decode oracle. q: (B, H, Dh); cache (B, S, KVH, Dh);
    lengths (B,) valid cache lengths, the new token included. In append
    mode (``k_new``, ``v_new`` of shape (B, KVH, Dh)) the cache holds
    ``lengths`` old tokens and the new one is one more key, always kept."""
    append = _check_append(k_new, v_new)
    B, H, Dh = q.shape
    if window is None and not append:
        out = attention_naive(q[:, None], k_cache, v_cache, causal=False,
                              softcap=softcap, kv_lens=lengths)
        return out[:, 0]
    # window anchored at the new token's position: lengths-1 committed,
    # lengths in append mode
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qf = q.float().reshape(B, KVH, G, Dh) * (Dh ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    vf = v_cache.float()
    k_pos = torch.arange(S, device=q.device)
    lens = lengths.to(q.device)[:, None]
    valid = k_pos[None] < lens
    if window is not None:
        valid &= k_pos[None] > (lens - (0 if append else 1) - window)
    if append:
        s = torch.cat([s, torch.einsum("bhgd,bhd->bhg", qf,
                                       k_new.float())[..., None]], -1)
        vf = torch.cat([vf, v_new.float()[:, None]], 1)
        valid = torch.cat([valid, torch.ones_like(valid[:, :1])], -1)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return o.reshape(B, H, Dh).to(q.dtype)


def decode_attention_direct(q, k_cache, v_cache, lengths, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            k_new: Optional[torch.Tensor] = None,
                            v_new: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Single-token decode as one masked softmax over the cache.

    Committed mode: the new token's K/V is already written and ``lengths``
    counts it. Append mode (``k_new``, ``v_new`` of shape (B, KVH, Dh)):
    the cache is read-only with ``lengths`` old tokens, the window is
    anchored at the new token's position (keys ``k_pos > lengths -
    window``), and the new token's score, softcapped too, is merged into
    the softmax analytically, as ``repro/kernels/ref.py`` does.

    Mirrors the reference's rounding: q is scaled in its own dtype, scores
    and sums are fp32, and the cache's probabilities are cast to the cache
    dtype before the PV product.
    """
    append = _check_append(k_new, v_new)
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
        valid &= k_pos[None] > (lens - (0 if append else 1) - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if append:
        s_self = torch.einsum("bhgd,bhd->bhg", qf.float(),
                              k_new.float())[..., None]
        if softcap is not None:
            s_self = softcap * torch.tanh(s_self / softcap)
        m = torch.maximum(m, s_self)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    if append:
        p_self = torch.exp(s_self - m_safe)                  # (B,KVH,G,1)
        l = l + p_self
        out = out + p_self * v_new.float()[:, :, None]
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Dh).to(q.dtype)


# kv rows per split-pass step of the CUDA decode kernel (csrc TILE): a
# split's chunk is a whole number of them
DECODE_SPLIT_TILE = 128


def split_chunk(S: int, n_splits: int, tile: int = DECODE_SPLIT_TILE) -> int:
    """Rows per kv split: ceil(S / n_splits) rounded up to ``tile``, as the
    CUDA decode kernel cuts the cache."""
    return -(-(-(-S // n_splits)) // tile) * tile


def decode_attention_split(q, k_cache, v_cache, lengths, *, n_splits: int,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None,
                           tile: int = DECODE_SPLIT_TILE) -> torch.Tensor:
    """Split-KV decode as the CUDA kernel does it, in fp32: the cache is cut
    into ``n_splits`` chunks of ``split_chunk(S, n_splits, tile)`` rows; each
    chunk gives a partial (m, l, o) of its kept keys (an empty chunk gives
    m = NEG_INF, l = 0, o = 0); the combine rescales each partial by
    exp(m_s - m), skips empty ones through the m_safe guard and divides by
    max(l, 1e-30). In append mode (``k_new``, ``v_new``) the chunks hold the
    ``lengths`` old tokens, the window keeps keys ``k_pos > lengths -
    window``, and the combine takes the new token as one more partial:
    m = softcap(scale * q . k_new), l = 1, o = v_new. Used by the tests,
    which cannot run the CUDA combine."""
    append = _check_append(k_new, v_new)
    B, H, Dh = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    chunk = split_chunk(S, n_splits, tile)
    qf = q.float().reshape(B, KVH, G, Dh) * (Dh ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)
    lens = lengths.to(q.device).long().clamp(0, S)[:, None]
    valid = k_pos[None] < lens
    if window is not None:
        valid &= k_pos[None] >= lens - window + (1 if append else 0)
    vf = v_cache.float()
    parts = []
    for i in range(n_splits):
        keep = (valid & (k_pos[None] // chunk == i))[:, None, None]
        s_i = torch.where(keep, s, NEG_INF)
        m_i = s_i.amax(dim=-1)
        m_safe = torch.where(m_i <= NEG_INF / 2, 0.0, m_i)
        p = torch.where(keep, torch.exp(s_i - m_safe[..., None]), 0.0)
        parts.append((m_i, p.sum(dim=-1),
                      torch.einsum("bhgs,bshd->bhgd", p, vf)))
    if append:
        m_self = torch.einsum("bhgd,bhd->bhg", qf, k_new.float())
        if softcap is not None:
            m_self = softcap * torch.tanh(m_self / softcap)
        parts.append((m_self, torch.ones_like(m_self),
                      v_new.float()[:, :, None].expand(B, KVH, G, Dh)))
    m_s = torch.stack([m for m, _, _ in parts])
    m = m_s.amax(dim=0)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    w = torch.where(m_s <= NEG_INF / 2, 0.0, torch.exp(m_s - m_safe))
    l = (w * torch.stack([l for _, l, _ in parts])).sum(dim=0)
    o = (w[..., None] * torch.stack([o for _, _, o in parts])).sum(dim=0)
    out = o / torch.clamp(l, min=1e-30)[..., None]
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


def topk_gating_bwd(logits: torch.Tensor, ids: torch.Tensor,
                    d_weights: torch.Tensor, d_lb_loss: torch.Tensor,
                    d_z_loss: torch.Tensor) -> torch.Tensor:
    """d logits (T, E) of ``topk_gating``'s weights (T, k) and aux losses,
    given the chosen ids (T, k) and the three upstream gradients, as JAX's
    autodiff of the reference's ``topk_gating`` gives them: through the
    renormalisation over the chosen probabilities (the 1e-9 floor passes
    no gradient to the sum), the top-k gather and the softmax; the load
    balance loss with the routed fraction f held constant (it is a count);
    the z-loss through the logsumexp."""
    lf = logits.float()
    T, E = lf.shape
    idx = ids.long()
    probs = torch.softmax(lf, dim=-1)
    vals = probs.gather(1, idx)
    s = vals.sum(-1, keepdim=True)
    s_safe = torch.clamp(s, min=1e-9)
    dw = d_weights.float()
    d_vals = dw / s_safe - torch.where(
        s > 1e-9, (dw * vals).sum(-1, keepdim=True) / (s_safe * s_safe), 0.0)
    d_probs = torch.zeros_like(probs).scatter_(1, idx, d_vals)
    f = torch.zeros(E, dtype=torch.float32, device=lf.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=lf.device)) / T
    d_probs = d_probs + d_lb_loss * E * f / T
    d_lf = probs * (d_probs - (d_probs * probs).sum(-1, keepdim=True))
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    d_lf = d_lf + d_z_loss * (2.0 / T) * lse * probs
    return d_lf.to(logits.dtype)


# ---------------------------------------------------------------------------
# MoE dispatch index maps (integers only; tiny)
# ---------------------------------------------------------------------------
def dispatch_indices(idx: torch.Tensor, E: int, cap: int):
    """The reference's ``build_dispatch_indices`` over a leading block dim:
    idx (N, T, K) expert choices -> (int64)
    slot_of (N, T, K): destination slot in [0, E*cap] (E*cap = dropped);
    token_of_slot (N, E*cap+1): source token in [0, T] (T = empty slot);
    tk_of_slot (N, E*cap+1): flat t*K+k index in [0, T*K] (T*K = empty).
    An entry's position is its rank among the block's entries routed to
    the same expert, in flat order (a stable sort); positions >= cap drop.
    """
    N, T, K = idx.shape
    TK = T * K
    dev = idx.device
    flat_expert = idx.reshape(N, TK).long()
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = flat_expert.gather(1, order)
    counts = torch.zeros((N, E), dtype=torch.int64, device=dev).scatter_add_(
        1, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(TK, device=dev) - starts.gather(1, sorted_expert)
    keep = pos < cap
    slot_sorted = torch.where(keep, sorted_expert * cap + pos, E * cap)
    inv = torch.argsort(order, dim=1, stable=True)
    slot_of = slot_sorted.gather(1, inv).reshape(N, T, K)
    # every dropped entry scatters to slot E*cap; the overwrite after each
    # scatter keeps that slot empty whichever duplicate landed last
    token_of_slot = torch.full((N, E * cap + 1), T, dtype=torch.int64,
                               device=dev).scatter_(
        1, slot_sorted, torch.where(keep, order // K, T))
    token_of_slot[:, E * cap] = T
    tk_of_slot = torch.full((N, E * cap + 1), TK, dtype=torch.int64,
                            device=dev).scatter_(
        1, slot_sorted, torch.where(keep, order, TK))
    tk_of_slot[:, E * cap] = TK
    return slot_of, token_of_slot, tk_of_slot


def moe_route(logits: torch.Tensor, top_k: int, cap: int, nb: int):
    """Top-k gating and the dispatch maps of ``nb`` blocks of T / nb tokens:
    (weights (T, k) f32, ids (T, k) i32, slot_of (nb, T/nb, k),
    token_of_slot and tk_of_slot (nb, E*cap+1), aux over all T)."""
    weights, ids, aux = topk_gating(logits, top_k)
    maps = dispatch_indices(ids.reshape(nb, -1, top_k), logits.shape[1],
                            cap)
    return (weights, ids, *maps, aux)


def moe_route_sliced(logits: torch.Tensor, top_k: int, cap: int, nb: int,
                     ctas: int):
    """``moe_route`` cut as the CUDA routing kernel cuts it, for the tests
    (which cannot run it): each block's tokens are split into ``ctas``
    contiguous slices of ceil(Tb / ctas) tokens (the last ones short or
    empty). Each slice ranks its entries per expert in flat order and
    counts them; a slice's offset for expert e is the count of the slices
    before it; an entry's position is offset + rank. Every output starts
    empty and each element is written once: kept entries write their slot,
    and the slices share out the empty slots and the sentinel E*cap by
    contiguous ranges. The aux sums go slice by slice, then block by block,
    in order."""
    T, E = logits.shape
    K = top_k
    Tb = T // nb
    S = E * cap + 1
    dev = logits.device
    lf = logits.float()
    weights, ids, _ = topk_gating(lf, K)
    probs = torch.softmax(lf, dim=-1)
    lse2 = torch.logsumexp(lf, dim=-1) ** 2
    slot_of = torch.empty((nb, Tb * K), dtype=torch.int64, device=dev)
    token_of_slot = torch.empty((nb, S), dtype=torch.int64, device=dev)
    tk_of_slot = torch.empty((nb, S), dtype=torch.int64, device=dev)
    per = -(-Tb // ctas)
    spans = [(min(r * per, Tb), min((r + 1) * per, Tb)) for r in range(ctas)]
    psum = torch.zeros(E, device=dev)
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    z_sum = torch.zeros((), device=dev)
    for g in range(nb):
        flat = ids[g * Tb:(g + 1) * Tb].reshape(-1).long()
        hist, ranks = [], []
        for t0, t1 in spans:
            oh = F.one_hot(flat[t0 * K:t1 * K], E)
            hist.append(oh.sum(0))
            ranks.append(((oh.cumsum(0) - oh) * oh).sum(1))
        tot = torch.stack(hist).sum(0)
        off = torch.zeros(E, dtype=torch.int64, device=dev)
        for (t0, t1), h, rank in zip(spans, hist, ranks):
            e = flat[t0 * K:t1 * K]
            pos = off[e] + rank
            keep = pos < cap
            slot = torch.where(keep, e * cap + pos, E * cap)
            slot_of[g, t0 * K:t1 * K] = slot
            fi = torch.arange(t0 * K, t1 * K, device=dev)
            token_of_slot[g, slot[keep]] = fi[keep] // K
            tk_of_slot[g, slot[keep]] = fi[keep]
            off = off + h
        s = torch.arange(S, device=dev)
        empty = (s == E * cap) | ((s % cap) >= tot[torch.clamp(
            s // cap, max=E - 1)])
        per_s = -(-S // ctas)
        for r in range(ctas):
            mine = empty & (s >= r * per_s) & (s < (r + 1) * per_s)
            token_of_slot[g, mine] = Tb
            tk_of_slot[g, mine] = Tb * K
        blk_psum = torch.zeros(E, device=dev)
        blk_z = torch.zeros((), device=dev)
        for t0, t1 in spans:
            blk_psum = blk_psum + probs[g * Tb + t0:g * Tb + t1].sum(0)
            blk_z = blk_z + lse2[g * Tb + t0:g * Tb + t1].sum()
        psum, z_sum, counts = psum + blk_psum, z_sum + blk_z, counts + tot
    aux = {"lb_loss": E * torch.sum(counts / T * (psum / T)),
           "z_loss": z_sum / T}
    return (weights, ids, slot_of.reshape(nb, Tb, K), token_of_slot,
            tk_of_slot, aux)


# ---------------------------------------------------------------------------
# RWKV6 (data-dependent-decay linear attention; "Finch")
# ---------------------------------------------------------------------------
def rwkv6_sequential(r, k, v, w, u, state):
    """The oracle: out_t = r_t · (S_t + diag(u) k_t vᵀ_t);
    S_{t+1} = diag(w_t) S_t + k_t vᵀ_t, one step at a time.

    r/k/w (B, T, H, K), v (B, T, H, V), u (H, K), state (B, H, K, V).
    Returns (out (B, T, H, V) in v's dtype, final state fp32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1).to(v.dtype), S


def rwkv6_single_step(r, k, v, w, u, state):
    """T == 1: one state update (the reference's decode fast path)."""
    rf, kf, vf, wf = (t[:, 0].float() for t in (r, k, v, w))
    S = state.float()
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       S + u.float()[None, :, :, None] * kv)
    return out[:, None].to(v.dtype), wf[..., None] * S + kv


def rwkv6_chunked(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunked WKV6: the carried state enters through matmuls, the tokens
    of a chunk through a (c, c) per-channel-decayed score matrix in log
    space, both exponents shifted by the chunk's midpoint and clipped at
    ±60, as in the reference. T is padded to a multiple of the chunk with
    zeros and w = 1 (the padding neither decays nor feeds the state).
    Not the plain path: the clip is wrong for strong decays (ROADMAP C1);
    ``ops`` takes ``rwkv6_chunked_exact``."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        pad = (0, 0, 0, 0, 0, (-T) % chunk)
        out, S = rwkv6_chunked(F.pad(r, pad), F.pad(k, pad), F.pad(v, pad),
                               F.pad(w, pad, value=1.0), u, state,
                               chunk=chunk)
        return out[:, :T], S
    c, n = chunk, T // chunk

    def split(x, d):            # (B, T, H, d) -> (n, B, H, c, d)
        return x.float().reshape(B, n, c, H, d).permute(1, 0, 3, 2, 4)

    rf, kf, vf, wf = split(r, K), split(k, K), split(v, V), split(w, K)
    uf = u.float()
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)                       # j < t
    S = state.float()
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rf[i], kf[i], vf[i], wf[i]
        lw = torch.log(torch.clamp(wc, min=1e-30))
        cum = torch.cumsum(lw, dim=2)                   # inclusive
        cum_excl = cum - lw
        inter = torch.einsum("bhck,bhkv->bhcv", rc * torch.exp(cum_excl), S)
        M = cum[:, :, c // 2, :][:, :, None, :]
        a = rc * torch.exp(torch.clamp(cum_excl - M, -60.0, 60.0))
        b = kc * torch.exp(torch.clamp(M - cum, -60.0, 60.0))
        scores = torch.einsum("bhtk,bhjk->bhtj", a, b)
        scores = torch.where(tri, scores, 0.0)
        diag = torch.einsum("bhck,hk,bhck->bhc", rc, uf, kc)
        outs.append(inter + torch.einsum("bhtj,bhjv->bhtv", scores, vc)
                    + diag[..., None] * vc)
        decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
        S = S * torch.exp(cum[:, :, -1, :])[..., None] + torch.einsum(
            "bhck,bhcv->bhkv", kc * decay_to_end, vc)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return out.to(v.dtype), S


class _DecayTable(torch.autograd.Function):
    """The chunks' decay table of ``rwkv6_chunked_exact``: w (B, H, n, c,
    K) -> D (B, H, n, c + 1, c + 1, K), D[t, j] = prod_{j < i < t} w_i
    with j from -1 and t up to c. Forward: factor[t, j] = w_{t-1} where
    j < t - 1, else 1, and its cumulative product over t. Backward without
    dividing by w (``torch.cumprod``'s gradient divides its output by its
    input, and once a product underflows to 0, as it does at w ~ e^-90,
    the gradient of every w inside it is lost): d D[t, j] / d w_i = D[i, j]
    D[t, i] for j < i < t, two entries of the table itself, so dw is
    two products of the table's size."""

    @staticmethod
    def forward(ctx, wf):
        c = wf.shape[-2]
        idx = torch.arange(c + 1, device=wf.device)
        # rows t = 0..c, columns j = -1..c-1 (stored from 0)
        live = (idx[:, None] - 1 > idx[None, :] - 1)[..., None]  # (t, j, 1)
        w_prev = torch.cat([torch.ones_like(wf[..., :1, :]), wf], dim=-2)
        factor = torch.where(live, w_prev[..., :, None, :], 1.0)
        D = torch.cumprod(factor, dim=-3)
        ctx.save_for_backward(D)
        return D

    @staticmethod
    def backward(ctx, G):
        D, = ctx.saved_tensors
        c = D.shape[-2] - 1
        idx = torch.arange(c + 1, device=D.device)
        # with stored column j' = j + 1 and w_i = w_prev[i + 1]: the table's
        # gradient for w_prev[m] is sum G[t, j'] D[m-1, j'] D[t, m] over
        # j' <= m - 1 and t >= m
        E = torch.where((idx[None, :] <= idx[:, None])[..., None], D, 0.0)
        F_ = torch.where((idx[:, None] >= idx[None, :])[..., None], D, 0.0)
        X = torch.einsum("...tjk,...ajk->...atk", G, E[..., :c, :, :])
        return torch.einsum("...atk,...tak->...ak", X, F_[..., :, 1:, :])


def rwkv6_chunked_exact(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunked WKV6 with no clip: the plain path at T > 1.

    Within a chunk, token j < t reaches token t through the decays of the
    steps between them, D[t, j] = prod_{j < i < t} w_i per channel,
    materialised as a (c + 1, c + 1, K) tensor with j from -1 and t up to
    c: D[t, -1] carries the state into token t, D[c, j] carries token j
    out of the chunk and D[c, -1] the state across it. The decays are
    multiplied (a cumulative product), as the sequential oracle and the
    CUDA kernel do: every factor is in (0, 1], so nothing overflows and
    nothing is clamped, whatever w. (exp(cum_excl_t - cum_j) from the
    chunk's cumulative log-decays is the same number, but the difference
    of two large sums loses ~|cum| * 2^-24 of its exponent: 7e-5 at
    w ~ e^-7.) All chunks' intra-chunk terms are computed at once; only
    the carry of the state walks the chunks. Padding as in
    ``rwkv6_chunked``."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        pad = (0, 0, 0, 0, 0, (-T) % chunk)
        out, S = rwkv6_chunked_exact(F.pad(r, pad), F.pad(k, pad),
                                     F.pad(v, pad), F.pad(w, pad, value=1.0),
                                     u, state, chunk=chunk)
        return out[:, :T], S
    c, n = chunk, T // chunk

    def split(x, d):            # (B, T, H, d) -> (B, H, n, c, d)
        return x.float().reshape(B, n, c, H, d).permute(0, 3, 1, 2, 4)

    rf, kf, vf, wf = split(r, K), split(k, K), split(v, V), split(w, K)
    D = _DecayTable.apply(wf)                       # (B, H, n, t, j, K)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[..., None]                     # j < t
    intra_decay = torch.where(tri, D[..., :c, 1:, :], 0.0)
    scores = torch.einsum("bhntk,bhntjk,bhnjk->bhntj", rf, intra_decay, kf)
    diag = torch.einsum("bhnck,hk,bhnck->bhnc", rf, u.float(), kf)
    intra = torch.einsum("bhntj,bhnjv->bhntv", scores, vf) \
        + diag[..., None] * vf
    local = torch.einsum("bhnck,bhncv->bhnkv", kf * D[..., c, 1:, :], vf)
    through = D[..., c, 0, :]                       # (B, H, n, K)
    S = state.float()
    s_in = []
    for i in range(n):
        s_in.append(S)
        S = through[:, :, i, :, None] * S + local[:, :, i]
    inter = torch.einsum("bhnck,bhnkv->bhncv", rf * D[..., :c, 0, :],
                         torch.stack(s_in, dim=2))
    out = (inter + intra).permute(0, 2, 3, 1, 4).reshape(B, T, H, V)
    return out.to(v.dtype), S


def rwkv6_chunk_parallel(r, k, v, w, u, state, *, chunk: int):
    """The CUDA kernel's three passes, for the tests (which cannot run it):
    T is cut into chunks of ``chunk`` steps (the last may be shorter);
    1. each chunk walks from S = 0 to its own state L_i, and P_i is the
       product of its decays (w multiplied, never through log / exp);
    2. the carry: S_in[0] = state, S_in[i+1] = P_i ⊙ S_in[i] + L_i;
    3. each chunk walks its steps from S_in[i] for its outputs.
    Exact for every w in (0, 1). Returns (out in v's dtype, final S fp32)."""
    T = r.shape[1]
    spans = [slice(t, min(t + chunk, T)) for t in range(0, T, chunk)]
    zero = torch.zeros_like(state, dtype=torch.float32)
    L = [rwkv6_sequential(r[:, s], k[:, s], v[:, s], w[:, s], u, zero)[1]
         for s in spans]
    P = [torch.prod(w[:, s].float(), dim=1) for s in spans]      # (B, H, K)
    S = state.float()
    S_in = []
    for L_i, P_i in zip(L, P):
        S_in.append(S)
        S = P_i[..., None] * S + L_i
    outs = [rwkv6_sequential(r[:, s], k[:, s], v[:, s], w[:, s], u, S_i)[0]
            for s, S_i in zip(spans, S_in)]
    return torch.cat(outs, dim=1), S


# ---------------------------------------------------------------------------
# Mamba selective scan
# ---------------------------------------------------------------------------
def ssm_sequential(x, dt, A, Bm, Cm, D, h0):
    """The oracle: h_t = exp(dt_t·A)·h_{t-1} + (dt_t·x_t)·B_t;
    y_t = h_t·C_t + D·x_t, one step at a time.

    x/dt (B, T, Din), A (Din, N), Bm/Cm (B, T, N), D (Din,), h0 (B, Din, N).
    Returns (y (B, T, Din) in x's dtype, final h fp32)."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    Af, Df = A.float(), D.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), h


def ssm_single_step(x, dt, A, Bm, Cm, D, h0):
    """T == 1: one state update (the reference's decode fast path)."""
    xf, dtf, Bf, Cf = (t[:, 0].float() for t in (x, dt, Bm, Cm))
    h = torch.exp(dtf[..., None] * A.float()) * h0.float() \
        + (dtf * xf)[..., None] * Bf[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cf) + D.float() * xf
    return y[:, None].to(x.dtype), h


def _doubling_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under the reference's
    combine (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), in log2(c) doubling
    rounds (torch has no associative_scan)."""
    c = a.shape[1]
    d = 1
    while d < c:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return a, b


def ssm_chunked(x, dt, A, Bm, Cm, D, h0, *, chunk: int = 256):
    """Chunk-sequential scan with a doubling scan inside each chunk. Peak
    intermediate: a few (B, chunk, Din, N) fp32 tensors, never the full
    (B, T, Din, N). T is padded to a multiple of the chunk with zeros
    (dt = 0 leaves the state as it is)."""
    B, T, Din = x.shape
    if T % chunk:
        pad = (0, 0, 0, (-T) % chunk)
        y, h = ssm_chunked(F.pad(x, pad), F.pad(dt, pad), A, F.pad(Bm, pad),
                           F.pad(Cm, pad), D, h0, chunk=chunk)
        return y[:, :T], h
    Af, Df = A.float(), D.float()
    h = h0.float()
    ys = []
    for s in range(0, T, chunk):
        xc, dtc, Bc, Cc = (t[:, s:s + chunk].float() for t in (x, dt, Bm, Cm))
        a = torch.exp(dtc[..., None] * Af)                 # (B,c,Din,N)
        b = (dtc * xc)[..., None] * Bc[:, :, None, :]
        aa, bb = _doubling_scan(a, b)
        del a, b
        h_t = aa * h[:, None] + bb
        ys.append(torch.einsum("bcdn,bcn->bcd", h_t, Cc) + Df * xc)
        h = h_t[:, -1]
    return torch.cat(ys, 1).to(x.dtype), h


# ---------------------------------------------------------------------------
# Trainable scans: a segmented forward, a plain backward segment by segment
# ---------------------------------------------------------------------------
# Steps per segment of the trainable scans. The backward holds one
# segment's autograd graph at a time: at Jamba's width (B 1, Din 16384, N
# 16) ``ssm_chunked`` keeps ~20 fp32 (B, 256, Din, N) tensors (268 MB
# each), at rwkv6's (B 2, H 32, K 64) ``rwkv6_chunked_exact`` ~8 (B, H, 8,
# 33, 33, K) ones (143 MB each); a whole T = 4096 would hold 16x that.
SCAN_SEGMENT = 256


def scan_segments(T: int) -> list:
    """The trainable scans' segments of T steps: slices of
    ``SCAN_SEGMENT`` steps, the last one ragged."""
    return [slice(t, min(t + SCAN_SEGMENT, T))
            for t in range(0, T, SCAN_SEGMENT)]


def _segmented_forward(fwd, seq, params, state):
    """Run ``fwd(*seq slices, *params, state) -> (out, state)`` segment by
    segment. Returns (out over all T, final state, [the state entering
    each segment])."""
    outs, states = [], []
    for sl in scan_segments(seq[0].shape[1]):
        states.append(state)
        out, state = fwd(*(t[:, sl].contiguous() for t in seq), *params,
                         state)
        outs.append(out)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out, state, states


def _segmented_backward(plain, seq, params, states, d_out, d_state):
    """Gradients of a segmented scan ``plain(*seq, *params, state) -> (out,
    state)`` for every sequence input, every parameter and the initial
    state. Walks the segments in reverse: under ``torch.enable_grad()`` it
    recomputes one segment from the state that entered it and calls
    ``torch.autograd.grad`` with that segment's d_out and the carried
    d_state, so one segment's graph is alive at a time. The parameters'
    gradients sum over the segments in fp32."""
    d_seq = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in seq]
    p_leaves = [p.detach().requires_grad_(True) for p in params]
    d_params = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]
    d_state = d_state.float()
    segs = scan_segments(seq[0].shape[1])
    n = len(seq)
    with torch.enable_grad():
        for sl, s_in in zip(reversed(segs), reversed(states)):
            s_leaves = [t[:, sl].detach().requires_grad_(True) for t in seq]
            st = s_in.detach().requires_grad_(True)
            out, s_out = plain(*s_leaves, *p_leaves, st)
            grads = torch.autograd.grad(
                (out, s_out), (*s_leaves, *p_leaves, st),
                (d_out[:, sl].to(out.dtype), d_state))
            for d, g in zip(d_seq, grads[:n]):
                d[:, sl] = g
            for d, g in zip(d_params, grads[n:-1]):
                d += g.float()
            d_state = grads[-1].float()
    return d_seq, [d.to(p.dtype) for d, p in zip(d_params, params)], \
        d_state.to(states[0].dtype)


def _ssm_by_segment(fwd):
    """``fwd(x, dt, A, Bm, Cm, D, h)`` in the segment walkers' argument
    order: the sequence inputs (x, dt, Bm, Cm), the parameters (A, D),
    the state."""
    return lambda x, dt, Bm, Cm, A, D, h: fwd(x, dt, A, Bm, Cm, D, h)


def ssm_scan_bwd(x, dt, A, Bm, Cm, D, states, dy, dh):
    """(dx, ddt, dA, dBm, dCm, dD, dh0) of the Mamba scan over T steps,
    from its inputs, the state entering each segment (``states``) and the
    upstream (dy, dh) of (y, final h): autograd through ``ssm_chunked``,
    one segment at a time (``_segmented_backward``). Plain PyTorch, as the
    reference differentiates its jnp scan off the TPU."""
    (dx, ddt, dBm, dCm), (dA, dD), dh0 = _segmented_backward(
        _ssm_by_segment(ssm_chunked), (x, dt, Bm, Cm), (A, D), states, dy,
        dh)
    return dx, ddt, dA, dBm, dCm, dD, dh0


class SSMScanTrainable(torch.autograd.Function):
    """The Mamba scan with a gradient for x, dt, A, Bm, Cm, D and h0.
    Forward: ``fwd(x, dt, A, Bm, Cm, D, h) -> (y, h)`` segment by segment
    (``SCAN_SEGMENT`` steps, contiguous slices), each from the state the
    one before left: ``ssm_chunked`` when ``fwd`` is None (the plain path),
    or the CUDA kernel's wrapper (``ops.ssm_scan`` passes it on CUDA
    tensors). It saves the inputs and the state entering each segment,
    (T / SCAN_SEGMENT) x (B, Din, N) fp32. Backward: ``ssm_scan_bwd``, plain
    PyTorch."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0, fwd=None):
        y, h, states = _segmented_forward(
            _ssm_by_segment(ssm_chunked if fwd is None else fwd),
            (x, dt, Bm, Cm), (A, D), h0)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, *states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, D, *states = ctx.saved_tensors
        return (*ssm_scan_bwd(x, dt, A, Bm, Cm, D, states, dy, dh), None)


def rwkv6_scan_bwd(r, k, v, w, u, states, dout, dstate):
    """(dr, dk, dv, dw, du, dstate0) of the WKV6 scan, as ``ssm_scan_bwd``:
    autograd through ``rwkv6_chunked_exact`` (exact at every decay), one
    segment at a time. Its (B, H, n, c + 1, c + 1, K) factor tensor then
    spans one segment's chunks, not T's."""
    (dr, dk, dv, dw), (du,), ds0 = _segmented_backward(
        rwkv6_chunked_exact, (r, k, v, w), (u,), states, dout, dstate)
    return dr, dk, dv, dw, du, ds0


class RWKV6ScanTrainable(torch.autograd.Function):
    """The WKV6 scan with a gradient for r, k, v, w, u and the state, shaped
    like ``SSMScanTrainable``: the forward is ``fwd(r, k, v, w, u, state)``
    segment by segment (``rwkv6_chunked_exact`` when None, or the CUDA
    kernel's wrapper), saving the inputs and the state entering each
    segment; the backward is ``rwkv6_scan_bwd``, plain PyTorch."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, fwd=None):
        out, s, states = _segmented_forward(
            rwkv6_chunked_exact if fwd is None else fwd, (r, k, v, w), (u,),
            state)
        ctx.save_for_backward(r, k, v, w, u, *states)
        return out, s

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, *states = ctx.saved_tensors
        return (*rwkv6_scan_bwd(r, k, v, w, u, states, dout, dstate), None)
