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
                           tile: int = DECODE_SPLIT_TILE) -> torch.Tensor:
    """Split-KV decode as the CUDA kernel does it, in fp32: the cache is cut
    into ``n_splits`` chunks of ``split_chunk(S, n_splits, tile)`` rows; each
    chunk gives a partial (m, l, o) of its kept keys (an empty chunk gives
    m = NEG_INF, l = 0, o = 0); the combine rescales each partial by
    exp(m_s - m), skips empty ones through the m_safe guard and divides by
    max(l, 1e-30). Used by the tests, which cannot run the CUDA combine."""
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
        valid &= k_pos[None] >= lens - window
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
    zeros and w = 1 (the padding neither decays nor feeds the state)."""
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
