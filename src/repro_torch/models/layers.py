"""Core transformer layers (port of ``repro/models/layers.py``): norms, RoPE,
GQA attention (global / sliding-window / cross), dense MLP variants.

Layers are plain functions over a dict of one layer's parameter tensors,
laid out as in the JAX package (``wq (D, H, Dh)``, ``wo (H, Dh, D)``, ...).
Attention goes through ``kernels/ops.py``, so CUDA tensors run the
hand-written kernels. A cross layer attends, without RoPE or a mask, over
K/V projected from the vision tokens; its cache holds them and is static
across decode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops

Params = dict


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (B, S, H, Dh); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, N, Dh) -> (B, S, N, Dh), contiguous."""
    B, S, D = x.shape
    return (x @ w.to(x.dtype).reshape(D, -1)).view(B, S, *w.shape[1:])


def _q(p: Params, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p["wq"])
    return q + p["bq"].to(x.dtype) if "bq" in p else q


def _kv(p: Params, src: torch.Tensor):
    k, v = _proj(src, p["wk"]), _proj(src, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(src.dtype)
        v = v + p["bv"].to(src.dtype)
    return k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (..., H, Dh) @ wo (H, Dh, D) -> (..., D)."""
    H, Dh, D = wo.shape
    return out.reshape(*out.shape[:-2], H * Dh) @ wo.to(out.dtype).reshape(
        H * Dh, D)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, spec: LayerSpec, rep: int, init) -> Params:
    """Stacked (leading ``rep`` dim) attention parameters. ``init(shape,
    std)`` draws normal weights; biases start at zero as in the JAX init."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_q = (2.0 / (D + H * Dh)) ** 0.5
    p: Params = {
        "wq": init((rep, D, H, Dh), s_q),
        "wk": init((rep, D, KV, Dh), s_q),
        "wv": init((rep, D, KV, Dh), s_q),
        "wo": init((rep, H, Dh, D), s_q),
    }
    if cfg.qkv_bias:
        p["bq"] = init((rep, H, Dh), 0.0)
        p["bk"] = init((rep, KV, Dh), 0.0)
        p["bv"] = init((rep, KV, Dh), 0.0)
    return p


def attention_forward(cfg: ModelConfig, spec: LayerSpec, p: Params,
                      x: torch.Tensor, *, positions: torch.Tensor,
                      vision_kv: Optional[torch.Tensor] = None,
                      impl: Optional[str] = None):
    """Full-sequence (prefill) attention. x: (B, S, D); positions: (B, S);
    vision_kv (B, Nv, D) for cross layers. Returns (out (B, S, D), {"k",
    "v"} of shape (B, S, KVH, Dh), or (B, Nv, KVH, Dh) for a cross layer,
    whose K/V is static across decode)."""
    q = _q(p, x)
    if spec.attn_type == "cross":
        k, v = _kv(p, vision_kv)
        out = ops.flash_attention(q, k, v, causal=False, window=None,
                                  softcap=cfg.attn_softcap, impl=impl)
        return _out_proj(out, p["wo"]), {"k": k, "v": v}
    k, v = _kv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if spec.attn_type == "local" else None
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, impl=impl)
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def attention_decode(cfg: ModelConfig, spec: LayerSpec, p: Params,
                     x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                     *, append: bool = False, impl: Optional[str] = None):
    """One decode step. x: (B, 1, D); cache {"k", "v"} of shape (B, Smax,
    KVH, Dh); lengths (B,) tokens already in the cache.

    ``append=False`` (committed): the new token's K/V is written IN PLACE
    into ``cache`` at ``lengths``, then the token attends over ``lengths +
    1`` positions; returns (out (B, 1, D), cache). ``append=True``: the
    cache is read-only, the token attends over its ``lengths`` old tokens
    and itself (``ops.decode_attention`` with ``k_new``/``v_new``), and the
    deltas {"k_new", "v_new"} of shape (B, KVH, Dh) are returned for the
    caller to commit, as in ``repro/models/layers.py``.

    A cross layer attends over its whole static cache (every row's length
    the cache's vision tokens), with no RoPE and no new K/V; it returns
    the cache in committed mode and no deltas ({}) in append mode.
    """
    B = x.shape[0]
    q = _q(p, x)
    if spec.attn_type == "cross":
        nv = cache["k"].shape[1]
        out = ops.decode_attention(
            q[:, 0], cache["k"], cache["v"],
            torch.full((B,), nv, dtype=torch.int64, device=x.device),
            softcap=cfg.attn_softcap, impl=impl)
        return _out_proj(out, p["wo"])[:, None], ({} if append else cache)
    pos = lengths[:, None]                                     # (B,1)
    k_new, v_new = _kv(p, x)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    window = cfg.sliding_window if spec.attn_type == "local" else None
    if append:
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                                   window=window, softcap=cfg.attn_softcap,
                                   k_new=k_new[:, 0], v_new=v_new[:, 0],
                                   impl=impl)
        return (_out_proj(out, p["wo"])[:, None],
                {"k_new": k_new[:, 0], "v_new": v_new[:, 0]})
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, lengths] = k_new[:, 0]
    cache["v"][bidx, lengths] = v_new[:, 0]
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths + 1,
                               window=window, softcap=cfg.attn_softcap,
                               impl=impl)
    return _out_proj(out, p["wo"])[:, None], cache


def init_attention_cache(cfg: ModelConfig, spec: LayerSpec, rep: int,
                         batch: int, max_seq: int, dtype,
                         device: torch.device) -> dict:
    """Zeroed stacked cache {"k", "v"}: (rep, batch, max_seq, KVH, Dh); a
    cross layer's holds max(n_vision_tokens, 1) positions instead."""
    seq = max(cfg.n_vision_tokens, 1) if spec.attn_type == "cross" \
        else max_seq
    shape = (rep, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, rep: int, init) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in = (2.0 / (D + Fd)) ** 0.5
    p: Params = {"w_up": init((rep, D, Fd), s_in),
                 "w_down": init((rep, Fd, D), s_in)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = init((rep, D, Fd), s_in)
    return p


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = _act(cfg.mlp_act, x @ p["w_gate"].to(dt)) * h
    else:
        h = _act(cfg.mlp_act, h)
    return h @ p["w_down"].to(dt)
