"""Core transformer layers (port of ``repro/models/layers.py``): norms, RoPE,
GQA attention (global / sliding-window / cross), dense MLP variants.

Layers are plain functions over a dict of one layer's parameter tensors,
laid out as in the JAX package (``wq (D, H, Dh)``, ``wo (H, Dh, D)``, ...).
Attention goes through ``kernels/ops.py``, so CUDA tensors run the
hand-written kernels. A cross layer attends, without RoPE or a mask, over
K/V projected from the vision tokens; its cache holds them and is static
across decode.

Tensor parallelism (a model on a mesh, ``TPPlan``; the MoE layers' expert
parallelism is ``moe.py``'s): each card holds the
slices of the weights that the reference's logical-axis rules give it and
computes at its local widths. ``wq`` / ``wo`` are sharded over heads,
``wk`` / ``wv`` over kv heads where they divide the axis, else replicated;
the MLP's ``w_up`` / ``w_gate`` over d_ff by columns and ``w_down`` by rows.
After ``wo`` and after ``w_down`` the cards' partial sums are all-reduced
(``sharding.reduce_from``), and the input of the column-parallel products
goes through ``sharding.copy_to``, whose backward all-reduces its gradient:
the residual stream's gradient is whole on every card (Megatron's pair), so
the norms' gradients are equal across "model". Where ``wk`` / ``wv`` are
replicated and the heads are not, a card's gradients of them (and of
``bk`` / ``bv``) hold only its query heads' part: the train step sums them
over "model" (``partial_leaves``).
Where ``wk`` is replicated, a card's query heads read only the kv heads
they map to (qwen2's 12 / 2 heads over 4 cards: 3 query heads and one kv
head a card). A decode cache sharded by kv heads is read as on one card; a
cache sharded by sequence (``TPPlan.seq``) is read flash-decoding style
across the cards: the query heads are gathered, the decode kernel runs
over all heads on this card's rows in its partial mode (``start``, global
lengths and window), the partials are gathered and merged by the kernel's
combine pass, and the card keeps its heads for ``wo``; only the card that
owns position ``lengths[b]`` writes or merges the new token.
A cross layer is cut the same way: its K/V are projected from the whole
vision tokens at ``wk``'s kv heads, its output all-reduced after ``wo``,
and a static cache cut by rows (``TPPlan.cross_seq``) is read through the
partial mode and the merge, every row valid.

Sequence parallelism (``seqpar``, Megatron's: ``TPPlan.sp``, the residual
stream's sequence cut over "model" in a prefill or a training pass): the
residual stream and the norms hold this card's rows of the sequence. A
layer's sharded part gathers them (``enter``: an all-gather, whose backward
reduce-scatters the cards' parts of the input gradient) and leaves by a
reduce-scatter of the partial sums over the sequence (``leave``, backward
an all-gather) in place of the all-reduce. A layer whose heads or d_ff are
not cut computes everything on the gathered sequence and keeps its rows
(``sharding.split_to``); its input gradient is then whole on every card,
and the gather's backward keeps this card's rows. The norms' gradients are
a card's part (``transformer.is_partial``). Mamba and RWKV-6 mixers
(``ssm.py``) and cross layers enter and leave the same way; a cross
layer's vision tokens are a second sequence, whole on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops

Params = dict

# Logical axes of one layer's leaves (the reference's ``init_attention`` /
# ``init_mlp`` / ``init_attention_cache`` axes; a stacked leaf adds a leading
# "layers")
ATTN_AXES = {
    "wq": ("model_d", "heads", "head_dim"),
    "wk": ("model_d", "kv_heads", "head_dim"),
    "wv": ("model_d", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "model_d"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
}
MLP_AXES = {"w_up": ("model_d", "ff"), "w_down": ("ff", "model_d"),
            "w_gate": ("model_d", "ff")}
CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Where this card's part of the attention and dense-MLP layers lives:
    the spec entry of each sharded dim (None: replicated) and the card's
    range of it. ``sp``, the residual stream's sequence entry under
    ``seqpar`` (None: every card holds the whole sequence), is set per
    prefill or training pass. ``seq`` / ``s0`` (the decode cache's row
    shard and the
    global position of its row 0), ``cache_kv`` / ``cache_kv0`` (its kv
    heads) and ``cross_seq`` / ``cross_s0`` (a cross layer's cache rows,
    cut by their own count) are set per decode step from the cache's
    layout."""

    layout: SH.Layout
    heads: Any
    h0: int
    hl: int
    kv: Any
    kv0: int
    kvl: int
    ff: Any
    seq: Any = None
    s0: int = 0
    cache_kv: Any = None
    cache_kv0: int = 0
    experts: Any = None
    expert_ff: Any = None
    e0: int = 0
    el: int = 0
    inner: Any = None
    dinl: int = 0
    rwkv: Any = None
    rh0: int = 0
    rhl: int = 0
    cross_seq: Any = None
    cross_s0: int = 0
    sp: Any = None


def tp_plan(cfg: ModelConfig, layout: SH.Layout) -> TPPlan:
    """The plan of ``cfg``'s attention, MLP and MoE layers under
    ``layout``: a MoE layer's experts [e0, e0 + el) and the spec entries of
    its experts and expert d_ff dims (``moe.MOE_AXES``); a Mamba layer's
    ``dinl`` channels a card over ``inner`` ("d_inner"); an RWKV
    layer's heads [rh0, rh0 + rhl) over ``rwkv`` ("rwkv_heads", which
    must cut its D-wide "d_inner" columns the same way, as must "ff" its
    channel mix: ``ssm.py``)."""
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    heads = layout.spec(ATTN_AXES["wq"], (D, H, Dh))[1]
    kv = layout.spec(ATTN_AXES["wk"], (D, KV, Dh))[1]
    ff = layout.spec(MLP_AXES["w_up"], (D, cfg.d_ff))[1]
    hl, kvl = H // layout.size(heads), KV // layout.size(kv)
    E = cfg.n_experts
    ex = exf = None
    el = E
    if E:
        ex, _, exf = layout.spec(("experts", "model_d", "expert_ff"),
                                 (E, D, cfg.moe_d_ff))
        el = E // layout.size(ex)
    kinds = {spec.kind for spec in cfg.layer_specs()}
    inner, dinl, rh, rhl = None, cfg.d_inner, None, cfg.rwkv_heads
    if "mamba" in kinds:
        inner = layout.spec(("d_inner",), (cfg.d_inner,))[0]
        dinl = cfg.d_inner // layout.size(inner)
    if "rwkv" in kinds:
        rh = layout.spec(("rwkv_heads",), (cfg.rwkv_heads,))[0]
        rhl = cfg.rwkv_heads // layout.size(rh)
        cols = layout.spec(("d_inner",), (D,))[0]
        if SH.entry_axes(cols) != SH.entry_axes(rh) or (
                layout.size(rh) > 1
                and SH.entry_axes(ff) != SH.entry_axes(rh)):
            raise NotImplementedError(
                f"{cfg.name}: rwkv_heads {rh}, its D columns {cols} and "
                f"its channel mix's ff {ff} must be cut over the same axes")
    return TPPlan(layout, heads, layout.index(heads) * hl, hl, kv,
                  layout.index(kv) * kvl, kvl, ff, experts=ex,
                  expert_ff=exf, e0=layout.index(ex) * el, el=el,
                  inner=inner, dinl=dinl,
                  rwkv=rh, rh0=layout.index(rh) * rhl, rhl=rhl)


def _q_kv_heads(cfg: ModelConfig, tp: TPPlan) -> tuple[int, int]:
    """The global kv heads [lo, hi) this card's query heads read. Its heads
    must map to whole kv heads with one group size: a kv head's group
    split over cards (G % hl == 0) or whole groups (hl % G == 0)."""
    G = cfg.n_heads // cfg.n_kv_heads
    if not (tp.hl % G == 0 or G % tp.hl == 0):
        raise NotImplementedError(
            f"{tp.hl} query heads a card against groups of {G}: a card's "
            "heads must read whole kv heads with one group size")
    return tp.h0 // G, (tp.h0 + tp.hl - 1) // G + 1


def _kv_for_q(cfg: ModelConfig, tp: Optional[TPPlan], k: torch.Tensor,
              v: torch.Tensor, k0: int):
    """The kv heads of k / v (..., KVH', Dh) whose first is global kv head
    ``k0`` that this card's query heads read (views)."""
    if tp is None or tp.heads is None:
        return k, v
    lo, hi = _q_kv_heads(cfg, tp)
    if lo < k0 or hi - k0 > k.shape[-2]:
        raise ValueError(f"kv heads [{lo}, {hi}) are not on this card "
                         f"({k.shape[-2]} from {k0})")
    return k[..., lo - k0:hi - k0, :], v[..., lo - k0:hi - k0, :]


def row_parallel(out: torch.Tensor, tp: Optional[TPPlan],
                 entry) -> torch.Tensor:
    """The cards' partial sums of a row-parallel product, all-reduced over
    ``entry`` (nothing where it is replicated); the gradient passes
    through."""
    if tp is None or entry is None:
        return out
    return SH.reduce_from(out, tp.layout, entry)


def column_parallel(x: torch.Tensor, tp: Optional[TPPlan],
                    entry) -> torch.Tensor:
    """The input of column-parallel products sharded over ``entry``:
    itself, its gradient all-reduced over ``entry`` in the backward."""
    if tp is None or entry is None:
        return x
    return SH.copy_to(x, tp.layout, entry)


def enter(x: torch.Tensor, tp: Optional[TPPlan], entry) -> torch.Tensor:
    """The input of a layer's part sharded over ``entry`` (heads, d_ff):
    with ``tp.sp`` this card's rows of the residual stream gathered over the
    sequence (backward: the cards' parts of the gradient reduce-scattered
    where ``entry`` cuts the work, this card's rows where every card did
    it all), else ``column_parallel``."""
    if tp is None or tp.sp is None:
        return column_parallel(x, tp, entry)
    return SH.gather_from(x, tp.layout, tp.sp, 1, scatter=entry is not None)


def leave(out: torch.Tensor, tp: Optional[TPPlan], entry) -> torch.Tensor:
    """A layer's output back to the residual stream: with ``tp.sp`` the
    cards' partial sums reduce-scattered over the sequence, or this card's
    rows where ``entry`` is not cut (``enter``), else ``row_parallel``."""
    if tp is None or tp.sp is None:
        return row_parallel(out, tp, entry)
    if entry is None:
        return SH.split_to(out, tp.layout, tp.sp, 1)
    return SH.reduce_scatter(out, tp.layout, tp.sp, 1)


def partial_leaves(cfg: ModelConfig, tp: Optional[TPPlan]) -> tuple:
    """The attention leaves whose gradient on a card is a part to be summed
    over "model": ``wk`` / ``wv`` (and their biases) where they are
    replicated and the query heads are sharded, each card reading only its
    heads' kv heads."""
    if tp is None or tp.heads is None or tp.kv is not None:
        return ()
    return ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())


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
                      impl: Optional[str] = None,
                      tp: Optional[TPPlan] = None):
    """Full-sequence (prefill) attention. x: (B, S, D), or this card's
    rows of the sequence under ``tp.sp``; positions: (B, S);
    vision_kv (B, Nv, D) for cross layers. Returns (out (B, S, D), {"k",
    "v"} of shape (B, S, KVH, Dh), or (B, Nv, KVH, Dh) for a cross layer,
    whose K/V is static across decode). With ``tp`` the heads and the K/V
    are this card's (``wk``'s kv heads) and ``out`` is all-reduced (under
    ``tp.sp`` reduce-scattered to this card's rows)."""
    x = enter(x, tp, tp and tp.heads)
    q = _q(p, x)
    cross = spec.attn_type == "cross"
    if cross:
        k, v = _kv(p, vision_kv)
    else:
        k, v = _kv(p, x)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if spec.attn_type == "local" else None
    kq, vq = _kv_for_q(cfg, tp, k, v, 0 if tp is None else tp.kv0)
    out = ops.flash_attention(q, kq.contiguous(), vq.contiguous(),
                              causal=not cross, window=window,
                              softcap=cfg.attn_softcap, impl=impl)
    return (leave(_out_proj(out, p["wo"]), tp, tp and tp.heads),
            {"k": k, "v": v})


def attention_decode(cfg: ModelConfig, spec: LayerSpec, p: Params,
                     x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                     *, append: bool = False, impl: Optional[str] = None,
                     tp: Optional[TPPlan] = None):
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
    the cache in committed mode and no deltas ({}) in append mode. On a
    mesh it reads its kv heads, or its rows (``TPPlan.cross_seq``) through
    the partial mode and the merge.

    With ``tp`` (module docstring) the cache is this card's shard and
    ``lengths`` stay global; a sequence-sharded cache is written only on
    the card that owns position ``lengths[b]``.
    """
    B = x.shape[0]
    q = _q(p, x)
    if spec.attn_type == "cross":
        out = _cross_decode(cfg, q[:, 0], cache, impl, tp)
        out = row_parallel(_out_proj(out, p["wo"]), tp, tp and tp.heads)
        return out[:, None], ({} if append else cache)
    pos = lengths[:, None]                                     # (B,1)
    k_new, v_new = _kv(p, x)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    window = cfg.sliding_window if spec.attn_type == "local" else None
    kn, vn = k_new[:, 0], v_new[:, 0]
    if tp is not None and tp.seq is not None:
        out = _decode_seq_sharded(cfg, q[:, 0], cache, lengths, kn, vn,
                                  window, append, impl, tp)
    else:
        if not append:
            bidx = torch.arange(B, device=x.device)
            cache["k"][bidx, lengths] = kn
            cache["v"][bidx, lengths] = vn
        kc, vc = cache["k"], cache["v"]
        if tp is not None:     # the kv heads this card's query heads read
            kc, vc = _kv_for_q(cfg, tp, kc, vc, tp.cache_kv0)
            kn_q, vn_q = _kv_for_q(cfg, tp, kn, vn, tp.kv0)
            kn_q, vn_q = kn_q.contiguous(), vn_q.contiguous()
        else:
            kn_q, vn_q = kn, vn
        if append:
            out = ops.decode_attention(q[:, 0], kc, vc, lengths,
                                       window=window,
                                       softcap=cfg.attn_softcap,
                                       k_new=kn_q, v_new=vn_q, impl=impl)
        else:
            out = ops.decode_attention(q[:, 0], kc, vc, lengths + 1,
                                       window=window,
                                       softcap=cfg.attn_softcap, impl=impl)
    out = row_parallel(_out_proj(out, p["wo"]), tp, tp and tp.heads)
    return out[:, None], ({"k_new": kn, "v_new": vn} if append else cache)


def write_owned(leaf: torch.Tensor, bidx: torch.Tensor,
                lengths: torch.Tensor, new: torch.Tensor,
                s0: int) -> None:
    """Write ``new`` at global position ``lengths[b]`` of each row of a
    sequence-sharded cache ``leaf`` (..., B, S_local, KVH, Dh) whose row 0
    is position ``s0``, IN PLACE, on the card that owns the position: the
    others write back what they hold there. Device indices and a mask, no
    host sync."""
    S = leaf.shape[-3]
    idx = (lengths - s0).clamp(0, S - 1)
    own = ((lengths >= s0) & (lengths < s0 + S))[:, None, None]
    old = leaf[..., bidx, idx, :, :]
    leaf[..., bidx, idx, :, :] = torch.where(own, new.to(leaf.dtype), old)


def _decode_seq_sharded(cfg, q, cache, lengths, kn, vn, window, append,
                        impl, tp: TPPlan) -> torch.Tensor:
    """Decode attention over a cache sharded by sequence (the module
    docstring): this card's query heads (B, hl, Dh) in, its heads' rows
    (B, hl, Dh) out."""
    if not append:
        bidx = torch.arange(q.shape[0], device=q.device)
        write_owned(cache["k"], bidx, lengths, kn, tp.s0)
        write_owned(cache["v"], bidx, lengths, vn, tp.s0)
    news = {"k_new": kn, "v_new": vn} if append else {}
    return _merged_over_rows(cfg, q, cache, lengths if append
                             else lengths + 1, tp.seq, tp.s0, impl, tp,
                             window=window, **news)


def _merged_over_rows(cfg, q, cache, lengths, seq, start, impl, tp: TPPlan,
                      **kw) -> torch.Tensor:
    """This card's query heads (B, hl, Dh) over a cache whose rows are cut
    over ``seq`` (its row 0 is global position ``start``): every query
    head gathered, the kernel's partial mode over this card's rows at the
    global ``lengths``, the partials gathered and merged; this card's
    heads out."""
    if tp.kv is not None or tp.cache_kv is not None:
        raise NotImplementedError("a cache sharded by sequence holds every "
                                  "kv head: wk must be replicated")
    layout = tp.layout
    qa = SH.all_gather(q, layout, tp.heads, dim=1) if tp.heads else q
    part = ops.decode_attention(
        qa.contiguous(), cache["k"], cache["v"], lengths,
        softcap=cfg.attn_softcap, start=start, partial=True, impl=impl, **kw)
    parts = SH.gather_partials(part, layout, seq)
    out = ops.decode_merge(parts, q.dtype, impl=impl)
    if tp.heads is None:
        return out
    return out[:, tp.h0:tp.h0 + tp.hl].contiguous()


def _cross_decode(cfg, q, cache, impl, tp: Optional[TPPlan]) -> torch.Tensor:
    """A cross layer's query heads (B, hl, Dh) over its static cache of
    ``cfg.n_vision_tokens`` rows, every one valid: its kv heads (those
    this card's heads read), or its rows merged over the cards where the
    cache is cut by rows."""
    nv = torch.full((q.shape[0],), cfg.n_vision_tokens, dtype=torch.int64,
                    device=q.device)
    if tp is not None and tp.cross_seq is not None:
        return _merged_over_rows(cfg, q, cache, nv, tp.cross_seq,
                                 tp.cross_s0, impl, tp)
    kc, vc = cache["k"], cache["v"]
    if tp is not None:
        kc, vc = _kv_for_q(cfg, tp, kc, vc, tp.cache_kv0)
    return ops.decode_attention(q, kc, vc, nv, softcap=cfg.attn_softcap,
                                impl=impl)


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


def mlp_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                tp: Optional[TPPlan] = None) -> torch.Tensor:
    """The dense MLP; with ``tp`` at this card's d_ff columns, the output
    all-reduced (under ``tp.sp``: on the gathered sequence, the output
    reduce-scattered to this card's rows)."""
    dt = x.dtype
    x = enter(x, tp, tp and tp.ff)
    h = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = _act(cfg.mlp_act, x @ p["w_gate"].to(dt)) * h
    else:
        h = _act(cfg.mlp_act, h)
    return leave(h @ p["w_down"].to(dt), tp, tp and tp.ff)
