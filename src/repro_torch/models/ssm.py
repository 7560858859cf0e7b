"""State-space / linear-recurrence blocks (port of ``repro/models/ssm.py``):
Mamba (Jamba's mixer) and RWKV-6 ("Finch").

Parameters keep the JAX names, shapes and dtypes, stacked with a leading
layer dim by ``init_*`` (``init(shape, std, dtype, fill=)`` as in
``transformer.Transformer``). The forward functions take one layer's
tensors and a state dict and return ``(out, new_state)``; the same call
serves prefill (full sequence from a zero state) and decode (one token from
the cache's state), as in the reference, and training (a zero state, no
cache, nothing written in place; with a gradient the scans go through
``ops``' trainable Functions). The scans go through ``kernels/ops.py``, so
CUDA tensors run the hand-written kernels at every sequence length.

On a mesh (``tp``, ``layers.TPPlan``; the reference's rules put
"d_inner" and "rwkv_heads" over "model") every card runs its own channels
or heads, with the collectives the reference's GSPMD inserts written out
(``sharding.copy_to`` / ``reduce_from``, Megatron's pair):

  * Mamba on the card's ``d_inner`` channels: ``in_proj`` column-parallel
    (its (D, 2 Din) leaf cut piece by piece, ``sharding.paired``: the card
    holds x_in's and z's columns of its channels), the conv, ``dt``, ``A``
    and the scan local; ``x_proj`` contracts over ``d_inner``, so its
    (dt_low, B, C) is all-reduced and, since every card's channels use
    all of it, its gradient all-reduced again (``copy_to``); ``out_proj``
    row-parallel. Every leaf is sharded.
  * RWKV-6's time mix on the card's heads: ``wr`` / ``wk`` / ``wv`` /
    ``wg`` column-parallel, ``u``, the WKV6 scan and the per-head group
    norm (its slice of ``ln_x_*``) local, ``wo`` row-parallel; the ddlerp
    is computed whole on every card and the decay LoRA at the card's
    columns (``decay_w2``'s and ``decay_base``'s slice). The channel mix:
    ``wk_c`` / ``wv_c`` over d_ff as the dense MLP, ``wr_c``'s D columns
    over the same axes, so its r is the card's slice of D: v is
    reduce-scattered over D, multiplied by the card's r, and r * v
    all-gathered (the link bytes of one all-reduce). Their replicated
    leaves (``PARTIAL_RWKV``) feed only the card's heads or columns, so a
    card's gradient of them is its part: the train step sums them over
    "model" (``partial_leaves``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models.layers import column_parallel, row_parallel

Params = dict


def state_shapes(cfg: ModelConfig, spec: LayerSpec, batch: int,
                 width: Optional[int] = None) -> dict:
    """{leaf: (shape, fp32 or not)} of one ``mamba`` or ``rwkv`` layer's
    state (``init_state``); ``width`` replaces d_inner (Mamba) or the
    heads (RWKV): a card's on a mesh."""
    if spec.kind == "mamba":
        Din = width or cfg.d_inner
        return {"h": ((batch, Din, cfg.mamba_d_state), True),
                "conv": ((batch, cfg.mamba_conv - 1, Din), False)}
    if spec.kind == "rwkv":
        H, K = width or cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"wkv": ((batch, H, K, K), True),
                "shift_tm": ((batch, cfg.d_model), False),
                "shift_cm": ((batch, cfg.d_model), False)}
    raise ValueError(spec.kind)


def init_state(cfg: ModelConfig, spec: LayerSpec, batch: int, dtype,
               device, lead: tuple = (), width: Optional[int] = None,
               layout: Optional[SH.Layout] = None) -> dict:
    """Zeroed recurrent state of a ``mamba`` or ``rwkv`` layer, with
    leading dims ``lead`` (a cache stacks its layers): Mamba ``h`` (B, Din,
    N) fp32 and ``conv`` (B, K-1, Din); RWKV ``wkv`` (B, H, K, K) fp32 and
    the token shifts ``shift_tm`` / ``shift_cm`` (B, D). Shifts and conv
    are in ``dtype`` (the model dtype). ``width``: a card's channels or
    heads (a prefill's state on a mesh); ``layout``: this card's shard of
    every leaf of a global state by ``STATE_AXES`` (a decode cache's;
    ``lead`` is then its "layers" dim)."""
    out = {}
    for name, (shape, f32) in state_shapes(cfg, spec, batch, width).items():
        shape = (*lead, *shape)
        if layout is not None:
            shape = layout.local_shape(("layers",) + STATE_AXES[spec.kind]
                                       [name], shape)
        out[name] = torch.zeros(shape, device=device,
                                dtype=torch.float32 if f32 else dtype)
    return out


# Logical axes of one layer's leaves (the reference's ``init_*`` axes; a
# stacked leaf adds a leading "layers"): parameters, then cache states.
MAMBA_AXES = {
    "in_proj": ("model_d", SH.paired("d_inner")),
    "conv_w": ("conv", "d_inner"),
    "conv_b": ("d_inner",), "x_proj": ("d_inner", None),
    "dt_w": (None, "d_inner"), "dt_bias": ("d_inner",),
    "A_log": ("d_inner", "state"), "Dskip": ("d_inner",),
    "out_proj": ("d_inner", "model_d"),
}
RWKV_AXES = {
    "mu_x": ("model_d",), "mu": (None, "model_d"),
    "maa_w1": ("model_d", None), "maa_w2": (None, None, "model_d"),
    "decay_base": ("model_d",),
    "decay_w1": ("model_d", None), "decay_w2": (None, "model_d"),
    "u": ("rwkv_heads", None),
    "wr": ("model_d", "d_inner"), "wk": ("model_d", "d_inner"),
    "wv": ("model_d", "d_inner"), "wg": ("model_d", "d_inner"),
    "wo": ("d_inner", "model_d"),
    "ln_x_scale": ("model_d",), "ln_x_bias": ("model_d",),
    "mu_k_c": ("model_d",), "mu_r_c": ("model_d",),
    "wk_c": ("model_d", "ff"), "wv_c": ("ff", "model_d"),
    "wr_c": ("model_d", "d_inner"),
}
# the RWKV leaves a card uses only for its heads' (or its D columns') part
PARTIAL_RWKV = ("mu_x", "mu", "maa_w1", "maa_w2", "decay_base", "decay_w1",
                "decay_w2", "ln_x_scale", "ln_x_bias", "mu_k_c", "mu_r_c")
STATE_AXES = {
    "mamba": {"h": ("batch", "d_inner", None),
              "conv": ("batch", None, "d_inner")},
    "rwkv": {"wkv": ("batch", "rwkv_heads", None, None),
             "shift_tm": ("batch", None), "shift_cm": ("batch", None)},
}


# ===========================================================================
# Mamba
# ===========================================================================
def init_mamba(cfg: ModelConfig, rep: int, init) -> Params:
    D, Din, N, R, K = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                       cfg.dt_rank, cfg.mamba_conv)
    return {
        "in_proj": init((rep, D, 2 * Din), D ** -0.5),
        "conv_w": init((rep, K, Din), K ** -0.5),
        "conv_b": init((rep, Din), 0.0),
        "x_proj": init((rep, Din, R + 2 * N), Din ** -0.5),
        "dt_w": init((rep, R, Din), R ** -0.5),
        "dt_bias": init((rep, Din), None, fill=math.log(math.expm1(0.01))),
        "A_log": init((rep, Din, N), None, fill=torch.log(
            torch.arange(1, N + 1, dtype=torch.float32))),
        "Dskip": init((rep, Din), None),
        "out_proj": init((rep, Din, D), Din ** -0.5),
    }


def _mamba_conv(p: Params, x_in: torch.Tensor, conv_state: torch.Tensor):
    """Causal depthwise conv, kernel K (small, unrolled).

    x_in: (B, S, Din); conv_state: (B, K-1, Din) trailing context.
    Returns (conv_out (B, S, Din), new_state (B, K-1, Din))."""
    K = p["conv_w"].shape[0]
    dt = x_in.dtype
    S = x_in.shape[1]
    padded = torch.cat([conv_state.to(dt), x_in], dim=1)
    w = p["conv_w"].to(dt)
    out = sum(w[i] * padded[:, i:i + S] for i in range(K)) \
        + p["conv_b"].to(dt)
    return out, padded[:, S:]


def mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict,
                  *, impl: Optional[str] = None, in_place: bool = False,
                  tp=None):
    """x: (B, S, D) pre-normed; state {"h", "conv"}. Returns (out (B, S, D),
    {"h": final h fp32, "conv": new conv state}). ``in_place``: the scan
    writes the final h into ``state["h"]`` and returns that tensor. With
    ``tp`` the leaves and the state are the card's channels (module
    docstring) and ``out`` is all-reduced."""
    dt_ = x.dtype
    N, R = cfg.mamba_d_state, cfg.dt_rank
    Din = p["in_proj"].shape[-1] // 2          # the card's channels
    entry = None if tp is None else tp.inner
    x = column_parallel(x, tp, entry)
    x_in, z = (x @ p["in_proj"].to(dt_)).split(Din, dim=-1)
    conv_out, conv_new = _mamba_conv(p, x_in, state["conv"])
    xc = F.silu(conv_out)
    # a sum over d_inner: every card's channels use the whole of it
    dbc = row_parallel(xc @ p["x_proj"].to(dt_), tp, entry)
    dbc = column_parallel(dbc, tp, entry)
    dt_low, Bm, Cm = dbc.split([R, N, N], dim=-1)
    dt = F.softplus(dt_low.float() @ p["dt_w"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_fin = ops.ssm_scan(xc, dt, A, Bm, Cm, p["Dskip"], state["h"],
                            impl=impl,
                            state_out=state["h"] if in_place else None)
    out = row_parallel((y * F.silu(z)) @ p["out_proj"].to(dt_), tp,
                       entry)
    return out, {"h": h_fin, "conv": conv_new}


# ===========================================================================
# RWKV6 ("Finch")
# ===========================================================================
def init_rwkv(cfg: ModelConfig, rep: int, init) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    mix, dec = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    s = D ** -0.5
    f32 = torch.float32
    return {
        # time-mix (ddlerp) params
        "mu_x": init((rep, D), 0.0, f32),
        "mu": init((rep, 5, D), 0.0, f32),             # w, k, v, r, g
        "maa_w1": init((rep, D, 5 * mix), s * 0.1),
        "maa_w2": init((rep, 5, mix, D), 0.1 * mix ** -0.5),
        # data-dependent decay
        "decay_base": init((rep, D), None, fill=-1.0),
        "decay_w1": init((rep, D, dec), s * 0.1),
        "decay_w2": init((rep, dec, D), 0.1 * dec ** -0.5),
        "u": init((rep, H, K), 0.1, f32),
        "wr": init((rep, D, D), s),
        "wk": init((rep, D, D), s),
        "wv": init((rep, D, D), s),
        "wg": init((rep, D, D), s),
        "wo": init((rep, D, D), s),
        "ln_x_scale": init((rep, D), None),
        "ln_x_bias": init((rep, D), 0.0, f32),
        # channel-mix
        "mu_k_c": init((rep, D), 0.0, f32),
        "mu_r_c": init((rep, D), 0.0, f32),
        "wk_c": init((rep, D, Fd), s),
        "wv_c": init((rep, Fd, D), Fd ** -0.5),
        "wr_c": init((rep, D, D), s),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """xx_t = x_{t-1}, with ``last`` (B, D) filling position 0."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def partial_leaves(tp) -> tuple:
    """The RWKV leaves whose gradient on a card is a part to be summed
    over "model": the replicated ones, where the heads are sharded."""
    if tp is None or tp.rwkv is None or tp.layout.size(tp.rwkv) == 1:
        return ()
    return PARTIAL_RWKV


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict,
                  *, impl: Optional[str] = None, in_place: bool = False,
                  tp=None):
    """x: (B, S, D) pre-normed; state {"wkv", "shift_tm"}. Returns (out,
    {"wkv": final state fp32, "shift_tm": x[:, -1]}). ``in_place``: the
    scan writes the final state into ``state["wkv"]`` and returns that
    tensor (the kernel takes it where S fits one chunk, as at decode).
    With ``tp`` the heads, their leaves and ``wkv`` are the card's (module
    docstring) and ``out`` is all-reduced."""
    B, S, D = x.shape
    K = cfg.rwkv_head_dim
    H = p["u"].shape[0]                        # the card's heads
    cols = slice(0, D) if tp is None else slice(tp.rh0 * K,
                                                (tp.rh0 + H) * K)
    entry = None if tp is None else tp.rwkv
    dt = x.dtype
    x = column_parallel(x, tp, entry)
    dx = _token_shift(x, state["shift_tm"].to(dt)) - x
    x_base = x + dx * p["mu_x"].to(dt)
    deltas = torch.tanh(x_base @ p["maa_w1"].to(dt)).reshape(
        B, S, 5, cfg.rwkv_lora_mix)
    deltas = torch.einsum("bsim,imd->bsid", deltas, p["maa_w2"].to(dt))
    mus = p["mu"].to(dt) + deltas                           # (B, S, 5, D)
    xw, xk, xv, xr, xg = (x + dx * mus[:, :, i] for i in range(5))

    r = (xr @ p["wr"].to(dt)).view(B, S, H, K)
    k = (xk @ p["wk"].to(dt)).view(B, S, H, K)
    v = (xv @ p["wv"].to(dt)).view(B, S, H, K)
    g = F.silu(xg @ p["wg"].to(dt))

    w_log = p["decay_base"][cols].float() + torch.tanh(
        xw @ p["decay_w1"].to(dt)).float() @ p["decay_w2"][:, cols].float()
    w = torch.exp(-torch.exp(w_log)).view(B, S, H, K)       # decay in (0, 1)
    out, s_new = ops.rwkv6_scan(
        r, k, v, w, p["u"], state["wkv"], impl=impl,
        state_out=state["wkv"] if in_place else None)

    # per-head groupnorm
    of = out.float()
    var, mean = torch.var_mean(of, dim=-1, keepdim=True, correction=0)
    of = (of - mean) * torch.rsqrt(var + 64e-5)
    of = of.reshape(B, S, H * K) * p["ln_x_scale"][cols] \
        + p["ln_x_bias"][cols]
    out = row_parallel((of.to(dt) * g) @ p["wo"].to(dt), tp, entry)
    return out, {"wkv": s_new, "shift_tm": x[:, -1]}


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: dict, tp=None):
    """x: (B, S, D) pre-normed; state {"shift_cm"}. Returns (out,
    {"shift_cm": x[:, -1]}). With ``tp``: d_ff and r's D columns are the
    card's, v is reduce-scattered over D and r * v all-gathered (module
    docstring)."""
    dt = x.dtype
    entry = None if tp is None else tp.rwkv
    live = entry is not None and tp.layout.size(entry) > 1
    x = column_parallel(x, tp, entry)
    dx = _token_shift(x, state["shift_cm"].to(dt)) - x
    xk = x + dx * p["mu_k_c"].to(dt)
    xr = x + dx * p["mu_r_c"].to(dt)
    k = torch.relu(xk @ p["wk_c"].to(dt)) ** 2
    v = k @ p["wv_c"].to(dt)
    r = torch.sigmoid(xr @ p["wr_c"].to(dt))
    if not live:
        return r * v, {"shift_cm": x[:, -1]}
    v = SH.reduce_scatter(v, tp.layout, entry, v.dim() - 1)
    out = SH.gather_from(r * v, tp.layout, entry, v.dim() - 1)
    return out, {"shift_cm": x[:, -1]}
