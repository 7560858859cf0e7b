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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops

Params = dict


def init_state(cfg: ModelConfig, spec: LayerSpec, batch: int, dtype,
               device, lead: tuple = ()) -> dict:
    """Zeroed recurrent state of a ``mamba`` or ``rwkv`` layer, with
    leading dims ``lead`` (a cache stacks its layers): Mamba ``h`` (B, Din,
    N) fp32 and ``conv`` (B, K-1, Din); RWKV ``wkv`` (B, H, K, K) fp32 and
    the token shifts ``shift_tm`` / ``shift_cm`` (B, D). Shifts and conv
    are in ``dtype`` (the model dtype)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)

    if spec.kind == "mamba":
        return {"h": zeros(cfg.d_inner, cfg.mamba_d_state, dt=torch.float32),
                "conv": zeros(cfg.mamba_conv - 1, cfg.d_inner)}
    if spec.kind == "rwkv":
        H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"wkv": zeros(H, K, K, dt=torch.float32),
                "shift_tm": zeros(cfg.d_model), "shift_cm": zeros(cfg.d_model)}
    raise ValueError(spec.kind)


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
                  *, impl: Optional[str] = None, in_place: bool = False):
    """x: (B, S, D) pre-normed; state {"h", "conv"}. Returns (out (B, S, D),
    {"h": final h fp32, "conv": new conv state}). ``in_place``: the scan
    writes the final h into ``state["h"]`` and returns that tensor."""
    dt_ = x.dtype
    Din, N, R = cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
    x_in, z = (x @ p["in_proj"].to(dt_)).split(Din, dim=-1)
    conv_out, conv_new = _mamba_conv(p, x_in, state["conv"])
    xc = F.silu(conv_out)
    dt_low, Bm, Cm = (xc @ p["x_proj"].to(dt_)).split([R, N, N], dim=-1)
    dt = F.softplus(dt_low.float() @ p["dt_w"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_fin = ops.ssm_scan(xc, dt, A, Bm, Cm, p["Dskip"], state["h"],
                            impl=impl,
                            state_out=state["h"] if in_place else None)
    out = (y * F.silu(z)) @ p["out_proj"].to(dt_)
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


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict,
                  *, impl: Optional[str] = None, in_place: bool = False):
    """x: (B, S, D) pre-normed; state {"wkv", "shift_tm"}. Returns (out,
    {"wkv": final state fp32, "shift_tm": x[:, -1]}). ``in_place``: the
    scan writes the final state into ``state["wkv"]`` and returns that
    tensor (the kernel takes it where S fits one chunk, as at decode)."""
    B, S, D = x.shape
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = x.dtype
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

    w_log = p["decay_base"].float() + torch.tanh(
        xw @ p["decay_w1"].to(dt)).float() @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(w_log)).view(B, S, H, K)       # decay in (0, 1)
    out, s_new = ops.rwkv6_scan(
        r, k, v, w, p["u"], state["wkv"], impl=impl,
        state_out=state["wkv"] if in_place else None)

    # per-head groupnorm
    of = out.float()
    var, mean = torch.var_mean(of, dim=-1, keepdim=True, correction=0)
    of = (of - mean) * torch.rsqrt(var + 64e-5)
    of = of.reshape(B, S, D) * p["ln_x_scale"] + p["ln_x_bias"]
    out = (of.to(dt) * g) @ p["wo"].to(dt)
    return out, {"wkv": s_new, "shift_tm": x[:, -1]}


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: dict):
    """x: (B, S, D) pre-normed; state {"shift_cm"}. Returns (out,
    {"shift_cm": x[:, -1]})."""
    dt = x.dtype
    dx = _token_shift(x, state["shift_cm"].to(dt)) - x
    xk = x + dx * p["mu_k_c"].to(dt)
    xr = x + dx * p["mu_r_c"].to(dt)
    k = torch.relu(xk @ p["wk_c"].to(dt)) ** 2
    v = k @ p["wv_c"].to(dt)
    r = torch.sigmoid(xr @ p["wr_c"].to(dt))
    return r * v, {"shift_cm": x[:, -1]}
