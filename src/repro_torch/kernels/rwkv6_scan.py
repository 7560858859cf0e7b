"""Wrapper of the CUDA WKV6 kernel (``csrc/rwkv6_scan.cu``), the port of
``repro/kernels/rwkv6_scan.py::rwkv6_scan``.

Takes CUDA tensors only; ``ops.rwkv6_scan`` sends CPU tensors to the plain
versions (``ref.rwkv6_single_step`` / ``ref.rwkv6_chunked``). ``launches``
counts the kernel's launches and nothing else.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import DTYPE_CODES

HEAD_DIMS = (16, 32, 64)     # csrc launch_k

launches = 0


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r/k/v (B, T, H, K) fp32 or bf16, w (B, T, H, K) fp32, u (H, K) fp32,
    state (B, H, K, K) fp32 -> (out (B, T, H, K) in v's dtype, final state
    (B, H, K, K) fp32). K == V, nothing is cast on entry."""
    global launches
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K), got {tuple(r.shape)}")
    B, T, H, K = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != r "
                             f"{tuple(r.shape)} (the kernel needs K == V)")
    if u.shape != (H, K) or state.shape != (B, H, K, K):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)} "
                         f"do not match r {tuple(r.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"{name} is {t.dtype}, r is {r.dtype}")
    for name, t in (("w", w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if r.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"rwkv6_scan kernel dtype {r.dtype}")
    if K not in HEAD_DIMS:
        raise NotImplementedError(f"rwkv6_scan kernel head dim {K}; "
                                  f"supported: {HEAD_DIMS}")
    out = torch.empty_like(v)
    s_out = torch.empty_like(state)
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(), s_out.data_ptr(),
            B, T, H, K, DTYPE_CODES[r.dtype], stream)
    _build.check(err, "rwkv6_scan launch")
    launches += 1
    return out, s_out
