"""Wrapper of the CUDA Mamba selective-scan kernel (``csrc/ssm_scan.cu``),
the port of ``repro/kernels/ssm_scan.py::ssm_scan``.

Takes CUDA tensors only; ``ops.ssm_scan`` sends CPU tensors to the plain
versions (``ref.ssm_single_step`` / ``ref.ssm_chunked``). ``launches``
counts the kernel's launches and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES

MAX_STATE = 16       # csrc MAX_N

launches = 0


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, state_out: Optional[torch.Tensor] = None):
    """x (B, T, Din), Bm/Cm (B, T, N), all fp32 or all bf16; dt (B, T, Din),
    A (Din, N), D (Din,), h0 (B, Din, N) fp32 -> (y (B, T, Din) in x's
    dtype, final h (B, Din, N) fp32). Bm and Cm may be strided views (unit
    stride along N); nothing is cast on entry.

    ``state_out``: a tensor like ``h0`` that the final h is written into
    (and returned); it may be ``h0`` itself."""
    global launches
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, Din), got {tuple(x.shape)}")
    B, T, Din = x.shape
    if A.dim() != 2 or A.shape[0] != Din:
        raise ValueError(f"A {tuple(A.shape)} does not match Din={Din}")
    N = A.shape[1]
    if dt.shape != x.shape or D.shape != (Din,) or h0.shape != (B, Din, N) \
            or Bm.shape != (B, T, N) or Cm.shape != (B, T, N):
        raise ValueError(
            f"shapes do not match x {tuple(x.shape)}, A {tuple(A.shape)}: dt "
            f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
            f"D {tuple(D.shape)}, h0 {tuple(h0.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D), ("h0", h0)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bm.stride() != Cm.stride() or Bm.stride(2) != 1:
        raise ValueError(f"Bm / Cm strides {Bm.stride()} / {Cm.stride()}: "
                         "the kernel needs equal strides, unit along N")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"ssm_scan kernel dtype {x.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise NotImplementedError(f"ssm_scan kernel takes a state of 1.."
                                  f"{MAX_STATE}, got N={N}")
    if B > 65535:
        raise NotImplementedError(f"ssm_scan kernel batch {B} > 65535")
    # x and dt are copied in 16-byte pieces, Bm / Cm rows in 4-byte words
    per_piece, per_word = 16 // x.element_size(), 4 // x.element_size()
    for name, t, align in (("x", x, 16), ("dt", dt, 16), ("Bm", Bm, 4),
                           ("Cm", Cm, 4)):
        if t.data_ptr() % align:
            raise NotImplementedError(f"ssm_scan kernel: {name} is not "
                                      f"{align}-byte aligned")
    if Din % per_piece or N % per_word or Bm.stride(0) % per_word \
            or Bm.stride(1) % per_word:
        raise NotImplementedError(
            f"ssm_scan kernel with {x.dtype}: Din={Din} must be a multiple "
            f"of {per_piece}, N={N} and the Bm/Cm strides {Bm.stride()} of "
            f"{per_word}")
    if state_out is None:
        hT = torch.empty_like(h0)
    elif (not state_out.is_cuda or state_out.device != x.device
            or state_out.shape != h0.shape or state_out.dtype != torch.float32
            or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous float32 CUDA tensor "
                         f"of shape {tuple(h0.shape)} on {x.device}")
    else:
        hT = state_out
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssm_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), B, T, Din, N, Bm.stride(0), Bm.stride(1),
            DTYPE_CODES[x.dtype], stream)
    _build.check(err, "ssm_scan launch")
    launches += 1
    return y, hT
