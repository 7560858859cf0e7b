"""Wrapper of the CUDA prefill attention kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py::flash_attention``.

bf16 runs on the tensor cores (wgmma); fp32 keeps an fp32-FMA kernel,
since TF32 products cannot meet the fp32 tolerance. With ``lse=True`` (the
training forward) the kernel also writes each query row's log-sum-exp, the
residual of the plain backward (``ref.flash_attention_bwd``). Takes CUDA
tensors only; ``ops.flash_attention`` sends CPU tensors to the plain
versions (``ref.blockwise_attention``, ``ref.blockwise_fwd_lse``).
``launches`` counts the kernel's launches, with or without the lse, and
nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128)
BLOCK_Q = 64        # query rows per block (csrc BQ, both dtypes)

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, lse: bool = False):
    """q: (B, Sq, H, Dh); k, v: (B, Skv, KVH, Dh) -> out (B, Sq, H, Dh);
    with ``lse``, (out, lse (B, KVH, H // KVH, Sq) fp32), NEG_INF on a
    fully masked row (``ref.blockwise_fwd_lse``'s layout)."""
    global launches
    B, Sq, H, Dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != Dh:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    Skv, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if q.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"flash_attention kernel dtype {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel head_dim {Dh}; "
                                  f"supported: {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    o = torch.empty_like(q)
    lse_t = (torch.empty((B, KVH, H // KVH, Sq), dtype=torch.float32,
                         device=q.device) if lse else None)
    if q.numel() == 0 or Skv == 0:
        o.zero_()
        if lse:
            lse_t.fill_(-1e30)
        return (o, lse_t) if lse else o
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(), B, Sq, Skv, H,
            KVH, Dh, DTYPE_CODES[q.dtype], int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), Dh ** -0.5, stream)
    _build.check(err, "flash_attention launch")
    launches += 1
    return (o, lse_t) if lse else o
