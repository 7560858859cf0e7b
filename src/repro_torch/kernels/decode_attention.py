"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the port of ``repro/kernels/decode_attention.py::decode_attention``.

Takes CUDA tensors only; ``ops.decode_attention`` sends CPU tensors to the
plain version (``ref.decode_attention_direct``). ``launches`` counts the
kernel's launches and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES, HEAD_DIMS

MAX_GROUP = 16      # query heads per kv head (csrc MAX_G)

launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Dh); cache (B, S, KVH, Dh); lengths (B,) cache lengths with
    the new token already written -> (B, H, Dh)."""
    global launches
    B, H, Dh = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != Dh:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not "
                         f"match q {tuple(q.shape)}")
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    if H % KVH or H // KVH > MAX_GROUP:
        raise NotImplementedError(
            f"decode kernel needs H % KVH == 0 and H / KVH <= {MAX_GROUP}; "
            f"got H={H}, KVH={KVH}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if q.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"decode_attention kernel dtype {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(f"decode_attention kernel head_dim {Dh}; "
                                  f"supported: {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), o.data_ptr(), B, S, H, KVH, Dh,
            DTYPE_CODES[q.dtype], -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), Dh ** -0.5, stream)
    _build.check(err, "decode_attention launch")
    launches += 1
    return o
