"""Wrapper of the CUDA split-KV decode attention kernels
(``csrc/decode_attention.cu``), the port of
``repro/kernels/decode_attention.py::decode_attention``.

Takes CUDA tensors only; ``ops.decode_attention`` sends CPU tensors to the
plain version (``ref.decode_attention_direct``; ``ref.decode_attention_split``
mirrors the kernels' split and combine). One call launches the split pass
and the combine pass, in committed and in append mode alike (the combine
pass merges the new token); ``launches`` counts such calls and nothing
else.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES, HEAD_DIMS
from .ref import DECODE_SPLIT_TILE

MAX_GROUP = 16      # query heads per kv head (csrc MAX_G)
LENGTH_CODES = {torch.int32: 0, torch.int64: 1}
BLOCKS_PER_SM = 4   # split-pass blocks the split count aims for, per SM

launches = 0


def plan_splits(B: int, KVH: int, S: int, sm_count: int) -> int:
    """Number of kv splits for a (B, KVH) grid over a cache of S rows:
    about ``BLOCKS_PER_SM * sm_count`` blocks in all, each split a whole
    number of ``DECODE_SPLIT_TILE`` rows, and no split that starts past S.
    A function of the shapes and the card only: never of the lengths, whose
    reading would make the host wait on the device."""
    tiles = max(1, -(-S // DECODE_SPLIT_TILE))
    want = max(1, -(-BLOCKS_PER_SM * sm_count // max(1, B * KVH)))
    per_split = -(-tiles // min(want, tiles))
    return -(-tiles // per_split)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     n_splits: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Dh); cache (B, S, KVH, Dh); lengths (B,) int32 or int64
    -> (B, H, Dh). Committed mode: ``lengths`` counts the new token, whose
    K/V is already written. Append mode (``k_new``, ``v_new`` of shape
    (B, KVH, Dh)): the cache is read-only with ``lengths`` old tokens and
    the combine pass merges the new token (``ref.decode_attention_direct``).
    ``n_splits`` overrides ``plan_splits`` (chip_smoke.py sweeps it)."""
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
    if (k_new is None) != (v_new is None):
        raise ValueError("append mode takes both k_new and v_new")
    news = () if k_new is None else (("k_new", k_new), ("v_new", v_new))
    for name, t in news:
        if t.shape != (B, KVH, Dh):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"({B}, {KVH}, {Dh})")
    if lengths.dtype not in LENGTH_CODES:
        raise ValueError(f"lengths must be int32 or int64, got "
                         f"{lengths.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths), *news):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), *news):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    *news):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    if q.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"decode_attention kernel dtype {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(f"decode_attention kernel head_dim {Dh}; "
                                  f"supported: {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    if n_splits is None:
        n_splits = plan_splits(B, KVH, S, _sm_count(q.device.index))
    elif n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    # per (b, h, split): m, l, then o (Dh) — fp32 scratch of the two passes
    partials = torch.empty(B * H * n_splits * (Dh + 2), dtype=torch.float32,
                           device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), None if k_new is None else k_new.data_ptr(),
            None if v_new is None else v_new.data_ptr(), o.data_ptr(),
            partials.data_ptr(), B, S, H,
            KVH, Dh, DTYPE_CODES[q.dtype], LENGTH_CODES[lengths.dtype],
            n_splits, -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), Dh ** -0.5, stream)
    _build.check(err, "decode_attention launch")
    launches += 1
    return o
