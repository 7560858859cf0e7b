"""Wrapper of the CUDA WKV6 kernels (``csrc/rwkv6_scan.cu``), the port of
``repro/kernels/rwkv6_scan.py::rwkv6_scan``.

Takes CUDA tensors only; ``ops.rwkv6_scan`` sends CPU tensors to the plain
versions (``ref.rwkv6_single_step`` / ``ref.rwkv6_chunked``;
``ref.rwkv6_chunk_parallel`` mirrors the kernels' three passes). Where T is
at most the chunk size one call launches the single pass, else the chunk
states, the carry and the outputs; ``launches`` counts calls, not device
kernels, and nothing else.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPE_CODES

HEAD_DIMS = (16, 32, 64)     # csrc launch_k
CHUNKS = (16, 32, 64)        # chunk sizes plan_chunks chooses from
BLOCKS_PER_SM = 2            # walk blocks plan_chunks aims for, per SM

launches = 0


def plan_chunks(B: int, T: int, H: int, sm_count: int) -> int:
    """Steps per chunk: the largest of ``CHUNKS`` whose B * H * ceil(T / c)
    walk blocks still give ``BLOCKS_PER_SM`` per SM, else the smallest. A
    function of the shapes and the card only (no data, no host sync). Where
    T <= c the call is the single pass."""
    for c in sorted(CHUNKS, reverse=True):
        if B * H * -(-T // c) >= BLOCKS_PER_SM * sm_count:
            return c
    return min(CHUNKS)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               state_out: Optional[torch.Tensor] = None,
               chunk: Optional[int] = None):
    """r/k/v (B, T, H, K) fp32 or bf16, w (B, T, H, K) fp32, u (H, K) fp32,
    state (B, H, K, K) fp32 -> (out (B, T, H, K) in v's dtype, final state
    (B, H, K, K) fp32). K == V, nothing is cast on entry.

    ``state_out``: a tensor like ``state`` that the final state is written
    into (and returned); it may be ``state`` itself.
    ``chunk`` overrides ``plan_chunks`` (chip_smoke.py sweeps it)."""
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
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % 16:
            raise NotImplementedError(f"rwkv6_scan kernel: {name} is not "
                                      "16-byte aligned")
    if K not in HEAD_DIMS:
        raise NotImplementedError(f"rwkv6_scan kernel head dim {K}; "
                                  f"supported: {HEAD_DIMS}")
    if chunk is None:
        chunk = plan_chunks(B, T, H, _sm_count(r.device.index or 0))
    elif chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    single = T <= chunk
    if state_out is None:
        s_out = torch.empty_like(state)
    elif (not state_out.is_cuda or state_out.device != r.device
            or state_out.shape != state.shape
            or state_out.dtype != torch.float32
            or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous float32 CUDA tensor "
                         f"of shape {tuple(state.shape)} on {r.device}")
    else:
        s_out = state_out
    out = torch.empty_like(v)
    n = -(-T // chunk)
    scratch = None if single else torch.empty(
        B * H * n * K * (K + 1), dtype=torch.float32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(), s_out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, T, H, K,
            chunk, DTYPE_CODES[r.dtype], stream)
    _build.check(err, "rwkv6_scan launch")
    launches += 1
    return out, s_out
