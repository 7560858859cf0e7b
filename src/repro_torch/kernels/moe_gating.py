"""Wrapper of the CUDA MoE top-k gating kernel (``csrc/moe_gating.cu``), the
port of ``repro/kernels/moe_gating.py::moe_gating_topk``.

Takes CUDA tensors only; ``ops.moe_gating`` sends CPU tensors to the plain
version (``ref.topk_gating``). ``launches`` counts the kernel's launches and
nothing else.
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 8            # csrc MAX_K
MAX_EXPERTS = 384    # 32 lanes x csrc MAX_NV values

launches = 0


def moe_gating_topk(logits: torch.Tensor, top_k: int):
    """logits: (T, E) fp32 -> (weights (T, k) fp32, ids (T, k) int32)."""
    global launches
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if not logits.is_cuda:
        raise ValueError("logits must be a CUDA tensor")
    if logits.dtype != torch.float32:
        raise ValueError(f"logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if not 1 <= E <= MAX_EXPERTS:
        raise NotImplementedError(f"moe_gating kernel takes 1..{MAX_EXPERTS} "
                                  f"experts, got {E}")
    if not 1 <= top_k <= min(MAX_K, E):
        raise NotImplementedError(f"moe_gating kernel takes 1 <= k <= "
                                  f"min({MAX_K}, E={E}), got {top_k}")
    w = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, ids
    lib = _build.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.repro_moe_gating(logits.data_ptr(), w.data_ptr(),
                                   ids.data_ptr(), T, E, top_k, stream)
    _build.check(err, "moe_gating launch")
    launches += 1
    return w, ids
