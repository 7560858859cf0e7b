"""Wrapper of the CUDA MoE routing kernel (``csrc/moe_gating.cu``), the port
of ``repro/kernels/moe_gating.py::moe_gating_topk`` together with what the
MoE layer computes from its output before the dispatch gather.

``moe_route`` launches it once for the gating, the GShard dispatch maps and
the aux losses of one MoE layer call; ``moe_gating`` (and ``moe_gating_topk``,
its weights and ids) launches it with the maps compiled out. Takes CUDA
tensors only; ``ops`` sends CPU tensors to the plain versions
(``ref.moe_route``, ``ref.topk_gating``). ``launches`` counts the kernel's
launches and nothing else.
"""
from __future__ import annotations

import functools

import torch

from . import _build

MAX_K = 8              # csrc MAX_K
MAX_EXPERTS = 384      # 32 lanes x csrc MAX_NV values
MAX_CTAS = 8           # csrc MAX_CTAS: the portable cluster size
MAX_CTA_ENTRIES = 8192  # csrc MAX_CTA_ENTRIES: a CTA's t * k + j entries
CTA_ROWS = 128         # tokens a CTA aims for: 32 warps x 4 rows

launches = 0


def plan_route(Tb: int, K: int, E: int) -> int:
    """CTAs in the cluster of one dispatch block of Tb tokens: about
    ``CTA_ROWS`` tokens each, at most ``MAX_CTAS``, and no more entries a
    CTA than its shared memory holds. A function of the shapes only, never
    of the data. Raises where even ``MAX_CTAS`` CTAs cannot hold the block
    (Tb * K > 65,536)."""
    if not 1 <= E <= MAX_EXPERTS or not 1 <= K <= min(MAX_K, E):
        raise NotImplementedError(
            f"the routing kernel takes E <= {MAX_EXPERTS} and 1 <= k <= "
            f"min({MAX_K}, E), got E={E}, k={K}")
    ctas = min(MAX_CTAS, max(1, -(-Tb // CTA_ROWS)))
    while -(-Tb // ctas) * K > MAX_CTA_ENTRIES:
        if ctas == MAX_CTAS:
            raise NotImplementedError(
                f"the routing kernel takes Tb * k <= "
                f"{MAX_CTAS * MAX_CTA_ENTRIES} entries a block, got "
                f"Tb={Tb}, k={K}")
        ctas += 1
    return ctas


@functools.cache
def _ticket(device: torch.device) -> torch.Tensor:
    """The kernel's last-block ticket: zeroed once, reset by every launch.
    Launches on one device must not run concurrently (one stream)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _check_logits(logits: torch.Tensor, top_k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    if not logits.is_cuda:
        raise ValueError("logits must be a CUDA tensor")
    if logits.dtype != torch.float32:
        raise ValueError(f"logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    E = logits.shape[1]
    if not 1 <= E <= MAX_EXPERTS:
        raise NotImplementedError(f"the routing kernel takes 1..{MAX_EXPERTS}"
                                  f" experts, got {E}")
    if not 1 <= top_k <= min(MAX_K, E):
        raise NotImplementedError(f"the routing kernel takes 1 <= k <= "
                                  f"min({MAX_K}, E={E}), got {top_k}")


def _launch(logits, top_k, maps, groups, ctas, cap):
    global launches
    T, E = logits.shape
    dev = logits.device
    w = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    ids = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    aux = torch.empty(2, dtype=torch.float32, device=dev)
    ptrs = [m.data_ptr() for m in maps] if maps else [None] * 3
    partial = ticket = None     # several blocks: their sums, and the ticket
    if groups > 1:
        ticket = _ticket(dev)   # before the scratch, which must outlive it
        partial = torch.empty(groups * (2 * E + 1), dtype=torch.float32,
                              device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_moe_route(logits.data_ptr(), w.data_ptr(),
                                  ids.data_ptr(), *ptrs, aux.data_ptr(),
                                  *[None if t is None else t.data_ptr()
                                    for t in (partial, ticket)],
                                  T, E, top_k, groups, ctas, cap, stream)
    _build.check(err, "moe_route launch")
    launches += 1
    return w, ids, {"lb_loss": aux[0], "z_loss": aux[1]}


def moe_route(logits: torch.Tensor, top_k: int, cap: int, nb: int):
    """One launch: logits (T, E) fp32 -> (weights (T, k) fp32, ids (T, k)
    int32, slot_of (nb, T/nb, k), token_of_slot (nb, E*cap+1), tk_of_slot
    (nb, E*cap+1), all int64 with each block's values local to it, and aux
    {"lb_loss", "z_loss"} over all T), equal to ``ref.moe_route``."""
    _check_logits(logits, top_k)
    T, E = logits.shape
    if nb < 1 or T % nb:
        raise ValueError(f"T={T} is not a whole number of {nb} blocks")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    Tb = T // nb
    ctas = plan_route(Tb, top_k, E)
    dev = logits.device
    slot_of = torch.empty((nb, Tb, top_k), dtype=torch.int64, device=dev)
    token_of_slot = torch.empty((nb, E * cap + 1), dtype=torch.int64,
                                device=dev)
    tk_of_slot = torch.empty_like(token_of_slot)
    w, ids, aux = _launch(logits, top_k, (slot_of, token_of_slot,
                                          tk_of_slot), nb, ctas, cap)
    return w, ids, slot_of, token_of_slot, tk_of_slot, aux


def moe_gating(logits: torch.Tensor, top_k: int):
    """One launch without the maps: logits (T, E) fp32 -> (weights (T, k)
    fp32, ids (T, k) int32, aux {"lb_loss", "z_loss"})."""
    _check_logits(logits, top_k)
    T = logits.shape[0]
    if T == 0:
        raise ValueError("logits has no rows")
    ctas = min(MAX_CTAS, -(-T // CTA_ROWS))
    return _launch(logits, top_k, None, -(-T // (ctas * CTA_ROWS)), ctas, 0)


def moe_gating_topk(logits: torch.Tensor, top_k: int):
    """logits: (T, E) fp32 -> (weights (T, k) fp32, ids (T, k) int32)."""
    return moe_gating(logits, top_k)[:2]
