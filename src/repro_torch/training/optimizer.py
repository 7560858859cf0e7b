"""Optimizers: AdamW and Adafactor (factored second moment), port of
``repro/training/optimizer.py``.

    state = init(params, kind)
    state = update(params, grads, state, kind, lr, ...)   # params IN PLACE
    lr    = lr_schedule(step)

``params`` and ``grads`` are dicts of tensors keyed by the model's parameter
names (``dict(model.named_parameters())``). The state keeps the reference's
layout with those names as keys: AdamW ``{"m": {name: t}, "v": {name: t},
"count"}``, Adafactor ``{"fac": {name: {"vr", "vc"} | {"v"}}, "count"}``,
moments fp32, ``count`` int32. Where JAX returns new arrays, ``update``
writes the parameters and the moments in place (the reference donates
them), so a step holds no second copy of either; the arithmetic is the
reference's, in fp32, each parameter rounded to its dtype at the end.
``state_to_tree`` / ``state_from_tree`` convert the state to and from the
JAX structure, in which the checkpoint stores it.

On a mesh (ZeRO-1, the reference's ``opt_rules``: ``model_d`` over the data
axes) ``init(..., shapes=)`` gives each card only its slice of ``m`` and
``v``, and ``update(..., zero=)`` updates that slice of each parameter
(``ZeroLeaf.index`` of the card's parameter shard) and all-gathers the
parameter over "data". Under ``fsdp`` a parameter and its moments share one
spec: the whole local shard is updated and nothing is gathered.
``state_to_tree`` / ``state_from_tree`` with ``specs`` and ``layout`` give
and take whole leaves. AdamW is what the dense configs use; a sharded
Adafactor comes with Jamba and kimi-k2 on a mesh (ROADMAP A9c item 1) and
raises until then.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.tree import keystr, name_of, named, nest, path_of

ADAFACTOR_ON_A_MESH = ("a sharded Adafactor (Jamba and kimi-k2 on a mesh) "
                       "is ROADMAP A9c item 1 (expert parallelism)")

Params = dict


@dataclasses.dataclass(frozen=True)
class ZeroLeaf:
    """Where a card's moments of one parameter sit in its shard of it:
    ``index`` (slices of the parameter's local shard), and the dim and spec
    entry over which the updated slice is all-gathered (None: the slice is
    the whole shard)."""

    index: tuple
    dim: Optional[int]
    entry: Any
    layout: Any


def init(params: Params, kind: str,
         shapes: Optional[dict] = None) -> dict:
    """Zeroed state of ``kind`` for ``params``; ``shapes`` ({name: shape})
    gives AdamW moments other shapes than the parameters' (a card's ZeRO-1
    slices)."""
    dev = next(iter(params.values())).device
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if kind == "adamw":
        shp = {k: (shapes or {}).get(k, p.shape) for k, p in params.items()}
        return {"m": {k: zeros(shp[k]) for k in params},
                "v": {k: zeros(shp[k]) for k in params},
                "count": count}
    if shapes is not None:
        raise NotImplementedError(ADAFACTOR_ON_A_MESH)
    if kind == "adafactor":
        fac = {}
        for k, p in params.items():
            if p.dim() >= 2:
                fac[k] = {"vr": zeros(p.shape[:-1]),
                          "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            else:
                fac[k] = {"v": zeros(p.shape)}
        return {"fac": fac, "count": count}
    raise ValueError(kind)


def _adamw_update(p, g, m, v, lr, b1, b2, eps, wd, count):
    gf = g.float()
    m.mul_(b1).add_((1 - b1) * gf)
    v.mul_(b2).add_((1 - b2) * gf * gf)
    c = count.float()
    mhat = m / (1 - b1 ** c)
    vhat = v / (1 - b2 ** c)
    upd = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
    p.copy_(p.float() - lr * upd)


def _adafactor_update(p, g, st, lr, decay):
    gf = g.float()
    g2 = gf * gf + 1e-30
    if p.dim() >= 2:
        st["vr"].mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
        st["vc"].mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
        vr, vc = st["vr"], st["vc"]
        denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
                 )[..., None] * vc[..., None, :]
        upd = gf * torch.rsqrt(torch.clamp(denom, min=1e-30))
    else:
        st["v"].mul_(decay).add_((1 - decay) * g2)
        upd = gf * torch.rsqrt(torch.clamp(st["v"], min=1e-30))
    # update clipping (RMS <= 1)
    rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
    upd = upd / torch.clamp(rms, min=1.0)
    p.copy_(p.float() - lr * upd)


@torch.no_grad()
def update(params: Params, grads: Params, state: dict, kind: str, lr, *,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.0, fac_decay: float = 0.99,
           zero: Optional[dict] = None) -> dict:
    """One step at learning rate ``lr`` (a number or a 0-dim tensor).
    Writes ``params`` and the moments in place; returns the state with
    ``count`` advanced. ``zero`` ({name: ``ZeroLeaf``}, a mesh's): each
    card updates its moments' slice of each parameter shard and
    all-gathers it."""
    count = state["count"] + 1
    if zero is not None and kind != "adamw":
        raise NotImplementedError(ADAFACTOR_ON_A_MESH)
    if kind == "adamw":
        for k, p in params.items():
            z = zero.get(k) if zero is not None else None
            if z is None:
                _adamw_update(p, grads[k], state["m"][k], state["v"][k], lr,
                              b1, b2, eps, weight_decay, count)
                continue
            part = p[z.index]                    # a view: written in place
            _adamw_update(part, grads[k][z.index], state["m"][k],
                          state["v"][k], lr, b1, b2, eps, weight_decay, count)
            if z.dim is not None:
                p.copy_(SH.all_gather(part.contiguous(), z.layout, z.entry,
                                      z.dim))
        return {"m": state["m"], "v": state["v"], "count": count}
    if kind == "adafactor":
        for k, p in params.items():
            _adafactor_update(p, grads[k], state["fac"][k], lr, fac_decay)
        return {"fac": state["fac"], "count": count}
    raise ValueError(kind)


def state_axes(params: Params, param_axes: dict, kind: str) -> dict:
    """Logical axes of ``init``'s state (the reference's ``state_axes``, in
    this module's layout): ``param_axes`` maps each parameter name to its
    axes; Adafactor's row and column moments drop the last and the
    second-to-last axis."""
    if kind == "adamw":
        return {"m": dict(param_axes), "v": dict(param_axes), "count": ()}
    if kind == "adafactor":
        fac = {}
        for k, p in params.items():
            a = param_axes[k]
            fac[k] = ({"vr": tuple(a[:-1]), "vc": tuple(a[:-2]) + (a[-1],)}
                      if p.dim() >= 2 else {"v": tuple(a)})
        return {"fac": fac, "count": ()}
    raise ValueError(kind)


def lr_schedule(step, *, peak: float = 3e-4, warmup: int = 100,
                total: int = 10_000, floor: float = 3e-5) -> torch.Tensor:
    """Linear warm-up to ``peak``, then a cosine down to ``floor`` at
    ``total``; fp32, on ``step``'s device when it is a tensor."""
    stepf = torch.as_tensor(step).float()
    warm = peak * torch.clamp(stepf / warmup, max=1.0)
    frac = torch.clamp((stepf - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return torch.where(stepf < warmup, warm, cos)


# ---------------------------------------------------------------------------
# The JAX structure (checkpoints)
# ---------------------------------------------------------------------------
def state_to_tree(state: dict, kind: str, specs: Optional[dict] = None,
                  layout=None) -> dict:
    """The reference's optimizer-state pytree: AdamW moments nested as the
    params are, Adafactor's ``fac`` keyed by the params' keystrs. With
    ``specs`` (the state's spec tree in this module's layout, e.g.
    ``build_cell``'s) and ``layout`` (this card's), every card's moments
    gathered into whole leaves (a collective: every card calls it)."""
    if specs is not None and kind != "adamw":
        raise NotImplementedError(ADAFACTOR_ON_A_MESH)
    if specs is not None:
        state = {**state, **{k: {n: SH.gather_whole(t, layout, specs[k][n])
                                 for n, t in state[k].items()}
                             for k in ("m", "v")}}
    if kind == "adamw":
        return {"m": nest(state["m"]), "v": nest(state["v"]),
                "count": state["count"]}
    if kind == "adafactor":
        return {"fac": {keystr(path_of(k)): st
                        for k, st in state["fac"].items()},
                "count": state["count"]}
    raise ValueError(kind)


def state_from_tree(tree: dict, kind: str, specs: Optional[dict] = None,
                    layout=None) -> dict:
    """The inverse of ``state_to_tree``: with ``specs`` and ``layout`` it
    takes whole leaves and keeps this card's slice of each."""
    if kind == "adamw":
        state = {"m": named(tree["m"]), "v": named(tree["v"]),
                 "count": tree["count"]}
        if specs is not None:
            for k in ("m", "v"):
                state[k] = {n: SH.local_shard(t, layout, specs[k][n],
                                             layout.coords).contiguous()
                            for n, t in state[k].items()}
        return state
    if kind == "adafactor":
        return {"fac": {name_of(ks): st for ks, st in tree["fac"].items()},
                "count": tree["count"]}
    raise ValueError(kind)
