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
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import keystr, name_of, named, nest, path_of

Params = dict


def init(params: Params, kind: str) -> dict:
    dev = next(iter(params.values())).device
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if kind == "adamw":
        return {"m": {k: zeros(p.shape) for k, p in params.items()},
                "v": {k: zeros(p.shape) for k, p in params.items()},
                "count": count}
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
           weight_decay: float = 0.0, fac_decay: float = 0.99) -> dict:
    """One step at learning rate ``lr`` (a number or a 0-dim tensor).
    Writes ``params`` and the moments in place; returns the state with
    ``count`` advanced."""
    count = state["count"] + 1
    if kind == "adamw":
        for k, p in params.items():
            _adamw_update(p, grads[k], state["m"][k], state["v"][k], lr, b1,
                          b2, eps, weight_decay, count)
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
def state_to_tree(state: dict, kind: str) -> dict:
    """The reference's optimizer-state pytree: AdamW moments nested as the
    params are, Adafactor's ``fac`` keyed by the params' keystrs."""
    if kind == "adamw":
        return {"m": nest(state["m"]), "v": nest(state["v"]),
                "count": state["count"]}
    if kind == "adafactor":
        return {"fac": {keystr(path_of(k)): st
                        for k, st in state["fac"].items()},
                "count": state["count"]}
    raise ValueError(kind)


def state_from_tree(tree: dict, kind: str) -> dict:
    """The inverse of ``state_to_tree``."""
    if kind == "adamw":
        return {"m": named(tree["m"]), "v": named(tree["v"]),
                "count": tree["count"]}
    if kind == "adafactor":
        return {"fac": {name_of(ks): st for ks, st in tree["fac"].items()},
                "count": tree["count"]}
    raise ValueError(kind)
