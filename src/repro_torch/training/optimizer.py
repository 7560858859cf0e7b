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
spec: the whole local shard is updated and nothing is gathered. Where the
moments' slice is not inside the parameter's shard (an expert leaf: its
d_ff over "data" in the parameter, its D over "data" in the moments), the
gradient and the parameter are first gathered over the dims the moments
hold whole (``ZeroLeaf.pre``), and the updated slice is gathered back and
cut to the shard.

Adafactor on a mesh (``update(..., zero=)`` with a ``FactorLeaf`` a
parameter): the state is the card's slice of ``vr`` / ``vc`` / ``v`` under
``opt_rules``, and each of the reference's four statistics becomes an
all-reduce over the axes that shard its dim: the row mean of g² (over the
last dim), the column mean (over the second-last), the row normaliser
``vr.mean(-1)`` and the update's RMS over the whole stacked leaf. The
factored moments are small: a card gathers what its parameter shard needs
where its slice is smaller (``FactorLeaf.take``) and keeps its own slice of
the result. A leaf is worked through in pieces of whole rows
(``FACTOR_CHUNK`` elements), so the update makes no fp32 temporary of a
whole leaf. ``state_to_tree`` / ``state_from_tree`` with ``specs`` and
``layout`` give and take whole leaves of either optimizer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.tree import keystr, name_of, named, nest, path_of

Params = dict


@dataclasses.dataclass(frozen=True)
class ZeroLeaf:
    """Where a card's AdamW moments of one parameter sit in its shard of
    it: ``index`` (slices of the parameter's local shard, or of it gathered
    over ``pre``'s (dim, spec entry) pairs first), and the dim and spec
    entry over which the updated slice is all-gathered (None: the slice is
    the whole shard, or the whole gathered part), then cut by ``back`` to
    the shard."""

    index: tuple
    dim: Optional[int]
    entry: Any
    layout: Any
    pre: tuple = ()
    back: tuple = ()

    def calls(self) -> dict:
        """Its all-gathers a step: the gradient and the parameter over each
        ``pre`` dim, the updated slice over ``dim``."""
        n = 2 * len(self.pre) + (self.dim is not None)
        return {"all-gather": n} if n else {}


@dataclasses.dataclass(frozen=True)
class FactorLeaf:
    """A parameter's sharded Adafactor update: its global ``shape``, the
    spec of its shard ``pspec``, and per state leaf ("vr", "vc" or "v")
    how the card's slice (under ``opt_rules``) meets the values of the
    parameter's shard: ``gather`` (dim, spec entry) pairs over which the
    slice is all-gathered, then ``take`` slices of the result; ``put``
    slices of the shard's values that are the card's slice."""

    layout: Any
    shape: tuple
    pspec: tuple
    gather: dict
    take_index: dict
    put_index: dict

    def take(self, key: str, st: torch.Tensor) -> torch.Tensor:
        for d, entry in self.gather[key]:
            st = SH.all_gather(st.contiguous(), self.layout, entry, d)
        return st[self.take_index[key]]

    def put(self, key: str, st: torch.Tensor, new: torch.Tensor) -> None:
        st.copy_(new[self.put_index[key]])

    def live(self, entry) -> bool:
        return self.layout.size(entry) > 1

    def calls(self) -> dict:
        """Its collectives a step (the module docstring's statistics)."""
        p = self.pspec
        ar = any(self.live(e) for e in p)
        if len(self.shape) >= 2:
            ar += self.live(p[-1]) + 2 * self.live(p[-2])
        ag = sum(len(v) for v in self.gather.values())
        return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag))
                if v}


def init(params: Params, kind: str,
         shapes: Optional[dict] = None) -> dict:
    """Zeroed state of ``kind`` for ``params``; ``shapes`` gives the state
    other shapes than the parameters' (a card's slices on a mesh): {name:
    shape} of the AdamW moments, {name: {"vr": shape, "vc": shape} or
    {"v": shape}} of Adafactor's."""
    dev = next(iter(params.values())).device
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if kind == "adamw":
        shp = {k: (shapes or {}).get(k, p.shape) for k, p in params.items()}
        return {"m": {k: zeros(shp[k]) for k in params},
                "v": {k: zeros(shp[k]) for k in params},
                "count": count}
    if kind == "adafactor":
        fac = {}
        for k, p in params.items():
            if shapes is not None and k in shapes:
                fac[k] = {n: zeros(s) for n, s in shapes[k].items()}
            elif p.dim() >= 2:
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


# elements of a leaf that the sharded Adafactor holds in fp32 temporaries at
# a time (128 MB of each)
FACTOR_CHUNK = 1 << 25


def _chunks(P: int, R: int, C: int):
    """(slice over P, slice over R) pieces of a (P, R, C) view of at most
    ``FACTOR_CHUNK`` elements each (at least one row of C)."""
    if R * C <= FACTOR_CHUNK:
        step = max(1, FACTOR_CHUNK // (R * C))
        for i in range(0, P, step):
            yield slice(i, min(P, i + step)), slice(None)
        return
    step = max(1, FACTOR_CHUNK // C)
    for i in range(P):
        for j in range(0, R, step):
            yield slice(i, i + 1), slice(j, min(R, j + step))


def _adafactor_sharded(p, g, st, lr, decay, f: FactorLeaf):
    """``_adafactor_update`` of this card's shard ``p`` (the module
    docstring's mesh form): each statistic summed over the shard and
    all-reduced over the axes of its dim. A leaf of two or more dims is
    worked through in pieces of whole rows (``FACTOR_CHUNK`` elements), so
    no fp32 temporary of the whole leaf is made: the row and column sums
    of g² piece by piece, the update's sum of squares piece by piece (the
    update from g, the row factor and the column factor, never the whole
    denominator), then the clipped update recomputed and applied piece by
    piece. The gradient is read, never written."""
    lay, n, spec = f.layout, f.shape, f.pspec
    used = {a for e in spec for a in SH.entry_axes(e)}
    axes = tuple(a for a in lay.sizes if a in used)       # mesh order
    if p.dim() < 2:
        gf = g.float()
        v = decay * f.take("v", st["v"]) + (1 - decay) * (gf * gf + 1e-30)
        f.put("v", st["v"], v)
        upd = gf * torch.rsqrt(torch.clamp(v, min=1e-30))
        ssq = SH.all_reduce(torch.sum(upd * upd).reshape(1), lay, axes)
        rms = torch.sqrt(ssq[0] / math.prod(n) + 1e-30)
        upd = upd / torch.clamp(rms, min=1.0)
        p.copy_(p.float() - lr * upd)
        return
    R, C = p.shape[-2], p.shape[-1]
    P = p.numel() // (R * C)
    g3, p3 = g.reshape(P, R, C), p.view(P, R, C)
    pieces = list(_chunks(P, R, C))
    rows = torch.empty((P, R), dtype=torch.float32, device=p.device)
    cols = torch.zeros((P, C), dtype=torch.float32, device=p.device)
    for a, b in pieces:
        gf = g3[a, b].float()
        g2 = gf * gf + 1e-30
        rows[a, b] = g2.sum(dim=-1)
        cols[a] += g2.sum(dim=-2)
        del gf, g2
    r = SH.all_reduce(rows.view(p.shape[:-1]), lay, spec[-1]) / n[-1]
    c = SH.all_reduce(cols.view(p.shape[:-2] + (C,)), lay, spec[-2]) / n[-2]
    vr = decay * f.take("vr", st["vr"]) + (1 - decay) * r
    vc = decay * f.take("vc", st["vc"]) + (1 - decay) * c
    f.put("vr", st["vr"], vr)
    f.put("vc", st["vc"], vc)
    row = SH.all_reduce(vr.sum(dim=-1, keepdim=True), lay, spec[-2]) / n[-2]
    vr3 = (vr / torch.clamp(row, min=1e-30)).reshape(P, R)
    vc3 = vc.reshape(P, C)

    def update_of(a, b):
        denom = vr3[a, b][..., None] * vc3[a][:, None, :]
        return g3[a, b].float() * torch.rsqrt(denom.clamp_(min=1e-30))

    ssq = torch.zeros(1, dtype=torch.float32, device=p.device)
    for a, b in pieces:
        u = update_of(a, b)
        ssq += torch.sum(u * u)
        del u
    ssq = SH.all_reduce(ssq, lay, axes)
    clip = torch.clamp(torch.sqrt(ssq[0] / math.prod(n) + 1e-30), min=1.0)
    for a, b in pieces:
        u = update_of(a, b).div_(clip)
        p3[a, b] = p3[a, b].float() - lr * u
        del u


@torch.no_grad()
def update(params: Params, grads: Params, state: dict, kind: str, lr, *,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.0, fac_decay: float = 0.99,
           zero: Optional[dict] = None) -> dict:
    """One step at learning rate ``lr`` (a number or a 0-dim tensor).
    Writes ``params`` and the moments in place; returns the state with
    ``count`` advanced. ``zero`` (a mesh's: {name: ``ZeroLeaf``} for
    AdamW, each card updating its moments' slice of each parameter shard
    and all-gathering it; {name: ``FactorLeaf``} for Adafactor)."""
    count = state["count"] + 1
    if kind == "adamw":
        for k, p in params.items():
            z = zero.get(k) if zero is not None else None
            if z is None:
                _adamw_update(p, grads[k], state["m"][k], state["v"][k], lr,
                              b1, b2, eps, weight_decay, count)
                continue
            g, whole = grads[k], p
            for d, entry in z.pre:
                g = SH.all_gather(g.contiguous(), z.layout, entry, d)
                whole = SH.all_gather(whole.contiguous(), z.layout, entry, d)
            part = whole[z.index]                # a view: written in place
            _adamw_update(part, g[z.index], state["m"][k], state["v"][k],
                          lr, b1, b2, eps, weight_decay, count)
            if z.dim is not None:
                whole = SH.all_gather(part.contiguous(), z.layout, z.entry,
                                      z.dim)
            if whole is not p:
                p.copy_(whole[z.back] if z.back else whole)
        return {"m": state["m"], "v": state["v"], "count": count}
    if kind == "adafactor":
        for k, p in params.items():
            f = zero.get(k) if zero is not None else None
            if f is None:
                _adafactor_update(p, grads[k], state["fac"][k], lr,
                                  fac_decay)
            else:
                _adafactor_sharded(p, grads[k], state["fac"][k], lr,
                                   fac_decay, f)
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
    if specs is not None and kind == "adamw":
        state = {**state, **{k: {n: SH.gather_whole(t, layout, specs[k][n])
                                 for n, t in state[k].items()}
                             for k in ("m", "v")}}
    elif specs is not None:
        state = {**state, "fac": {
            n: {k: SH.gather_whole(t, layout, specs["fac"][n][k])
                for k, t in st.items()}
            for n, st in state["fac"].items()}}
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
        fac = {name_of(ks): st for ks, st in tree["fac"].items()}
        if specs is not None:
            fac = {n: {k: SH.local_shard(t, layout, specs["fac"][n][k],
                                         layout.coords).contiguous()
                       for k, t in st.items()} for n, st in fac.items()}
        return {"fac": fac, "count": tree["count"]}
    raise ValueError(kind)
