"""The train step (port of ``repro/launch/steps.py::build_train_step``) on
one card: microbatched gradient accumulation, a global-norm clip and the
optimizer update. The reference's sharding rules have no counterpart here:
nothing is sharded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT


def value_and_grad(cfg: ModelConfig, model: T.Transformer, batch: dict, *,
                   n_micro: int = 1, grad_dtype=torch.float32,
                   impl: Optional[str] = None):
    """``loss_fn`` over ``batch`` and its gradient with respect to every
    parameter, as the reference's train step takes them: where ``n_micro``
    divides the batch, over ``n_micro`` microbatches of consecutive rows
    (of every batch entry: tokens, labels and a vision config's
    vision_embeds (B, Nv, D), as the reference's tree-mapped split),
    each microbatch's gradients divided by ``n_micro`` in their own dtype
    and summed in ``grad_dtype``, the loss summed the same way and each
    metric averaged; else over the whole batch, the gradients cast to
    ``grad_dtype``. Turns the parameters' gradients on. Returns (loss,
    metrics, grads {name: tensor})."""
    params = dict(model.named_parameters())
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    B = batch["tokens"].shape[0]
    nm = n_micro if B % n_micro == 0 and B >= n_micro else 1

    def one(mb):
        loss, metrics = T.loss_fn(cfg, model, mb, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if nm == 1:
        loss, metrics, gs = one(batch)
        return loss, metrics, {k: g.to(grad_dtype)
                               for k, g in zip(params, gs)}
    acc = {k: torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
           for k, p in params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    per_micro = []
    for i in range(nm):
        mb = {k: v.reshape((nm, B // nm) + v.shape[1:])[i]
              for k, v in batch.items()}
        loss, metrics, gs = one(mb)
        for k, g in zip(params, gs):
            acc[k] += (g / nm).to(grad_dtype)
        del gs
        loss_acc = loss_acc + loss / nm
        per_micro.append(metrics)
    metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
               for k in per_micro[0]}
    return loss_acc, metrics, acc


def build_train_step(cfg: ModelConfig, n_micro: int = 4,
                     grad_dtype=torch.float32):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``: the
    learning rate ``lr_schedule(count + 1)``, the gradients of
    ``value_and_grad``, their global norm in fp32 and a clip to norm 1,
    then ``cfg.optimizer``'s update, which writes the model's parameters
    in place. ``metrics`` holds 0-dim tensors on the device (nothing waits
    on the host): loss, grad_norm, lr, ce, z, lb_loss and z_loss.

    ``grad_dtype=torch.bfloat16`` halves the accumulators (the
    reference's lever; the update still runs in fp32)."""
    kind = cfg.optimizer

    def train_step(model: T.Transformer, opt_state: dict, batch: dict):
        lr = OPT.lr_schedule(opt_state["count"] + 1)
        loss, metrics, grads = value_and_grad(
            cfg, model, batch, n_micro=n_micro, grad_dtype=grad_dtype)
        gsq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        gnorm = torch.sqrt(gsq)
        clip = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(clip.to(g.dtype))
        opt_state = OPT.update(dict(model.named_parameters()), grads,
                               opt_state, kind, lr)
        return opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    return train_step
