"""The steps of a cell on one card (port of ``repro/launch/steps.py``): the
train step (microbatched gradient accumulation, a global-norm clip and the
optimizer update), the prefill and decode steps, their abstract inputs and
the perf-lever variants, assembled by ``build_cell``.

The reference's sharding rules (``rules_for``, ``opt_rules``,
``shardings_of``, ``batch_axes``) have no counterpart: nothing is sharded
on one card, so ``build_cell`` returns no shardings, and the variants that
only change sharding rules raise. ``lower_cell`` has none either: eager
PyTorch lowers nothing; the cell's step runs as it is called.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT

# variants whose only effect in the reference is a sharding rule (expert
# and data axes, sequence parallelism, FSDP): they need a mesh of cards
SHARDING_VARIANTS = ("seqpar", "expdata", "fsdp")
MULTI_CARD = ("the multi-card slice of ROADMAP A9 (launch/mesh.py, "
              "distributed/sharding.py)")


def variant_tokens(variant: str) -> set[str]:
    return {t for t in variant.split("+") if t and t != "baseline"}


def apply_variant_config(cfg: ModelConfig, variant: str) -> ModelConfig:
    """The perf-lever variants that alter the model config, as the
    reference's: ``vocabpad`` pads the vocabulary to a multiple of 128,
    ``blockdispatch`` routes MoE tokens in 32 dispatch blocks. ``micro8``
    and ``bf16grad`` choose the train step's ``n_micro`` and
    ``grad_dtype``, ``cacheappend`` the decode step's append mode (all in
    ``build_cell``). The reference's ``decodefast`` (single-step recurrent
    updates at decode instead of its padded chunk machinery) has no
    counterpart: the port's scans always take their one-step path at T = 1
    (the kernels' walk, the plain path's single step), so there is nothing
    to switch, and it raises as an unknown token does. The sharding-only
    variants raise ``NotImplementedError``."""
    toks = variant_tokens(variant)
    sharding = sorted(toks & set(SHARDING_VARIANTS))
    if sharding:
        raise NotImplementedError(
            f"variant {'+'.join(sharding)} only changes sharding rules, which "
            f"need more than one card: {MULTI_CARD}")
    unknown = toks - {"vocabpad", "blockdispatch", "micro8", "bf16grad",
                      "cacheappend"}
    if unknown:
        raise ValueError(f"unknown variant tokens {sorted(unknown)}")
    if "vocabpad" in toks:
        cfg = dataclasses.replace(cfg, vocab_pad_to=128)
    if "blockdispatch" in toks:
        cfg = dataclasses.replace(cfg, moe_block_dispatch=32)
    return cfg


def abstract_batch(cfg: ModelConfig, case: ShapeCase) -> dict:
    """The case's batch on the meta device: tokens (B, S), or (B, S, C)
    with codebooks, int32; labels alike for train; a vision config's
    vision_embeds (B, Nv, D) in the model dtype for train and prefill."""
    B, S = case.global_batch, case.seq_len
    shp = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": torch.empty(shp, dtype=torch.int32, device="meta")}
    if case.kind == "train":
        batch["labels"] = torch.empty(shp, dtype=torch.int32, device="meta")
    if cfg.n_vision_tokens and case.kind in ("train", "prefill"):
        batch["vision_embeds"] = torch.empty(
            (B, cfg.n_vision_tokens, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device="meta")
    return batch


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
                     grad_dtype=torch.float32, impl: Optional[str] = None):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``: the
    learning rate ``lr_schedule(count + 1)``, the gradients of
    ``value_and_grad``, their global norm in fp32 and a clip to norm 1,
    then ``cfg.optimizer``'s update, which writes the model's parameters
    in place. ``metrics`` holds 0-dim tensors on the device (nothing waits
    on the host): loss, grad_norm, lr, ce, z, lb_loss and z_loss.

    ``grad_dtype=torch.bfloat16`` halves the accumulators (the
    reference's lever; the update still runs in fp32). ``impl`` goes to
    every kernel call (``"plain"``: the plain versions)."""
    kind = cfg.optimizer

    def train_step(model: T.Transformer, opt_state: dict, batch: dict):
        lr = OPT.lr_schedule(opt_state["count"] + 1)
        loss, metrics, grads = value_and_grad(
            cfg, model, batch, n_micro=n_micro, grad_dtype=grad_dtype,
            impl=impl)
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


def build_prefill_step(cfg: ModelConfig, impl: Optional[str] = None):
    """``prefill_step(model, batch) -> (logits, cache)``:
    ``Transformer.prefill`` over batch["tokens"] (and a vision config's
    batch["vision_embeds"])."""
    def prefill_step(model: T.Transformer, batch: dict):
        return model.prefill(batch["tokens"].long(),
                             vision_embeds=batch.get("vision_embeds"),
                             impl=impl)
    return prefill_step


def build_decode_step(cfg: ModelConfig, append: bool = False,
                      impl: Optional[str] = None):
    """``serve_step(model, cache, tokens, lengths) -> (logits, cache)``:
    ``Transformer.decode_step``, which writes the cache in place (the
    reference donates it); ``append`` is its append mode (the engine's)."""
    def serve_step(model: T.Transformer, cache: dict, tokens: torch.Tensor,
                   lengths: torch.Tensor):
        return model.decode_step(cache, tokens, lengths, append=append,
                                 impl=impl)
    return serve_step


def build_cell(cfg: ModelConfig, case: ShapeCase, device="cuda",
               variant: str = "baseline", impl: Optional[str] = None):
    """Returns (fn, kwargs, donate) for ``case`` on one card. ``kwargs``
    holds the step's abstract inputs on the meta device, named as the
    reference names them: {"params", "opt_state", "batch"} for train,
    {"params", "batch"} for prefill, {"params", "cache", "tokens",
    "lengths"} for decode, in ``fn``'s argument order. "params" is a
    ``Transformer`` on the meta device (``T.param_tree`` gives the
    reference's params structure); the rest are tensors and trees of them.
    ``donate`` names the inputs the step writes in place. The reference's
    in / out shardings and rules have no counterpart on one card, so none
    are returned. ``device`` is checked (``T.resolve_device``: CUDA unless
    the caller asks for the CPU) but allocates nothing: the caller builds
    the real inputs there (``launch/dryrun.py``)."""
    if torch.device(device).type != "meta":
        T.resolve_device(device)
    cfg = apply_variant_config(cfg, variant)
    toks = variant_tokens(variant)
    model = T.Transformer(cfg, device="meta")
    if case.kind == "train":
        fn = build_train_step(
            cfg, n_micro=8 if "micro8" in toks else 4,
            grad_dtype=torch.bfloat16 if "bf16grad" in toks
            else torch.float32, impl=impl)
        opt_state = OPT.init(dict(model.named_parameters()), cfg.optimizer)
        kwargs = {"params": model, "opt_state": opt_state,
                  "batch": abstract_batch(cfg, case)}
        return fn, kwargs, ("params", "opt_state")
    if case.kind == "prefill":
        kwargs = {"params": model, "batch": abstract_batch(cfg, case)}
        return build_prefill_step(cfg, impl=impl), kwargs, ()
    B, S = case.global_batch, case.seq_len
    tok_shape = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    kwargs = {"params": model,
              "cache": T.init_cache(cfg, B, S, device="meta"),
              "tokens": torch.empty(tok_shape, dtype=torch.int32,
                                    device="meta"),
              "lengths": torch.empty((B,), dtype=torch.int32,
                                     device="meta")}
    fn = build_decode_step(cfg, append="cacheappend" in toks, impl=impl)
    return fn, kwargs, ("cache",)
