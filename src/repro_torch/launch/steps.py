"""The steps of a cell (port of ``repro/launch/steps.py``): the train step
(microbatched gradient accumulation, a global-norm clip and the optimizer
update), the prefill and decode steps, their abstract inputs and the
perf-lever variants, assembled by ``build_cell``.

The baseline sharding policy is the reference's (``rules_for``,
``opt_rules``, ``shardings_of``, ``batch_axes``, with the specs of
``distributed/sharding.py``): train and prefill shard the batch over the
data axes and heads / d_ff / vocab over "model"; decode adds the cache
policy, by kv heads where they divide the model axis, else by sequence over
"model", and by sequence over every axis at global_batch 1 (long_500k).
On a mesh ``build_cell`` also returns the rules and the in / out spec
trees. The port runs the prefill and decode steps on a mesh; a sharded
train step, and the variants that only change sharding rules (``seqpar``,
``expdata``, ``fsdp``), raise ``NotImplementedError`` (ROADMAP A9c).
``lower_cell`` has no counterpart: eager PyTorch lowers nothing; the
cell's step runs as it is called.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT

# variants whose only effect in the reference is a sharding rule (expert
# and data axes, sequence parallelism, FSDP)
SHARDING_VARIANTS = ("seqpar", "expdata", "fsdp")
MULTI_CARD = ("the multi-card slice of ROADMAP A9c (the sharded train "
              "step, expert parallelism, sequence parallelism)")


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
            f"variant {'+'.join(sharding)} only changes sharding rules, "
            f"which the port does not run yet: {MULTI_CARD}")
    unknown = toks - {"vocabpad", "blockdispatch", "micro8", "bf16grad",
                      "cacheappend"}
    if unknown:
        raise ValueError(f"unknown variant tokens {sorted(unknown)}")
    if "vocabpad" in toks:
        cfg = dataclasses.replace(cfg, vocab_pad_to=128)
    if "blockdispatch" in toks:
        cfg = dataclasses.replace(cfg, moe_block_dispatch=32)
    return cfg


# ===========================================================================
# Rules and spec trees
# ===========================================================================
def rules_for(cfg: ModelConfig, case: ShapeCase, mesh,
              variant: str = "baseline") -> SH.ShardingRules:
    """The reference's ``rules_for``: the default rules, the decode cache
    policy, and the sharding variants' overrides. ``mesh`` is a
    ``DeviceMesh``, a ``sharding.Layout`` or anything with a ``.shape``
    mapping; only its axis sizes are read."""
    rules = SH.ShardingRules()
    toks = variant_tokens(variant)
    mp = SH.axis_sizes(mesh).get("model", 1)
    if case.kind == "decode":
        if case.global_batch == 1:
            # single-request long-context: flash-decoding across all axes
            rules = rules.with_overrides(
                kv_seq=("pod", "data", "model"), kv_heads=())
        elif cfg.n_kv_heads % mp != 0:
            rules = rules.with_overrides(kv_seq=("model",), kv_heads=())
    if "seqpar" in toks:
        # Megatron-style sequence parallelism on the residual stream
        rules = rules.with_overrides(seq=("model",))
    if "expdata" in toks:
        # experts sharded over data axes as well (wider EP at decode)
        rules = rules.with_overrides(experts=("data", "model"),
                                     expert_ff=("pod",))
    if "fsdp" in toks:
        # weight-stationary compute: every weight's model_d dim sharded
        # over data
        rules = rules.with_overrides(model_d=("pod", "data"), expert_ff=())
    return rules


def opt_rules(rules: SH.ShardingRules) -> SH.ShardingRules:
    """ZeRO-1-style optimizer-state sharding: moments spread over data axes."""
    return rules.with_overrides(model_d=("pod", "data"))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in v)


def shardings_of(mesh, axes_tree, shapes_tree, rules) -> object:
    """The spec of every leaf: ``axes_tree``'s logical axes (tuples of names)
    resolved on ``mesh`` under ``rules`` against the matching leaf of
    ``shapes_tree`` (tensors, e.g. on the meta device, or shapes)."""
    if _is_axes(axes_tree):
        shape = tuple(getattr(shapes_tree, "shape", shapes_tree))
        return SH.logical_to_spec(mesh, axes_tree, shape, rules)
    if isinstance(axes_tree, dict):
        return {k: shardings_of(mesh, axes_tree[k], shapes_tree[k], rules)
                for k in axes_tree}
    return tuple(shardings_of(mesh, a, x, rules)
                 for a, x in zip(axes_tree, shapes_tree))


def batch_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of the batch (the reference's ``batch_axes``)."""
    tok = ("batch", "seq", None) if cfg.n_codebooks else ("batch", "seq")
    ax = {"tokens": tok}
    if kind == "train":
        ax["labels"] = tok
    if cfg.n_vision_tokens and kind in ("train", "prefill"):
        ax["vision_embeds"] = ("batch", None, None)
    return ax


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
               variant: str = "baseline", impl: Optional[str] = None,
               mesh=None, rules: Optional[SH.ShardingRules] = None):
    """Returns (fn, kwargs, donate) for ``case`` on one card. ``kwargs``
    holds the step's abstract inputs on the meta device, named as the
    reference names them: {"params", "opt_state", "batch"} for train,
    {"params", "batch"} for prefill, {"params", "cache", "tokens",
    "lengths"} for decode, in ``fn``'s argument order. "params" is a
    ``Transformer`` on the meta device (``T.param_tree`` gives the
    reference's params structure); the rest are tensors and trees of them.
    ``donate`` names the inputs the step writes in place. ``device`` is
    checked (``T.resolve_device``: CUDA unless the caller asks for the CPU)
    but allocates nothing: the caller builds the real inputs there
    (``launch/dryrun.py``).

    With ``mesh`` (a ``DeviceMesh``, or a ``sharding.Layout`` for a rank
    without a process group) it returns (fn, kwargs, donate, rules,
    in_specs, out_specs), as the reference's: "params" is this card's
    shard on the meta device (``T.Transformer(..., mesh=, rules=)``), the
    cache its ``ShardedCache``, tokens and lengths global; the spec trees
    follow ``param_axes`` / ``cache_axes`` / ``batch_axes`` (the optimizer
    state's under ``opt_rules``), in_specs keyed as ``kwargs`` and
    out_specs (params, opt_state, None) for train, None for prefill,
    (None, cache) for decode. The train step raises on a mesh (ROADMAP
    A9c); configs whose layers the port does not run on a mesh raise when
    their model is built (``T.check_shardable``). ``rules`` replaces
    ``rules_for``'s (a cell whose batch was cut keeps its case's)."""
    if torch.device(device).type != "meta":
        T.resolve_device(device)
    cfg = apply_variant_config(cfg, variant)
    toks = variant_tokens(variant)
    if mesh is not None and rules is None:
        rules = rules_for(cfg, case, mesh, variant)
    model = T.Transformer(cfg, device="meta", mesh=mesh, rules=rules)
    B, S = case.global_batch, case.seq_len
    if case.kind == "train":
        fn = build_train_step(
            cfg, n_micro=8 if "micro8" in toks else 4,
            grad_dtype=torch.bfloat16 if "bf16grad" in toks
            else torch.float32, impl=impl)
        opt_state = OPT.init(dict(model.named_parameters()), cfg.optimizer)
        kwargs = {"params": model, "opt_state": opt_state,
                  "batch": abstract_batch(cfg, case)}
        donate = ("params", "opt_state")
    elif case.kind == "prefill":
        fn = build_prefill_step(cfg, impl=impl)
        kwargs = {"params": model, "batch": abstract_batch(cfg, case)}
        donate = ()
    else:
        tok_shape = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
        kwargs = {"params": model,
                  "cache": T.init_cache(cfg, B, S, device="meta", mesh=mesh,
                                        rules=rules),
                  "tokens": torch.empty(tok_shape, dtype=torch.int32,
                                        device="meta"),
                  "lengths": torch.empty((B,), dtype=torch.int32,
                                         device="meta")}
        fn = build_decode_step(cfg, append="cacheappend" in toks, impl=impl)
        donate = ("cache",)
    if mesh is None:
        return fn, kwargs, donate
    in_specs, out_specs = _specs(cfg, case, mesh, rules, kwargs)
    if case.kind == "train":
        def fn(*args, **kw):
            raise NotImplementedError(f"a sharded train step is {T.A9C}")
    return fn, kwargs, donate, rules, in_specs, out_specs


def _specs(cfg: ModelConfig, case: ShapeCase, mesh, rules, kwargs: dict):
    """build_cell's (in_specs, out_specs) on ``mesh``: every leaf's spec from
    its global shape."""
    full = T.Transformer(cfg, device="meta")
    p_specs = shardings_of(mesh, T.param_axes(cfg), T.param_tree(full),
                           rules)
    if case.kind == "train":
        params = dict(full.named_parameters())
        o_axes = OPT.state_axes(params, {k: T._axes_of(cfg, k)
                                         for k in params}, cfg.optimizer)
        o_specs = shardings_of(mesh, o_axes, OPT.init(params, cfg.optimizer),
                               opt_rules(rules))
        b_specs = shardings_of(mesh, batch_axes(cfg, "train"),
                               kwargs["batch"], rules)
        return ({"params": p_specs, "opt_state": o_specs,
                 "batch": b_specs}, (p_specs, o_specs, None))
    if case.kind == "prefill":
        b_specs = shardings_of(mesh, batch_axes(cfg, "prefill"),
                               kwargs["batch"], rules)
        return {"params": p_specs, "batch": b_specs}, None
    B, S = case.global_batch, case.seq_len
    c_specs = shardings_of(mesh, T.cache_axes(cfg),
                           T.init_cache(cfg, B, S, device="meta"), rules)
    tok = kwargs["tokens"]
    tok_spec = SH.logical_to_spec(mesh, ("batch",) + (None,) * (tok.dim() - 1),
                                  tuple(tok.shape), rules)
    len_spec = SH.logical_to_spec(mesh, ("batch",), (B,), rules)
    return ({"params": p_specs, "cache": c_specs, "tokens": tok_spec,
             "lengths": len_spec}, (None, c_specs))
