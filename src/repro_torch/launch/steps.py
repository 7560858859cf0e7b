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
trees, and every step runs there: prefill, decode and the train step
(data parallelism over the data axes, tensor parallelism over "model",
expert parallelism in the MoE layers, ZeRO-1 moments or a sharded
Adafactor, ``micro8``, ``bf16grad``, ``fsdp``, ``expdata`` and ``seqpar``).
The variants that only change sharding rules run only on a mesh, for
every config (``seqpar`` through every layer kind: attention, cross,
Mamba, RWKV, dense and MoE MLPs, codebooks).
``lower_cell`` has no counterpart: eager PyTorch lowers nothing; the
cell's step runs as it is called.

The sharded train step (``build_train_step`` on a model built on a mesh)
follows the reference's ``train_step`` under its shardings: the global
batch is split into ``n_micro`` consecutive chunks and each chunk's rows
are sharded over the data axes (so a card's microbatch i is not a slice of
its own contiguous rows); each card's gradients, of its rows' mean loss,
are accumulated in ``grad_dtype`` and averaged over the data axes (in
``grad_dtype``); gradients that are a card's part (``transformer.
is_partial``) are summed over "model" in the same all-reduce; the
global norm sums each leaf's squares once (``MeshPlan.copies``); then the
clip and ``optimizer.update`` with its ZeRO-1 slices. Under ``seqpar`` a
microbatch whose sequence is cut (``Transformer.seq_plan``) also sums the
norms' gradients over "model" (``MeshPlan.seq_reduce``).
"""
from __future__ import annotations

import dataclasses
import math
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
MULTI_CARD = ("the multi-card slice (build_cell(mesh=), run_cell(mesh=)): "
              "one card has nothing to shard")


def variant_tokens(variant: str) -> set[str]:
    return {t for t in variant.split("+") if t and t != "baseline"}


def apply_variant_config(cfg: ModelConfig, variant: str,
                         mesh=None) -> ModelConfig:
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
    variants raise ``NotImplementedError`` without a ``mesh``; they
    change only ``rules_for``'s rules."""
    toks = variant_tokens(variant)
    sharding = sorted(toks & set(SHARDING_VARIANTS))
    if sharding and mesh is None:
        raise NotImplementedError(
            f"variant {'+'.join(sharding)} only changes sharding rules, "
            f"which run on a mesh: {MULTI_CARD}")
    unknown = toks - {"vocabpad", "blockdispatch", "micro8", "bf16grad",
                      "cacheappend", "fsdp", "expdata", "seqpar"}
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


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The train step's plan of a model on its mesh, per parameter name:
    ``reduce``, the mesh axes its gradient is all-reduced over (the data
    axes where the leaf is not sharded over them, "model" where a card's
    gradient is a part: ``transformer.is_partial``), and ``seq_reduce``
    theirs for a microbatch whose sequence ``seqpar`` cuts (the norms' over
    "model" too); ``copies``, the cards
    holding each shard of the reduced gradient (the global norm divides
    by it); ``zero``, the card's ZeRO-1 slice (``optimizer.ZeroLeaf``) or
    its sharded Adafactor leaf (``optimizer.FactorLeaf``) and
    ``opt_shapes`` its state's shapes; ``data`` the live data axes and
    ``dp`` their size."""

    layout: SH.Layout
    reduce: dict
    copies: dict
    zero: dict
    opt_shapes: dict
    data: tuple
    dp: int
    seq_reduce: dict


def mesh_plan(model: T.Transformer) -> MeshPlan:
    """``model``'s ``MeshPlan`` under its layout and ``opt_rules`` (made
    once a model)."""
    plan = getattr(model, "_mesh_plan", None)
    if plan is not None:
        return plan
    cfg, lay = model.cfg, model.layout
    olay = lay.with_rules(opt_rules(lay.rules))
    full = {n: tuple(p.shape) for n, p in
            T.Transformer(cfg, device="meta").named_parameters()}
    data = tuple(a for a in ("pod", "data") if lay.sizes.get(a, 1) > 1)
    # the plan of a pass whose sequence the rules cut (any S they divide)
    sp = SH.logical_to_spec(lay, ("seq",), None, lay.rules)[0]
    tp_sp = dataclasses.replace(model.tp, sp=sp if lay.size(sp) > 1
                                else None)
    reduce, seq_reduce, copies, zero, shapes = {}, {}, {}, {}, {}
    for name, p in model.named_parameters():
        axes, shape = T._axes_of(cfg, name), full[name]
        spec, ospec = lay.spec(axes, shape), olay.spec(axes, shape)
        used = {a for e in spec for a in SH.entry_axes(e)}
        copies[name] = math.prod(n for a, n in lay.sizes.items()
                                 if a not in used)
        red = set(data) - used
        for plan, out in ((model.tp, reduce), (tp_sp, seq_reduce)):
            part = red | ({"model"} if T.is_partial(cfg, plan, name)
                          else set())
            out[name] = tuple(a for a in lay.sizes if a in part)
        if cfg.optimizer == "adafactor":
            zero[name], shapes[name] = _factor_leaf(lay, olay, axes, shape)
            continue
        z, shapes[name] = _zero_leaf(name, lay, olay, axes, shape)
        if z is not None:
            zero[name] = z
    plan = MeshPlan(lay, reduce, copies, zero, shapes, data,
                    SH.mesh_axes_size(lay.sizes, data), seq_reduce)
    object.__setattr__(model, "_mesh_plan", plan)
    return plan


def _zero_leaf(name, lay, olay, axes, shape):
    """(the ``ZeroLeaf`` of a parameter or None, its moments' shape): the
    moments' slice under ``olay`` within the parameter's shard under
    ``lay``, the dims where it is not inside the shard gathered first."""
    spec, ospec = lay.spec(axes, shape), olay.spec(axes, shape)
    pre, cover = [], []
    for d, ((p0, pn), (o0, on)) in enumerate(zip(lay.ranges(axes, shape),
                                                 olay.ranges(axes, shape))):
        if p0 <= o0 and o0 + on <= p0 + pn:
            cover.append((p0, pn))
        else:
            pre.append((d, spec[d]))
            cover.append((0, shape[d]))
    index, back, dims = [], [], []
    for d, ((p0, pn), (o0, on), (c0, cn)) in enumerate(zip(
            lay.ranges(axes, shape), olay.ranges(axes, shape), cover)):
        index.append(slice(o0 - c0, o0 - c0 + on))
        back.append(slice(p0 - c0, p0 - c0 + pn))
        if on != cn:
            dims.append(d)
    if len(dims) > 1:
        raise NotImplementedError(f"{name}: its moments are cut on dims "
                                  f"{dims}; one dim is gathered back")
    shape_o = tuple(sl.stop - sl.start for sl in index)
    if not dims and not pre:
        return None, shape_o
    dim = dims[0] if dims else None
    return OPT.ZeroLeaf(tuple(index), dim, None if dim is None
                        else ospec[dim], lay, tuple(pre),
                        tuple(back) if pre else ()), shape_o


def _factor_leaf(lay, olay, axes, shape):
    """(the ``FactorLeaf`` of a parameter, its Adafactor state's shapes):
    each state leaf's slice under ``olay`` against the values the
    parameter's shard under ``lay`` needs."""
    pr = lay.ranges(axes, shape)
    keep = ({"vr": list(range(len(shape) - 1)),
             "vc": list(range(len(shape) - 2)) + [len(shape) - 1]}
            if len(shape) >= 2 else {"v": list(range(len(shape)))})
    gather, take, put, shapes = {}, {}, {}, {}
    for key, dims in keep.items():
        s_axes = tuple(axes[d] for d in dims)
        s_shape = tuple(shape[d] for d in dims)
        ospec = olay.spec(s_axes, s_shape)
        g, t, u = [], [], []
        for i, ((o0, on), d) in enumerate(zip(olay.ranges(s_axes, s_shape),
                                              dims)):
            p0, pn = pr[d]
            if (o0, on) == (p0, pn):
                t.append(slice(None))
                u.append(slice(None))
            elif p0 <= o0 and o0 + on <= p0 + pn:
                g.append((i, ospec[i]))     # whole dim once gathered
                t.append(slice(p0, p0 + pn))
                u.append(slice(o0 - p0, o0 - p0 + on))
            else:
                raise NotImplementedError(
                    f"{axes}: the Adafactor {key} slice of dim {d} is not "
                    "inside the parameter's shard")
        gather[key], take[key], put[key] = tuple(g), tuple(t), tuple(u)
        shapes[key] = tuple(on for _, on in olay.ranges(s_axes, s_shape))
    return OPT.FactorLeaf(lay, tuple(shape), lay.spec(axes, shape), gather,
                          take, put), shapes


def init_opt_state(model: T.Transformer) -> dict:
    """``cfg.optimizer``'s zeroed state for ``model``; on a mesh this card's
    slices of it (``MeshPlan.opt_shapes``)."""
    params = dict(model.named_parameters())
    if model.layout is None:
        return OPT.init(params, model.cfg.optimizer)
    return OPT.init(params, model.cfg.optimizer,
                    shapes=mesh_plan(model).opt_shapes)


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
    metrics, grads {name: tensor}).

    On a mesh ``batch`` is global on every card and each microbatch's rows
    are sharded over the data axes (``Transformer._rows``); the loss,
    metrics and gradients come back averaged over them (the gradients in
    ``grad_dtype``, parts summed over "model": ``MeshPlan.reduce``, or
    ``seq_reduce`` where ``seqpar`` cuts the sequence), equal on every card
    that holds them."""
    params = dict(model.named_parameters())
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    B = batch["tokens"].shape[0]
    nm = n_micro if B % n_micro == 0 and B >= n_micro else 1

    def one(mb):
        mb = {k: model._rows(v) for k, v in mb.items()}
        loss, metrics = T.loss_fn(cfg, model, mb, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if nm == 1:
        loss, metrics, gs = one(batch)
        grads = {k: g.to(grad_dtype) for k, g in zip(params, gs)}
    else:
        grads = {k: torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                 for k, p in params.items()}
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        per_micro = []
        for i in range(nm):
            mb = {k: v.reshape((nm, B // nm) + v.shape[1:])[i]
                  for k, v in batch.items()}
            ls, m, gs = one(mb)
            for k, g in zip(params, gs):
                grads[k] += (g / nm).to(grad_dtype)
            del gs
            loss = loss + ls / nm
            per_micro.append(m)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
    if model.layout is None:
        return loss, metrics, grads
    return _reduce_over_mesh(model, loss, metrics, grads,
                             _seq_cut(model, B // nm,
                                      batch["tokens"].shape[1]))


def _seq_cut(model: T.Transformer, batch: int, seq: int) -> bool:
    """True when ``seqpar`` cuts the sequence of a microbatch of ``batch``
    global rows of ``seq`` tokens (``Transformer.seq_plan``)."""
    return model.seq_plan(batch, seq).sp is not None


def _reduce_over_mesh(model: T.Transformer, loss, metrics: dict,
                      grads: dict, seq_cut: bool = False):
    """The cards' loss, metrics and gradients averaged over the data axes,
    the gradients' parts summed over "model" (one all-reduce a leaf, in
    its dtype, and one for the metrics); ``seq_cut``: the parts of a
    microbatch whose sequence ``seqpar`` cut (``MeshPlan.seq_reduce``)."""
    plan = mesh_plan(model)
    lay = plan.layout
    reduce = plan.seq_reduce if seq_cut else plan.reduce
    for name, g in grads.items():
        if reduce[name]:
            SH.all_reduce(g, lay, reduce[name])
        if plan.dp > 1:
            g.div_(plan.dp)
    if plan.dp == 1:
        return loss, metrics, grads
    keys = sorted(metrics)
    both = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    both = SH.all_reduce(both, lay, plan.data) / plan.dp
    return both[0], dict(zip(keys, both[1:].unbind())), grads


def train_step_collectives(model: T.Transformer, batch_size: int,
                           n_micro: int,
                           seq_len: Optional[int] = None) -> dict:
    """The collectives of one sharded train step of ``batch_size``
    sequences (of ``seq_len`` tokens: a MoE config, or ``seqpar``, needs
    it), by kind (what ``sharding.collectives()`` counts):
    ``Transformer``'s ``train_collectives`` for each microbatch, one
    all-reduce per gradient with axes to reduce, one for the metrics over
    the data axes, one for the global norm, and the optimizer's
    (``ZeroLeaf.calls`` / ``FactorLeaf.calls``)."""
    if model.layout is None:
        return {}
    plan = mesh_plan(model)
    nm = n_micro if batch_size % n_micro == 0 and batch_size >= n_micro \
        else 1
    n = {k: v * nm for k, v in T.train_collectives(
        model, batch_size // nm, seq_len).items()}
    reduce = (plan.seq_reduce if seq_len is not None
              and _seq_cut(model, batch_size // nm, seq_len)
              else plan.reduce)
    live = [a for a, k in plan.layout.sizes.items() if k > 1]
    extra = {"all-reduce": sum(bool(r) for r in reduce.values())
             + (plan.dp > 1) + bool(live)}
    for z in plan.zero.values():
        for k, v in z.calls().items():
            extra[k] = extra.get(k, 0) + v
    for k, v in extra.items():
        if v:
            n[k] = n.get(k, 0) + v
    return n


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
    every kernel call (``"plain"``: the plain versions).

    On a mesh (a model built on one, its state from ``init_opt_state``):
    the module docstring's sharded step; the metrics are equal on every
    card."""
    kind = cfg.optimizer

    def train_step(model: T.Transformer, opt_state: dict, batch: dict):
        lr = OPT.lr_schedule(opt_state["count"] + 1)
        loss, metrics, grads = value_and_grad(
            cfg, model, batch, n_micro=n_micro, grad_dtype=grad_dtype,
            impl=impl)
        plan = None if model.layout is None else mesh_plan(model)
        if plan is None:
            gsq = sum(torch.sum(torch.square(g.float()))
                      for g in grads.values())
        else:          # each shard's squares once, over every card
            gsq = sum(torch.sum(torch.square(g.float())) / plan.copies[k]
                      for k, g in grads.items()).reshape(1)
            gsq = SH.all_reduce(gsq, plan.layout, tuple(
                a for a, n in plan.layout.sizes.items() if n > 1))[0]
        gnorm = torch.sqrt(gsq)
        clip = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(clip.to(g.dtype))
        opt_state = OPT.update(dict(model.named_parameters()), grads,
                               opt_state, kind, lr,
                               zero=None if plan is None else plan.zero)
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
    (None, cache) for decode; the optimizer state is this card's ZeRO-1
    slices (``init_opt_state``). ``rules`` replaces ``rules_for``'s (a
    cell whose batch was cut keeps its case's)."""
    if torch.device(device).type != "meta":
        T.resolve_device(device)
    cfg = apply_variant_config(cfg, variant, mesh)
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
        opt_state = init_opt_state(model)
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
