"""Period-grouped decoder stack (port of ``repro/models/transformer.py``) for
attention (self and cross), Mamba and RWKV-6 layers with dense, MoE or no
MLPs: all ten configs of ``configs/archs.py``.

Parameters keep the JAX names and shapes: ``embed (V, D)`` (``(C, V, D)``
with C codebooks), ``final_norm``, ``lm_head (D, V)`` when untied (``(C, D,
V)``), ``vision_proj (D, D)`` with vision tokens, and per group
``g{i}.{j}.<leaf>`` stacked with a leading layer dim (e.g.
``g0.0.mixer.wq (L, D, H, Dh)``), where ``j`` is the position in the
group's period. A JAX params pytree therefore converts leaf for leaf
(``from_jax_params``).

PyTorch runs eagerly, so where the JAX stack scans over layers this one
loops over views of the stacked tensors. Decode writes each recurrent
layer's new state into the cache in place. Attention K/V is written in
place per layer in committed mode (``append=False``, the default, as in the
reference), or, in append mode (the serving engine's), read-only in the
layers and committed after each group with one batched write per stacked
leaf.

Codebook models (musicgen) take tokens (B, S, C), sum the C embeddings
and give logits (B, S, C, V). Vision models (llama-3.2-vision) take
``vision_embeds`` (B, Nv, D) in ``prefill``; their cross layers attend over
``vision_embeds @ vision_proj`` and keep its K/V as a static cache that
decode reads whole and never writes.

Caches mirror the JAX structure: ``{"g{i}": ({"mixer": {...}}, ...)}``.
Attention layers hold ``k``/``v`` (L, B, S, KVH, Dh), cross layers (L, B,
Nv, KVH, Dh); Mamba layers ``h`` (L, B, Din, N) fp32 and ``conv`` (L, B,
K-1, Din); RWKV layers ``wkv`` (L, B, H, K, K) fp32, ``shift_tm`` and
``shift_cm`` (L, B, D).

Training (``train_forward``, ``loss_fn``) runs every config: grad mode on,
no cache (a recurrent layer starts from a zero state and writes nothing in
place; its scan goes through ``ops``' trainable scans), the vision
projection computed once a pass, codebook labels (B, S, C) against logits
(B, S, C, V), the MoE aux losses summed over layers, and under
``cfg.remat`` each period of a group recomputed in the backward
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` with ``nothing_saveable`` over its scan body).
Parameters are created with ``requires_grad=False``; the train step
(``launch/steps.py``) turns gradients on.

On a mesh (``Transformer(..., mesh=, rules=)``: a ``DeviceMesh`` from
``launch/mesh.py`` and the reference's logical-axis rules,
``distributed/sharding.py``) every card runs the same program on its
shards: each leaf is drawn whole on the card from the seed and cut to the
slice ``param_axes`` and the rules give it, so a sharded model equals the
unsharded one; the embedding is vocab-parallel (a masked local lookup, then
an all-reduce), the logits stay sharded over vocab (and batch), and the
attention, dense-MLP, Mamba and RWKV layers are tensor-parallel
(``layers.TPPlan``; the recurrent ones on the card's d_inner channels or
heads, ``ssm.py``).
``init_cache(..., mesh=, rules=)`` gives the card's shard of a decode
cache (``ShardedCache``, which carries its layout): by kv heads where they
divide the model axis, else by sequence, as ``launch/steps.py::rules_for``
decides; its recurrent states by ``ssm.STATE_AXES`` (Mamba's by channels,
RWKV's ``wkv`` by heads, the token shifts whole). Inputs (tokens, lengths)
are global on every card; each card takes its batch rows.
``gather_logits`` assembles the full logits. Serving and training run
attention, Mamba and RWKV layers with dense or MoE MLPs this way (a MoE
layer's experts over "model", their d_ff over "data": ``moe.py``'s expert
parallelism). A cross layer projects this card's rows of the vision
tokens at ``wk``'s kv heads (their gradient all-reduced over "model": each
card differentiates through its kv heads only) and its static cache is cut
as a self-attention cache, by kv heads or by its own rows; the codebook
embedding and head ``(C, V, D)`` / ``(C, D, V)`` are vocab-parallel per
codebook, the C masked lookups summed before one all-reduce, and the
codebook logits ``(B, S, C, V)`` stay sharded over vocab.

Training on a mesh (``train_forward`` over this card's batch rows, the
train step of ``launch/steps.py``): the collectives are differentiable
(``sharding.copy_to`` / ``reduce_from``, Megatron's pair), the embedding's
backward stays on this card's vocab rows, and ``loss_fn`` is vocab-parallel:
each card takes its shard's row max, sum of exponentials and gold logit and
reduces them over "model" into the logsumexp, so no card holds the full
logits. Under ``fsdp`` (``model_d`` over "data") each weight's D dim is
gathered over "data" just before its layer uses it (inside the remat
region, so the recompute gathers again) and its gradient reduce-scattered
back (``sharding.gather_from(..., scatter=True)``). Under ``seqpar``
(``seq_plan``) a prefill or training pass keeps the card's rows of the
sequence in the residual stream through every layer kind; each layer
gathers them on entry and reduce-scatters its output (``layers.enter`` /
``leave``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import named, nest
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


def resolve_device(device) -> torch.device:
    """Entry points default to CUDA and never fall back to the CPU: asking
    for CUDA where it is missing raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.kind not in ("attn", "mamba", "rwkv"):
            raise NotImplementedError(f"{cfg.name}: {spec.kind} layers are "
                                      "not ported")
        if spec.mlp not in ("dense", "moe", "none"):
            raise NotImplementedError(f"{cfg.name}: {spec.mlp} MLP layers "
                                      "are not ported")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless the port can train ``cfg``: it trains every config
    whose layers it runs (``check_supported``), recurrent, vision and
    codebook ones included."""
    check_supported(cfg)


def is_partial(cfg: ModelConfig, tp, name: str) -> bool:
    """True when a card's gradient of parameter ``name`` is its part, to be
    summed over "model" (``layers.partial_leaves``,
    ``ssm.partial_leaves``; under ``seqpar``, ``tp.sp`` set, the norms,
    which see only this card's rows of the sequence)."""
    parts = name.split(".")
    if tp is not None and tp.sp is not None and (
            name == "final_norm" or (len(parts) == 3
                                     and parts[2].startswith(("norm",
                                                              "post_norm")))):
        return True
    if len(parts) != 4 or parts[2] != "mixer":
        return False
    kind = cfg.groups[int(parts[0][1:])][0][int(parts[1])].kind
    if kind == "attn":
        return parts[3] in L.partial_leaves(cfg, tp)
    return kind == "rwkv" and parts[3] in SSM.partial_leaves(tp)


def _axes_of(cfg: ModelConfig, name: str) -> tuple:
    """The logical axes of the parameter ``name`` (the reference's
    ``param_axes`` leaf): stacked layer leaves lead with "layers"."""
    parts = name.split(".")
    C = (None,) if cfg.n_codebooks else ()
    if len(parts) == 1:
        return {"embed": C + ("vocab", "model_d"),
                "lm_head": C + ("model_d", "vocab"),
                "vision_proj": ("model_d", None),
                "final_norm": ("model_d",)}[name]
    spec = cfg.groups[int(parts[0][1:])][0][int(parts[1])]
    if len(parts) == 3:                              # norms
        return ("layers", "model_d")
    if parts[2] == "mixer":
        table = {"attn": L.ATTN_AXES, "mamba": SSM.MAMBA_AXES,
                 "rwkv": SSM.RWKV_AXES}[spec.kind]
    else:
        table = MOE.MOE_AXES if spec.mlp == "moe" else L.MLP_AXES
    return ("layers",) + table[parts[3]]


def param_axes(cfg: ModelConfig) -> dict:
    """Logical axes of every parameter, in the reference's params structure
    (``param_tree``), as its ``param_axes`` gives them."""
    return nest({name: _axes_of(cfg, name) for name, _ in
                 Transformer(cfg, device="meta").named_parameters()})


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of every decode-cache leaf, in ``init_cache``'s
    structure, as the reference's ``cache_axes`` gives them."""
    def layer(spec):
        if spec.kind == "attn":
            return {"k": ("layers",) + L.CACHE_AXES,
                    "v": ("layers",) + L.CACHE_AXES}
        return {k: ("layers",) + ax for k, ax in SSM.STATE_AXES[spec.kind]
                .items()}

    return {f"g{gi}": tuple({"mixer": layer(spec)} for spec in period)
            for gi, (period, _) in enumerate(cfg.groups)}


def _layout(mesh, rules) -> Optional[SH.Layout]:
    """A model's or a cache's ``Layout``: ``mesh`` a ``DeviceMesh`` or a
    ``Layout`` (the meta device's, without a process group)."""
    if mesh is None:
        return None
    if isinstance(mesh, SH.Layout):
        return mesh if rules is None else mesh.with_rules(rules)
    return SH.Layout.of(mesh, rules)


def is_recurrent(cfg: ModelConfig) -> bool:
    """True when a layer carries a recurrent state (Mamba or RWKV)."""
    return any(spec.kind in ("mamba", "rwkv") for spec in cfg.layer_specs())


def _padded_vocab(cfg: ModelConfig) -> int:
    if cfg.vocab_pad_to:
        return -(-cfg.vocab_size // cfg.vocab_pad_to) * cfg.vocab_pad_to
    return cfg.vocab_size


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class _LayerStack(nn.Module):
    """One period position of a group: its parameters stacked over the
    group's ``rep`` repeats. ``init`` gives each leaf's draw (a function
    of no arguments, run in the order the leaves are made) and ``place(name,
    draw)`` runs it and keeps this card's slice of leaf ``prefix.name``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, rep: int, init,
                 place, prefix: str):
        super().__init__()
        D = cfg.d_model

        def norm(name):
            return nn.Parameter(place(f"{prefix}.{name}",
                                      init((rep, D), None)),
                                requires_grad=False)

        def params(sub, draws):
            return _params({k: place(f"{prefix}.{sub}.{k}", d)
                            for k, d in draws.items()})

        self.rep = rep
        self.norm1 = norm("norm1")
        if spec.kind == "mamba":
            self.mixer = params("mixer", SSM.init_mamba(cfg, rep, init))
        elif spec.kind == "rwkv":
            self.mixer = params("mixer", SSM.init_rwkv(cfg, rep, init))
        else:
            self.mixer = params("mixer",
                                L.init_attention(cfg, spec, rep, init))
        # an RWKV layer's norm2 feeds its channel mix; it has no mlp
        if spec.kind == "rwkv" or spec.mlp != "none":
            self.norm2 = norm("norm2")
        if spec.kind != "rwkv" and spec.mlp != "none":
            self.mlp = params("mlp", MOE.init_moe(cfg, rep, init)
                              if spec.mlp == "moe"
                              else L.init_mlp(cfg, rep, init))
        if cfg.use_post_norms:
            self.post_norm1 = norm("post_norm1")
            self.post_norm2 = norm("post_norm2")

    def per_layer(self) -> list[dict]:
        """One dict of views per repeat: {"norm1": t, "mixer": {...}, ...}."""
        views = {name: p.unbind(0) for name, p in self.named_parameters()}
        out = []
        for r in range(self.rep):
            d: dict = {"mixer": {}, "mlp": {}}
            for name, vs in views.items():
                head, _, leaf = name.partition(".")
                if leaf:
                    d[head][leaf] = vs[r]
                else:
                    d[head] = vs[r]
            out.append(d)
        return out


class Transformer(nn.Module):
    """Decoder stack with JAX-named parameters.

    ``generator`` seeds the normal init (a fresh one seeded 0 when omitted);
    norms start at one and biases at zero, as in the JAX init. The model is
    built on ``device`` (CUDA by default; raises when CUDA is missing).

    ``mesh`` (a ``DeviceMesh``, or a ``sharding.Layout`` on the meta device)
    and ``rules`` (``sharding.ShardingRules``; the context's when None)
    build this card's shard of every leaf (module docstring): each is drawn
    whole from the generator, in the unsharded model's order, and cut, so
    one leaf at a time is whole on the card.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None, mesh=None,
                 rules: Optional[SH.ShardingRules] = None):
        super().__init__()
        check_supported(cfg)
        self.layout = _layout(mesh, rules)
        # leaves whose model_d dim is sharded (fsdp): name -> (dim, entry)
        self._fsdp: dict = {}
        dev = resolve_device(device)
        pd = getattr(torch, cfg.param_dtype)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)

        def place(name, draw):
            """Run ``draw`` and keep this card's slice of leaf ``name``
            (a copy, so the whole leaf is freed)."""
            full = draw()
            if self.layout is None:
                return full
            axes = _axes_of(cfg, name)
            if "model_d" in axes:
                dim = axes.index("model_d")
                entry = self.layout.spec(axes, full.shape)[dim]
                if self.layout.size(entry) > 1:
                    self._fsdp[name] = (dim, entry)
            part = self.layout.local(full, axes)
            if part.shape == full.shape:
                return full
            if full.is_cuda:
                # the draw's fp32 temporary is free in the caching allocator;
                # a slice placed in its block would pin the whole block (13.6
                # GB of gemma2's stacked d_ff leaves a card), so return it
                torch.cuda.empty_cache()
            return part.clone()

        def init(shape, std, dtype=None, *, fill=1.0):
            """The draw of one leaf (``place`` runs it): std None: ``fill``
            in fp32 (a number, or a tensor broadcast over the leading dims):
            norm scales and the recurrent layers' fp32 constants; 0.0:
            zeros; else normal weights in ``dtype`` (the param dtype when
            None)."""
            return functools.partial(draw, shape, std, dtype, fill)

        def draw(shape, std, dtype, fill):
            if std is None:
                out = torch.empty(shape, dtype=torch.float32, device=dev)
                return out.copy_(torch.as_tensor(fill, dtype=torch.float32))
            dt = pd if dtype is None else dtype
            if dev.type == "meta" or std == 0.0:
                return torch.zeros(shape, dtype=dt, device=dev)
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return w.mul_(std).to(dt)     # in place: one fp32 temporary

        def top(name, shape, std):
            return nn.Parameter(place(name, init(shape, std)),
                                requires_grad=False)

        self.cfg = cfg
        D, V = cfg.d_model, _padded_vocab(cfg)
        C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        self.embed = top("embed", C + (V, D), 0.02)
        if cfg.n_vision_tokens:
            self.vision_proj = top("vision_proj", (D, D), D ** -0.5)
        self.final_norm = top("final_norm", (D,), None)
        if not cfg.tie_embeddings:
            self.lm_head = top("lm_head", C + (D, V), 0.02)
        for gi, (period, rep) in enumerate(cfg.groups):
            self.add_module(f"g{gi}", nn.ModuleList(
                [_LayerStack(cfg, spec, rep, init, place, f"g{gi}.{j}")
                 for j, spec in enumerate(period)]))
        self.tp = None
        self.row_entry = None
        if self.layout is not None:
            self.tp = L.tp_plan(cfg, self.layout)
            # the vocab shards of the embedding and of the unembedding
            # (a codebook leaf's vocab dim follows its C dim)
            self._embed_vocab = self._vocab_range("embed", C + (V, D),
                                                  len(C))
            self._unembed_vocab = self._embed_vocab if cfg.tie_embeddings \
                else self._vocab_range("lm_head", C + (D, V), len(C) + 1)

    def _vocab_range(self, name: str, shape, dim: int):
        """(spec entry, first row, rows) of leaf ``name``'s vocab dim on
        this card."""
        entry = self.layout.spec(_axes_of(self.cfg, name), shape)[dim]
        n = shape[dim] // self.layout.size(entry)
        return entry, self.layout.index(entry) * n, n

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _full(self, name: str, t: torch.Tensor, lead: int = 0):
        """Leaf ``name`` (``t``: its view, ``lead`` leading dims dropped)
        with its D dim gathered over "data" where ``fsdp`` shards it; the
        backward reduce-scatters its gradient."""
        d = self._fsdp.get(name)
        if d is None:
            return t
        return SH.gather_from(t, self.layout, d[1], d[0] - lead,
                              scatter=True)

    def _full_layer(self, prefix: Optional[str], p: dict) -> dict:
        """One layer's views (``_LayerStack.per_layer``) with every
        ``fsdp`` leaf gathered."""
        if not self._fsdp or prefix is None:
            return p
        return {k: ({leaf: self._full(f"{prefix}.{k}.{leaf}", t, 1)
                     for leaf, t in v.items()} if isinstance(v, dict)
                    else self._full(f"{prefix}.{k}", v, 1))
                for k, v in p.items()}

    # -- pieces ----------------------------------------------------------------
    def seq_plan(self, batch: int, seq: int):
        """The card's plan for a prefill or training pass over a global
        batch of ``batch`` rows of ``seq`` tokens: the model's ``TPPlan``
        with ``sp``, the residual stream's sequence entry (the reference's
        ``("batch", "seq", None)`` resolved under the rules: None on one
        card, at the default rules, where ``seq`` does not divide the
        axis, and at decode's S = 1). The heads, d_ff, d_inner, RWKV heads
        and vocab must be cut over the sequence's axes where they are
        cut."""
        if self.tp is None:
            return None
        lay = self.layout
        sp = lay.spec(("batch", "seq", None), (batch, seq,
                                               self.cfg.d_model))[1]
        if lay.size(sp) == 1:
            return self.tp
        tp = self.tp
        for what, entry in (("heads", tp.heads), ("ff", tp.ff),
                            ("d_inner", tp.inner), ("rwkv_heads", tp.rwkv),
                            ("vocab", self._embed_vocab[0]),
                            ("vocab", self._unembed_vocab[0])):
            if lay.size(entry) > 1 and SH.entry_axes(entry) != \
                    SH.entry_axes(sp):
                raise NotImplementedError(
                    f"{self.cfg.name}: {what} over {entry} against the "
                    f"sequence over {sp}")
        return dataclasses.replace(tp, sp=sp)

    def counted_plan(self, batch: Optional[int], seq: Optional[int]):
        """The plan of a pass of ``batch`` global rows of ``seq`` tokens
        whose collectives a formula counts (``seq_plan``; the model's own
        where no shape is given, which rules that cut the sequence
        need)."""
        if batch is not None and seq is not None:
            return self.seq_plan(batch, seq)
        if self.layout.rules.rules.get("seq"):
            raise ValueError("under seqpar the collectives of a pass need "
                             "its batch and seq")
        return self.tp

    def _embed(self, tokens: torch.Tensor, tp=None) -> torch.Tensor:
        """tokens (B, S), or (B, S, C) with codebooks: the C embeddings
        summed in codebook order. On a mesh with the vocab sharded, a
        masked lookup of this card's rows (of each codebook, summed),
        all-reduced once. Under ``tp.sp`` this card's rows of the sequence:
        the lookup's sum reduce-scattered over it, or, where the vocab is
        not cut, every row looked up (the codebooks' summed) and this
        card's kept (``split_to``: the gradient gathered whole, as the
        unembedding's of a tied table)."""
        emb = self._full("embed", self.embed).to(getattr(torch,
                                                         self.cfg.dtype))
        C = self.cfg.n_codebooks
        sp = None if tp is None else tp.sp
        if self.tp is None or self._embed_vocab[0] is None:
            h = (sum(emb[c][tokens[..., c]] for c in range(C)) if C
                 else emb[tokens])
            return SH.split_to(h, self.layout, sp, 1)
        entry, v0, n = self._embed_vocab

        def lookup(table, ids):
            local = ids - v0
            mine = (local >= 0) & (local < n)
            return torch.where(mine[..., None], table[local.clamp(0, n - 1)],
                               0.0)

        h = (sum(lookup(emb[c], tokens[..., c]) for c in range(C)) if C
             else lookup(emb, tokens))
        if sp is not None:
            return SH.reduce_scatter(h.to(emb.dtype), self.layout, sp, 1)
        return SH.reduce_from(h.to(emb.dtype), self.layout, entry)

    def _unembed(self, h: torch.Tensor, tp=None) -> torch.Tensor:
        """Logits (B, S, Vp), or (B, S, C, Vp) with codebooks; padded vocab
        rows masked to -1e30. On a mesh this card's vocab columns (``h``'s
        gradient all-reduced over them in the backward); under ``tp.sp``
        ``h`` is this card's rows, all-gathered over the sequence first
        (backward: reduce-scattered, or this card's rows where the vocab is
        not cut)."""
        cfg = self.cfg
        if self.tp is not None:
            entry = self._unembed_vocab[0]
            if tp is not None and tp.sp is not None:
                h = SH.gather_from(h, self.layout, tp.sp, 1,
                                   scatter=entry is not None)
            else:
                h = SH.copy_to(h, self.layout, entry)
        if cfg.tie_embeddings:
            logits = h @ self._full("embed", self.embed).to(h.dtype).T
        elif cfg.n_codebooks:
            logits = torch.einsum("bsd,cdv->bscv", h, self._full(
                "lm_head", self.lm_head).to(h.dtype))
        else:
            logits = h @ self._full("lm_head", self.lm_head).to(h.dtype)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(
                logits.float() / cfg.final_softcap).to(logits.dtype)
        v0 = 0 if self.tp is None else self._unembed_vocab[1]
        if v0 + logits.shape[-1] > cfg.vocab_size:
            # mask padded vocab rows out of the softmax (and argmax sampling)
            pad = v0 + torch.arange(logits.shape[-1],
                                    device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def gather_logits(self, logits: torch.Tensor,
                      batch: int) -> torch.Tensor:
        """The full logits of a global batch of ``batch`` rows from this
        card's shard (gathered over the vocab and batch axes); the logits
        themselves on one card."""
        if self.tp is None:
            return logits
        logits = SH.all_gather(logits, self.layout, self._unembed_vocab[0],
                               dim=logits.dim() - 1)
        entry = self.layout.spec(("batch",), (batch,))[0]
        return SH.all_gather(logits, self.layout, entry, dim=0)

    def step_collectives(self, cache: Optional[dict] = None, *,
                         batch: Optional[int] = None,
                         seq: Optional[int] = None) -> dict:
        """The collectives one prefill (``cache`` None; a MoE config
        needs its global ``batch`` and ``seq``) or decode step on
        ``cache`` makes on a mesh, by kind, from the layout (the formula
        the counts of ``sharding.collectives()`` are held to): the
        embedding's all-reduce (codebooks: their lookups summed first);
        per attention layer, cross layers included, the all-reduce after
        ``wo``, and over a cache sharded by sequence (a cross layer's: by
        its own rows) the all-gathers of the query heads and of the decode
        partials; per Mamba layer the all-reduces after ``x_proj`` and
        ``out_proj``; per RWKV layer the all-reduce after ``wo``, and its
        channel mix's reduce-scatter of v and all-gather of r * v; per
        dense MLP the all-reduce after ``w_down``; per MoE layer its
        ``moe.EPPlan``'s. Under ``seqpar`` (a prefill whose sequence is cut:
        ``seq_plan``) the embedding's all-reduce is a reduce-scatter (none
        where the vocab is not cut), each layer's all-reduce a
        reduce-scatter after an all-gather of its input (only the gather
        where its heads, d_ff, channels or RWKV heads are not cut; Mamba's
        ``x_proj`` all-reduce stays; the RWKV channel mix's is an
        all-gather of its input, its cut over D as before and its rows
        kept), and the unembedding gathers the sequence.
        A dim sharded over axes of size 1 is no collective;
        ``gather_logits`` is not part of a step."""
        if self.tp is None:
            return {}
        tp = (self.counted_plan(batch, seq) if cache is None
              else cache.plan(self)[0])
        live = lambda entry: self.layout.size(entry) > 1   # noqa: E731
        sp, vocab = live(tp.sp), live(self._embed_vocab[0])
        n = {"all-reduce": int(vocab and not sp), "all-gather": int(sp),
             "reduce-scatter": int(vocab and sp)}
        moe = {}
        if self.cfg.n_experts:
            if cache is not None:
                batch, seq, lay = cache.batch, 1, cache.layout
            elif batch is None or seq is None:
                raise ValueError("a MoE prefill's collectives need its "
                                 "batch and seq")
            else:
                lay = self.layout
            moe = MOE.ep_plan(self.cfg, tp, lay.spec(("batch",), (batch,))[0],
                              batch * seq).collectives()
        for spec in self.cfg.layer_specs():
            if spec.kind == "attn":
                _exit(n, sp, live(tp.heads))
                seq = tp.cross_seq if spec.attn_type == "cross" else tp.seq
                if cache is not None and live(seq):
                    n["all-gather"] += 1 + live(tp.heads)
            elif spec.kind == "mamba":
                c = live(tp.inner)
                _exit(n, sp, c)
                n["all-reduce"] += c             # x_proj's (dt, B, C)
            else:
                r = int(live(tp.rwkv))
                _exit(n, sp, r)                  # the time mix
                _exit(n, sp, False)              # the channel mix's rows
                n["all-gather"] += r
                n["reduce-scatter"] = n.get("reduce-scatter", 0) + r
            if spec.mlp == "dense":
                _exit(n, sp, live(tp.ff))
            if spec.mlp == "moe":
                for k, v in moe.items():
                    n[k] = n.get(k, 0) + v
        return {k: v for k, v in n.items() if v}

    def _rows(self, x: torch.Tensor,
              layout: Optional[SH.Layout] = None) -> torch.Tensor:
        """This card's batch rows of a global input (all rows on one card,
        or where the batch is not sharded). Keeps the batch dim's spec
        entry as ``row_entry``, over which the MoE layers gather their
        tokens (a caller that cuts the rows itself sets it)."""
        layout = layout or self.layout
        if layout is None:
            return x
        self.row_entry = layout.spec(("batch",), (x.shape[0],))[0]
        (b0, n), = layout.ranges(("batch",), (x.shape[0],))
        return x[b0:b0 + n]

    def _layer(self, spec: LayerSpec, p: dict, x: torch.Tensor, *,
               positions=None, cache=None, lengths=None, append=False,
               vision_kv=None, impl=None, tp=None, prefix=None):
        """One layer. ``cache`` None: prefill (attention returns its K/V,
        a cross layer that of ``vision_kv``, a recurrent layer starts from
        a zero state); else this layer's cache views (decode: attention
        writes K/V into them, or with ``append`` returns its {"k_new",
        "v_new"}). Returns (x, the layer's new K/V, deltas or recurrent
        state, its MoE aux losses or None). ``tp`` the card's plan on a
        mesh (``layers.TPPlan``); ``prefix`` the layer's ``g{i}.{j}``, whose
        ``fsdp`` leaves are gathered here."""
        cfg = self.cfg
        p = self._full_layer(prefix, p)
        h_in = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.kind == "attn":
            if cache is None:
                mix_out, new = L.attention_forward(
                    cfg, spec, p["mixer"], h_in, positions=positions,
                    vision_kv=vision_kv, impl=impl, tp=tp)
            else:
                mix_out, new = L.attention_decode(cfg, spec, p["mixer"],
                                                  h_in, cache, lengths,
                                                  append=append, impl=impl,
                                                  tp=tp)
        else:
            width = None if tp is None else (
                tp.dinl if spec.kind == "mamba" else tp.rhl)
            st = cache if cache is not None else SSM.init_state(
                cfg, spec, x.shape[0], x.dtype, x.device, width=width)
            # decode: the scan writes the new state into the cache slot
            in_place = cache is not None
            if spec.kind == "mamba":
                mix_out, new = SSM.mamba_forward(
                    cfg, p["mixer"], h_in, st, impl=impl, in_place=in_place,
                    tp=tp)
            else:      # rwkv: time mix, then channel mix, no mlp
                mix_out, new = SSM.rwkv_time_mix(
                    cfg, p["mixer"], h_in, st, impl=impl, in_place=in_place,
                    tp=tp)
                x = x + mix_out
                h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
                cm_out, cm_new = SSM.rwkv_channel_mix(cfg, p["mixer"], h2,
                                                      st, tp=tp)
                return x + cm_out, {**new, **cm_new}, None
        if cfg.use_post_norms:
            mix_out = L.rms_norm(mix_out, p["post_norm1"], cfg.norm_eps)
        x = x + mix_out
        if spec.mlp == "none":
            return x, new, None
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        aux = None
        if spec.mlp == "moe":
            mlp_out, aux = MOE.moe_forward(cfg, p["mlp"], h2, impl=impl,
                                           tp=tp, rows=self.row_entry)
        else:
            mlp_out = L.mlp_forward(cfg, p["mlp"], h2, tp=tp)
        if cfg.use_post_norms:
            mlp_out = L.rms_norm(mlp_out, p["post_norm2"], cfg.norm_eps)
        return x + mlp_out, new, aux

    def _groups(self):
        for gi, (period, rep) in enumerate(self.cfg.groups):
            stacks = getattr(self, f"g{gi}")
            yield gi, period, rep, [s.per_layer() for s in stacks]

    # -- entry points ------------------------------------------------------------
    def _vision_kv(self, vision_embeds: Optional[torch.Tensor],
                   dtype: torch.dtype) -> Optional[torch.Tensor]:
        """``vision_embeds @ vision_proj`` in the compute dtype for a
        vision config (which must be given them), else None. On a mesh
        ``vision_embeds`` are this card's batch rows; every card's cross
        layers differentiate through their own kv heads only, so the
        gradient is all-reduced over "model" (once a pass: it sums every
        cross layer's) and ``vision_proj``'s is whole on every card."""
        if not self.cfg.n_vision_tokens:
            return None
        if vision_embeds is None:
            raise ValueError(f"{self.cfg.name}: a vision model needs "
                             "vision_embeds (B, n_vision_tokens, d_model)")
        kv = vision_embeds.to(device=self.device, dtype=dtype) \
            @ self._full("vision_proj", self.vision_proj).to(dtype)
        return L.column_parallel(kv, self.tp, self.tp and self.tp.heads)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *,
                vision_embeds: Optional[torch.Tensor] = None,
                impl: Optional[str] = None):
        """Full-sequence pass over tokens (B, S), or (B, S, C) with
        codebooks; a vision config also takes ``vision_embeds`` (B, Nv, D).
        Returns (logits (B, S, V) or (B, S, C, V), cache) with cache
        capacity == S (a cross layer's: Nv). On a mesh: this card's batch
        rows of the global tokens (and vision embeddings), its vocab shard
        of the logits and its cache (``wk``'s kv heads, every position)."""
        if vision_embeds is not None:
            vision_embeds = self._rows(vision_embeds)
        B, S = tokens.shape[:2]
        tp = self.seq_plan(B, S)
        tokens = self._rows(tokens)
        h = self._embed(tokens, tp)
        B = tokens.shape[0]
        positions = torch.arange(S, device=h.device).expand(B, S)
        vision_kv = self._vision_kv(vision_embeds, h.dtype)
        caches = {}
        for gi, period, rep, views in self._groups():
            per_pos = [[] for _ in period]
            for r in range(rep):
                for li, spec in enumerate(period):
                    h, new, _ = self._layer(spec, views[li][r], h,
                                            positions=positions,
                                            vision_kv=vision_kv, impl=impl,
                                            tp=tp, prefix=f"g{gi}.{li}")
                    per_pos[li].append(new)
            caches[f"g{gi}"] = tuple(
                {"mixer": {name: torch.stack([st[name] for st in sts])
                           for name in sts[0]}}
                for sts in per_pos)
        h = L.rms_norm(h, self._full("final_norm", self.final_norm),
                       self.cfg.norm_eps)
        return self._unembed(h, tp), caches

    def forward(self, tokens: torch.Tensor, *,
                vision_embeds: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """Logits (B, S, V) (or (B, S, C, V)) of a full-sequence pass, under
        ``torch.no_grad`` (it is ``prefill``'s). The differentiable pass is
        ``train_forward`` (through ``loss_fn``)."""
        return self.prefill(tokens, vision_embeds=vision_embeds,
                            impl=impl)[0]

    def _period(self, period, views: list, h: torch.Tensor,
                positions: torch.Tensor, vision_kv: Optional[torch.Tensor],
                impl: Optional[str], gi: int = 0, tp=None):
        """One repeat of group ``gi``'s period in training: (h, lb_loss,
        z_loss), the aux losses summed over its MoE layers (the reference's
        scan body); cross layers attend over ``vision_kv``. ``tp``: the
        pass's plan (``seq_plan``)."""
        lb = torch.zeros((), dtype=torch.float32, device=h.device)
        z = torch.zeros((), dtype=torch.float32, device=h.device)
        for li, (spec, p) in enumerate(zip(period, views)):
            h, _, aux = self._layer(spec, p, h, positions=positions,
                                    vision_kv=vision_kv, impl=impl,
                                    tp=tp, prefix=f"g{gi}.{li}")
            if aux is not None:
                lb, z = lb + aux["lb_loss"], z + aux["z_loss"]
        return h, lb, z

    def train_forward(self, tokens: torch.Tensor, *,
                      vision_embeds: Optional[torch.Tensor] = None,
                      impl: Optional[str] = None):
        """The training pass over tokens (B, S), or (B, S, C) with
        codebooks; a vision config also takes ``vision_embeds`` (B, Nv, D),
        projected once for all its cross layers. Differentiable, no cache
        (the reference's ``forward(mode="train")``). Returns (logits (B, S,
        V) or (B, S, C, V), {"lb_loss", "z_loss"} summed over the MoE
        layers). Under ``cfg.remat`` every period is recomputed in the
        backward, so each attention and scan layer's kernels run twice a
        step. On a mesh ``tokens`` are this card's batch rows (the train
        step takes them: ``row_entry`` their spec) and the logits its vocab
        shard; under ``seqpar`` the residual stream holds this card's rows
        of the sequence (``seq_plan``)."""
        cfg = self.cfg
        check_trainable(cfg)
        B, S = tokens.shape[:2]
        tp = None if self.tp is None else self.seq_plan(
            B * self.layout.size(self.row_entry), S)
        h = self._embed(tokens, tp)
        positions = torch.arange(S, device=h.device).expand(B, S)
        vision_kv = self._vision_kv(vision_embeds, h.dtype)
        lb_tot = torch.zeros((), dtype=torch.float32, device=h.device)
        z_tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for gi, period, rep, views in self._groups():
            lbs, zs = [], []
            for r in range(rep):
                args = (period, [v[r] for v in views], h, positions,
                        vision_kv, impl, gi, tp)
                if cfg.remat:
                    h, lb, z = checkpoint(self._period, *args,
                                          use_reentrant=False)
                else:
                    h, lb, z = self._period(*args)
                lbs.append(lb)
                zs.append(z)
            lb_tot = lb_tot + torch.stack(lbs).sum()
            z_tot = z_tot + torch.stack(zs).sum()
        h = L.rms_norm(h, self._full("final_norm", self.final_norm),
                       cfg.norm_eps)
        return self._unembed(h, tp), {"lb_loss": lb_tot, "z_loss": z_tot}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, *, append: bool = False,
                    impl: Optional[str] = None):
        """One decode step. tokens (B,), or (B, C) with codebooks; lengths
        (B,) tokens already in the cache (the position of the new token).
        Writes each self-attention layer's new K/V and each recurrent
        layer's new state into ``cache`` IN PLACE and returns (logits (B, V)
        or (B, C, V), cache). Cross layers read their static cache whole
        and write nothing.

        ``append=False`` (the default, as the reference's): each attention
        layer writes its token's K/V before it attends. ``append=True`` (the
        serving engine's mode): attention layers read the cache as it was
        and merge the token analytically, and each group's K/V deltas are
        committed after the group with one batched write per stacked leaf
        (``k[:, b, lengths[b]]``); recurrent states are written in place
        either way.

        Lengths given on the CPU are bounds-checked before anything is
        written (on the device an out-of-range write would be a device-side
        fault): never negative, and below the capacity of the first
        self-attention layer's cache where the config has one (a recurrent
        state has no capacity); on a mesh, the cache's global capacity.

        On a mesh ``cache`` is this card's ``ShardedCache``; tokens and
        lengths are global, the logits this card's shard (its batch rows,
        its vocab columns: ``gather_logits``). A sequence-sharded cache is
        written only where a card owns position ``lengths[b]``."""
        tp, layout, s0 = self.tp, None, 0
        if tp is not None:
            if not isinstance(cache, ShardedCache):
                raise ValueError("a model on a mesh decodes a cache from "
                                 "init_cache(..., mesh=)")
            tp, layout = cache.plan(self)
            s0 = tp.s0
        if lengths.device.type == "cpu":
            max_seq = (_attention_capacity(self.cfg, cache)
                       if layout is None else cache.max_seq)
            if bool(((lengths < 0) | (lengths >= max_seq)).any()):
                raise ValueError(f"lengths {lengths.tolist()} outside the "
                                 f"cache's [0, {max_seq})")
        if layout is not None:
            tokens = self._rows(tokens, layout=layout)
            lengths = self._rows(lengths, layout=layout)
        h = self._embed(tokens[:, None])
        lengths = lengths.to(device=h.device, dtype=torch.int64)
        bidx = None          # batch rows of the append-mode commit
        for gi, period, rep, views in self._groups():
            deltas = [[] for _ in period]
            for r in range(rep):
                for li, spec in enumerate(period):
                    layer_cache = {name: t[r] for name, t in
                                   cache[f"g{gi}"][li]["mixer"].items()}
                    h, new, _ = self._layer(spec, views[li][r], h,
                                            cache=layer_cache,
                                            lengths=lengths, append=append,
                                            impl=impl, tp=tp,
                                            prefix=f"g{gi}.{li}")
                    if spec.kind == "attn":
                        if append:
                            deltas[li].append(new)
                        continue
                    for name, t in new.items():
                        if t is not layer_cache[name]:  # in place
                            layer_cache[name].copy_(t)
            if not append:
                continue
            for li, spec in enumerate(period):
                if spec.kind != "attn" or spec.attn_type == "cross":
                    continue           # cross: static, nothing to commit
                leaves = cache[f"g{gi}"][li]["mixer"]
                if bidx is None:
                    bidx = torch.arange(h.shape[0], device=h.device)
                for name in ("k", "v"):
                    new = torch.stack([d[f"{name}_new"] for d in deltas[li]])
                    if tp is not None and tp.seq is not None:
                        L.write_owned(leaves[name], bidx, lengths, new, s0)
                    else:
                        leaves[name][:, bidx, lengths] = new
        h = L.rms_norm(h, self._full("final_norm", self.final_norm),
                       self.cfg.norm_eps)
        return self._unembed(h)[:, 0], cache


def _exit(n: dict, sp: bool, cut: bool, gathers: int = 1,
          sums: int = 1) -> None:
    """Add a tensor-parallel layer's collectives to ``n``: ``sums``
    all-reduces where its heads or d_ff are ``cut``; under ``sp``
    (``seqpar``) ``gathers`` all-gathers of its input or of its output's
    gradient and, where ``cut``, ``sums`` reduce-scatters instead."""
    if sp:
        n["all-gather"] += gathers
        n["reduce-scatter"] = n.get("reduce-scatter", 0) + sums * cut
    else:
        n["all-reduce"] += sums * cut


class ShardedCache(dict):
    """This card's shard of a decode cache (``init_cache(..., mesh=)``):
    the cache dict, with the layout it was cut by (``layout``: the cache's
    rules on the mesh) and its global ``batch`` and ``max_seq``."""

    def __init__(self, tree: dict, layout: SH.Layout, batch: int,
                 max_seq: int):
        super().__init__(tree)
        self.layout, self.batch, self.max_seq = layout, batch, max_seq

    def leaf_shape(self, cfg: ModelConfig, cross: bool = False) -> tuple:
        """The global shape of one layer's K or V leaf (layers 1): a cross
        layer's rows are its vision tokens."""
        rows = max(cfg.n_vision_tokens, 1) if cross else self.max_seq
        return (1, self.batch, rows, cfg.n_kv_heads, cfg.head_dim)

    def spec(self, cfg: ModelConfig, cross: bool = False) -> tuple:
        """The spec of a self-attention (or cross) leaf (layers, batch,
        kv_seq, kv_heads, head_dim)."""
        return self.layout.spec(("layers",) + L.CACHE_AXES,
                                self.leaf_shape(cfg, cross))

    def plan(self, model: "Transformer"):
        """(the model's ``TPPlan`` with this cache's rows and kv heads, the
        cache's layout)."""
        lay = self.layout
        axes = ("layers",) + L.CACHE_AXES
        _, _, (s0, _), (k0, _), _ = lay.ranges(axes,
                                               self.leaf_shape(model.cfg))
        _, _, seq, kv, _ = self.spec(model.cfg)
        xseq = self.spec(model.cfg, cross=True)[2]
        _, _, (x0, _), _, _ = lay.ranges(axes, self.leaf_shape(model.cfg,
                                                               cross=True))
        return (dataclasses.replace(model.tp, seq=seq, s0=s0, cache_kv=kv,
                                    cache_kv0=k0, cross_seq=xseq,
                                    cross_s0=x0), lay)


_pytree.register_pytree_node(
    ShardedCache,
    lambda c: (list(c.values()), (list(c), c.layout, c.batch, c.max_seq)),
    lambda vals, ctx: ShardedCache(dict(zip(ctx[0], vals)), *ctx[1:]),
    serialized_type_name="repro_torch.models.transformer.ShardedCache")


def _attention_capacity(cfg: ModelConfig, cache: dict) -> float:
    """Positions the first self-attention layer's cache holds; unbounded in
    a config without one."""
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            if spec.kind == "attn" and spec.attn_type != "cross":
                return cache[f"g{gi}"][li]["mixer"]["k"].shape[2]
    return float("inf")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda", mesh=None,
               rules: Optional[SH.ShardingRules] = None) -> dict:
    """Zeroed decode cache: attention K/V in the model dtype (a cross
    layer's over its n_vision_tokens positions, filled by ``cache_insert``
    from a prefill), recurrent states as ``ssm.init_state``. With ``mesh``
    (as ``Transformer``'s) and ``rules`` (``launch/steps.py::rules_for``'s
    decode policy), this card's shard of every leaf by ``cache_axes`` (a
    recurrent state's: its batch rows, and Mamba's channels or RWKV's
    heads where they are sharded), as a ``ShardedCache``."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = getattr(torch, cfg.dtype)
    layout = _layout(mesh, rules)

    def layer(spec, rep):
        if spec.kind != "attn":
            return SSM.init_state(cfg, spec, batch, cdt, dev, lead=(rep,),
                                  layout=layout)
        if layout is not None:
            rows = max(cfg.n_vision_tokens, 1) if spec.attn_type == "cross" \
                else max_seq
            shape = (rep, batch, rows, cfg.n_kv_heads, cfg.head_dim)
            local = layout.local_shape(("layers",) + L.CACHE_AXES, shape)
            return {"k": torch.zeros(local, dtype=cdt, device=dev),
                    "v": torch.zeros(local, dtype=cdt, device=dev)}
        return L.init_attention_cache(cfg, spec, rep, batch, max_seq, cdt,
                                      dev)

    tree = {f"g{gi}": tuple({"mixer": layer(spec, rep)} for spec in period)
            for gi, (period, rep) in enumerate(cfg.groups)}
    if layout is None:
        return tree
    return ShardedCache(tree, layout, batch, max_seq)


def cache_insert(cfg: ModelConfig, cache: dict, prefill_cache: dict,
                 slot: int, length: int) -> dict:
    """Write a single-sequence prefill cache (batch == 1) into batch slot
    ``slot`` of a decode cache, IN PLACE: the first ``length`` positions of
    every self-attention layer's K/V, and every cross layer's K/V and
    recurrent state whole (the prefill must have run on exactly ``length``
    tokens for a recurrent state to be the prompt's). Returns ``cache``.

    A ``ShardedCache`` takes its part: the slot where this card holds it,
    the positions of its rows (a cross layer's rows of its vision tokens),
    and its kv heads (the prefill cache holds ``wk``'s: this card's, or
    all of them); a recurrent state's channels or heads alike (the
    prefill's: this card's, or all of them)."""
    if isinstance(cache, ShardedCache):
        return _insert_shard(cfg, cache, prefill_cache, slot, length)
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            dst = cache[f"g{gi}"][li]["mixer"]
            src = prefill_cache[f"g{gi}"][li]["mixer"]
            for name, d in dst.items():
                if spec.kind == "attn" and spec.attn_type != "cross":
                    d[:, slot, :length] = src[name][:, 0, :length].to(d.dtype)
                else:
                    d[:, slot] = src[name][:, 0].to(d.dtype)
    return cache


def _insert_shard(cfg: ModelConfig, cache: "ShardedCache",
                  prefill_cache: dict, slot: int, length: int) -> dict:
    """``cache_insert`` into this card's shard: a self-attention layer's
    positions below ``length`` in its rows, a cross layer's rows whole."""
    lay = cache.layout
    axes = ("layers",) + L.CACHE_AXES
    _, (b0, bl), (s0, sl), (k0, kl), _ = lay.ranges(axes,
                                                    cache.leaf_shape(cfg))
    _, _, (x0, xl), _, _ = lay.ranges(axes, cache.leaf_shape(cfg,
                                                             cross=True))
    if not b0 <= slot < b0 + bl:
        return cache                  # another card holds the slot
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            dst = cache[f"g{gi}"][li]["mixer"]
            src = prefill_cache[f"g{gi}"][li]["mixer"]
            for name, d in dst.items():
                x = src[name][:, 0]
                if spec.kind != "attn":   # the card's channels or heads
                    if x.shape != d[:, 0].shape:
                        x = lay.local(x[:, None], ("layers",)
                                      + SSM.STATE_AXES[spec.kind][name])[:, 0]
                    d[:, slot - b0] = x.to(d.dtype)
                    continue
                if x.shape[-2] != kl:         # all kv heads: take ours
                    x = x[..., k0:k0 + kl, :]
                if spec.attn_type == "cross":
                    lo, hi = x0, x0 + xl
                else:
                    lo, hi = s0, min(length, s0 + sl)
                if hi > lo:
                    d[:, slot - b0, :hi - lo] = x[:, lo:hi].to(d.dtype)
    return cache


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count, from a model built on the meta device. With
    ``active_only``, every ``mlp`` gate/up/down leaf counts top_k/n_experts
    of its size (floored per leaf), as in the reference; like it, this also
    scales a dense MLP in an MoE config (kimi-k2's first layer)."""
    model = Transformer(cfg, device="meta")
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        if active_only and cfg.n_experts and ".mlp." in name and \
                name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            n = n * cfg.moe_top_k // cfg.n_experts
        total += n
    return total


def from_jax_params(cfg: ModelConfig, params, *, device="cuda", mesh=None,
                    rules: Optional[SH.ShardingRules] = None) -> Transformer:
    """Build a Transformer from a JAX params pytree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``). Names, shapes and dtypes
    must match leaf for leaf. With ``mesh`` and ``rules`` (as
    ``Transformer``'s) each leaf is cut to this card's slice."""
    model = Transformer(cfg, device="meta", mesh=mesh, rules=rules)
    own = dict(model.named_parameters())
    given = named(params)
    if set(own) != set(given):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(own) - set(given))}"
            f", unexpected {sorted(set(given) - set(own))}")
    dev = resolve_device(device)
    model = model.to_empty(device=dev)
    for name, p in model.named_parameters():
        arr = np.asarray(given[name])
        if arr.dtype.name == "bfloat16":      # numpy has no bf16 for torch
            arr = arr.astype(np.float32)
        if model.layout is not None:
            arr = model.layout.local(arr, _axes_of(cfg, name))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.data.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.dtype))
    return model


def param_tree(model: Transformer) -> dict:
    """The model's parameters in the JAX params structure (``{"embed",
    "final_norm", "g0": ({"mixer": {...}, ...}, ...), ...}``), as the
    checkpoint saves them."""
    return nest(dict(model.named_parameters()))


def to_jax_params(model: Transformer) -> dict:
    """The inverse of ``from_jax_params``: a JAX params pytree of numpy
    arrays on the host. numpy has no bfloat16, so bf16 leaves come back as
    float32 (exactly). On a mesh every leaf is gathered whole from the
    cards' shards (a collective: every card calls it)."""
    def host(p):
        t = p.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    lay = model.layout
    if lay is None:
        return nest({name: host(p) for name, p in model.named_parameters()})
    full = {n: tuple(p.shape) for n, p in
            Transformer(model.cfg, device="meta").named_parameters()}
    return nest({name: host(SH.gather_whole(
        p.detach(), lay, lay.spec(_axes_of(model.cfg, name), full[name])))
        for name, p in model.named_parameters()})


def loss_fn(cfg: ModelConfig, model: Transformer, batch: dict, *,
            impl: Optional[str] = None):
    """Port of the reference's ``loss_fn``. batch: {"tokens", "labels"}
    (B, S) integer tensors on the model's device, (B, S, C) with codebooks,
    and for a vision config "vision_embeds" (B, Nv, D). Returns (loss,
    {"ce", "z", "lb_loss", "z_loss"}): next-token cross-entropy over fp32
    logits (padded vocab rows masked by ``_unembed``; with codebooks every
    (position, codebook) is one term of the mean), plus 1e-4 x the mean
    squared logsumexp z, 1e-2 x lb_loss and 1e-3 x the router z_loss.
    ``cfg`` must be the model's.

    On a mesh the batch is this card's rows and the loss their mean; with
    the vocab sharded the cross-entropy is vocab-parallel (``vocab_lse``):
    the logits stay this card's columns."""
    if cfg != model.cfg:
        raise ValueError(f"loss_fn: cfg {cfg.name} is not the model's")
    logits, aux = model.train_forward(
        batch["tokens"].long(), vision_embeds=batch.get("vision_embeds"),
        impl=impl)
    lf = logits.float()
    labels = batch["labels"].long()
    if model.tp is not None and model.layout.size(model._unembed_vocab[0]) > 1:
        lse, gold = vocab_lse(lf, labels, model.layout,
                              *model._unembed_vocab)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels[..., None])[..., 0]
    ce = (lse - gold).mean()
    z = (lse ** 2).mean()
    loss = ce + 1e-4 * z + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"ce": ce, "z": z, **aux}


def vocab_lse(lf: torch.Tensor, labels: torch.Tensor, layout: SH.Layout,
              entry, v0: int, n: int):
    """(logsumexp, gold logit) of each row of fp32 logits sharded over the
    vocab: ``lf`` (..., n) this card's columns from global column ``v0``
    (padded ones already -1e30), ``labels`` global. The row max is
    all-reduced (max, no gradient); the sum of exponentials below it and
    the gold logit (0 off this card) are all-reduced together, their
    gradients passing through to this card's columns."""
    m = lf.detach().amax(dim=-1)
    SH.all_reduce(m, layout, entry, op="max")
    local = labels - v0
    mine = (local >= 0) & (local < n)
    gold = lf.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    parts = torch.stack([torch.exp(lf - m[..., None]).sum(dim=-1),
                         torch.where(mine, gold, 0.0)], dim=-1)
    parts = SH.reduce_from(parts, layout, entry)
    return m + torch.log(parts[..., 0]), parts[..., 1]


def train_collectives(model: Transformer, batch: Optional[int] = None,
                      seq: Optional[int] = None) -> dict:
    """The collectives one microbatch's ``loss_fn`` and its backward make
    on a mesh, by kind, from the layout (what ``sharding.collectives()``
    counts for it): the embedding's all-reduce (codebooks: their lookups
    summed first); with the vocab sharded the unembedding's input gradient
    and the loss's max and sums (3 all-reduces); with vision tokens and
    the heads sharded, the gradient of the projected vision tokens (one
    all-reduce); per attention layer (cross ones included) and dense MLP
    with their heads or d_ff sharded, the output's all-reduce (again in
    the recompute under remat, except a period's last MLP without a post
    norm: the checkpoint's recompute stops after the last saved tensor)
    and the input gradient's; per Mamba layer with its channels sharded, the
    all-reduces after ``x_proj`` and ``out_proj`` (both recomputed: an MLP
    follows) and the gradients' of its input and of (dt_low, B, C); per
    RWKV layer with its heads sharded, ``wo``'s all-reduce, the gradients'
    of the time and channel mixes' inputs, the channel mix's
    reduce-scatter (recomputed; its backward an all-gather) and its
    all-gather of r * v (not recomputed in a period's last layer); per MoE
    layer its ``moe.EPPlan``'s forward, backward
    and recompute (the same stop after its combine), for a microbatch of
    ``batch`` global rows of ``seq`` tokens (a MoE config needs both);
    under ``fsdp`` an all-gather of every sharded leaf at each use (the
    recompute gathers a period's again) and a reduce-scatter of its
    gradient. Under ``seqpar`` (``seq_plan`` of ``batch`` and ``seq``
    cuts the sequence) each of those layer all-reduces is a reduce-scatter
    (the exit's, and its entry's gradient) with an all-gather (the entry's,
    recomputed as it is, and its exit's gradient), or only the all-gathers
    where the heads, d_ff, Mamba channels or RWKV heads are not cut (an
    RWKV channel mix: the gathers of its input and of its output's
    gradient and its input gradient's reduce-scatter, beside its cut over
    D as before; Mamba's ``x_proj`` all-reduces stay); the embedding's
    all-reduce a reduce-scatter (none where the vocab is not cut) and its
    gradient an all-gather; the unembedding's input an all-gather and its
    gradient a reduce-scatter (none where the vocab is not cut)."""
    if model.tp is None:
        return {}
    cfg, lay = model.cfg, model.layout
    tp = model.counted_plan(batch, seq)
    live = lambda entry: lay.size(entry) > 1     # noqa: E731
    sp = live(tp.sp)
    vocab_in = live(model._embed_vocab[0])
    vocab_out = live(model._unembed_vocab[0])
    n = {"all-reduce": 2 * vocab_out, "all-gather": 0, "reduce-scatter": 0}
    _exit(n, sp, vocab_in, gathers=sp)           # the embedding
    _exit(n, sp, vocab_out, gathers=sp)          # the unembedding's input
    if cfg.n_vision_tokens and live(tp.heads):
        n["all-reduce"] += 1
    top = {"embed": 1 + cfg.tie_embeddings, "final_norm": 1, "lm_head": 1,
           "vision_proj": 1}
    runs = 2 if cfg.remat else 1
    for name in model._fsdp:
        if name in top:
            n["all-gather"] += top[name]
            n["reduce-scatter"] += top[name]
        else:               # a stacked leaf: each layer's view, each run
            rep = cfg.groups[int(name.split(".")[0][1:])][1]
            n["all-gather"] += rep * runs
            n["reduce-scatter"] += rep
    if cfg.n_experts and (batch is None or seq is None):
        raise ValueError("a MoE microbatch's collectives need its batch "
                         "and seq")
    for period, rep in cfg.groups:
        for li, spec in enumerate(period):
            last = li == len(period) - 1
            tail = not (cfg.remat and last and not cfg.use_post_norms)
            if spec.kind == "attn":
                _exit(n, sp, live(tp.heads), rep * (runs + 1),
                      rep * (runs + 1))
            elif spec.kind == "mamba":
                c = live(tp.inner)
                _exit(n, sp, c, rep * (runs + 1), rep * (runs + 1))
                n["all-reduce"] += rep * (runs + 1) * c     # x_proj's
            elif spec.kind == "rwkv":
                c = live(tp.rwkv)
                _exit(n, sp, c, rep * (runs + 1), rep * (runs + 1))
                _exit(n, sp, c, rep * (runs + 1), rep)   # the channel mix
                n["reduce-scatter"] += rep * runs * c
                n["all-gather"] += rep * (runs - (cfg.remat and last)
                                          + 1) * c
            if spec.mlp == "dense":
                recomputed = runs - (not tail)
                _exit(n, sp, live(tp.ff), rep * (runs + 1),
                      rep * (recomputed + 1))
            if spec.mlp == "moe":
                moe = MOE.ep_plan(
                    cfg, tp, lay.spec(("batch",), (batch,))[0],
                    batch * seq, train=True).collectives(
                        train=True, recompute=runs - 1, recompute_out=tail)
                for k, v in moe.items():
                    n[k] = n.get(k, 0) + rep * v
    return {k: v for k, v in n.items() if v}
