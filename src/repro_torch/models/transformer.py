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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import named, nest
from repro_torch.configs.base import LayerSpec, ModelConfig
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
    group's ``rep`` repeats."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, rep: int, init):
        super().__init__()
        D = cfg.d_model

        def norm():
            return nn.Parameter(init((rep, D), None), requires_grad=False)

        self.rep = rep
        self.norm1 = norm()
        if spec.kind == "mamba":
            self.mixer = _params(SSM.init_mamba(cfg, rep, init))
        elif spec.kind == "rwkv":
            self.mixer = _params(SSM.init_rwkv(cfg, rep, init))
        else:
            self.mixer = _params(L.init_attention(cfg, spec, rep, init))
        # an RWKV layer's norm2 feeds its channel mix; it has no mlp
        if spec.kind == "rwkv" or spec.mlp != "none":
            self.norm2 = norm()
        if spec.kind != "rwkv" and spec.mlp != "none":
            self.mlp = _params(MOE.init_moe(cfg, rep, init)
                               if spec.mlp == "moe"
                               else L.init_mlp(cfg, rep, init))
        if cfg.use_post_norms:
            self.post_norm1 = norm()
            self.post_norm2 = norm()

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
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        pd = getattr(torch, cfg.param_dtype)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)

        def init(shape, std, dtype=None, *, fill=1.0):
            """std None: ``fill`` in fp32 (a number, or a tensor broadcast
            over the leading dims): norm scales and the recurrent layers'
            fp32 constants; 0.0: zeros; else normal weights in ``dtype``
            (the param dtype when None)."""
            if std is None:
                out = torch.empty(shape, dtype=torch.float32, device=dev)
                return out.copy_(torch.as_tensor(fill, dtype=torch.float32))
            dt = pd if dtype is None else dtype
            if dev.type == "meta" or std == 0.0:
                return torch.zeros(shape, dtype=dt, device=dev)
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return w.mul_(std).to(dt)     # in place: one fp32 temporary

        self.cfg = cfg
        D, V = cfg.d_model, _padded_vocab(cfg)
        C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        self.embed = nn.Parameter(init(C + (V, D), 0.02),
                                  requires_grad=False)
        if cfg.n_vision_tokens:
            self.vision_proj = nn.Parameter(init((D, D), D ** -0.5),
                                            requires_grad=False)
        self.final_norm = nn.Parameter(init((D,), None), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(init(C + (D, V), 0.02),
                                        requires_grad=False)
        for gi, (period, rep) in enumerate(cfg.groups):
            self.add_module(f"g{gi}", nn.ModuleList(
                [_LayerStack(cfg, spec, rep, init) for spec in period]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- pieces ----------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S), or (B, S, C) with codebooks: the C embeddings
        summed in codebook order."""
        emb = self.embed.to(getattr(torch, self.cfg.dtype))
        if self.cfg.n_codebooks:
            return sum(emb[c][tokens[..., c]]
                       for c in range(self.cfg.n_codebooks))
        return emb[tokens]

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, Vp), or (B, S, C, Vp) with codebooks; padded vocab
        rows masked to -1e30."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = h @ self.embed.to(h.dtype).T
        elif cfg.n_codebooks:
            logits = torch.einsum("bsd,cdv->bscv", h,
                                  self.lm_head.to(h.dtype))
        else:
            logits = h @ self.lm_head.to(h.dtype)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(
                logits.float() / cfg.final_softcap).to(logits.dtype)
        if logits.shape[-1] != cfg.vocab_size:
            # mask padded vocab rows out of the softmax (and argmax sampling)
            pad = torch.arange(logits.shape[-1], device=logits.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _layer(self, spec: LayerSpec, p: dict, x: torch.Tensor, *,
               positions=None, cache=None, lengths=None, append=False,
               vision_kv=None, impl=None):
        """One layer. ``cache`` None: prefill (attention returns its K/V,
        a cross layer that of ``vision_kv``, a recurrent layer starts from
        a zero state); else this layer's cache views (decode: attention
        writes K/V into them, or with ``append`` returns its {"k_new",
        "v_new"}). Returns (x, the layer's new K/V, deltas or recurrent
        state, its MoE aux losses or None)."""
        cfg = self.cfg
        h_in = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.kind == "attn":
            if cache is None:
                mix_out, new = L.attention_forward(
                    cfg, spec, p["mixer"], h_in, positions=positions,
                    vision_kv=vision_kv, impl=impl)
            else:
                mix_out, new = L.attention_decode(cfg, spec, p["mixer"],
                                                  h_in, cache, lengths,
                                                  append=append, impl=impl)
        else:
            st = cache if cache is not None else SSM.init_state(
                cfg, spec, x.shape[0], x.dtype, x.device)
            # decode: the scan writes the new state into the cache slot
            in_place = cache is not None
            if spec.kind == "mamba":
                mix_out, new = SSM.mamba_forward(
                    cfg, p["mixer"], h_in, st, impl=impl, in_place=in_place)
            else:      # rwkv: time mix, then channel mix, no mlp
                mix_out, new = SSM.rwkv_time_mix(
                    cfg, p["mixer"], h_in, st, impl=impl, in_place=in_place)
                x = x + mix_out
                h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
                cm_out, cm_new = SSM.rwkv_channel_mix(cfg, p["mixer"], h2,
                                                      st)
                return x + cm_out, {**new, **cm_new}, None
        if cfg.use_post_norms:
            mix_out = L.rms_norm(mix_out, p["post_norm1"], cfg.norm_eps)
        x = x + mix_out
        if spec.mlp == "none":
            return x, new, None
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        aux = None
        if spec.mlp == "moe":
            mlp_out, aux = MOE.moe_forward(cfg, p["mlp"], h2, impl=impl)
        else:
            mlp_out = L.mlp_forward(cfg, p["mlp"], h2)
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
        vision config (which must be given them), else None."""
        if not self.cfg.n_vision_tokens:
            return None
        if vision_embeds is None:
            raise ValueError(f"{self.cfg.name}: a vision model needs "
                             "vision_embeds (B, n_vision_tokens, d_model)")
        return vision_embeds.to(device=self.device, dtype=dtype) \
            @ self.vision_proj.to(dtype)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *,
                vision_embeds: Optional[torch.Tensor] = None,
                impl: Optional[str] = None):
        """Full-sequence pass over tokens (B, S), or (B, S, C) with
        codebooks; a vision config also takes ``vision_embeds`` (B, Nv, D).
        Returns (logits (B, S, V) or (B, S, C, V), cache) with cache
        capacity == S (a cross layer's: Nv)."""
        h = self._embed(tokens)
        B, S = tokens.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        vision_kv = self._vision_kv(vision_embeds, h.dtype)
        caches = {}
        for gi, period, rep, views in self._groups():
            per_pos = [[] for _ in period]
            for r in range(rep):
                for li, spec in enumerate(period):
                    h, new, _ = self._layer(spec, views[li][r], h,
                                            positions=positions,
                                            vision_kv=vision_kv, impl=impl)
                    per_pos[li].append(new)
            caches[f"g{gi}"] = tuple(
                {"mixer": {name: torch.stack([st[name] for st in sts])
                           for name in sts[0]}}
                for sts in per_pos)
        h = L.rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._unembed(h), caches

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
                impl: Optional[str]):
        """One repeat of a group's period in training: (h, lb_loss, z_loss),
        the aux losses summed over its MoE layers (the reference's scan
        body); cross layers attend over ``vision_kv``."""
        lb = torch.zeros((), dtype=torch.float32, device=h.device)
        z = torch.zeros((), dtype=torch.float32, device=h.device)
        for spec, p in zip(period, views):
            h, _, aux = self._layer(spec, p, h, positions=positions,
                                    vision_kv=vision_kv, impl=impl)
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
        step."""
        cfg = self.cfg
        check_trainable(cfg)
        h = self._embed(tokens)
        B, S = tokens.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        vision_kv = self._vision_kv(vision_embeds, h.dtype)
        lb_tot = torch.zeros((), dtype=torch.float32, device=h.device)
        z_tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for _, period, rep, views in self._groups():
            lbs, zs = [], []
            for r in range(rep):
                args = (period, [v[r] for v in views], h, positions,
                        vision_kv, impl)
                if cfg.remat:
                    h, lb, z = checkpoint(self._period, *args,
                                          use_reentrant=False)
                else:
                    h, lb, z = self._period(*args)
                lbs.append(lb)
                zs.append(z)
            lb_tot = lb_tot + torch.stack(lbs).sum()
            z_tot = z_tot + torch.stack(zs).sum()
        h = L.rms_norm(h, self.final_norm, cfg.norm_eps)
        return self._unembed(h), {"lb_loss": lb_tot, "z_loss": z_tot}

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
        state has no capacity)."""
        if lengths.device.type == "cpu":
            max_seq = _attention_capacity(self.cfg, cache)
            if bool(((lengths < 0) | (lengths >= max_seq)).any()):
                raise ValueError(f"lengths {lengths.tolist()} outside the "
                                 f"cache's [0, {max_seq})")
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
                                            impl=impl)
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
                    leaves[name][:, bidx, lengths] = torch.stack(
                        [d[f"{name}_new"] for d in deltas[li]])
        h = L.rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._unembed(h)[:, 0], cache


def _attention_capacity(cfg: ModelConfig, cache: dict) -> float:
    """Positions the first self-attention layer's cache holds; unbounded in
    a config without one."""
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            if spec.kind == "attn" and spec.attn_type != "cross":
                return cache[f"g{gi}"][li]["mixer"]["k"].shape[2]
    return float("inf")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """Zeroed decode cache: attention K/V in the model dtype (a cross
    layer's over its n_vision_tokens positions, filled by ``cache_insert``
    from a prefill), recurrent states as ``ssm.init_state``."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = getattr(torch, cfg.dtype)

    def layer(spec, rep):
        if spec.kind == "attn":
            return L.init_attention_cache(cfg, spec, rep, batch, max_seq,
                                          cdt, dev)
        return SSM.init_state(cfg, spec, batch, cdt, dev, lead=(rep,))

    return {f"g{gi}": tuple({"mixer": layer(spec, rep)} for spec in period)
            for gi, (period, rep) in enumerate(cfg.groups)}


def cache_insert(cfg: ModelConfig, cache: dict, prefill_cache: dict,
                 slot: int, length: int) -> dict:
    """Write a single-sequence prefill cache (batch == 1) into batch slot
    ``slot`` of a decode cache, IN PLACE: the first ``length`` positions of
    every self-attention layer's K/V, and every cross layer's K/V and
    recurrent state whole (the prefill must have run on exactly ``length``
    tokens for a recurrent state to be the prompt's). Returns ``cache``."""
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


def from_jax_params(cfg: ModelConfig, params, *, device="cuda") -> Transformer:
    """Build a Transformer from a JAX params pytree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``). Names, shapes and dtypes
    must match leaf for leaf."""
    model = Transformer(cfg, device="meta")
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
    float32 (exactly)."""
    def host(p):
        t = p.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return nest({name: host(p) for name, p in model.named_parameters()})


def loss_fn(cfg: ModelConfig, model: Transformer, batch: dict, *,
            impl: Optional[str] = None):
    """Port of the reference's ``loss_fn``. batch: {"tokens", "labels"}
    (B, S) integer tensors on the model's device, (B, S, C) with codebooks,
    and for a vision config "vision_embeds" (B, Nv, D). Returns (loss,
    {"ce", "z", "lb_loss", "z_loss"}): next-token cross-entropy over fp32
    logits (padded vocab rows masked by ``_unembed``; with codebooks every
    (position, codebook) is one term of the mean), plus 1e-4 x the mean
    squared logsumexp z, 1e-2 x lb_loss and 1e-3 x the router z_loss.
    ``cfg`` must be the model's."""
    if cfg != model.cfg:
        raise ValueError(f"loss_fn: cfg {cfg.name} is not the model's")
    logits, aux = model.train_forward(
        batch["tokens"].long(), vision_embeds=batch.get("vision_embeds"),
        impl=impl)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, batch["labels"].long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    z = (lse ** 2).mean()
    loss = ce + 1e-4 * z + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"ce": ce, "z": z, **aux}
