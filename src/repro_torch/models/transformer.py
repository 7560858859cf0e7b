"""Period-grouped decoder stack (port of ``repro/models/transformer.py``) for
attention, Mamba and RWKV-6 layers with dense, MoE or no MLPs: qwen2,
internlm2, minitron, gemma2, granite-moe, kimi-k2, jamba and rwkv6.

Parameters keep the JAX names and shapes: ``embed (V, D)``, ``final_norm``,
``lm_head (D, V)`` when untied, and per group ``g{i}.{j}.<leaf>`` stacked
with a leading layer dim (e.g. ``g0.0.mixer.wq (L, D, H, Dh)``), where ``j``
is the position in the group's period. A JAX params pytree therefore
converts leaf for leaf (``from_jax_params``).

PyTorch runs eagerly, so where the JAX stack scans over layers this one
loops over views of the stacked tensors, and decode writes each layer's new
K/V, and each recurrent layer's new state, into the cache in place
(committed mode).

Caches mirror the JAX structure: ``{"g{i}": ({"mixer": {...}}, ...)}``.
Attention layers hold ``k``/``v`` (L, B, S, KVH, Dh); Mamba layers ``h``
(L, B, Din, N) fp32 and ``conv`` (L, B, K-1, Din); RWKV layers ``wkv``
(L, B, H, K, K) fp32, ``shift_tm`` and ``shift_cm`` (L, B, D).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

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
    if cfg.n_codebooks or cfg.n_vision_tokens:
        raise NotImplementedError(f"{cfg.name}: codebook / vision frontends "
                                  "are not ported")
    for spec in cfg.layer_specs():
        if spec.kind not in ("attn", "mamba", "rwkv"):
            raise NotImplementedError(f"{cfg.name}: {spec.kind} layers are "
                                      "not ported")
        if spec.kind == "attn" and spec.attn_type == "cross":
            raise NotImplementedError(f"{cfg.name}: cross-attention is not "
                                      "ported")
        if spec.mlp not in ("dense", "moe", "none"):
            raise NotImplementedError(f"{cfg.name}: {spec.mlp} MLP layers "
                                      "are not ported")


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
        self.embed = nn.Parameter(init((V, D), 0.02), requires_grad=False)
        self.final_norm = nn.Parameter(init((D,), None), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(init((D, V), 0.02),
                                        requires_grad=False)
        for gi, (period, rep) in enumerate(cfg.groups):
            self.add_module(f"g{gi}", nn.ModuleList(
                [_LayerStack(cfg, spec, rep, init) for spec in period]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- pieces ----------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.to(getattr(torch, self.cfg.dtype))[tokens]

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = h @ self.embed.to(h.dtype).T
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
               positions=None, cache=None, lengths=None, impl=None):
        """One layer. ``cache`` None: prefill (attention returns its K/V,
        a recurrent layer starts from a zero state); else this layer's
        cache views (decode: attention writes K/V into them). Returns (x,
        the layer's new K/V or recurrent state)."""
        cfg = self.cfg
        h_in = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.kind == "attn":
            if cache is None:
                mix_out, new = L.attention_forward(
                    cfg, spec, p["mixer"], h_in, positions=positions,
                    impl=impl)
            else:
                mix_out, new = L.attention_decode(cfg, spec, p["mixer"],
                                                  h_in, cache, lengths,
                                                  impl=impl)
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
                return x + cm_out, {**new, **cm_new}
        if cfg.use_post_norms:
            mix_out = L.rms_norm(mix_out, p["post_norm1"], cfg.norm_eps)
        x = x + mix_out
        if spec.mlp == "none":
            return x, new
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.mlp == "moe":      # aux losses are for training: dropped
            mlp_out, _ = MOE.moe_forward(cfg, p["mlp"], h2, impl=impl)
        else:
            mlp_out = L.mlp_forward(cfg, p["mlp"], h2)
        if cfg.use_post_norms:
            mlp_out = L.rms_norm(mlp_out, p["post_norm2"], cfg.norm_eps)
        return x + mlp_out, new

    def _groups(self):
        for gi, (period, rep) in enumerate(self.cfg.groups):
            stacks = getattr(self, f"g{gi}")
            yield gi, period, rep, [s.per_layer() for s in stacks]

    # -- entry points ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, impl: Optional[str] = None):
        """Full-sequence pass over tokens (B, S). Returns (logits (B, S, V),
        cache) with cache capacity == S."""
        h = self._embed(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        caches = {}
        for gi, period, rep, views in self._groups():
            per_pos = [[] for _ in period]
            for r in range(rep):
                for li, spec in enumerate(period):
                    h, new = self._layer(spec, views[li][r], h,
                                         positions=positions, impl=impl)
                    per_pos[li].append(new)
            caches[f"g{gi}"] = tuple(
                {"mixer": {name: torch.stack([st[name] for st in sts])
                           for name in sts[0]}}
                for sts in per_pos)
        h = L.rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._unembed(h), caches

    def forward(self, tokens: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
        """Logits (B, S, V) of a full-sequence pass."""
        return self.prefill(tokens, impl=impl)[0]

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, *, append: bool = False,
                    impl: Optional[str] = None):
        """One decode step. tokens (B,); lengths (B,) tokens already in the
        cache (the position of the new token). Writes each attention layer's
        new K/V and each recurrent layer's new state into ``cache`` IN
        PLACE and returns (logits (B, V), cache).

        Lengths given on the CPU are bounds-checked before anything is
        written (on the device an out-of-range write would be a device-side
        fault): never negative, and below the capacity of the first
        attention layer's cache where the config has one (a recurrent state
        has no capacity)."""
        if append:
            raise NotImplementedError(
                "append-mode decode is not ported; use append=False")
        if lengths.device.type == "cpu":
            max_seq = _attention_capacity(self.cfg, cache)
            if bool(((lengths < 0) | (lengths >= max_seq)).any()):
                raise ValueError(f"lengths {lengths.tolist()} outside the "
                                 f"cache's [0, {max_seq})")
        h = self._embed(tokens[:, None])
        lengths = lengths.to(device=h.device, dtype=torch.int64)
        for gi, period, rep, views in self._groups():
            for r in range(rep):
                for li, spec in enumerate(period):
                    layer_cache = {name: t[r] for name, t in
                                   cache[f"g{gi}"][li]["mixer"].items()}
                    h, new = self._layer(spec, views[li][r], h,
                                         cache=layer_cache, lengths=lengths,
                                         impl=impl)
                    if spec.kind != "attn":
                        for name, t in new.items():
                            if t is not layer_cache[name]:  # in place
                                layer_cache[name].copy_(t)
        h = L.rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._unembed(h)[:, 0], cache


def _attention_capacity(cfg: ModelConfig, cache: dict) -> float:
    """Positions the first attention layer's cache holds; unbounded in an
    attention-free config."""
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            if spec.kind == "attn":
                return cache[f"g{gi}"][li]["mixer"]["k"].shape[2]
    return float("inf")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """Zeroed decode cache: attention K/V in the model dtype, recurrent
    states as ``ssm.init_state``."""
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
    every attention layer's K/V, and every recurrent state whole (the
    prefill must have run on exactly ``length`` tokens for that state to be
    the prompt's). Returns ``cache``."""
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            dst = cache[f"g{gi}"][li]["mixer"]
            src = prefill_cache[f"g{gi}"][li]["mixer"]
            for name, d in dst.items():
                if spec.kind == "attn":
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


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def from_jax_params(cfg: ModelConfig, params, *, device="cuda") -> Transformer:
    """Build a Transformer from a JAX params pytree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``). Names, shapes and dtypes
    must match leaf for leaf."""
    model = Transformer(cfg, device="meta")
    own = dict(model.named_parameters())
    given = dict(_flatten(params))
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
