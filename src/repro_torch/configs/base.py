"""Model configuration schema (the port's own copy of ``repro.configs.base``).

A model is a stack of *groups*; each group is a repeating *period* of layer
specs (e.g. gemma2 = [(local, global)] × 23, jamba = one 8-layer period × 9).
The PyTorch model keeps each group's parameters stacked with a leading layer
dim, so parameter names and shapes match the JAX package one for one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # "attn" | "mamba" | "rwkv"
    attn_type: str = "global"   # "global" | "local" | "cross"
    mlp: str = "dense"          # "dense" | "moe" | "none"


Group = Tuple[Tuple[LayerSpec, ...], int]   # (period, repeat)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: Tuple[Group, ...]

    # attention options
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    use_post_norms: bool = False          # gemma2-style post-block norms

    # mlp
    mlp_act: str = "swiglu"               # swiglu | gelu | relu2

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "capacity"            # capacity | dense (oracle)
    # >0: GShard group-capacity dispatch — index math + gathers batched over
    # this many token blocks so SPMD partitions them locally (§Perf lever)
    moe_block_dispatch: int = 0

    # Mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # RWKV
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # modality frontends (stubs)
    n_codebooks: int = 0                  # musicgen EnCodec streams
    n_vision_tokens: int = 0              # llama-vision patch embeddings

    tie_embeddings: bool = False
    # pad the vocab so it divides the model-parallel axis (perf lever:
    # un-shardable vocabs replicate the logits compute; see §Perf)
    vocab_pad_to: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    optimizer: str = "adamw"              # adamw | adafactor
    remat: bool = True

    # --- derived -----------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(len(period) * rep for period, rep in self.groups)

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_attention_free(self) -> bool:
        return all(spec.kind != "attn"
                   for period, _ in self.groups for spec in period)

    @property
    def has_subquadratic_context(self) -> bool:
        """True if long-context decode (500K) is feasible: any non-attn layer
        or sliding-window keeps the dominant state sub-linear in context."""
        kinds = [spec for period, _ in self.groups for spec in period]
        if any(s.kind in ("mamba", "rwkv") for s in kinds):
            return True
        if self.sliding_window is not None:
            return True
        return False

    def layer_specs(self):
        for period, rep in self.groups:
            for _ in range(rep):
                yield from period

    def param_count(self) -> int:
        """Exact parameter count of the port's model (built on the meta
        device, so nothing is allocated)."""
        from repro_torch.models import transformer
        return transformer.count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token passes through: expert weights count top_k of
        n_experts (``transformer.count_params(active_only=True)``)."""
        from repro_torch.models import transformer
        return transformer.count_params(self, active_only=True)

    def reduced(self, *, repeat_cap: int = 2, d_model: int = 64,
                vocab: int = 128) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = 4
        kv = max(1, min(self.n_kv_heads, 2))
        rwkv_hd = 16
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=d_model * 2,
            vocab_size=vocab,
            groups=tuple((period, min(rep, repeat_cap))
                         for period, rep in self.groups),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=d_model if self.n_experts else 0,
            mamba_dt_rank=8,
            mamba_d_state=8,
            rwkv_head_dim=rwkv_hd,
            rwkv_lora_decay=8,
            rwkv_lora_mix=8,
            sliding_window=(32 if self.sliding_window is not None else None),
            n_vision_tokens=16 if self.n_vision_tokens else 0,
            dtype="float32",
            param_dtype="float32",
        )


def uniform_groups(spec: LayerSpec, n_layers: int) -> Tuple[Group, ...]:
    return (((spec,), n_layers),)
