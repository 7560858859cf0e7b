"""The 10 assigned architectures, exact configs from the assignment table
(the port's own copy of ``repro.configs.archs``).

Sources noted per entry; every dimension below matches the assignment block.
"""
from __future__ import annotations

from .base import LayerSpec, ModelConfig, uniform_groups

ATTN = LayerSpec(kind="attn", attn_type="global", mlp="dense")


def musicgen_large() -> ModelConfig:
    # [audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
    # decoder-only over EnCodec tokens [arXiv:2306.05284]. 4 codebook streams;
    # the EnCodec frontend is a stub (token ids in, summed embeddings).
    return ModelConfig(
        name="musicgen-large", family="audio",
        d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048,
        groups=uniform_groups(ATTN, 48),
        mlp_act="gelu", n_codebooks=4,
    )


def granite_moe_1b() -> ModelConfig:
    # [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
    # [hf:ibm-granite/granite-3.0-1b-a400m-base]
    moe_layer = LayerSpec(kind="attn", attn_type="global", mlp="moe")
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155,
        groups=uniform_groups(moe_layer, 24),
        n_experts=32, moe_top_k=8, moe_d_ff=512,
        tie_embeddings=True,
    )


def kimi_k2_1t() -> ModelConfig:
    # [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
    # MoE 384e top-8 [arXiv:2501.kimi2] — trillion-param MoE (paper-table).
    moe_layer = LayerSpec(kind="attn", attn_type="global", mlp="moe")
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
        d_ff=2048, vocab_size=163840,
        groups=(((ATTN,), 1), ((moe_layer,), 60)),   # first layer dense
        n_experts=384, moe_top_k=8, moe_d_ff=2048,
        optimizer="adafactor",
    )


def minitron_4b() -> ModelConfig:
    # [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
    # pruned nemotron [arXiv:2407.14679]; squared-ReLU non-gated MLP.
    return ModelConfig(
        name="minitron-4b", family="dense",
        d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=9216, vocab_size=256000,
        groups=uniform_groups(ATTN, 32),
        mlp_act="relu2",
    )


def qwen2_1_5b() -> ModelConfig:
    # [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
    # GQA, QKV bias [arXiv:2407.10671]; tied embeddings.
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        groups=uniform_groups(ATTN, 28),
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    )


def internlm2_1_8b() -> ModelConfig:
    # [dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92544,
        groups=uniform_groups(ATTN, 24),
        rope_theta=1_000_000.0,
    )


def gemma2_27b() -> ModelConfig:
    # [dense] 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
    # local+global alternating, logit softcap [arXiv:2408.00118].
    local = LayerSpec(kind="attn", attn_type="local", mlp="dense")
    return ModelConfig(
        name="gemma2-27b", family="dense",
        d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab_size=256000,
        groups=(((local, ATTN), 23),),
        mlp_act="geglu",
        attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
        use_post_norms=True,
    )


def llama32_vision_11b() -> ModelConfig:
    # [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
    # cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].
    # Pattern: every 5th layer cross-attends to precomputed patch embeddings
    # (vision tower is a stub per the assignment).
    cross = LayerSpec(kind="attn", attn_type="cross", mlp="dense")
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256,
        groups=(((cross, ATTN, ATTN, ATTN, ATTN), 8),),
        rope_theta=500_000.0, n_vision_tokens=1600,
    )


def jamba_1_5_large() -> ModelConfig:
    # [hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
    # MoE 16e top-2 — Mamba+attn 1:7 interleave [arXiv:2403.19887].
    # Period of 8: attn at index 3, mamba elsewhere; MoE on odd layers.
    m_d = LayerSpec(kind="mamba", mlp="dense")
    m_e = LayerSpec(kind="mamba", mlp="moe")
    a_e = LayerSpec(kind="attn", attn_type="global", mlp="moe")
    period = (m_d, m_e, m_d, a_e, m_d, m_e, m_d, m_e)
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=65536,
        groups=((period, 9),),
        n_experts=16, moe_top_k=2, moe_d_ff=24576,
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        optimizer="adafactor",
    )


def rwkv6_1_6b() -> ModelConfig:
    # [ssm] 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
    # RWKV-6 "Finch" — data-dependent decay [arXiv:2404.05892].
    rwkv = LayerSpec(kind="rwkv", mlp="none")
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=7168, vocab_size=65536,
        groups=uniform_groups(rwkv, 24),
        rwkv_head_dim=64,
    )


ARCHS = {
    "musicgen-large": musicgen_large,
    "granite-moe-1b-a400m": granite_moe_1b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "minitron-4b": minitron_4b,
    "qwen2-1.5b": qwen2_1_5b,
    "internlm2-1.8b": internlm2_1_8b,
    "gemma2-27b": gemma2_27b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "rwkv6-1.6b": rwkv6_1_6b,
}
