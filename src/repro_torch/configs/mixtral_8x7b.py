"""Mixtral-8x7B [arXiv:2401.04088] — MoE (8 experts top-2) + sliding-window
attention.

32 layers, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
window 4096.  SWA bounds the KV cache, so the long_500k decode shape runs.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x7b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        mlp_type="swiglu",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            n_experts=8, top_k=2, d_expert=14336, layer_mode="all",
            gate_mode="softmax_topk",
        ),
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=256, layer_mode="all", capacity_factor=4.0),
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
