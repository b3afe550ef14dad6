"""Granite-20B (code) [arXiv:2405.04324] — llama-arch dense decoder with MQA.

52 layers, d_model 6144, 48 heads (kv=1, i.e. multi-query), d_ff 24576,
vocab 49152.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "granite-20b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        mlp_type="swiglu",
        rope_theta=10000.0,
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=1,
        head_dim=16,
        d_ff=512,
        vocab_size=512,
        mlp_type="swiglu",
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
