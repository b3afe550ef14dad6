"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B card family] — dense GQA with QKV bias.

48 layers, d_model 5120, 40 heads (GQA kv=8), d_ff 13824, vocab 152064.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        qkv_bias=True,
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
