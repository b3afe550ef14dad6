"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense GQA decoder with QK-norm.

36 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 12288, vocab 151936.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-8b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        mlp_type="swiglu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        dtype=dtype,
    )


def sliding_window_variant(dtype: str = "bfloat16", window: int = 4096) -> ModelConfig:
    """Sliding-window attention over a bounded rolling KV cache."""
    return dataclasses.replace(config(dtype), name=ARCH_ID + "-swa", sliding_window=window)


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
        qk_norm=True,
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
