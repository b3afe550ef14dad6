"""Qwen2-VL-2B [arXiv:2409.12191] — VLM decoder with M-RoPE + QKV bias.

28 layers, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
The ViT vision encoder + projector is a stub, as in the reference:
``input_specs()`` supplies precomputed patch embeddings (B, n_patches,
d_model) that prefix the token stream; M-RoPE position ids (3, B, S) give
patch tokens distinct height/width coordinates.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-vl-2b"

# Stub vision frontend: patches prefix 1/8 of the sequence budget.
PATCHES_PER_SEQ_DIV = 8


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # t/h/w sections of head_dim//2 = 64
        modality="vlm",
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        qkv_bias=True,
        mrope_sections=(4, 6, 6),  # head_dim//2 = 16
        modality="vlm",
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
