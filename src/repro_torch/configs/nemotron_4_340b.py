"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA decoder, squared-ReLU MLP.

96 layers, d_model 18432, 96 heads (GQA kv=8), d_ff 73728, vocab 256000.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "nemotron-4-340b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        mlp_type="squared_relu",
        rope_theta=10000.0,
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    """Smoke-test variant: same family (GQA + squared-ReLU), tiny dims."""
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=512,
        vocab_size=512,
        mlp_type="squared_relu",
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
