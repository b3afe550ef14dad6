"""Mamba2-370m [arXiv:2405.21060] — attention-free SSM with SSD.

48 layers, d_model 1024, ssm_state 128, head_dim 64, expand 2 (32 heads),
vocab 50280, tied embeddings.  Every layer is one Mamba-2 block (the block
subsumes the FFN).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "mamba2-370m"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=16,  # unused by the SSM path (attention-free)
        n_kv_heads=16,
        d_ff=0,
        vocab_size=50280,
        attn_impl="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=True,
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        attn_impl="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        tie_embeddings=True,
        dtype=dtype,
        remat=False,
    )
