"""Jamba-v0.1 (52B) [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE.

32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 65536,
MoE 16 experts top-2 on every other layer.  Period of 8 layers contains one
attention mixer (position 4, matching the paper's 1:7 ratio) and 7 Mamba
mixers.

Hardware adaptation (DESIGN.md): Jamba ships Mamba-1 (S6, d_state 16); the
zoo substitutes Mamba-2 SSD blocks (d_state 128, head_dim 64) — the
chunked-scan formulation the SSD scan kernel (K7) runs.
Jamba uses no explicit positional encoding (``rope`` disabled for its
attention layers).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

ARCH_ID = "jamba-v0.1-52b"

HYBRID_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        mlp_type="swiglu",
        hybrid_period=HYBRID_PERIOD,
        moe=MoEConfig(
            n_experts=16, top_k=2, d_expert=14336, layer_mode="every_2",
        ),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        hybrid_period=("mamba", "attn"),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=256, layer_mode="every_2", capacity_factor=4.0),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
