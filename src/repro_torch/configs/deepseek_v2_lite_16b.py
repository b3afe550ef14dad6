"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MLA + fine-grained MoE.

27 layers, d_model 2048, 16 heads, MLA (kv_lora 512, nope 128, rope 64,
v 128), vocab 102400.  MoE: 64 routed experts top-6 + 2 shared experts,
d_expert 1408, first layer dense (first_k_dense_replace=1).

Assignment-line discrepancy (DESIGN.md §4): the bracket mentions "160 routed"
which belongs to full V2; Lite has 64 routed — we follow Lite's model card,
matching the "MoE 64e top-6" figure.  d_ff per the assignment equals the
expert hidden size (1408), the same convention the Mixtral line uses.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MLA: a single latent serves all heads; field unused
        d_ff=10944,  # dense FFN of the first (non-MoE) layer, per model card
        vocab_size=102400,
        mlp_type="swiglu",
        attn_impl="mla",
        mla=MLAConfig(
            kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
            nope_head_dim=128, v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=64, top_k=6, d_expert=1408, n_shared=2,
            layer_mode="after_first", gate_mode="topk_softmax",
        ),
        first_k_dense=1,
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        attn_impl="mla",
        mla=MLAConfig(
            kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32, v_head_dim=32
        ),
        moe=MoEConfig(
            n_experts=4, top_k=2, d_expert=64, n_shared=1,
            layer_mode="after_first", gate_mode="topk_softmax",
            capacity_factor=4.0,
        ),
        first_k_dense=1,
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
