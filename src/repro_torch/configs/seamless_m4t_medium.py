"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder multimodal backbone.

12 encoder + 12 decoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206.  The speech frontend (mel + conformer feature extractor) is a
stub, as in the reference: the encoder consumes precomputed frame
embeddings of shape (B, T_frames, d_model) provided by ``input_specs()``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "seamless-m4t-medium"

# Stub frontend: ~50 frames/sec after conv subsampling; we expose the frame
# count as a fraction of the text sequence length in input_specs.
FRAMES_PER_SEQ_DIV = 4  # T_frames = seq_len // 4


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        is_enc_dec=True,
        n_encoder_layers=12,
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        mlp_type="gelu",
        modality="audio",
        dtype=dtype,
    )


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced",
        arch_type="audio",
        is_enc_dec=True,
        n_encoder_layers=2,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_type="gelu",
        modality="audio",
        dtype=dtype,
        attn_chunk=64,
        remat=False,
    )
