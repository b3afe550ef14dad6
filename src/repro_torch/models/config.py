"""Model configuration of the LM zoo (the twin of ``repro.models.config``).

Only the fields the served decoder-only text models use are ported: dense
GQA decoders with QK-norm (Qwen3) and attention-free Mamba-2 SSD stacks.
The other families of the reference (MoE, MLA, hybrid, encoder-decoder,
VLM) raise ``NotImplementedError`` in :mod:`repro_torch.models.transformer`,
naming the ROADMAP item they wait for.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # SSD "P"
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | ssm (moe | hybrid | audio | vlm are not ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    attn_impl: str = "gqa"  # gqa | none (pure SSM); mla is not ported
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_logit_softcap: Optional[float] = None
    mlp_type: str = "swiglu"
    moe: Optional[object] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[object] = None
    hybrid_period: Optional[Tuple[str, ...]] = None
    first_k_dense: int = 0
    is_enc_dec: bool = False
    n_encoder_layers: int = 0
    modality: str = "text"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"
    attn_chunk: int = 1024
    remat: bool = True
    init_scale: float = 0.02

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def layer_kinds(self) -> List[str]:
        """Mixer kind per decoder layer ('attn' | 'mamba')."""
        if self.hybrid_period:
            period = list(self.hybrid_period)
            return period * (self.n_layers // len(period))
        if self.arch_type == "ssm":
            return ["mamba"] * self.n_layers
        return ["attn"] * self.n_layers

    def ffn_kinds(self) -> List[str]:
        """FFN kind per decoder layer ('dense' | 'none'; MoE is not ported)."""
        if self.arch_type == "ssm":
            return ["none"] * self.n_layers
        if self.moe is not None:
            raise NotImplementedError("MoE layers are not ported yet (ROADMAP A14)")
        return ["dense"] * self.n_layers

    def scan_period(self) -> int:
        """Length of the repeating layer pattern (1 for the ported stacks)."""
        if self.hybrid_period:
            return len(self.hybrid_period)
        return 1

    def param_count(self) -> int:
        """Parameters of the ported families (embedding included, no biases)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        for kind, ffn in zip(self.layer_kinds(), self.ffn_kinds()):
            if kind == "attn":
                n += 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            else:
                s = self.ssm
                d_in = s.expand * d
                n += d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
                n += s.d_conv * (d_in + 2 * s.n_groups * s.d_state) + d_in * d
            if ffn == "dense":
                n += (3 if self.mlp_type == "swiglu" else 2) * d * f
        return n
