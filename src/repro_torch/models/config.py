"""Model configuration of the LM zoo (the twin of ``repro.models.config``).

Every family of the reference is ported: dense GQA / MQA decoders (QK-norm,
QKV bias, sliding windows), MoE (Mixtral; DeepSeek's fine-grained experts
with shared ones), MLA (DeepSeek-V2), attention-free Mamba-2 SSD stacks,
hybrid Mamba/attention stacks (Jamba), the encoder-decoder (SeamlessM4T,
``arch_type="audio"``, ``is_enc_dec``) and the VLM decoder with M-RoPE
(Qwen2-VL, ``arch_type="vlm"``), the attention logit softcap on any of
them, and both of the reference's remat policies (``"full"``, ``"dots"``).
:func:`config_to_dict` and
:func:`config_from_dict` give the reference's JSON form (checkpoint
manifests carry it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    n_shared: int = 0  # shared (always-on) experts, DeepSeek-style
    # which layers are MoE: "all" | "every_2" (odd layers) | "after_first"
    layer_mode: str = "all"
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # router weight normalisation: "softmax_topk" (Mixtral: softmax over the
    # selected logits) | "topk_softmax" (DeepSeek: softmax first, renormalise)
    gate_mode: str = "softmax_topk"


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
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => direct q projection (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    attn_impl: str = "gqa"  # gqa | mla | none (pure SSM)
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_logit_softcap: Optional[float] = None
    mlp_type: str = "swiglu"  # swiglu | squared_relu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid_period: Optional[Tuple[str, ...]] = None
    first_k_dense: int = 0  # DeepSeek: the first k layers use a dense FFN
    is_enc_dec: bool = False  # SeamlessM4T: an encoder stack before the decoder
    n_encoder_layers: int = 0
    modality: str = "text"  # text | audio | vlm (the frontends are stubs: frames, patches)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"
    attn_chunk: int = 1024
    remat: bool = True  # recompute each period's activations in the backward pass
    # full | dots (keep the outputs of the unbatched matmuls, recompute the rest)
    remat_policy: str = "full"
    loss_chunk: int = 0  # >0: cross-entropy over sequence chunks of this length
    init_scale: float = 0.02

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def layer_kinds(self) -> List[str]:
        """Mixer kind per decoder layer ('attn' | 'mamba')."""
        if self.hybrid_period:
            period = list(self.hybrid_period)
            assert self.n_layers % len(period) == 0
            return period * (self.n_layers // len(period))
        if self.arch_type == "ssm":
            return ["mamba"] * self.n_layers
        return ["attn"] * self.n_layers

    def ffn_kinds(self) -> List[str]:
        """FFN kind per decoder layer ('dense' | 'moe' | 'none')."""
        if self.arch_type == "ssm":
            return ["none"] * self.n_layers  # the Mamba-2 block subsumes the FFN
        if self.moe is None:
            return ["dense"] * self.n_layers
        mode = self.moe.layer_mode
        kinds = []
        for layer in range(self.n_layers):
            if mode == "all":
                kinds.append("moe")
            elif mode == "every_2":
                kinds.append("moe" if layer % 2 == 1 else "dense")
            elif mode == "after_first":
                kinds.append("dense" if layer < self.first_k_dense else "moe")
            else:
                raise ValueError(mode)
        return kinds

    def scan_period(self) -> int:
        """Length of the repeating layer pattern after the ``first_k_dense``
        head (the unit of the stacked parameter layout)."""
        body = self.n_layers - self.first_k_dense
        if self.hybrid_period:
            p = len(self.hybrid_period)
            if self.moe is not None and self.moe.layer_mode == "every_2":
                p = max(p, 2) if p % 2 == 0 else p * 2
            assert body % p == 0
            return p
        if self.moe is not None and self.moe.layer_mode == "every_2":
            assert body % 2 == 0
            return 2
        return 1

    def supports_long_decode(self) -> bool:
        """Sub-quadratic or bounded-cache decode (SSM, hybrid, sliding window)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding included, biases ignored),
        the reference's formula term for term."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        mult = 3 if self.mlp_type == "swiglu" else 2
        n = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind == "attn" and self.attn_impl == "mla":
                m = self.mla
                n += d * self.n_heads * (m.nope_head_dim + m.rope_head_dim)  # q
                n += d * (m.kv_lora_rank + m.rope_head_dim)  # down
                n += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)  # up
                n += self.n_heads * m.v_head_dim * d  # out
            elif kind == "attn":
                n += 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            else:
                s = self.ssm
                d_in = s.expand * d
                n += d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
                n += s.d_conv * (d_in + 2 * s.n_groups * s.d_state) + d_in * d
        for ffn in self.ffn_kinds():
            if ffn == "dense":
                n += mult * d * f
            elif ffn == "moe":
                mo = self.moe
                n += (mo.n_experts + mo.n_shared) * mult * d * mo.d_expert
                n += d * mo.n_experts  # router
        if self.is_enc_dec:
            n += self.n_encoder_layers * (4 * d * self.n_heads * hd + 3 * d * f)
            n += self.n_layers * 4 * d * self.n_heads * hd  # cross-attention
        return n

    def active_param_count(self) -> int:
        """Parameters a token passes through: an MoE layer counts its top-k
        routed experts and the shared ones only."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * self.d_model * mo.d_expert
        n_moe = self.ffn_kinds().count("moe")
        return self.param_count() - n_moe * (mo.n_experts - mo.top_k) * per_expert


# ---------------------------------------------------------------------------
# JSON round trip (checkpoint manifests carry the model config)
# ---------------------------------------------------------------------------


def config_to_dict(cfg: ModelConfig) -> dict:
    """JSON-serialisable form of a :class:`ModelConfig` (sub-configs become
    dicts), the reference's key for key and in its order.  The port runs no
    layer scan, so the reference's ``scan_unroll`` is written as a
    constant."""
    out = {}
    for key, value in dataclasses.asdict(cfg).items():
        out[key] = value
        if key == "loss_chunk":
            out["scan_unroll"] = False
    return out


def config_from_dict(d: dict) -> ModelConfig:
    """Inverse of :func:`config_to_dict`: rebuilds the MoE, SSM and MLA
    sub-configs and the tuple fields JSON turned into lists.  The
    reference's ``scan_unroll`` (a dry-run flag of its layer scan) is
    dropped."""
    d = dict(d)
    d.pop("scan_unroll", None)
    if d.get("moe") is not None:
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("mla") is not None:
        d["mla"] = MLAConfig(**d["mla"])
    if d.get("ssm") is not None:
        s = dict(d["ssm"])
        if s.get("a_init_range") is not None:
            s["a_init_range"] = tuple(s["a_init_range"])
        d["ssm"] = SSMConfig(**s)
    for k in ("mrope_sections", "hybrid_period"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ModelConfig(**d)
