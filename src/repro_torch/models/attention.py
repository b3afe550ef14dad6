"""GQA attention with QK-norm and sliding windows: prefill through the
flash-attention kernel (K6), decode against a KV cache in plain PyTorch.

The reference's prefill core (``repro.models.attention.attention_core``)
computes full or chunked scores in jnp; the port routes it to
:func:`repro_torch.kernels.flash_attention.flash_attention`, which computes
the same masked softmax online (and on the CPU runs its plain version).
Decode stays plain PyTorch, as in the reference, which has no decode
kernel.  MLA (DeepSeek) is not ported (ROADMAP A14).

Caches are updated in place (the reference returns new arrays): the engine
keeps one slot-stacked cache and every write lands in it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, normal_init, rms_norm, vec
from repro_torch.models.rope import apply_rope

Tensor = torch.Tensor
NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype, stack: tuple = ()) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    s = cfg.init_scale
    dev = gen.device
    p = {
        "wq": normal_init(gen, stack + (d, h, hd), s, dtype),
        "wk": normal_init(gen, stack + (d, hkv, hd), s, dtype),
        "wv": normal_init(gen, stack + (d, hkv, hd), s, dtype),
        "wo": normal_init(gen, stack + (h, hd, d), s / math.sqrt(2 * cfg.n_layers), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(stack + (h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(stack + (hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(stack + (hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(stack + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(stack + (hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params: Dict, cfg: ModelConfig, x: Tensor, slotted: bool = False):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd), with bias and QK-norm."""
    q = linear(x, params["wq"], slotted)
    k = linear(x, params["wk"], slotted)
    v = linear(x, params["wv"], slotted)
    if cfg.qkv_bias:
        q = q + vec(params["bq"], slotted, 4).to(q.dtype)
        k = k + vec(params["bk"], slotted, 4).to(k.dtype)
        v = v + vec(params["bv"], slotted, 4).to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, vec(params["q_norm"], slotted, 4), cfg.norm_eps)
        k = rms_norm(k, vec(params["k_norm"], slotted, 4), cfg.norm_eps)
    return q, k, v


def attention_core(
    q: Tensor,  # (B, Sq, H, D)
    k: Tensor,  # (B, Sk, Hkv, D)
    v: Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    use_kernel: bool = True,
) -> Tensor:
    """Full-sequence causal attention (prefill); returns (B, Sq, H, D).

    The kernel reads the (B, S, H, D) tensors through their strides as
    (B, H, S, D) views; nothing is copied.  ``use_kernel=False`` computes the
    kernel's plain version instead (the on-card yardstick of the prefill)."""
    if not causal:
        raise NotImplementedError("non-causal attention (encoder-decoder) waits for ROADMAP A14")
    if softcap is not None:
        raise NotImplementedError("attention logit softcap is not ported (ROADMAP A14)")
    fn = flash_attention if use_kernel else kref.flash_attention_ref
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=True, window=window)
    return out.transpose(1, 2)


def decode_attention_core(
    q: Tensor,  # (B, 1, H, D)
    k_cache: Tensor,  # (B, S_cache, Hkv, D)
    v_cache: Tensor,  # (B, S_cache, Hkv, D)
    valid: Tensor,  # (B, S_cache) bool
) -> Tensor:
    """One query against the cache, as the reference's ``_sdpa``: scores in
    the input dtype, softmax in float32, probabilities cast back."""
    b, _, h, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache) * (1.0 / math.sqrt(dh))
    scores = torch.where(valid[:, None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(b, 1, h, -1)


def init_gqa_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device=None,
                   stack: tuple = ()) -> Dict:
    """KV cache; a rolling buffer of size ``window`` under SWA."""
    size = max_seq if cfg.sliding_window is None else min(max_seq, cfg.sliding_window)
    shape = stack + (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_fill_cache(cache: Dict, k: Tensor, v: Tensor) -> Dict:
    """Write prefill K/V into ``cache`` in place (the rolling tail under SWA)."""
    size, s = cache["k"].shape[1], k.shape[1]
    if s >= size:
        cache["k"].copy_(k[:, s - size:])
        cache["v"].copy_(v[:, s - size:])
    else:
        cache["k"][:, :s].copy_(k)
        cache["v"][:, :s].copy_(v)
    return cache


def gqa_decode(
    params: Dict,
    cfg: ModelConfig,
    x: Tensor,  # (B, 1, d)
    cos_sin: Tuple[Tensor, Tensor],  # tables at each row's position
    cache: Dict,
    pos: Tensor,  # (B,) int: tokens already in each row's context
    slotted: bool = False,
) -> Tensor:
    """One token per row; writes its K/V into ``cache`` at the row's own
    ``pos`` (``pos % window`` under SWA) and returns (B, 1, d)."""
    q, k, v = _project_qkv(params, cfg, x, slotted)
    q = apply_rope(q, *cos_sin)
    k = apply_rope(k, *cos_sin)
    size = cache["k"].shape[1]
    pos = pos.to(torch.long)
    # past the end of a full-attention cache the write lands on its last
    # entry, as the reference's clamped dynamic_update_slice does
    slot = pos % size if cfg.sliding_window is not None else pos.clamp(max=size - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    idx = torch.arange(size, device=x.device)[None, :]
    valid = idx <= pos[:, None]
    if cfg.sliding_window is not None:
        valid = valid | (pos[:, None] >= size)  # the rolling buffer is full once wrapped
    out = decode_attention_core(q, cache["k"], cache["v"], valid)
    b, _, h, hd = out.shape
    return linear(out.reshape(b, 1, h * hd), params["wo"].flatten(-3, -2), slotted)
