"""GQA / MQA attention (QK-norm, QKV bias, sliding windows, with or without
RoPE; causal, bidirectional or cross) and DeepSeek's Multi-head Latent
Attention (MLA): prefill through the flash-attention kernel (K6), decode
against a KV cache and the training forward (:func:`gqa_forward`,
:func:`mla_forward`, differentiable) in plain PyTorch.

The reference's prefill core (``repro.models.attention.attention_core``)
computes full or chunked scores in jnp; the port routes it to
:func:`repro_torch.kernels.flash_attention.flash_attention`, which computes
the same masked softmax online (and on the CPU runs its plain version).
MLA's prefill materialises K (the up-projected no-RoPE part beside the one
shared RoPE key) and V, with a q/k head dim (nope + rope) above V's; its
decode is the absorbed form of the reference (``W_uk`` folded into the
query, ``W_uv`` after the latent-space reduction, over the compressed
``c_kv`` / ``k_rope`` cache).  Decode stays plain PyTorch, as in the
reference, which has no decode kernel.  ``cos_sin=None`` means no RoPE
(Jamba's attention layers).

The attention logit softcap (``cfg.attn_logit_softcap``, Gemma-2's
``cap * tanh(s / cap)``) is applied on every path in the reference's order:
the scaled scores are capped, then masked, then go through the float32
softmax.  K6 caps its f32 score tiles the same way.

The encoder-decoder's attention (SeamlessM4T): its encoder runs K6 without
the causal mask (``attention_core(causal=False)``); a cross-attention takes
its keys and values from the encoder memory (``x_kv``), rotated with the
memory's own position tables (``cos_sin_kv``), as the reference does.  A
decode step's cross-attention (one query against the whole memory) is
:func:`gqa_forward` with ``causal=False``: the plain grouped form, as the
reference's, not a K6 call.

Caches are updated in place (the reference returns new arrays): the engine
keeps one slot-stacked cache and every write lands in it.

Tensor parallelism (``tp``, see :mod:`repro_torch.models.layers`): a rank
holds its share of the q heads (``wq``, ``bq``, ``wo`` by head; MLA's
``w_uk`` / ``w_uv`` too) and computes attention on them; the local head
counts come from the weights' shapes.  Where the placements hold ``wk`` /
``wv`` whole (MQA, or fewer KV heads than model ranks) every rank projects
all KV heads, caches them all as the placements give it, and attends with
those of its q heads (:func:`local_kv`).  MLA's latent projections and
cache stay whole.  ``wo``'s partial product leaves summed over the ranks.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, normal_init, rms_norm, sharded, vec
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


def spec_gqa(cfg: ModelConfig, model_axis: str = "model") -> Dict:
    """Placements: heads over ``model_axis`` (K and V replicated under MQA)."""
    mp = model_axis
    kv = (None, mp, None) if cfg.n_kv_heads > 1 else (None, None, None)
    sp = {"wq": (None, mp, None), "wk": kv, "wv": kv, "wo": (mp, None, None)}
    if cfg.qkv_bias:
        bkv = (mp, None) if cfg.n_kv_heads > 1 else (None, None)
        sp.update(bq=(mp, None), bk=bkv, bv=bkv)
    if cfg.qk_norm:
        sp.update(q_norm=(None,), k_norm=(None,))
    return sp


def spec_gqa_cache(cfg: ModelConfig, batch_axes, model_axis: str = "model") -> Dict:
    """The KV cache's placements: the batch over ``batch_axes``, the KV
    heads over ``model_axis`` (whole under MQA)."""
    kv = (batch_axes, None, model_axis if cfg.n_kv_heads > 1 else None, None)
    return {"k": kv, "v": kv}


def gqa_tp(params: Dict, cfg: ModelConfig, tp):
    """``tp`` when this layer's q heads are split over the model ranks."""
    return sharded(tp, params["wq"].shape[-2], cfg.n_heads)


def _region_params(params: Dict, tp, whole) -> Dict:
    """The layer's parameters with every leaf named in ``whole`` entered
    (a leaf held whole that a rank's share reads: its gradient is summed
    over the model ranks)."""
    if tp is None:
        return params
    return {k: tp.enter(v) if k in whole else v for k, v in params.items()}


def _project_qkv(params: Dict, cfg: ModelConfig, x: Tensor, slotted: bool = False,
                 x_kv: Optional[Tensor] = None, tp=None):
    """q (B, S, H, hd), k and v (B, S_kv, Hkv, hd), with bias and QK-norm;
    k and v project ``x_kv`` (a cross-attention's memory) when given, else
    ``x``.  Under ``tp`` (an entered ``x``) q holds this rank's heads and k
    and v the heads its placements give it (all when ``wk`` is whole)."""
    if tp is not None:
        kv_whole = params["wk"].shape[-2] == cfg.n_kv_heads
        whole = {"q_norm", "k_norm"} | ({"wk", "wv", "bk", "bv"} if kv_whole else set())
        params = _region_params(params, tp, whole)
    xkv = x if x_kv is None else x_kv
    q = linear(x, params["wq"], slotted)
    k = linear(xkv, params["wk"], slotted)
    v = linear(xkv, params["wv"], slotted)
    if cfg.qkv_bias:
        q = q + vec(params["bq"], slotted, 4).to(q.dtype)
        k = k + vec(params["bk"], slotted, 4).to(k.dtype)
        v = v + vec(params["bv"], slotted, 4).to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, vec(params["q_norm"], slotted, 4), cfg.norm_eps)
        k = rms_norm(k, vec(params["k_norm"], slotted, 4), cfg.norm_eps)
    return q, k, v


def local_kv(cfg: ModelConfig, tp, h_local: int, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """The K and V heads (dim 2) of this rank's ``h_local`` q heads.  K and V
    already split over the ranks are the rank's own; whole ones are cut to
    the KV heads of its q heads (views), each q head's own (copies) where
    the rank's heads do not fall into whole groups."""
    if tp is None or k.shape[2] != cfg.n_kv_heads:
        return k, v
    group = cfg.n_heads // cfg.n_kv_heads
    heads = torch.arange(tp.index * h_local, (tp.index + 1) * h_local) // group
    if h_local % group == 0 or group % h_local == 0:
        lo, hi = int(heads[0]), int(heads[-1]) + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = heads.to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def rope_qk(q: Tensor, k: Tensor, cos_sin) -> Tuple[Tensor, Tensor]:
    """q and k rotated by ``cos_sin``, or as they are when it is None."""
    if cos_sin is None:
        return q, k
    return apply_rope(q, *cos_sin), apply_rope(k, *cos_sin)


def attention_core(
    q: Tensor,  # (B, Sq, H, D)
    k: Tensor,  # (B, Sk, Hkv, D)
    v: Tensor,  # (B, Sk, Hkv, Dv), Dv <= D
    *,
    causal: bool,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    use_kernel: bool = True,
) -> Tensor:
    """Full-sequence attention (prefill, and the encoder's bidirectional
    pass with ``causal=False``); returns (B, Sq, H, Dv), scores scaled by
    1/sqrt(D) and capped by ``softcap`` when given.  Without the causal mask
    the window is ignored, as the reference's unmasked path ignores it.

    The kernel reads the (B, S, H, D) tensors through their strides as
    (B, H, S, D) views; nothing is copied.  ``use_kernel=False`` computes the
    kernel's plain version instead (the on-card yardstick of the prefill)."""
    fn = flash_attention if use_kernel else kref.flash_attention_ref
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, window=window if causal else None, softcap=softcap)
    return out.transpose(1, 2)


def _softcap(scores: Tensor, cap: Optional[float]) -> Tensor:
    """``cap * tanh(scores / cap)`` in the scores' dtype (unchanged for None)."""
    return scores if cap is None else cap * torch.tanh(scores / cap)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
          softcap: Optional[float] = None) -> Tensor:
    """Grouped attention as the reference's ``_sdpa``: q (B, Sq, Hkv, G, D),
    k and v (B, Sk, Hkv, D); scores in the input dtype, capped, masked,
    softmax in float32, probabilities cast back.  Returns (B, Sq, Hkv, G, D)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    scores = _softcap(scores, softcap)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _causal_mask(sq: int, sk: int, q_offset: int, window: Optional[int], device) -> Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_train(
    q: Tensor,  # (B, Sq, H, D)
    k: Tensor,  # (B, Sk, Hkv, D)
    v: Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    softcap: Optional[float] = None,
) -> Tensor:
    """Attention of the training forward, differentiable: the reference's
    ``attention_core`` (causal: full scores up to ``chunk`` queries, else
    query chunks against their causal key span; non-causal: full scores,
    unmasked, the window ignored).  The reference trains through this jnp
    code and has no gradient kernel; K6 is forward-only and stays the
    prefill's.  Returns (B, Sq, H, D)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    if not causal:
        return _sdpa(qg, k, v, None, softcap).reshape(b, sq, h, -1)
    if sq <= chunk or sq % chunk:
        out = _sdpa(qg, k, v, _causal_mask(sq, k.shape[1], 0, window, q.device), softcap)
        return out.reshape(b, sq, h, -1)
    outs = []
    for q0 in range(0, sq, chunk):
        k_end = q0 + chunk
        k0 = 0 if window is None else max(0, k_end - window - chunk)
        mask = _causal_mask(chunk, k_end - k0, q0 - k0, window, q.device)
        outs.append(_sdpa(qg[:, q0:k_end], k[:, k0:k_end], v[:, k0:k_end], mask, softcap))
    return torch.cat(outs, dim=1).reshape(b, sq, h, -1)


def gqa_forward(params: Dict, cfg: ModelConfig, x: Tensor, cos_sin, *, causal: bool = True,
                x_kv: Optional[Tensor] = None, cos_sin_kv=None, tp=None) -> Tensor:
    """The training forward of a GQA layer, x (B, S, d) -> (B, S, d).  A
    cross-attention takes k and v from ``x_kv`` (B, S_kv, d), rotated with
    ``cos_sin_kv`` (``cos_sin`` when None)."""
    tp = gqa_tp(params, cfg, tp)
    if tp is not None:
        x = tp.enter(x)
        x_kv = None if x_kv is None else tp.enter(x_kv)
    q, k, v = _project_qkv(params, cfg, x, x_kv=x_kv, tp=tp)
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
        k = apply_rope(k, *(cos_sin if cos_sin_kv is None else cos_sin_kv))
    k, v = local_kv(cfg, tp, q.shape[2], k, v)
    out = attention_train(q, k, v, causal=causal, window=cfg.sliding_window,
                          chunk=cfg.attn_chunk, softcap=cfg.attn_logit_softcap)
    b, s, h, hd = out.shape
    out = linear(out.reshape(b, s, h * hd), params["wo"].flatten(0, 1))
    return out if tp is None else tp.exit(out)


def split_softmax_values(scores: Tensor, values: Tensor, spec: str, idle) -> Tensor:
    """``softmax(scores) @ values`` over a key axis split across the idle
    ranks (each holds a block of the sequence): the scores' max is reduced
    over the ranks, each rank weighs its values by ``exp(score - max)``
    (cast to the values' dtype, as the whole softmax's probabilities are),
    and the numerators and denominators are summed over the ranks in one
    float32 all-reduce.  ``spec`` contracts the probabilities (the scores'
    shape, keys last) with ``values``; returns the output in the values'
    dtype.  One query: the output's leading dims are the scores' non-key
    dims in the same order, so each row's denominator pairs with its
    numerators."""
    s32 = scores.to(torch.float32)
    top = idle.max(torch.amax(s32, dim=-1, keepdim=True))
    e = torch.exp(s32 - top)
    num = torch.einsum(spec, e.to(values.dtype), values).to(torch.float32)
    den = torch.sum(e, dim=-1)  # the scores' shape without the key axis
    width = num.numel() // den.numel()
    packed = torch.cat([num.reshape(den.numel(), width), den.reshape(-1, 1)], dim=1)
    tot = idle.sum(packed)
    return (tot[:, :width] / tot[:, width:]).reshape(num.shape).to(values.dtype)


def decode_attention_core(
    q: Tensor,  # (B, 1, H, D)
    k_cache: Tensor,  # (B, S_cache, Hkv, D)
    v_cache: Tensor,  # (B, S_cache, Hkv, D)
    valid: Tensor,  # (B, S_cache) bool
    softcap: Optional[float] = None,
    idle=None,
) -> Tensor:
    """One query against the cache, as the reference's ``_sdpa``: scores in
    the input dtype, capped, softmax in float32, probabilities cast back.
    Under ``idle`` the cache is this rank's block of the sequence and the
    softmax is combined over the idle ranks (:func:`split_softmax_values`)."""
    b, _, h, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache) * (1.0 / math.sqrt(dh))
    scores = _softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    if idle is not None:
        out = split_softmax_values(scores, v_cache, "bhgqk,bkhd->bqhgd", idle)
        return out.reshape(b, 1, h, -1)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(b, 1, h, -1)


def _write_slot(cache: Dict, names, rows: Tensor, slot: Tensor, new, idle) -> int:
    """Write each row's new entries at its cache ``slot`` (a global index),
    in place; under ``idle`` only the rank whose block holds the slot writes
    (the others rewrite what they hold).  Returns the global index of the
    rank's first entry."""
    size = cache[names[0]].shape[1]
    if idle is None:
        for name, t in zip(names, new):
            cache[name][rows, slot] = t
        return 0
    lo = idle.index * size
    local = slot - lo
    mine = (local >= 0) & (local < size)
    local = local.clamp(0, size - 1)
    for name, t in zip(names, new):
        held = cache[name][rows, local]
        cache[name][rows, local] = torch.where(mine.reshape((-1,) + (1,) * (t.dim() - 1)),
                                               t, held)
    return lo


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
    cos_sin: Optional[Tuple[Tensor, Tensor]],  # tables at each row's position
    cache: Dict,
    pos: Tensor,  # (B,) int: tokens already in each row's context
    slotted: bool = False,
    tp=None,
    idle=None,
) -> Tensor:
    """One token per row; writes its K/V into ``cache`` at the row's own
    ``pos`` (``pos % window`` under SWA) and returns (B, 1, d).  Under
    ``tp`` the cache holds the KV heads the placements give this rank;
    under ``idle`` (:class:`repro_torch.launch.mesh.IdleAxis`) it holds the
    rank's block of the sequence: positions stay global, only the rank
    that holds the slot writes it, and the softmax is combined over the
    idle ranks."""
    tp = gqa_tp(params, cfg, tp)
    idle = idle if idle is not None and idle.seq else None
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _project_qkv(params, cfg, x, slotted, tp=tp)
    q, k = rope_qk(q, k, cos_sin)
    size = cache["k"].shape[1] * (1 if idle is None else idle.size)
    pos = pos.to(torch.long)
    # past the end of a full-attention cache the write lands on its last
    # entry, as the reference's clamped dynamic_update_slice does
    slot = pos % size if cfg.sliding_window is not None else pos.clamp(max=size - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    lo = _write_slot(cache, ("k", "v"), rows, slot, (k[:, 0], v[:, 0]), idle)
    idx = torch.arange(cache["k"].shape[1], device=x.device)[None, :]
    valid = (idx if not lo else idx + lo) <= pos[:, None]
    if cfg.sliding_window is not None:
        valid = valid | (pos[:, None] >= size)  # the rolling buffer is full once wrapped
    k_att, v_att = local_kv(cfg, tp, q.shape[2], cache["k"], cache["v"])
    out = decode_attention_core(q, k_att, v_att, valid, cfg.attn_logit_softcap, idle)
    b, _, h, hd = out.shape
    out = linear(out.reshape(b, 1, h * hd), params["wo"].flatten(-3, -2), slotted)
    return out if tp is None else tp.exit(out)


# ---------------------------------------------------------------------------
# MLA: materialised K/V for prefill and training, absorbed decode
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, stack: tuple = ()) -> Dict:
    m = cfg.mla
    d, h, s = cfg.d_model, cfg.n_heads, cfg.init_scale
    return {
        "wq": normal_init(gen, stack + (d, h, m.nope_head_dim + m.rope_head_dim), s, dtype),
        "w_dkv": normal_init(gen, stack + (d, m.kv_lora_rank), s, dtype),
        "w_kr": normal_init(gen, stack + (d, m.rope_head_dim), s, dtype),
        "kv_norm": torch.ones(stack + (m.kv_lora_rank,), dtype=dtype, device=gen.device),
        "w_uk": normal_init(gen, stack + (m.kv_lora_rank, h, m.nope_head_dim), s, dtype),
        "w_uv": normal_init(gen, stack + (m.kv_lora_rank, h, m.v_head_dim), s, dtype),
        "wo": normal_init(gen, stack + (h, m.v_head_dim, d), s / math.sqrt(2 * cfg.n_layers),
                          dtype),
    }


def spec_mla(cfg: ModelConfig, model_axis: str = "model") -> Dict:
    """Placements: heads over ``model_axis``, the latent projections
    replicated."""
    mp = model_axis
    return {"wq": (None, mp, None), "w_dkv": (None, None), "w_kr": (None, None),
            "kv_norm": (None,), "w_uk": (None, mp, None), "w_uv": (None, mp, None),
            "wo": (mp, None, None)}


def spec_mla_cache(cfg: ModelConfig, batch_axes, model_axis: str = "model") -> Dict:
    """The latent cache's placements: the batch over ``batch_axes``, held
    whole over the model ranks."""
    return {"c_kv": (batch_axes, None, None), "k_rope": (batch_axes, None, None)}


MLA_WHOLE = ("w_dkv", "w_kr", "kv_norm")


def _mla_qkr(params: Dict, cfg: ModelConfig, x: Tensor, cos_sin, slotted: bool = False,
             tp=None):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rope), the normed latent
    c_kv (B, S, r) and the one shared RoPE key k_rope (B, S, rope).  Under
    ``tp`` (an entered ``x``) q holds this rank's heads and the latents are
    whole."""
    m = cfg.mla
    params = _region_params(params, tp, MLA_WHOLE)
    q = linear(x, params["wq"], slotted)
    q_nope = q[..., :m.nope_head_dim]
    q_rope = apply_rope(q[..., m.nope_head_dim:], *cos_sin)
    c_kv = rms_norm(linear(x, params["w_dkv"], slotted), vec(params["kv_norm"], slotted, 3),
                    cfg.norm_eps)
    k_rope = apply_rope(linear(x, params["w_kr"], slotted)[:, :, None, :], *cos_sin)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_qkv(params: Dict, q_nope, q_rope, c_kv, k_rope):
    """Materialised q, k (B, S, H, nope + rope) and v (B, S, H, v_head_dim):
    the latent up-projected, the shared RoPE key beside every head's no-RoPE
    key, each a contiguous tensor (K6 reads them through TMA)."""
    k_nope = linear(c_kv, params["w_uk"])
    value = linear(c_kv, params["w_uv"])
    k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3], k_rope.shape[-1])
    return (torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope_b], dim=-1), value)


def mla_forward(params: Dict, cfg: ModelConfig, x: Tensor, cos_sin, tp=None) -> Tensor:
    """The training forward of an MLA layer (materialised K/V), x (B, S, d)
    -> (B, S, d)."""
    tp = gqa_tp(params, cfg, tp)
    if tp is not None:
        x = tp.enter(x)
    q, k, v = mla_qkv(params, *_mla_qkr(params, cfg, x, cos_sin, tp=tp))
    out = attention_train(q, k, v, window=None, chunk=cfg.attn_chunk,
                          softcap=cfg.attn_logit_softcap)
    b, s, h, dv = out.shape
    out = linear(out.reshape(b, s, h * dv), params["wo"].flatten(0, 1))
    return out if tp is None else tp.exit(out)


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device=None,
                   stack: tuple = ()) -> Dict:
    m = cfg.mla
    return {"c_kv": torch.zeros(stack + (batch, max_seq, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros(stack + (batch, max_seq, m.rope_head_dim), dtype=dtype,
                                  device=device)}


def mla_fill_cache(cache: Dict, c_kv: Tensor, k_rope: Tensor) -> Dict:
    """Write the prefill's latents into ``cache`` in place."""
    s = c_kv.shape[1]
    cache["c_kv"][:, :s].copy_(c_kv)
    cache["k_rope"][:, :s].copy_(k_rope)
    return cache


def mla_decode(
    params: Dict,
    cfg: ModelConfig,
    x: Tensor,  # (B, 1, d)
    cos_sin: Tuple[Tensor, Tensor],
    cache: Dict,
    pos: Tensor,  # (B,) int
    slotted: bool = False,
    tp=None,
    idle=None,
) -> Tensor:
    """Absorbed-matrix MLA decode: attention in the compressed latent space
    (MQA-shaped), ``W_uk`` folded into the query and ``W_uv`` applied after
    the value reduction; writes the token's latents at the row's ``pos``
    (every model rank the same whole latents).  Under ``idle`` the latent
    cache is this rank's block of the sequence, as in :func:`gqa_decode`."""
    m = cfg.mla
    tp = gqa_tp(params, cfg, tp)
    idle = idle if idle is not None and idle.seq else None
    if tp is not None:
        x = tp.enter(x)
    q_nope, q_rope, c_new, r_new = _mla_qkr(params, cfg, x, cos_sin, slotted, tp)
    size = cache["c_kv"].shape[1] * (1 if idle is None else idle.size)
    pos = pos.to(torch.long)
    slot = pos.clamp(max=size - 1)  # the reference's clamped dynamic_update_slice
    rows = torch.arange(x.shape[0], device=x.device)
    lo = _write_slot(cache, ("c_kv", "k_rope"), rows, slot, (c_new[:, 0], r_new[:, 0]), idle)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    per = "b" if slotted else ""
    q_lat = torch.einsum(f"bshk,{per}rhk->bshr", q_nope, params["w_uk"])
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_cache)
              + torch.einsum("bshr,btr->bhst", q_rope, r_cache)) * scale
    scores = _softcap(scores, cfg.attn_logit_softcap)
    valid = (torch.arange(c_cache.shape[1], device=x.device)[None, :] + lo if lo else
             torch.arange(c_cache.shape[1], device=x.device)[None, :]) <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    if idle is not None:
        ctx = split_softmax_values(scores, c_cache, "bhst,btr->bshr", idle)
    else:
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btr->bshr", probs, c_cache)
    out = torch.einsum(f"bshr,{per}rhk->bshk", ctx, params["w_uv"])
    b, _, h, dv = out.shape
    out = linear(out.reshape(b, 1, h * dv), params["wo"].flatten(-3, -2), slotted)
    return out if tp is None else tp.exit(out)
