"""Decoder-only LM for the served families: dense GQA decoders (Qwen3) and
Mamba-2 SSD stacks (the twin of ``repro.models.transformer``).

Parameters keep the reference's stacked layout — ``{"embed", "final_norm",
"lm_head", "head_layers": [...], "layers": {"pos0": ...}}`` with a leading
period axis on every leaf of ``layers`` — so weights and caches cross over
leaf for leaf (:mod:`repro_torch.weights`).  The reference's ``lax.scan``
over the stacked axis becomes a Python loop over views of it.

Entry points:

* :func:`lm_prefill` — logits and a filled cache.  Attention layers run the
  flash-attention kernel (K6), Mamba layers the SSD scan kernel (K7);
  ``use_kernels=False`` runs their plain versions instead.
* :func:`lm_decode` — one token per row against the cache (plain PyTorch;
  the reference has no decode kernel).  With ``slotted=True`` every
  parameter carries a leading slot axis, one agent per row, and each
  projection is one batched product over the slots; the cache's ``pos`` is
  then one position per slot.

Caches are updated in place and returned.  Families the port does not cover
yet (MoE, MLA, hybrid, encoder-decoder, VLM / M-RoPE, prefix embeddings)
raise ``NotImplementedError`` naming ROADMAP A14.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, normal_init, rms_norm, vec
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.rope import apply_rope, rope_cos_sin, text_positions

Tensor = torch.Tensor
Tree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the families the port does not cover."""
    missing = []
    if cfg.is_enc_dec:
        missing.append("encoder-decoder")
    if cfg.modality != "text" or cfg.mrope_sections is not None:
        missing.append("VLM / audio frontends and M-RoPE")
    if cfg.moe is not None:
        missing.append("MoE")
    if cfg.attn_impl == "mla":
        missing.append("MLA")
    if cfg.hybrid_period or cfg.arch_type == "hybrid":
        missing.append("hybrid stacks")
    if cfg.attn_logit_softcap is not None:
        missing.append("attention logit softcap")
    if cfg.arch_type not in ("dense", "ssm"):
        missing.append(f"arch_type {cfg.arch_type!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP A14)")


def _period_patterns(cfg: ModelConfig):
    """(head_patterns, period_pattern, n_periods): lists of (kind, ffn_kind)."""
    check_supported(cfg)
    pairs = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    head, body = pairs[:cfg.first_k_dense], pairs[cfg.first_k_dense:]
    period = cfg.scan_period()
    return head, body[:period], len(body) // period


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, ffn_kind: str, dtype,
               stack: tuple = ()) -> Dict:
    dev = gen.device
    p: Dict[str, Any] = {"norm1": {"scale": torch.ones(stack + (cfg.d_model,), dtype=dtype,
                                                       device=dev)}}
    p["mixer"] = (A.init_gqa if kind == "attn" else M.init_mamba2)(gen, cfg, dtype, stack)
    if ffn_kind == "dense":
        p["norm2"] = {"scale": torch.ones(stack + (cfg.d_model,), dtype=dtype, device=dev)}
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, cfg.init_scale, dtype,
                            stack)
    return p


def init_lm(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None) -> Tree:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (stacked layers drawn whole, one leaf at a time)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    params: Dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), cfg.init_scale, dtype),
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=dev)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), cfg.init_scale,
                                          dtype)
    params["head_layers"] = [init_block(gen, cfg, k, f, dtype) for k, f in head_pat]
    params["layers"] = {f"pos{i}": init_block(gen, cfg, k, f, dtype, (n_periods,))
                        for i, (k, f) in enumerate(period_pat)}
    return params


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype, device,
                 stack: tuple = ()) -> Dict:
    if kind == "attn":
        return A.init_gqa_cache(cfg, batch, max_seq, dtype, device, stack)
    return M.init_mamba2_cache(cfg, batch, dtype, device, stack)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "head_layers": [_block_cache(cfg, k, batch, max_seq, dtype, dev) for k, _ in head_pat],
        "layers": {f"pos{i}": _block_cache(cfg, k, batch, max_seq, dtype, dev, (n_periods,))
                   for i, (k, _) in enumerate(period_pat)},
    }


def _index(tree: Tree, fn) -> Tree:
    """Views of every leaf of a nested dict."""
    return {k: _index(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _lm_head(params: Tree, cfg: ModelConfig) -> Tensor:
    if not cfg.tie_embeddings:
        return params["lm_head"]
    return params["embed"].transpose(-1, -2)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_block(bp: Dict, cfg: ModelConfig, kind: str, ffn_kind: str, x: Tensor,
                   cos_sin, cc: Dict, use_kernels: bool) -> Tensor:
    h = rms_norm(x, bp["norm1"]["scale"], cfg.norm_eps)
    mp = bp["mixer"]
    b, s, _ = x.shape
    if kind == "attn":
        q, k, v = A._project_qkv(mp, cfg, h)
        q = apply_rope(q, *cos_sin)
        k = apply_rope(k, *cos_sin)
        A.gqa_fill_cache(cc, k, v)
        core = A.attention_core(q, k, v, causal=True, window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap, use_kernel=use_kernels)
        out = linear(core.reshape(b, s, -1), mp["wo"].flatten(0, 1))
    else:
        s_cfg, d_in, _, _ = M._dims(cfg)
        z, xbc, dt_raw = M._split_proj(cfg, linear(h, mp["in_proj"]))
        conv_full = M.causal_conv(xbc, mp["conv_w"], mp["conv_b"])
        conv_win = xbc[:, -(s_cfg.d_conv - 1):, :]
        xm, b_mat, c_mat = M._split_xbc(cfg, F.silu(conv_full))
        dt = M.softplus(dt_raw.to(torch.float32) + mp["dt_bias"])
        a_neg = -torch.exp(mp["a_log"])
        scan = ssd_scan if use_kernels else kref.ssd_scan_ref
        y, final_state = scan(xm, dt.to(xm.dtype), a_neg, b_mat, c_mat, chunk=s_cfg.chunk)
        y = y.to(x.dtype) + mp["d_skip"].to(x.dtype)[None, None, :, None] * xm
        y = rms_norm(y.reshape(b, s, d_in) * F.silu(z), mp["norm"], cfg.norm_eps)
        out = linear(y, mp["out_proj"])
        cc["conv"].copy_(conv_win)
        cc["ssm"].copy_(final_state)
    x = x + out
    if ffn_kind != "none":
        x = x + mlp_forward(bp["ffn"], cfg.mlp_type, rms_norm(x, bp["norm2"]["scale"],
                                                              cfg.norm_eps))
    return x


def lm_prefill(
    params: Tree,
    cfg: ModelConfig,
    tokens: Tensor,  # (B, S)
    cache: Dict,
    *,
    prefix_embeds: Optional[Tensor] = None,
    positions: Optional[Tensor] = None,
    use_kernels: bool = True,
) -> Tuple[Tensor, Dict]:
    """Full causal forward and cache fill; returns (logits (B, S, V), cache).

    A Mamba layer keeps the last ``d_conv - 1`` inputs of its convolution
    in the cache, so prompts shorter than that are refused."""
    if prefix_embeds is not None or positions is not None:
        raise NotImplementedError("prefix embeddings and explicit positions (VLM / audio) "
                                  "are not ported yet (ROADMAP A14)")
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    b, s = tokens.shape
    if cfg.arch_type == "ssm" and s < cfg.ssm.d_conv - 1:
        raise ValueError(f"{cfg.name}: a prompt needs at least {cfg.ssm.d_conv - 1} tokens "
                         f"(the conv window), got {s}")
    x = params["embed"][tokens.long()]
    cos_sin = None
    if cfg.arch_type != "ssm":
        cos_sin = rope_cos_sin(text_positions(b, s, 0, x.device), cfg.resolved_head_dim,
                               cfg.rope_theta)
    for bp, (k, f), cc in zip(params["head_layers"], head_pat, cache["head_layers"]):
        x = _prefill_block(bp, cfg, k, f, x, cos_sin, cc, use_kernels)
    for p in range(n_periods):
        for i, (k, f) in enumerate(period_pat):
            bp = _index(params["layers"][f"pos{i}"], lambda t: t[p])
            cc = _index(cache["layers"][f"pos{i}"], lambda t: t[p])
            x = _prefill_block(bp, cfg, k, f, x, cos_sin, cc, use_kernels)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = linear(x, _lm_head(params, cfg))
    cache["pos"].fill_(s)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_block(bp: Dict, cfg: ModelConfig, kind: str, ffn_kind: str, x: Tensor, cos_sin,
                  cc: Dict, pos: Tensor, slotted: bool) -> Tensor:
    h = rms_norm(x, vec(bp["norm1"]["scale"], slotted, 3), cfg.norm_eps)
    if kind == "attn":
        h = A.gqa_decode(bp["mixer"], cfg, h, cos_sin, cc, pos, slotted)
    else:
        h = M.mamba2_decode(bp["mixer"], cfg, h, cc, slotted)
    x = x + h
    if ffn_kind != "none":
        h = rms_norm(x, vec(bp["norm2"]["scale"], slotted, 3), cfg.norm_eps)
        x = x + mlp_forward(bp["ffn"], cfg.mlp_type, h, slotted)
    return x


def lm_decode(
    params: Tree,
    cfg: ModelConfig,
    token: Tensor,  # (B, 1)
    cache: Dict,
    *,
    slotted: bool = False,
) -> Tuple[Tensor, Dict]:
    """One decode step; returns (logits (B, 1, V), cache advanced in place).

    Shared parameters take the reference's cache: leaves (n_periods, B, ...)
    and a scalar ``pos``.  Slotted parameters (a leading slot axis of size
    B on every leaf) take the engine's slot-stacked cache: leaves
    (B, n_periods, 1, ...) and ``pos`` (B,), one position per slot."""
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    b = token.shape[0]
    pos = cache["pos"]
    posv = pos.reshape(1).expand(b) if pos.dim() == 0 else pos
    tok = token[:, 0].long()
    if slotted:
        x = params["embed"][torch.arange(b, device=tok.device), tok][:, None, :]
    else:
        x = params["embed"][tok][:, None, :]
    cos_sin = None
    if cfg.arch_type != "ssm":
        cos_sin = rope_cos_sin(text_positions(b, 1, posv, x.device), cfg.resolved_head_dim,
                               cfg.rope_theta)
    for j, ((k, f), bp) in enumerate(zip(head_pat, params["head_layers"])):
        cc = cache["head_layers"][j]
        if slotted:
            cc = _index(cc, lambda t: t[:, 0])
        x = _decode_block(bp, cfg, k, f, x, cos_sin, cc, posv, slotted)
    for p in range(n_periods):
        for i, (k, f) in enumerate(period_pat):
            if slotted:
                bp = _index(params["layers"][f"pos{i}"], lambda t: t[:, p])
                cc = _index(cache["layers"][f"pos{i}"], lambda t: t[:, p, 0])
            else:
                bp = _index(params["layers"][f"pos{i}"], lambda t: t[p])
                cc = _index(cache["layers"][f"pos{i}"], lambda t: t[p])
            x = _decode_block(bp, cfg, k, f, x, cos_sin, cc, posv, slotted)
    x = rms_norm(x, vec(params["final_norm"]["scale"], slotted, 3), cfg.norm_eps)
    logits = linear(x, _lm_head(params, cfg), slotted)
    pos.add_(1)
    return logits, cache
