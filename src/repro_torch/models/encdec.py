"""Encoder-decoder transformer: SeamlessM4T's text/speech backbone (the twin
of ``repro.models.encdec``).

The audio frontend (mel + conformer feature extractor) is a stub, as in the
reference: the encoder consumes precomputed frame embeddings (B, T_frames,
d_model).  A bidirectional encoder stack, then a causal decoder whose layers
also attend, across, to the encoder's memory.

Parameters keep the reference's tree, ``{"embed", "enc_layers", "enc_norm",
"dec_layers", "final_norm", "lm_head"}``: the encoder layers' ``norm1``,
``attn``, ``norm2``, ``ffn`` and the decoder layers' ``norm1``,
``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``, ``ffn``, each leaf
stacked on a leading layer axis, so weights cross over leaf for leaf
(:mod:`repro_torch.weights`).  The cache is ``{"pos", "self_kv", "memory"}``:
the decoder's stacked self-attention K/V and the encoder memory.

Entry points:

* :func:`encode` / :func:`decode_train` / :func:`encdec_loss` — the
  training forward, differentiable (attention through
  :func:`repro_torch.models.attention.attention_train`, the encoder's
  unmasked, as the reference trains).
* :func:`encode_prefill` — the encoder of the prefill: K6 without the causal
  mask on every layer (``use_kernels=False``: its plain version).
* :func:`encdec_decode_step` — one token against the cache (plain PyTorch).
  Its cross-attention recomputes K/V from the memory every step, as the
  reference does.

The reference's prefill (``repro.models.registry``) is the encoder plus one
decode step on the first token; :class:`repro_torch.models.registry.ModelBundle`
keeps it.  Every entry point takes ``tp`` (the agent's model axis, or None),
as :mod:`repro_torch.models.transformer`'s do: the attention layers run on
the rank's heads, the FFNs on its block of the hidden dim, and a split
vocabulary is looked up, projected and reduced as the decoder-only LM's.
The cache is updated in place and returned; a prefill replaces its
``memory`` entry with the encoder's output, whatever ``mem_len`` it was made
with.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (can_remat, linear, normal_init, remat_call, rms_norm,
                                       seeded_generator, sharded, spec_rms_norm)
from repro_torch.models.mlp import init_mlp, mlp_forward, spec_mlp
from repro_torch.models.rope import rope_cos_sin, text_positions
from repro_torch.models.transformer import (_ce_sum, dtype_of, embed_lookup, gathered,
                                            head_logits, stacked_specs, unstack, vocab_ce_sum,
                                            vocab_tp)
from repro_torch.utils.pytree import flatten_paths, nest_map

Tensor = torch.Tensor
Tree = Any


# ---------------------------------------------------------------------------
# Parameters and cache
# ---------------------------------------------------------------------------


def init_encdec(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
                leaf_hook=None) -> Tree:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (each stacked leaf drawn whole).  On the meta device: the
    tree's shapes and dtypes, nothing allocated.  ``leaf_hook``: see
    :func:`repro_torch.models.layers.seeded_generator`."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    gen = seeded_generator(dev, seed, leaf_hook)

    def norm(stack: tuple = ()) -> Dict[str, Tensor]:
        return {"scale": torch.ones(stack + (cfg.d_model,), dtype=dtype, device=dev)}

    def ffn(stack: tuple) -> Dict[str, Tensor]:
        return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, cfg.init_scale, dtype, stack)

    ne, nd = (cfg.n_encoder_layers,), (cfg.n_layers,)
    embed = normal_init(gen, (cfg.vocab_size, cfg.d_model), cfg.init_scale, dtype)
    enc = {"norm1": norm(ne), "attn": A.init_gqa(gen, cfg, dtype, ne), "norm2": norm(ne),
           "ffn": ffn(ne)}
    dec = {"norm1": norm(nd), "self_attn": A.init_gqa(gen, cfg, dtype, nd), "norm_x": norm(nd),
           "cross_attn": A.init_gqa(gen, cfg, dtype, nd), "norm2": norm(nd), "ffn": ffn(nd)}
    return {"embed": embed, "enc_layers": enc, "enc_norm": norm(), "dec_layers": dec,
            "final_norm": norm(),
            "lm_head": normal_init(gen, (cfg.d_model, cfg.vocab_size), cfg.init_scale, dtype)}


def encdec_param_specs(cfg: ModelConfig, model_axis: str = "model") -> Dict[str, tuple]:
    """The twin of the reference's ``encdec_param_specs``: placements keyed
    by parameter path (see :func:`repro_torch.models.transformer.lm_param_specs`)."""
    gqa, mlp = A.spec_gqa(cfg, model_axis), spec_mlp(cfg.mlp_type, model_axis)
    enc = {"norm1": spec_rms_norm(), "attn": gqa, "norm2": spec_rms_norm(), "ffn": mlp}
    dec = {"norm1": spec_rms_norm(), "self_attn": gqa, "norm_x": spec_rms_norm(),
           "cross_attn": gqa, "norm2": spec_rms_norm(), "ffn": mlp}
    return flatten_paths({
        "embed": (model_axis, None), "enc_layers": stacked_specs(enc),
        "enc_norm": spec_rms_norm(), "dec_layers": stacked_specs(dec),
        "final_norm": spec_rms_norm(), "lm_head": (None, model_axis)})


def encdec_cache_specs(cfg: ModelConfig, batch_axes, model_axis: str = "model") -> Dict:
    """The twin of the reference's ``encdec_cache_specs``, keyed by path."""
    kv = A.spec_gqa_cache(cfg, batch_axes, model_axis)
    return flatten_paths({"pos": (), "self_kv": stacked_specs(kv),
                          "memory": (batch_axes, None, None)})


def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int, mem_len: int,
                      device: DeviceLike = None) -> Dict:
    """``pos``, the decoder's self-attention K/V (n_layers, batch, max_seq,
    Hkv, hd) and a zero memory (batch, mem_len, d_model)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "self_kv": A.init_gqa_cache(cfg, batch, max_seq, dtype, dev, (cfg.n_layers,)),
        "memory": torch.zeros((batch, mem_len, cfg.d_model), dtype=dtype, device=dev),
    }


def _layer(tree: Tree, i: int) -> Tree:
    return nest_map(lambda t: t[i], tree)


def _cos_sin(cfg: ModelConfig, b: int, s: int, offset, device):
    return rope_cos_sin(text_positions(b, s, offset, device), cfg.resolved_head_dim,
                        cfg.rope_theta)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _ffn_tp(lp: Dict, cfg: ModelConfig, tp):
    return sharded(tp, lp["ffn"]["w_down"].shape[-2], cfg.d_ff)


def _encode(params: Tree, cfg: ModelConfig, frames: Tensor,
            attend: Callable[[Dict, Tensor, Any], Tensor], remat: bool, tp=None,
            fsdp=None) -> Tensor:
    """The encoder stack, each layer's self-attention computed by
    ``attend(attn_params, normed_x, cos_sin)``; under ``fsdp`` each layer
    gathered where it starts, inside its remat region."""
    b, t, _ = frames.shape
    cos_sin = _cos_sin(cfg, b, t, 0, frames.device)

    layers = unstack(params["enc_layers"], cfg.n_encoder_layers)

    def layer(x: Tensor, i: int) -> Tensor:
        lp = gathered(fsdp, layers[i], "enc_layers", layer=True)
        x = x + attend(lp["attn"], rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps), cos_sin)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        return x + mlp_forward(lp["ffn"], cfg.mlp_type, h, tp=_ffn_tp(lp, cfg, tp))

    x = frames.to(dtype_of(cfg))
    remat = remat and can_remat(x)
    for i in range(cfg.n_encoder_layers):
        x = remat_call(cfg.remat_policy, layer, x, i) if remat else layer(x, i)
    return rms_norm(x, gathered(fsdp, params["enc_norm"], "enc_norm")["scale"], cfg.norm_eps)


def encode(params: Tree, cfg: ModelConfig, frames: Tensor, tp=None, fsdp=None) -> Tensor:
    """frames (B, T, d_model), the stub frontend's output -> the encoder
    memory (B, T, d_model): the training forward, bidirectional."""
    return _encode(params, cfg, frames,
                   lambda p, h, cs: A.gqa_forward(p, cfg, h, cs, causal=False, tp=tp),
                   cfg.remat, tp, fsdp)


def encode_prefill(params: Tree, cfg: ModelConfig, frames: Tensor, *,
                   use_kernels: bool = True, tp=None) -> Tensor:
    """The encoder of the prefill: every layer's self-attention through K6
    without the causal mask (its plain version when ``use_kernels`` is
    False)."""

    def attend(p: Dict, h: Tensor, cos_sin) -> Tensor:
        ttp = A.gqa_tp(p, cfg, tp)
        h_in = h if ttp is None else ttp.enter(h)
        q, k, v = A._project_qkv(p, cfg, h_in, tp=ttp)
        q, k = A.rope_qk(q, k, cos_sin)
        k, v = (t.contiguous() for t in A.local_kv(cfg, ttp, q.shape[2], k, v))
        core = A.attention_core(q, k, v, causal=False, softcap=cfg.attn_logit_softcap,
                                use_kernel=use_kernels)
        b, s = h.shape[:2]
        out = linear(core.reshape(b, s, -1), p["wo"].flatten(0, 1))
        return out if ttp is None else ttp.exit(out)

    return _encode(params, cfg, frames, attend, False, tp)


# ---------------------------------------------------------------------------
# Decoder: training forward and loss
# ---------------------------------------------------------------------------


def _dec_layer(lp: Dict, cfg: ModelConfig, x: Tensor, memory: Tensor, cos_sin,
               mem_cos_sin, tp=None) -> Tensor:
    h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
    x = x + A.gqa_forward(lp["self_attn"], cfg, h, cos_sin, causal=True, tp=tp)
    h = rms_norm(x, lp["norm_x"]["scale"], cfg.norm_eps)
    x = x + A.gqa_forward(lp["cross_attn"], cfg, h, cos_sin, causal=False, x_kv=memory,
                          cos_sin_kv=mem_cos_sin, tp=tp)
    h = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_forward(lp["ffn"], cfg.mlp_type, h, tp=_ffn_tp(lp, cfg, tp))


def _decoder_hidden(params: Tree, cfg: ModelConfig, tokens: Tensor, memory: Tensor,
                    tp=None, fsdp=None) -> Tensor:
    """The teacher-forced decoder to its final norm."""
    b, s = tokens.shape
    x = embed_lookup(gathered(fsdp, params["embed"], "embed"), tokens,
                     vocab_tp(params, cfg, tp, fsdp))
    cos_sin = _cos_sin(cfg, b, s, 0, x.device)
    mem_cos_sin = _cos_sin(cfg, b, memory.shape[1], 0, x.device)

    layers = unstack(params["dec_layers"], cfg.n_layers)

    def layer(xx: Tensor, i: int) -> Tensor:
        lp = gathered(fsdp, layers[i], "dec_layers", layer=True)
        return _dec_layer(lp, cfg, xx, memory, cos_sin, mem_cos_sin, tp)

    remat = cfg.remat and can_remat(x)
    for i in range(cfg.n_layers):
        x = remat_call(cfg.remat_policy, layer, x, i) if remat else layer(x, i)
    return rms_norm(x, gathered(fsdp, params["final_norm"], "final_norm")["scale"],
                    cfg.norm_eps)


def decode_train(params: Tree, cfg: ModelConfig, tokens: Tensor, memory: Tensor,
                 tp=None, fsdp=None) -> Tensor:
    """Teacher-forced decoder over ``tokens`` (B, S) against ``memory``;
    returns logits (B, S, V)."""
    hidden = _decoder_hidden(params, cfg, tokens, memory, tp, fsdp)
    return head_logits(params, cfg, hidden, tp, fsdp)


def encdec_loss(params: Tree, cfg: ModelConfig, batch: Dict, tp=None, fsdp=None) -> Tensor:
    """Next-token cross-entropy of the decoder over ``batch["tokens"]`` (B,
    S) given ``batch["frames"]`` (B, T, d_model); logits in float32.
    ``fsdp``: as :func:`repro_torch.models.transformer.lm_loss`'s."""
    memory = encode(params, cfg, batch["frames"], tp, fsdp)
    tokens = batch["tokens"]
    b, s = tokens.shape
    vtp = vocab_tp(params, cfg, tp, fsdp)
    if vtp is not None:
        hidden = _decoder_hidden(params, cfg, tokens, memory, tp, fsdp)
        return vocab_ce_sum(hidden[:, :-1], gathered(fsdp, params["lm_head"], "lm_head"),
                            tokens[:, 1:], vtp) / (b * (s - 1))
    logits = decode_train(params, cfg, tokens, memory, tp, fsdp)
    return _ce_sum(logits[:, :-1], tokens[:, 1:]) / (b * (s - 1))


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------


def encdec_decode_step(params: Tree, cfg: ModelConfig, token: Tensor,
                       cache: Dict, tp=None, idle=None) -> Tuple[Tensor, Dict]:
    """One token per row (``token`` (B, 1)) at the cache's ``pos``: causal
    self-attention against the cached K/V (written in place), then
    cross-attention to the whole memory, K/V projected anew from it.
    Returns (logits (B, 1, V), the cache advanced in place).  Under
    ``idle`` the self-attention cache is this rank's block of the sequence
    (:func:`repro_torch.models.attention.gqa_decode`); the memory stays
    whole."""
    pos, memory = cache["pos"], cache["memory"]
    b = token.shape[0]
    posv = pos.reshape(1).expand(b)
    x = embed_lookup(params["embed"], token, vocab_tp(params, cfg, tp))
    cos_sin = _cos_sin(cfg, b, 1, posv, x.device)
    mem_cos_sin = _cos_sin(cfg, b, memory.shape[1], 0, x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
        x = x + A.gqa_decode(lp["self_attn"], cfg, h, cos_sin, _layer(cache["self_kv"], i), posv,
                             tp=tp, idle=idle)
        h = rms_norm(x, lp["norm_x"]["scale"], cfg.norm_eps)
        x = x + A.gqa_forward(lp["cross_attn"], cfg, h, cos_sin, causal=False, x_kv=memory,
                              cos_sin_kv=mem_cos_sin, tp=tp)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        x = x + mlp_forward(lp["ffn"], cfg.mlp_type, h, tp=_ffn_tp(lp, cfg, tp))
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = head_logits(params, cfg, x, tp)
    pos.add_(1)
    return logits, cache
