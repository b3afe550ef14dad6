"""Decoder-only LM of the zoo: dense GQA / MQA decoders (Qwen3, Qwen2.5,
Granite, Nemotron-4), MoE (Mixtral; DeepSeek-V2-Lite with MLA and a dense
first layer), Mamba-2 SSD stacks, hybrid Mamba/attention stacks with MoE
every other layer (Jamba) and the VLM decoder (Qwen2-VL: M-RoPE, a prefix
of patch embeddings) (the twin of ``repro.models.transformer``).  The
encoder-decoder is :mod:`repro_torch.models.encdec`.

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
  the reference has no decode kernel).
* :func:`lm_loss` — next-token cross-entropy of the training forward
  (:func:`lm_forward`), differentiable: attention through
  :func:`repro_torch.models.attention.attention_train` and Mamba layers
  through the chunked ``ssd_reference``, as the reference trains (it has no
  gradient kernels), plus the MoE layers' load-balance loss; with
  ``cfg.remat`` every period is recomputed in the
  backward pass (``torch.utils.checkpoint``, non-reentrant), the reference's
  ``jax.checkpoint`` of its scanned period — all of it under
  ``remat_policy="full"``, all but the outputs of the unbatched matmuls
  under ``"dots"`` (:func:`repro_torch.models.layers.remat_call`) — except
  under ``torch.func``
  transforms (the agents' vmapped gradients), where checkpointing has no
  vmap rule and every activation is kept.  With ``slotted=True`` every
  parameter carries a leading slot axis, one agent per row, and each
  projection is one batched product over the slots; the cache's ``pos`` is
  then one position per slot.

The VLM's stub frontend hands over ``prefix_embeds`` (B, S_img, d_model),
which go before the token embeddings, and ``positions``: M-RoPE ids (3, B,
S) of the whole stream (text-only ids when none are given).  The loss is
taken over the text tail.  A decode step rotates at the degenerate ids
``mrope_text_positions(b, 1, pos)``, as the reference's does, whatever ids
the prefill's prefix carried.

Caches are updated in place and returned.  Hybrid stacks use no RoPE (their
Mamba layers carry position).  The attention logit softcap
(``cfg.attn_logit_softcap``) caps the scores on every path, K6's prefill
included.

Tensor parallelism: every entry point takes ``tp``, the agent's model axis
(:class:`repro_torch.launch.mesh.ModelAxis`) or None, and then the rank's
model shard of the parameters and cache (:func:`repro_torch.launch.specs.shard_model`).
The layers split by head and width (see :mod:`repro_torch.models.layers`);
a split vocabulary is looked up with the ids outside the rank's block
masked, the loss is the vocab-parallel cross-entropy (max, log-sum-exp and
target logit reduced over the ranks), and the prefill's and decode's logits
are gathered over the ranks, the reference's replicated output.

Pod-as-agent: the loss takes ``fsdp``, the agent's data axis
(:class:`repro_torch.launch.mesh.DataAxis`) or None, and then the rank's
data shards of the parameters.  The stacked shards are unbound once, and
each period gathers its own layers at its top, inside its remat region, so
that the backward re-gathers the period and its gradient is reduce-scattered
when its backward ends; head layers are gathered one at a time, the
embedding, head and final norm where they are used (a tied embedding once).
An MoE layer routes the rank's tokens and sizes and fills expert capacity
over the agent's whole batch from the data ranks' expert counts; its
load-balance loss is the whole batch's (``repro_torch.models.moe``).
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
from repro_torch.models.layers import (
    can_remat,
    REMAT_POLICIES,
    linear,
    normal_init,
    remat_call,
    rms_norm,
    seeded_generator,
    sharded,
    spec_rms_norm,
    vec,
)
from repro_torch.models.mlp import init_mlp, mlp_forward, spec_mlp
from repro_torch.models.moe import init_moe, moe_forward, spec_moe
from repro_torch.models.rope import mrope_text_positions, rope_cos_sin, text_positions
from repro_torch.utils.pytree import flatten_paths

Tensor = torch.Tensor
Tree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an unknown arch_type or remat policy, or a
    softcap that is not positive."""
    if cfg.attn_logit_softcap is not None and not cfg.attn_logit_softcap > 0:
        raise ValueError(f"{cfg.name}: attn_logit_softcap must be > 0, "
                         f"got {cfg.attn_logit_softcap}")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: unknown remat_policy {cfg.remat_policy!r} "
                         f"(one of {REMAT_POLICIES})")
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}")


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
    if kind == "attn":
        p["mixer"] = (A.init_mla if cfg.attn_impl == "mla" else A.init_gqa)(gen, cfg, dtype, stack)
    else:
        p["mixer"] = M.init_mamba2(gen, cfg, dtype, stack)
    if ffn_kind != "none":
        p["norm2"] = {"scale": torch.ones(stack + (cfg.d_model,), dtype=dtype, device=dev)}
    if ffn_kind == "dense":
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, cfg.init_scale, dtype,
                            stack)
    elif ffn_kind == "moe":
        p["ffn"] = init_moe(gen, cfg, dtype, stack)
    return p


def spec_block(cfg: ModelConfig, kind: str, ffn_kind: str, model_axis: str = "model") -> Dict:
    """The placements of one layer's parameters (see :func:`lm_param_specs`)."""
    sp: Dict[str, Any] = {"norm1": spec_rms_norm()}
    if kind == "attn":
        sp["mixer"] = (A.spec_mla if cfg.attn_impl == "mla" else A.spec_gqa)(cfg, model_axis)
    else:
        sp["mixer"] = M.spec_mamba2(cfg, model_axis)
    if ffn_kind != "none":
        sp["norm2"] = spec_rms_norm()
        sp["ffn"] = (spec_mlp(cfg.mlp_type, model_axis) if ffn_kind == "dense"
                     else spec_moe(cfg, model_axis))
    return sp


def stacked_specs(tree: Tree) -> Tree:
    """Placements of a stacked layer: the leading period axis replicated."""
    return _index(tree, lambda sp: (None,) + sp) if isinstance(tree, dict) else (None,) + tree


def lm_param_specs(cfg: ModelConfig, model_axis: str = "model") -> Dict[str, tuple]:
    """The twin of the reference's ``lm_param_specs``: each parameter's
    placement over a mesh with a ``model_axis`` (heads, FFN hidden and
    inner channels sharded; norms, routers and latent projections
    replicated), a tuple with one entry per dim, keyed by the parameter's
    path (:func:`repro_torch.utils.pytree.flatten_paths`)."""
    head_pat, period_pat, _ = _period_patterns(cfg)
    specs: Dict[str, Any] = {"embed": (model_axis, None), "final_norm": spec_rms_norm()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, model_axis)
    specs["head_layers"] = [spec_block(cfg, k, f, model_axis) for k, f in head_pat]
    specs["layers"] = {f"pos{i}": stacked_specs(spec_block(cfg, k, f, model_axis))
                       for i, (k, f) in enumerate(period_pat)}
    return flatten_paths(specs)


def _spec_block_cache(cfg: ModelConfig, kind: str, batch_axes, model_axis: str) -> Dict:
    if kind == "attn" and cfg.attn_impl == "mla":
        return A.spec_mla_cache(cfg, batch_axes, model_axis)
    if kind == "attn":
        return A.spec_gqa_cache(cfg, batch_axes, model_axis)
    return M.spec_mamba2_cache(cfg, batch_axes, model_axis)


def cache_specs(cfg: ModelConfig, batch_axes, model_axis: str = "model") -> Dict[str, tuple]:
    """The twin of the reference's ``cache_specs``: each cache leaf's
    placement (the batch over ``batch_axes``, heads or channels over
    ``model_axis``), keyed by path."""
    head_pat, period_pat, _ = _period_patterns(cfg)
    specs: Dict[str, Any] = {
        "pos": (),
        "head_layers": [_spec_block_cache(cfg, k, batch_axes, model_axis) for k, _ in head_pat],
        "layers": {f"pos{i}": stacked_specs(_spec_block_cache(cfg, k, batch_axes, model_axis))
                   for i, (k, _) in enumerate(period_pat)}}
    return flatten_paths(specs)


def init_lm(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
            leaf_hook=None) -> Tree:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (stacked layers drawn whole, one leaf at a time).  On the
    meta device: the tree's shapes and dtypes, nothing allocated.
    ``leaf_hook``: see :func:`repro_torch.models.layers.seeded_generator`."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    gen = seeded_generator(dev, seed, leaf_hook)
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
    if kind == "attn" and cfg.attn_impl == "mla":
        return A.init_mla_cache(cfg, batch, max_seq, dtype, device, stack)
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


def unstack(tree: Tree, n: int) -> list:
    """The ``n`` layers of a stacked nested dict, every leaf unbound once
    along its first axis.  A layer's gradient then lands in one stack of
    all ``n`` (unbind's backward), where indexing each layer apart would
    write a zero-filled copy of the whole stacked leaf per layer and add
    them: work quadratic in the depth."""
    unbound = _index(tree, lambda t: t.unbind(0))
    return [_index(unbound, lambda views, i=i: views[i]) for i in range(n)]


def params_from_paths(flat: Dict[str, Tensor], cfg: ModelConfig) -> Tree:
    """The parameter tree of a flat dict keyed by leaf path (the layout of
    :func:`repro_torch.utils.pytree.flatten_paths`)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    if cfg.is_enc_dec:
        return tree
    head = tree.pop("head_layers", {})
    tree["head_layers"] = [head[str(i)] for i in range(len(_period_patterns(cfg)[0]))]
    return tree


def _cos_sin(cfg: ModelConfig, b: int, s: int, offset, device, positions=None):
    """RoPE tables at ``positions`` (M-RoPE's (3, B, S) under
    ``mrope_sections``), by default the text positions ``offset +
    arange(s)`` (MLA rotates its rope_head_dim part only); None for stacks
    without RoPE (SSM, hybrid)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return None
    hd = cfg.mla.rope_head_dim if cfg.attn_impl == "mla" else cfg.resolved_head_dim
    if positions is None:
        ids = mrope_text_positions if cfg.mrope_sections is not None else text_positions
        positions = ids(b, s, offset, device)
    return rope_cos_sin(positions, hd, cfg.rope_theta, cfg.mrope_sections)


def _ffn(bp: Dict, cfg: ModelConfig, ffn_kind: str, x: Tensor, slotted: bool = False,
         tp=None, idle=None, fsdp=None):
    """The block's FFN on its normed input: (out, MoE aux loss or None);
    ``fsdp``: an MoE layer fills capacity over the agent's whole batch."""
    h = rms_norm(x, vec(bp["norm2"]["scale"], slotted, 3), cfg.norm_eps)
    if ffn_kind == "dense":
        tp = sharded(tp, bp["ffn"]["w_down"].shape[-2], cfg.d_ff)
        return mlp_forward(bp["ffn"], cfg.mlp_type, h, slotted, tp), None
    return moe_forward(bp["ffn"], cfg, h, slotted, tp, idle, fsdp)


def gathered(fsdp, tree: Tree, path: str, layer: bool = False) -> Tree:
    """``tree`` (the parameters at ``path``) gathered over the data ranks
    under ``fsdp`` (:class:`repro_torch.launch.mesh.DataAxis`), as it is
    without."""
    return tree if fsdp is None else fsdp.gather(tree, path, layer)


def _lm_head(params: Tree, cfg: ModelConfig, fsdp=None) -> Tensor:
    """The vocabulary projection's weight (the embedding's transpose when
    tied), gathered over the data ranks under ``fsdp``."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    head = gathered(fsdp, params[key], key)
    return head.transpose(-1, -2) if cfg.tie_embeddings else head


def vocab_tp(params: Tree, cfg: ModelConfig, tp, fsdp=None):
    """``tp`` when the vocabulary is split over the model ranks."""
    emb = params["embed"]
    rows = emb.shape[0] if fsdp is None else fsdp.whole_shape("embed", emb)[0]
    return sharded(tp, rows, cfg.vocab_size)


def embed_lookup(embed: Tensor, ids: Tensor, tp=None) -> Tensor:
    """``embed[ids]``; under ``tp`` (``embed`` this rank's block of rows) the
    ids outside the block look up zeros and the ranks' rows are summed."""
    if tp is None:
        return embed[ids.long()]
    n = embed.shape[0]
    local = ids.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    return tp.exit(torch.where(inside[..., None], rows, torch.zeros_like(rows)))


def head_logits(params: Tree, cfg: ModelConfig, hidden: Tensor, tp=None,
                fsdp=None) -> Tensor:
    """The vocabulary projection, gathered over the model ranks when the
    vocabulary is split (the reference's replicated logits)."""
    tp = vocab_tp(params, cfg, tp, fsdp)
    if tp is None:
        return linear(hidden, _lm_head(params, cfg, fsdp))
    return tp.gather(linear(tp.enter(hidden), _lm_head(params, cfg, fsdp)))


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def block_forward(bp: Dict, cfg: ModelConfig, kind: str, ffn_kind: str, x: Tensor,
                  cos_sin, tp=None, fsdp=None) -> Tuple[Tensor, Tensor]:
    """One layer of the training forward on its gathered parameters: (x,
    MoE aux loss); ``fsdp``: x is this data rank's share of the agent's
    batch, whose expert capacity an MoE layer fills over the whole batch."""
    h = rms_norm(x, bp["norm1"]["scale"], cfg.norm_eps)
    if kind == "attn" and cfg.attn_impl == "mla":
        h = A.mla_forward(bp["mixer"], cfg, h, cos_sin, tp=tp)
    elif kind == "attn":
        h = A.gqa_forward(bp["mixer"], cfg, h, cos_sin, tp=tp)
    else:
        h = M.mamba2_forward(bp["mixer"], cfg, h, tp=tp)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn_kind != "none":
        h, a = _ffn(bp, cfg, ffn_kind, x, tp=tp, fsdp=fsdp)
        x = x + h
        if a is not None:
            aux = aux + a
    return x, aux


def _embed(params: Tree, tokens: Tensor, prefix_embeds: Optional[Tensor], cfg: ModelConfig,
           tp=None, fsdp=None) -> Tensor:
    """Token embeddings (B, S_txt, d), after the prefix (B, S_img, d) when
    one is given (cast to the embeddings' dtype)."""
    x = embed_lookup(gathered(fsdp, params["embed"], "embed"), tokens,
                     vocab_tp(params, cfg, tp, fsdp))
    if prefix_embeds is None:
        return x
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def _hidden_states(params: Tree, cfg: ModelConfig, tokens: Tensor,
                   prefix_embeds: Optional[Tensor] = None,
                   positions: Optional[Tensor] = None, tp=None,
                   fsdp=None) -> Tuple[Tensor, Tensor]:
    """Forward to the final norm, without the vocabulary projection; returns
    (hidden (B, S_img + S_txt, d), MoE aux loss summed over the layers).
    Under ``fsdp`` each head layer and each period is gathered where it
    starts, the period inside its remat region."""
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    x = _embed(params, tokens, prefix_embeds, cfg, tp, fsdp)
    b, s, _ = x.shape
    cos_sin = _cos_sin(cfg, b, s, 0, x.device, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (bp, (k, f)) in enumerate(zip(params["head_layers"], head_pat)):
        x, a = block_forward(gathered(fsdp, bp, f"head_layers/{j}"), cfg, k, f, x, cos_sin, tp,
                             fsdp)
        aux = aux + a

    # the stacked shards unbound once; a period gathers its own layers
    layers = [unstack(params["layers"][f"pos{i}"], n_periods) for i in range(len(period_pat))]

    def period(x_in: Tensor, p: int) -> Tuple[Tensor, Tensor]:
        lp = gathered(fsdp, {f"pos{i}": layers[i][p] for i in range(len(period_pat))}, "layers",
                      layer=True)
        a_tot = torch.zeros((), dtype=torch.float32, device=x_in.device)
        for i, (k, f) in enumerate(period_pat):
            x_in, a = block_forward(lp[f"pos{i}"], cfg, k, f, x_in, cos_sin, tp, fsdp)
            a_tot = a_tot + a
        return x_in, a_tot

    remat = cfg.remat and can_remat(x)
    auxs = []
    for p in range(n_periods):
        x, a = remat_call(cfg.remat_policy, period, x, p) if remat else period(x, p)
        auxs.append(a)
    aux = aux + torch.sum(torch.stack(auxs))
    norm = gathered(fsdp, params["final_norm"], "final_norm")
    return rms_norm(x, norm["scale"], cfg.norm_eps), aux


def lm_forward(params: Tree, cfg: ModelConfig, tokens: Tensor, *,
               prefix_embeds: Optional[Tensor] = None,
               positions: Optional[Tensor] = None, tp=None,
               fsdp=None) -> Tuple[Tensor, Tensor]:
    """Full causal training forward over the prefix and the tokens; returns
    (logits (B, S_img + S_txt, V), MoE aux)."""
    hidden, aux = _hidden_states(params, cfg, tokens, prefix_embeds, positions, tp, fsdp)
    return head_logits(params, cfg, hidden, tp, fsdp), aux


def _ce_sum(logits: Tensor, targets: Tensor, tp=None) -> Tensor:
    """The summed cross-entropy of ``logits`` (..., V) in float32; under
    ``tp`` the logits are this rank's block of the vocabulary and the max,
    the sum of exponentials and the target's logit are reduced over the
    model ranks."""
    pred = logits.to(torch.float32)
    if tp is None:
        gold = torch.gather(pred, -1, targets.long()[..., None])[..., 0]
        return torch.sum(torch.logsumexp(pred, dim=-1) - gold)
    n = pred.shape[-1]
    top = tp.max(torch.amax(pred, dim=-1, keepdim=True))
    lse = torch.log(tp.exit(torch.sum(torch.exp(pred - top), dim=-1))) + top[..., 0]
    local = targets.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(pred, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp.exit(torch.where(inside, gold, torch.zeros_like(gold)))
    return torch.sum(lse - gold)


def vocab_ce_sum(hidden: Tensor, head: Tensor, targets: Tensor, tp=None) -> Tensor:
    """``_ce_sum`` of the logits ``hidden @ head``: under ``tp`` (``head``
    this rank's vocabulary columns) the hidden states enter and the logits
    stay split."""
    if tp is not None:
        hidden = tp.enter(hidden)
    return _ce_sum(linear(hidden, head), targets, tp)


def _chunked_ce(hidden: Tensor, head: Tensor, targets: Tensor, chunk: int,
                tp=None) -> Tensor:
    """Next-token CE over sequence chunks: one (B, chunk, V) logits block is
    live at a time in the forward pass."""
    b, s_pred, _ = hidden.shape
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s_pred, min(chunk, s_pred)):
        c1 = min(c0 + chunk, s_pred)
        total = total + vocab_ce_sum(hidden[:, c0:c1], head, targets[:, c0:c1], tp)
    return total / (b * s_pred)


def tie_gathered(params: Tree, cfg: ModelConfig, fsdp) -> Tuple[Tree, Any]:
    """``(params, fsdp)`` with a tied embedding gathered once over the data
    ranks, for its lookup and the head both, and marked whole in ``fsdp``."""
    if fsdp is None or not cfg.tie_embeddings:
        return params, fsdp
    return {**params, "embed": fsdp.gather(params["embed"], "embed")}, fsdp.gathered("embed")


def lm_loss(params: Tree, cfg: ModelConfig, batch: Dict, tp=None, fsdp=None) -> Tensor:
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S): position t
    of the text tail predicts token t + 1, logits in float32; plus the MoE
    aux loss.  ``batch`` may carry ``prefix_embeds`` and ``positions``
    (VLM).  ``fsdp``: pod-as-agent's data axis
    (:class:`repro_torch.launch.mesh.DataAxis`), when ``params`` are this
    rank's data shards; each leaf is gathered where it is used."""
    tokens = batch["tokens"]
    prefix, positions = batch.get("prefix_embeds"), batch.get("positions")
    b, s = tokens.shape
    params, fsdp = tie_gathered(params, cfg, fsdp)
    vtp = vocab_tp(params, cfg, tp, fsdp)
    if cfg.loss_chunk > 0:
        hidden, aux = _hidden_states(params, cfg, tokens, prefix, positions, tp, fsdp)
        return _chunked_ce(hidden[:, -s:-1], _lm_head(params, cfg, fsdp), tokens[:, 1:],
                           cfg.loss_chunk, vtp) + aux
    if vtp is not None:
        hidden, aux = _hidden_states(params, cfg, tokens, prefix, positions, tp, fsdp)
        return vocab_ce_sum(hidden[:, -s:-1], _lm_head(params, cfg, fsdp), tokens[:, 1:],
                            vtp) / (b * (s - 1)) + aux
    logits, aux = lm_forward(params, cfg, tokens, prefix_embeds=prefix, positions=positions,
                             tp=tp, fsdp=fsdp)
    return _ce_sum(logits[:, -s:-1], tokens[:, 1:]) / (b * (s - 1)) + aux


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_block(bp: Dict, cfg: ModelConfig, kind: str, ffn_kind: str, x: Tensor,
                   cos_sin, cc: Dict, use_kernels: bool, tp=None) -> Tensor:
    h = rms_norm(x, bp["norm1"]["scale"], cfg.norm_eps)
    mp = bp["mixer"]
    b, s, _ = x.shape
    if kind == "attn":
        ttp = A.gqa_tp(mp, cfg, tp)
        h = h if ttp is None else ttp.enter(h)
    if kind == "attn" and cfg.attn_impl == "mla":
        q_nope, q_rope, c_kv, k_rope = A._mla_qkr(mp, cfg, h, cos_sin, tp=ttp)
        A.mla_fill_cache(cc, c_kv, k_rope)
        q, k, v = A.mla_qkv(mp, q_nope, q_rope, c_kv, k_rope)
        core = A.attention_core(q, k, v, causal=True, softcap=cfg.attn_logit_softcap,
                                use_kernel=use_kernels)
        out = linear(core.reshape(b, s, -1), mp["wo"].flatten(0, 1))
    elif kind == "attn":
        q, k, v = A._project_qkv(mp, cfg, h, tp=ttp)
        q, k = A.rope_qk(q, k, cos_sin)
        A.gqa_fill_cache(cc, k, v)
        # K6 reads whole tiles through TMA: the rank's KV heads made contiguous
        k, v = (t.contiguous() for t in A.local_kv(cfg, ttp, q.shape[2], k, v))
        core = A.attention_core(q, k, v, causal=True, window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap, use_kernel=use_kernels)
        out = linear(core.reshape(b, s, -1), mp["wo"].flatten(0, 1))
    else:
        s_cfg = cfg.ssm
        ttp, d_in, _, heads = M._local(mp, cfg, tp)
        if ttp is not None:
            h, mp = ttp.enter(h), M._tp_params(mp, cfg, ttp, heads)
        z, xbc, dt_raw = M._split_proj(cfg, linear(h, mp["in_proj"]), d_in)
        conv_full = M.causal_conv(xbc, mp["conv_w"], mp["conv_b"])
        conv_win = xbc[:, -(s_cfg.d_conv - 1):, :]
        xm, b_mat, c_mat = M._split_xbc(cfg, F.silu(conv_full), d_in)
        dt = M.softplus(dt_raw.to(torch.float32) + mp["dt_bias"])
        a_neg = -torch.exp(mp["a_log"])
        scan = ssd_scan if use_kernels else kref.ssd_scan_ref
        y, final_state = scan(xm, dt.to(xm.dtype), a_neg, b_mat, c_mat, chunk=s_cfg.chunk)
        y = y.to(x.dtype) + mp["d_skip"].to(x.dtype)[None, None, :, None] * xm
        out = linear(M._gated_norm(y.reshape(b, s, d_in), z, mp["norm"], cfg, ttp),
                     mp["out_proj"])
        cc["conv"].copy_(conv_win)
        cc["ssm"].copy_(final_state)
    x = x + (out if ttp is None else ttp.exit(out))
    if ffn_kind != "none":
        x = x + _ffn(bp, cfg, ffn_kind, x, tp=tp)[0]
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
    tp=None,
) -> Tuple[Tensor, Dict]:
    """Full causal forward over the prefix (if any) and the tokens, and the
    cache fill; returns (logits (B, S_img + S, V), cache), the cache's
    ``pos`` at the stream's length.

    A Mamba layer keeps the last ``d_conv - 1`` inputs of its convolution
    in the cache, so prompts shorter than that are refused."""
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    x = _embed(params, tokens, prefix_embeds, cfg, tp)
    b, s, _ = x.shape
    if "mamba" in cfg.layer_kinds() and s < cfg.ssm.d_conv - 1:
        raise ValueError(f"{cfg.name}: a prompt needs at least {cfg.ssm.d_conv - 1} tokens "
                         f"(the conv window), got {s}")
    cos_sin = _cos_sin(cfg, b, s, 0, x.device, positions)
    for bp, (k, f), cc in zip(params["head_layers"], head_pat, cache["head_layers"]):
        x = _prefill_block(bp, cfg, k, f, x, cos_sin, cc, use_kernels, tp)
    for p in range(n_periods):
        for i, (k, f) in enumerate(period_pat):
            bp = _index(params["layers"][f"pos{i}"], lambda t: t[p])
            cc = _index(cache["layers"][f"pos{i}"], lambda t: t[p])
            x = _prefill_block(bp, cfg, k, f, x, cos_sin, cc, use_kernels, tp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = head_logits(params, cfg, x, tp)
    cache["pos"].fill_(s)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_block(bp: Dict, cfg: ModelConfig, kind: str, ffn_kind: str, x: Tensor, cos_sin,
                  cc: Dict, pos: Tensor, slotted: bool, tp=None, idle=None) -> Tensor:
    h = rms_norm(x, vec(bp["norm1"]["scale"], slotted, 3), cfg.norm_eps)
    if kind == "attn":
        decode = A.mla_decode if cfg.attn_impl == "mla" else A.gqa_decode
        h = decode(bp["mixer"], cfg, h, cos_sin, cc, pos, slotted, tp, idle)
    else:
        h = M.mamba2_decode(bp["mixer"], cfg, h, cc, slotted, tp, idle)
    x = x + h
    if ffn_kind != "none":
        x = x + _ffn(bp, cfg, ffn_kind, x, slotted, tp, idle)[0]
    return x


def lm_decode(
    params: Tree,
    cfg: ModelConfig,
    token: Tensor,  # (B, 1)
    cache: Dict,
    *,
    slotted: bool = False,
    tp=None,
    idle=None,
) -> Tuple[Tensor, Dict]:
    """One decode step; returns (logits (B, 1, V), cache advanced in place).

    Shared parameters take the reference's cache: leaves (n_periods, B, ...)
    and a scalar ``pos``.  Slotted parameters (a leading slot axis of size
    B on every leaf) take the engine's slot-stacked cache: leaves
    (B, n_periods, 1, ...) and ``pos`` (B,), one position per slot.
    ``idle``: a batch-1 decode's idle axes
    (:class:`repro_torch.launch.mesh.IdleAxis`), over which the cache's
    sequence, the SSM state's heads and the experts are split (the
    reference's ``--opt-idle-batch``)."""
    head_pat, period_pat, n_periods = _period_patterns(cfg)
    b = token.shape[0]
    pos = cache["pos"]
    posv = pos.reshape(1).expand(b) if pos.dim() == 0 else pos
    tok = token[:, 0].long()
    if slotted and tp is not None:
        raise ValueError("slotted decode runs on whole parameters (no model axis)")
    if slotted:
        x = params["embed"][torch.arange(b, device=tok.device), tok][:, None, :]
    else:
        x = embed_lookup(params["embed"], tok, vocab_tp(params, cfg, tp))[:, None, :]
    cos_sin = _cos_sin(cfg, b, 1, posv, x.device)
    for j, ((k, f), bp) in enumerate(zip(head_pat, params["head_layers"])):
        cc = cache["head_layers"][j]
        if slotted:
            cc = _index(cc, lambda t: t[:, 0])
        x = _decode_block(bp, cfg, k, f, x, cos_sin, cc, posv, slotted, tp, idle)
    for p in range(n_periods):
        for i, (k, f) in enumerate(period_pat):
            if slotted:
                bp = _index(params["layers"][f"pos{i}"], lambda t: t[:, p])
                cc = _index(cache["layers"][f"pos{i}"], lambda t: t[:, p, 0])
            else:
                bp = _index(params["layers"][f"pos{i}"], lambda t: t[p])
                cc = _index(cache["layers"][f"pos{i}"], lambda t: t[p])
            x = _decode_block(bp, cfg, k, f, x, cos_sin, cc, posv, slotted, tp, idle)
    x = rms_norm(x, vec(params["final_norm"]["scale"], slotted, 3), cfg.norm_eps)
    logits = (linear(x, _lm_head(params, cfg), slotted) if slotted
              else head_logits(params, cfg, x, tp))
    pos.add_(1)
    return logits, cache
