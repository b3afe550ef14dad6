"""Mixture-of-Experts: sort-based capacity dispatch and DeepSeek-style shared
experts (the twin of ``repro.models.moe``).

Routing follows ``gate_mode``: ``softmax_topk`` (Mixtral: softmax over the
top-k logits) or ``topk_softmax`` (DeepSeek: softmax over all experts, keep
the top k, renormalise).  Ties in the top-k go to the lower expert index, as
``jax.lax.top_k`` (and the port's top-k compressor) breaks them.

Dispatch is the reference's: the T·k (token, expert) entries are sorted
stably by expert, each expert keeps its first ``cap = max(1, min(int(cf·T·k
/ E), T·k))`` entries and drops the rest, and the expert FFN is one batched
product over an (E, cap, d) buffer whose unused rows are zeros, with no
host sync.  A routing group of one token (a decode step) drops nothing (its
k experts are distinct and cap >= 1), so it runs its k experts alone,
reading their weights in place, and leaves the other E - k unread: the
batched product would read E / k times the weights.  Its k expert ids cross
to the host to index the weights.  The combine adds each token's weighted
expert outputs in ascending expert order, the order of the reference's
scatter-add, with no atomics.

A ``slotted`` call (one parameter set per row, the engine's decode over
slots) routes and dispatches each row on its own, with the capacity of its
own tokens: what ``jax.vmap`` of the reference's layer over the slots
computes.  Expert products are plain PyTorch, as the reference computes them
outside any Pallas kernel.

Tensor parallelism (``tp``): each model rank holds its block of every
expert's hidden dim (and of the shared experts'), routes identically (the
router is whole and its input replicated), dispatches its slice, and the
ranks' partial outputs are summed; the routing weights enter the region, so
the router's gradient is summed over the ranks, and the load-balance loss,
computed on every rank from the same routes, is counted once.

Pod-as-agent (``fsdp``, :class:`repro_torch.launch.mesh.DataAxis`): each
data rank holds its block of the agent's rows, rank r the r-th, and routes
its own tokens; capacity is sized and filled over the agent's whole batch,
as the reference's GSPMD does.  In the agent's token stream rank r's
entries follow those of ranks 0 … r-1, so the reference's stable sort by
expert keeps rank r's j-th entry of expert e iff ``before_r[e] + j <
cap_agent``, ``before_r[e]`` the entries of e on the ranks before it and
``cap_agent = capacity(n · T_rank)``: rank r keeps ``keep_r[e] =
clamp(cap_agent - before_r[e], 0, counts_r[e])`` (:func:`agent_keep`).  Only
the ranks' (E,) expert counts cross (one all-gather with no gradient, read
on the host), and no token or output moves: every rank holds the layer's
experts, gathered at the top of its period.  The buffer is (E, c, d) with
``c = max_e keep_r[e]``, never above min(cap_agent, T_rank · k) and near
the balanced share ``capacity(T_rank)`` when routes are balanced; on the
meta device (the dry run), which has no counts, ``c`` is that share.  The
load-balance loss is the agent's: the gathered counts give its expert
shares, the router probabilities are summed over the data ranks (with the
sum's gradient).  Where the agent's batch does not split, every rank holds
it whole and routes it as one group, with no collective.

A batch-1 decode over the idle axes (``idle``) splits the experts over
them: each rank runs the selected experts it holds (the batched form, the
dry run's, drops the entries routed elsewhere) and the partial outputs are
summed over the idle ranks.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import normal_init, sharded
from repro_torch.models.mlp import activation, init_mlp, mlp_forward, spec_mlp

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, stack: tuple = ()) -> Dict[str, Any]:
    mo = cfg.moe
    d, fe, e = cfg.d_model, mo.d_expert, mo.n_experts
    s = cfg.init_scale
    p: Dict[str, Any] = {"router": normal_init(gen, stack + (d, e), s, torch.float32)}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = normal_init(gen, stack + (e, d, fe), s, dtype)
    p["w_up"] = normal_init(gen, stack + (e, d, fe), s, dtype)
    p["w_down"] = normal_init(gen, stack + (e, fe, d), s, dtype)
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, mo.n_shared * fe, cfg.mlp_type, s, dtype, stack)
    return p


def spec_moe(cfg: ModelConfig, model_axis: str = "model") -> Dict[str, Any]:
    """Placements: each expert's hidden dim over ``model_axis`` (the
    reference's tensor-parallel experts), the router replicated."""
    mp = model_axis
    sp: Dict[str, Any] = {"router": (None, None)}
    if cfg.mlp_type == "swiglu":
        sp["w_gate"] = (None, None, mp)
    sp["w_up"] = (None, None, mp)
    sp["w_down"] = (None, mp, None)
    if cfg.moe.n_shared:
        sp["shared"] = spec_mlp(cfg.mlp_type, model_axis)
    return sp


def top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest entries of the last axis, largest first, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: Tensor, mo: MoEConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """(top_idx (T, k), top_w (T, k) float32, probs (T, E) float32)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    if mo.gate_mode == "softmax_topk":
        top_logit, top_idx = top_k(logits, mo.top_k)
        top_w = torch.softmax(top_logit.to(torch.float32), dim=-1)
    elif mo.gate_mode == "topk_softmax":
        top_p, top_idx = top_k(probs, mo.top_k)
        top_w = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    else:
        raise ValueError(mo.gate_mode)
    return top_idx, top_w, probs


def _expert_counts(top_idx: Tensor, n_experts: int) -> Tensor:
    """Entries routed to each expert (int64, on the device, no host sync)."""
    flat = top_idx.reshape(-1).long()
    return torch.zeros(n_experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def aux_load_balance_loss(probs: Tensor, top_idx: Tensor, mo: MoEConfig,
                          fsdp=None, agent_counts: Optional[Tensor] = None) -> Tensor:
    """``E · sum_e f_e · p_e · coef``: f the share of routed entries, p the
    mean router probability of each expert; under ``fsdp`` both over the
    agent's whole batch: f from ``agent_counts`` (each expert's entries
    over the data ranks), p from the router probabilities summed over
    them."""
    if fsdp is None:
        counts = _expert_counts(top_idx, mo.n_experts).to(torch.float32)
        frac = counts / (top_idx.shape[0] * mo.top_k)
        return mo.n_experts * torch.sum(frac * torch.mean(probs, dim=0)) * mo.router_aux_coef
    p_sum = fsdp.sum(probs.sum(0))
    t = top_idx.shape[0] * fsdp.size
    return mo.n_experts * torch.sum(agent_counts.to(torch.float32) / (t * mo.top_k)
                                    * (p_sum / t)) * mo.router_aux_coef


def capacity(mo: MoEConfig, t: int) -> int:
    """Entries each expert keeps out of a layer's ``t`` tokens."""
    return max(1, min(int(mo.capacity_factor * t * mo.top_k / mo.n_experts), t * mo.top_k))


def agent_keep(counts: Tensor, cap_agent: int, index: int) -> Tensor:
    """(E,) entries of each expert that data rank ``index`` keeps: ``counts``
    (n, E) every rank's expert counts in rank order, the ranks' rows
    consecutive blocks of the agent's batch; an expert keeps its first
    ``cap_agent`` entries in the agent's token order, and rank r's follow
    those of the ranks before it."""
    before = counts[:index].sum(0)
    return torch.minimum(torch.clamp(cap_agent - before, min=0), counts[index])


def _agent_capacity(fsdp, top_idx: Tensor, mo: MoEConfig) -> Tuple[Tensor, int, Tensor]:
    """``(keep, c, agent_counts)`` of this data rank under ``fsdp``: the
    entries it keeps of each expert (:func:`agent_keep`) and each expert's
    entries over the agent's batch, both on the device, and the buffer's
    rows ``c = max_e keep[e]``, read on the host (the balanced share
    ``capacity(T_rank)`` on the meta device)."""
    t = top_idx.shape[0]
    counts = fsdp.gather_counts(_expert_counts(top_idx, mo.n_experts))  # (n, E), host
    keep = agent_keep(counts, capacity(mo, fsdp.size * t), fsdp.index)
    c = capacity(mo, t) if counts.device.type == "meta" else int(keep.max())
    both = torch.stack([keep, counts.sum(0)]).to(top_idx.device)
    return both[0], c, both[1]


def _ffn(params: Dict, mlp_type: str, x: Tensor) -> Tensor:
    """The expert FFN: ``x`` (..., d) through weights of matching leading
    axes, (E, cap, d) against (E, d, f) batched or (1, d) against (d, f)."""
    return activation(params, mlp_type, lambda m: x @ m) @ params["w_down"]


def _combine(contrib: Tensor, top_idx: Tensor) -> Tensor:
    """contrib (T, k, d), each entry's weighted output (zero where dropped)
    -> (T, d): a token's k entries added into a zero row in ascending
    expert order."""
    t, k, d = contrib.shape
    by_expert = torch.argsort(top_idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(t, k, d))
    y = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def dispatch_batched(experts: Dict, cfg: ModelConfig, xf: Tensor, top_idx: Tensor,
                     top_w: Tensor, lo: int = 0, keep: Optional[Tensor] = None,
                     cap: Optional[int] = None) -> Tensor:
    """The reference's dispatch: xf (T, d) through an (E, cap, d) buffer and
    one batched product over the experts -> each entry's weighted output
    (T, k, d), zero where dropped.  No host sync.  On a rank that holds
    experts ``[lo, lo + E_local)`` (``experts`` their leaves) the buffer is
    theirs, the entries routed elsewhere are dropped and each held expert
    keeps its first ``cap`` entries of the whole layer's capacity.  Given
    ``keep`` (E,) (pod-as-agent, :func:`_agent_capacity`), expert e keeps its
    first ``keep[e]`` entries in a buffer of ``cap`` rows."""
    mo = cfg.moe
    t, d = xf.shape
    k = mo.top_k
    n_loc = experts["w_down"].shape[-3]
    if keep is None:
        cap = capacity(mo, t)
    whole = n_loc == mo.n_experts
    flat_expert = top_idx.reshape(-1)  # (T·k,)
    if not whole:  # held experts, the entries routed elsewhere in a last bin of their own
        local = flat_expert - lo
        flat_expert = torch.where((local >= 0) & (local < n_loc), local,
                                  torch.full_like(local, n_loc))
    order = torch.argsort(flat_expert, stable=True)  # entries grouped by expert
    counts = (_expert_counts(top_idx, mo.n_experts) if whole
              else _expert_counts(flat_expert, n_loc + 1)[:n_loc])
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix
    slot = torch.arange(cap, device=xf.device)
    limit = torch.clamp(counts, max=cap) if keep is None else keep
    in_range = slot[None, :] < limit[:, None]  # (E_local, cap)
    src = order[torch.clamp(offsets[:, None] + slot[None, :], max=t * k - 1)]
    x_exp = xf[src // k] * in_range[..., None].to(xf.dtype)  # (E_local, cap, d)
    y_exp = _ffn(experts, cfg.mlp_type, x_exp)  # (E_local, cap, d)
    w = top_w.reshape(-1)[src] * in_range.to(torch.float32)
    # each kept entry's weighted output to its place in the (T·k) stream;
    # unused buffer rows go to a spare row past its end
    dest = torch.where(in_range, src, t * k).reshape(-1)
    contrib = torch.zeros((t * k + 1, d), dtype=xf.dtype, device=xf.device).index_copy(
        0, dest, (y_exp * w[..., None].to(y_exp.dtype)).reshape(-1, d))
    return contrib[:t * k].reshape(t, k, d)


def dispatch_in_place(experts: Dict, cfg: ModelConfig, xf: Tensor, top_idx: Tensor,
                      top_w: Tensor, lo: int = 0) -> Tensor:
    """One token (xf (1, d)): its k distinct experts, none dropped, each
    read in place -> (1, k, d).  The k expert ids cross to the host.  On a
    rank that holds experts ``[lo, lo + E_local)`` only those run; the
    entries of the others are zero."""
    n_loc = experts["w_down"].shape[-3]
    rows = []
    for j, i in enumerate(top_idx[0].tolist()):
        if lo <= i < lo + n_loc:
            rows.append(_ffn({n: w[i - lo] for n, w in experts.items()}, cfg.mlp_type, xf)[0]
                        * top_w[0, j].to(xf.dtype))
        else:
            rows.append(torch.zeros_like(xf[0]))
    return torch.stack(rows)[None]


def _moe_tokens(params: Dict, cfg: ModelConfig, xf: Tensor, tp=None,
                idle=None, fsdp=None) -> Tuple[Tensor, Tensor]:
    """xf (T, d) -> (y (T, d), aux): one routing group.  Under ``idle`` this
    rank holds its block of the experts (over the idle axes): it runs the
    entries routed to them, and the partial outputs are summed over the
    idle ranks (in float32 for 16-bit) before the shared experts are
    added; the routing is computed on every rank from the same inputs.
    Under ``fsdp`` xf is this data rank's block of the agent's rows, its
    capacity and aux the whole batch's (where the batch splits)."""
    mo = cfg.moe
    logits = xf.to(torch.float32) @ params["router"]
    top_idx, top_w, probs = route(logits, mo)
    if fsdp is not None and not fsdp.split_batch:
        fsdp = None  # every data rank holds the agent's whole batch
    experts = {n: params[n] for n in ("w_gate", "w_up", "w_down") if n in params}
    if fsdp is not None:
        keep, c, agent_counts = _agent_capacity(fsdp, top_idx, mo)
        aux = aux_load_balance_loss(probs, top_idx, mo, fsdp, agent_counts)
        dispatch = functools.partial(dispatch_batched, keep=keep, cap=c)
    else:
        aux = aux_load_balance_loss(probs, top_idx, mo)
        # one token reads its experts in place (it drops nothing), but its
        # ids are data: on the meta device (the dry run) it takes the
        # batched form, as the reference lowers
        in_place = xf.shape[0] == 1 and xf.device.type != "meta"
        dispatch = dispatch_in_place if in_place else dispatch_batched
    tp_e = sharded(tp, experts["w_down"].shape[-2], mo.d_expert)
    tp_s = (sharded(tp, params["shared"]["w_down"].shape[-2], mo.n_shared * mo.d_expert)
            if mo.n_shared else None)
    x_e, w_e = (xf, top_w) if tp_e is None else (tp_e.enter(xf), tp_e.enter(top_w))
    if idle is None or experts["w_down"].shape[-3] == mo.n_experts:  # whole over idle
        y = _combine(dispatch(experts, cfg, x_e, top_idx, w_e), top_idx)
    else:
        lo = idle.index * experts["w_down"].shape[-3]
        y = idle.sum(_combine(dispatch(experts, cfg, x_e, top_idx, w_e, lo), top_idx))
    if tp_e is not None:
        # the shared experts, n_shared times as wide, split too: one partial
        # sum leaves the region
        if mo.n_shared:
            y = y + mlp_forward(params["shared"], cfg.mlp_type, x_e[None])[0]
        return tp_e.exit(y), aux
    if mo.n_shared:
        y = y + mlp_forward(params["shared"], cfg.mlp_type, xf[None], tp=tp_s)[0]
    return y, aux


def moe_forward(params: Dict, cfg: ModelConfig, x: Tensor,
                slotted: bool = False, tp=None, idle=None,
                fsdp=None) -> Tuple[Tensor, Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss).  With ``slotted`` every leaf
    of ``params`` carries a leading axis of size B and each row is its own
    routing group; aux is then one loss per row.  ``idle``: the experts
    split over a batch-1 decode's idle axes; ``fsdp``: x is this data
    rank's share of the agent's batch (:func:`_moe_tokens`)."""
    b, s, d = x.shape
    if not slotted:
        y, aux = _moe_tokens(params, cfg, x.reshape(b * s, d), tp, idle, fsdp)
        return y.reshape(b, s, d), aux
    ys, auxs = [], []
    for row in range(b):
        p_row = {k: ({kk: vv[row] for kk, vv in v.items()} if isinstance(v, dict) else v[row])
                 for k, v in params.items()}
        y, aux = _moe_tokens(p_row, cfg, x[row])
        ys.append(y)
        auxs.append(aux)
    return torch.stack(ys), torch.stack(auxs)
