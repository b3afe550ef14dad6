"""Carry weights and state across from the JAX package, and back.

Layouts stay the reference's at this boundary: the MLP's ``w1`` is already
(hidden, d_in), and the CNN keeps NHWC/HWIO (its forward converts inside),
so crossing over is a copy into a tensor on the target device.  The JAX
side hands over numpy arrays (``np.asarray`` of its arrays); nothing here
imports JAX.  The LM zoo's nested trees (parameters and caches, the
encoder-decoder's among them) cross with :func:`lm_params_from_jax` /
:func:`lm_cache_from_jax` and back; a PISCO
state over LM trees crosses with :func:`lm_state_from_jax` as flat,
path-keyed dicts, and :func:`split_state` / :func:`join_states` cut an
agent-stacked state into one state per rank and back.  Over a model axis
:func:`lm_params_from_jax` cuts each leaf to the rank's model shard, and
:func:`init_model_shard` draws a rank's shard of a random init without the
whole model.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike

Tree = Dict[str, torch.Tensor]

# tree fields of each state type; ``step``, PISCO's ``ef`` and every
# state's ``opt`` cross apart
_TREE_FIELDS = {
    "PiscoState": ("x", "y", "g"),
    "GTState": ("x", "y", "g"),
    "ScaffoldState": ("x", "c_i", "c"),
    "SGDState": ("x",),
}


def from_jax(params: Mapping[str, Any], device: DeviceLike) -> Tree:
    """Model params (or any agent-stacked dict) as tensors on ``device``,
    keeping each array's dtype and layout."""
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_jax`: numpy arrays in the reference layout."""
    return {k: params[k].detach().cpu().numpy() for k in sorted(params)}


def _state_kind(state: Any) -> str:
    """The port's state type for a reference state, from its fields: PISCO
    (and periodical GT) carry ``ef``, DSGT carries ``y`` without it,
    SCAFFOLD carries ``c_i``, DSGD / Gossip-PGA / FedAvg only ``x``."""
    if hasattr(state, "c_i"):
        return "ScaffoldState"
    if hasattr(state, "y"):
        return "PiscoState" if hasattr(state, "ef") else "GTState"
    return "SGDState"


def state_from_jax(state: Any, device: DeviceLike, *, seed: int = 0) -> Any:
    """An agent-stacked reference state as the port's state of the same
    algorithm: ``PiscoState`` (``x``, ``y``, ``g``, ``step``, optionally
    ``ef``), ``GTState``, ``ScaffoldState`` or ``SGDState``.  Error-feedback
    residuals carry across; the JAX PRNG key cannot, so a compressed state
    gets a fresh generator seeded with ``seed``.  The update-rule state
    (``opt``: the rules' buffers and step counts) carries across as it is."""
    from repro_torch.core import baselines, pisco

    kind = _state_kind(state)
    cls = pisco.PiscoState if kind == "PiscoState" else getattr(baselines, kind)
    fields = {f: from_jax(getattr(state, f), device) for f in _TREE_FIELDS[kind]}
    fields["step"] = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device)
    if kind == "PiscoState":
        ef = getattr(state, "ef", ())
        if ef:
            dev = torch.device(device)
            ef = {
                "x": from_jax(ef["x"], dev) if ef["x"] else (),
                "y": from_jax(ef["y"], dev) if ef["y"] else (),
                "gen": torch.Generator(device=dev).manual_seed(seed),
            }
        fields["ef"] = ef
    fields["opt"] = tree_from_jax(getattr(state, "opt", ()), device)
    return cls(**fields)


def state_to_numpy(state: Any) -> Dict[str, Any]:
    """Inverse of :func:`state_from_jax` (the generator does not cross)."""
    out = {f: to_numpy(getattr(state, f)) for f in _TREE_FIELDS[type(state).__name__]}
    out["step"] = int(state.step)
    if getattr(state, "ef", ()):
        out["ef"] = {k: to_numpy(state.ef[k]) if state.ef[k] else () for k in ("x", "y")}
    if state.opt:
        out["opt"] = tree_to_numpy(state.opt)
    return out


# ---------------------------------------------------------------------------
# Nested trees of the LM zoo: parameters and caches
# ---------------------------------------------------------------------------


def _leaf_from_numpy(a: Any, device: DeviceLike) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: cross as its bits
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor, bf16_dtype: Any) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def tree_from_jax(tree: Any, device: DeviceLike) -> Any:
    """A nested tree of arrays (dicts, lists, tuples) as tensors on
    ``device``, each leaf keeping its dtype and shape; bfloat16 leaves cross
    over as their ``uint16`` bits viewed as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: tree_from_jax(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_jax(x, device) for x in tree)
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree: Any, bf16_dtype: Any = None) -> Any:
    """Inverse of :func:`tree_from_jax`.  bfloat16 leaves come back as their
    ``uint16`` bits, viewed as ``bf16_dtype`` when one is given (the JAX
    side passes ``ml_dtypes.bfloat16``; the port imports no such package)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(tree[k], bf16_dtype) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(x, bf16_dtype) for x in tree)
    return _leaf_to_numpy(tree, bf16_dtype)


def lm_params_from_jax(params: Any, device: DeviceLike, layout: Any = None,
                       mesh: Any = None) -> Any:
    """LM parameters of the reference as the port's, every family's leaves
    as they are: ``init_lm``'s nested tree (dicts, the ``head_layers`` list
    and the stacked ``layers``: MoE's float32 router, its (periods, experts,
    d_in, d_out) expert stacks and the shared experts' dict, MLA's
    projections, Mamba's float32 ``a_log`` / ``dt_bias`` / ``d_skip``) and
    the encoder-decoder's ``init_encdec`` tree (the stacked ``enc_layers``
    and ``dec_layers`` with their ``cross_attn``); this one function carries
    both.  With a model ``layout`` (:func:`repro_torch.launch.steps.param_layout`)
    each leaf is then cut to ``mesh``'s rank's model shard
    (:func:`repro_torch.launch.specs.shard_tree`)."""
    tree = tree_from_jax(params, device)
    if layout is None:
        return tree
    from repro_torch.launch.specs import shard_tree

    return shard_tree(tree, layout, mesh)


def lm_cache_from_jax(cache: Any, device: DeviceLike) -> Any:
    """A reference cache as the port's: ``init_cache`` / ``lm_prefill``'s
    layout, with its scalar ``pos`` (GQA's ``k`` / ``v``, MLA's ``c_kv`` /
    ``k_rope``, Mamba's ``conv`` / ``ssm``, mixed by position in a hybrid
    stack), or the encoder-decoder's ``init_encdec_cache`` layout (``pos``,
    the stacked ``self_kv`` and the encoder ``memory``)."""
    return tree_from_jax(cache, device)


def lm_params_to_numpy(params: Any, bf16_dtype: Any = None) -> Any:
    return tree_to_numpy(params, bf16_dtype)


def lm_cache_to_numpy(cache: Any, bf16_dtype: Any = None) -> Any:
    return tree_to_numpy(cache, bf16_dtype)


# ---------------------------------------------------------------------------
# PISCO states over LM trees, and one agent per rank
# ---------------------------------------------------------------------------


def lm_state_from_jax(state: Any, device: DeviceLike, *, seed: int = 0) -> Any:
    """A reference ``PiscoState`` whose x, y, g (and error-feedback
    residuals) are agent-stacked LM trees, as the port's ``PiscoState`` over
    flat dicts keyed by leaf path (what the collective round carries).  The
    JAX PRNG key does not cross: a compressed state gets a fresh generator
    seeded with ``seed``.  In the update-rule state, each buffer shaped like
    the parameters (a dict with the LM tree's top-level keys) is flattened
    the same way; step counts cross as they are."""
    from repro_torch.core.pisco import PiscoState
    from repro_torch.utils.pytree import flatten_paths

    top = sorted(state.x)

    def opt_leaves(tree):
        if isinstance(tree, dict):
            if sorted(tree) == top:
                return flatten_paths(tree_from_jax(tree, device))
            return {k: opt_leaves(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(opt_leaves(x) for x in tree)
        return _leaf_from_numpy(tree, device)

    fields = {f: flatten_paths(tree_from_jax(getattr(state, f), device)) for f in ("x", "y", "g")}
    ef = getattr(state, "ef", ())
    if ef:
        ef = {k: flatten_paths(tree_from_jax(ef[k], device)) if ef[k] else () for k in ("x", "y")}
        ef["gen"] = torch.Generator(device=torch.device(device)).manual_seed(seed)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device)
    return PiscoState(step=step, ef=ef, opt=opt_leaves(getattr(state, "opt", ())), **fields)


def split_state(state: Any) -> List[Any]:
    """One ``PiscoState`` per agent (x, y, g rows and the step) of an
    agent-stacked one: what rank ``a`` of a collective mixer holds.  The
    error-feedback state does not split: attach it per rank with
    ``init_compression_state``."""
    from repro_torch.core.pisco import PiscoState

    n = next(iter(state.x.values())).shape[0]
    return [PiscoState(**{f: {k: v[a].clone() for k, v in getattr(state, f).items()}
                          for f in ("x", "y", "g")}, step=state.step.clone())
            for a in range(n)]


def join_states(states: List[Any]) -> Dict[str, Any]:
    """The agent-stacked numpy view of per-rank states (each brought to the
    host; bfloat16 as its uint16 bits): x, y, g and, where the ranks carry
    them, the residuals."""
    def stack(trees):
        return {k: np.stack([_leaf_to_numpy(t[k], None) for t in trees]) for k in sorted(trees[0])}

    out: Dict[str, Any] = {f: stack([getattr(st, f) for st in states]) for f in ("x", "y", "g")}
    out["step"] = int(states[0].step)
    if states[0].ef:
        out["ef"] = {s: stack([st.ef[s] for st in states]) for s in ("x", "y")}
    return out


def init_model_shard(bundle: Any, layout: Mapping[str, Any], mesh: Any, seed: int = 0,
                     idle: Any = None) -> Any:
    """``bundle.init(seed)`` cut to this rank's model shard without ever
    holding the whole model: each random leaf is cut as soon as it is drawn
    (``bundle.init``'s ``leaf_hook``) and its whole tensor dropped, so a rank
    holds one whole leaf at most beside its shards; the values are the
    whole init's, block for block.  ``layout``: the model layout of the
    parameters (:func:`repro_torch.launch.steps.param_layout`).  ``idle``:
    ``(dims, axes)`` of a batch-1 decode over the idle axes
    (:class:`repro_torch.launch.steps.IdleLayouts`' ``params`` and
    ``axes``): each model shard is then cut to this rank's block over those
    axes as well (its experts)."""
    import dataclasses

    from repro_torch.launch.specs import shard_leaf
    from repro_torch.utils.pytree import flatten_paths, nest_map_with_path

    # the order in which the init draws its random leaves, by path (a meta
    # init draws the same leaves in the same order and allocates nothing)
    drawn: list = []
    meta = dataclasses.replace(bundle, device=torch.device("meta")).init(
        seed, leaf_hook=lambda t: drawn.append(t) or t)
    path_of = {id(t): p for p, t in flatten_paths(meta).items()}
    order = iter([path_of.get(id(t)) for t in drawn])
    done = set()

    def shard(t: torch.Tensor, path: str) -> torch.Tensor:
        t = shard_leaf(t, layout.get(path), mesh)
        return t if idle is None else shard_leaf(t, idle[0].get(path), mesh, idle[1])

    def cut(t: torch.Tensor) -> torch.Tensor:
        path = next(order)
        if path is None:
            return t
        done.add(path)
        return shard(t, path)

    tree = bundle.init(seed, leaf_hook=cut)
    rest = [p for p in flatten_paths(tree) if p not in done]
    return nest_map_with_path(lambda p, t: t if p in done else shard(t, p), tree) if rest else tree
