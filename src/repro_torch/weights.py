"""Carry weights and state across from the JAX package, and back.

Layouts stay the reference's at this boundary: the MLP's ``w1`` is already
(hidden, d_in), and the CNN keeps NHWC/HWIO (its forward converts inside),
so crossing over is a copy into a tensor on the target device.  The JAX
side hands over numpy arrays (``np.asarray`` of its arrays); nothing here
imports JAX.  The LM zoo's nested trees (parameters and caches) cross with
:func:`lm_params_from_jax` / :func:`lm_cache_from_jax` and back.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike

Tree = Dict[str, torch.Tensor]

# tree fields of each state type; ``step`` (and PISCO's ``ef``) cross apart
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
    gets a fresh generator seeded with ``seed``.  The reference's update-rule
    state (``opt``) is not ported (ROADMAP A9) and must be empty."""
    from repro_torch.core import baselines, pisco

    if getattr(state, "opt", ()):
        raise NotImplementedError("update-rule state is not ported yet (ROADMAP A9)")
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
    return cls(**fields)


def state_to_numpy(state: Any) -> Dict[str, Any]:
    """Inverse of :func:`state_from_jax` (the generator does not cross)."""
    out = {f: to_numpy(getattr(state, f)) for f in _TREE_FIELDS[type(state).__name__]}
    out["step"] = int(state.step)
    if getattr(state, "ef", ()):
        out["ef"] = {k: to_numpy(state.ef[k]) if state.ef[k] else () for k in ("x", "y")}
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


def lm_params_from_jax(params: Any, device: DeviceLike) -> Any:
    """LM parameters of the reference (``init_lm``'s nested tree: dicts, the
    ``head_layers`` list and the stacked ``layers``) as the port's."""
    return tree_from_jax(params, device)


def lm_cache_from_jax(cache: Any, device: DeviceLike) -> Any:
    """A reference KV/SSM cache (``init_cache`` / ``lm_prefill`` layout, with
    its scalar ``pos``) as the port's."""
    return tree_from_jax(cache, device)


def lm_params_to_numpy(params: Any, bf16_dtype: Any = None) -> Any:
    return tree_to_numpy(params, bf16_dtype)


def lm_cache_to_numpy(cache: Any, bf16_dtype: Any = None) -> Any:
    return tree_to_numpy(cache, bf16_dtype)
