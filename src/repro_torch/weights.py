"""Carry weights and state across from the JAX package, and back.

Layouts stay the reference's at this boundary: the MLP's ``w1`` is already
(hidden, d_in), and the CNN keeps NHWC/HWIO (its forward converts inside),
so crossing over is a copy into a tensor on the target device.  The JAX
side hands over numpy arrays (``np.asarray`` of its arrays); nothing here
imports JAX.
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
