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

from repro_torch.core.pisco import PiscoState
from repro_torch.device import DeviceLike

Tree = Dict[str, torch.Tensor]


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


def state_from_jax(state: Any, device: DeviceLike, *, seed: int = 0) -> PiscoState:
    """An agent-stacked reference ``PiscoState`` (anything with ``x``, ``y``,
    ``g``, ``step`` and optionally ``ef``) as a port state.  Error-feedback
    residuals carry across; the JAX PRNG key cannot, so a compressed state
    gets a fresh generator seeded with ``seed``."""
    ef = getattr(state, "ef", ())
    if ef:
        dev = torch.device(device)
        ef = {
            "x": from_jax(ef["x"], dev) if ef["x"] else (),
            "y": from_jax(ef["y"], dev) if ef["y"] else (),
            "gen": torch.Generator(device=dev).manual_seed(seed),
        }
    return PiscoState(
        x=from_jax(state.x, device),
        y=from_jax(state.y, device),
        g=from_jax(state.g, device),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        ef=ef,
    )


def state_to_numpy(state: PiscoState) -> Dict[str, Any]:
    """Inverse of :func:`state_from_jax` (the generator does not cross)."""
    out = {
        "x": to_numpy(state.x),
        "y": to_numpy(state.y),
        "g": to_numpy(state.g),
        "step": int(state.step),
    }
    if state.ef:
        out["ef"] = {k: to_numpy(state.ef[k]) if state.ef[k] else () for k in ("x", "y")}
    return out
