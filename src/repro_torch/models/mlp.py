"""Feed-forward blocks: SwiGLU (Llama family), squared ReLU (Nemotron-4) and
GELU with the tanh approximation (``jax.nn.gelu``'s default)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import linear, normal_init

MLP_TYPES = ("swiglu", "squared_relu", "gelu")


def init_mlp(gen: torch.Generator, d: int, f: int, mlp_type: str, scale: float, dtype,
             stack: tuple = ()) -> Dict[str, torch.Tensor]:
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    p = {}
    if mlp_type == "swiglu":
        p["w_gate"] = normal_init(gen, stack + (d, f), scale, dtype)
    p["w_up"] = normal_init(gen, stack + (d, f), scale, dtype)
    p["w_down"] = normal_init(gen, stack + (f, d), scale, dtype)
    return p


def spec_mlp(mlp_type: str, model_axis: str = "model") -> Dict:
    """Placements: the hidden dim over ``model_axis``."""
    mp = model_axis
    if mlp_type == "swiglu":
        return {"w_gate": (None, mp), "w_up": (None, mp), "w_down": (mp, None)}
    return {"w_up": (None, mp), "w_down": (mp, None)}


def activation(params: Dict, mlp_type: str, up) -> torch.Tensor:
    """The hidden activation of ``mlp_type``; ``up(name)`` projects the input
    through the weight ``params[name]``."""
    if mlp_type == "swiglu":
        return F.silu(up(params["w_gate"])) * up(params["w_up"])
    if mlp_type == "squared_relu":
        return torch.square(F.relu(up(params["w_up"])))
    if mlp_type == "gelu":
        return F.gelu(up(params["w_up"]), approximate="tanh")
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def mlp_forward(params: Dict, mlp_type: str, x: torch.Tensor, slotted: bool = False,
                tp=None):
    """The block on ``x``; under ``tp`` (the hidden dim split over the model
    ranks: ``w_gate`` and ``w_up`` by column, ``w_down`` by row) the input
    enters and the rank's partial output exits summed."""
    if tp is not None:
        x = tp.enter(x)
    h = activation(params, mlp_type, lambda w: linear(x, w, slotted))
    out = linear(h, params["w_down"], slotted)
    return out if tp is None else tp.exit(out)
