"""SwiGLU feed-forward block (the other MLP types of the reference serve no
ported model and wait for ROADMAP A14)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import linear, normal_init


def init_mlp(gen: torch.Generator, d: int, f: int, mlp_type: str, scale: float, dtype,
             stack: tuple = ()) -> Dict[str, torch.Tensor]:
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet (ROADMAP A14)")
    return {
        "w_gate": normal_init(gen, stack + (d, f), scale, dtype),
        "w_up": normal_init(gen, stack + (d, f), scale, dtype),
        "w_down": normal_init(gen, stack + (f, d), scale, dtype),
    }


def mlp_forward(params: Dict, mlp_type: str, x: torch.Tensor, slotted: bool = False):
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet (ROADMAP A14)")
    h = F.silu(linear(x, params["w_gate"], slotted)) * linear(x, params["w_up"], slotted)
    return linear(h, params["w_down"], slotted)
