"""Shared primitive layers of the LM zoo: RMSNorm, linear maps over a batch
of per-slot weights, and initialisers drawing from a ``torch.Generator``.

Parameters are nested dicts of tensors in the reference's layouts.  A
*slotted* call gives every parameter a leading axis that matches the
activations' batch axis, one parameter set per row: what ``jax.vmap`` of the
reference's decode over the slot axis lowered to.
"""
from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float, dtype,
                device=None) -> Tensor:
    """``scale * N(0, 1)`` drawn in float32 from ``gen``, cast to ``dtype``."""
    draw = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device or gen.device)
    return draw.mul_(scale).to(dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm in float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def linear(x: Tensor, w: Tensor, slotted: bool = False) -> Tensor:
    """``x`` (B, S, d_in) times ``w`` (d_in, *out) -> (B, S, *out).  With
    ``slotted`` the weight is (B, d_in, *out) and row b uses ``w[b]``: one
    batched product over the rows."""
    b, s, d = x.shape
    if slotted:
        return torch.bmm(x, w.reshape(b, d, -1)).reshape(b, s, *w.shape[2:])
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def vec(p: Tensor, slotted: bool, ndim: int) -> Tensor:
    """A per-feature parameter ready to broadcast against an activation of
    ``ndim`` dims whose first is the batch: unchanged when shared, with
    singleton axes after the slot axis when slotted."""
    if not slotted:
        return p
    return p.reshape(p.shape[0], *([1] * (ndim - p.ndim)), *p.shape[1:])
