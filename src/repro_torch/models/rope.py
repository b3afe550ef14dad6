"""Rotary position embeddings (1-D RoPE, the HF ``rotate_half`` layout).

M-RoPE (Qwen2-VL) is not ported: it waits for the VLM family (ROADMAP A14).
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: Tensor, head_dim: int, theta: float) -> Tuple[Tensor, Tensor]:
    """cos/sin tables of shape positions.shape + (head_dim // 2,)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate the pairs (x[..., :hd/2], x[..., hd/2:]) of ``x`` (B, S, H, hd)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def text_positions(batch: int, seq: int, offset=0, device=None) -> Tensor:
    """(batch, seq) int32 positions ``offset + arange(seq)``; ``offset`` may
    be a (batch,) tensor (one position per decode slot)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, Tensor):
        return pos + offset.to(torch.int32).reshape(-1, 1).expand(batch, 1)
    return (pos + int(offset)).expand(batch, seq)
