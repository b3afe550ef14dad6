"""Rotary position embeddings in the HF ``rotate_half`` layout, including
Qwen2-VL's M-RoPE (the twin of ``repro.models.rope``).

M-RoPE (arXiv:2409.12191 §2.1) splits the frequency axis into three
sections (temporal, height, width), each rotated by its own position id:
position ids are (3, B, S) and section i reads ``positions[i]``.  Text
tokens carry equal (t, h, w) ids, where M-RoPE is 1-D RoPE; vision patches
carry their own row and column.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: Tensor, head_dim: int, theta: float,
                 mrope_sections: Optional[Tuple[int, int, int]] = None) -> Tuple[Tensor, Tensor]:
    """cos/sin tables of shape positions.shape + (head_dim // 2,); with
    ``mrope_sections`` the positions are (3, B, S) and the tables (B, S,
    head_dim // 2), section i of the frequency axis at ``positions[i]``."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    if mrope_sections is not None:
        if positions.dim() < 3 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) position ids, got {tuple(positions.shape)}")
        if sum(mrope_sections) != head_dim // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not cover head_dim // 2 = "
                             f"{head_dim // 2}")
        bounds = [0]
        for sec in mrope_sections:
            bounds.append(bounds[-1] + sec)
        ang = torch.cat([ang[i, ..., bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)
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


def mrope_text_positions(batch: int, seq: int, offset=0, device=None) -> Tensor:
    """Equal (t, h, w) M-RoPE ids of a text-only stream: (3, batch, seq)."""
    return text_positions(batch, seq, offset, device)[None].expand(3, batch, seq)
