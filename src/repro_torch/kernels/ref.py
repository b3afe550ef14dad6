"""Plain PyTorch versions of every ported kernel.

Each is the kernel's twin: the same function in direct tensor code.  The
wrappers run these for tensors on the CPU (the tests' path), and the chip
check holds each CUDA kernel against its twin on the card.  They repeat the
kernels' arithmetic — float32 math, the same grouping of sums — and are no
yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32)


def fused_local_step_ref(
    x: Tensor, y: Tensor, g_new: Tensor, g_old: Tensor, eta_l: float
) -> Tuple[Tensor, Tensor]:
    """Reference-form PISCO eq. (3a)+(3c): ``x' = x - eta_l*y``,
    ``y' = (y + g_new) - g_old`` — both from the OLD y; f32 math, output in
    the input dtype."""
    xf, yf = _f32(x), _f32(y)
    return (xf - eta_l * yf).to(x.dtype), ((yf + _f32(g_new)) - _f32(g_old)).to(y.dtype)


def fused_track_step_ref(
    x: Tensor, y: Tensor, g_new: Tensor, g_old: Tensor, eta_l: float
) -> Tuple[Tensor, Tensor]:
    """Track-step form: ``y' = y + (g_new - g_old)`` (step t's 3c, PISCO's
    grouping), then ``x' = x - eta_l*y'`` (step t+1's 3a)."""
    yn = _f32(y) + (_f32(g_new) - _f32(g_old))
    return (_f32(x) - eta_l * yn).to(x.dtype), yn.to(y.dtype)


def row_absmax_ref(x: Tensor, residual: Optional[Tensor] = None) -> Tensor:
    """(n, d) -> (n,) float32: ``max_j |x_ij + r_ij|``."""
    m = _f32(x) if residual is None else _f32(x) + _f32(residual)
    return m.abs().amax(dim=1)


def quantize_rows_ref(
    m: Tensor, absmax: Tensor, bits: int, noise: Optional[Tensor] = None
) -> Tensor:
    """The q grid: per-row symmetric int-``bits`` round trip of ``m`` (n, d)
    with the row abs-max ``absmax`` (n,).  Round half to even, or
    ``floor(u + noise)`` when ``noise`` (uniform [0, 1)) is given."""
    qmax = float(2 ** (bits - 1) - 1)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal, which can differ in the last bit
    amax = torch.clamp_min(absmax, 1e-12)
    scale = (amax / torch.full_like(amax, qmax))[:, None]
    u = m / scale
    q = torch.floor(u + noise) if noise is not None else torch.round(u)
    return torch.clamp(q, -qmax, qmax) * scale


def compressed_mix_ref(
    x: Tensor,
    residual: Optional[Tensor],
    w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Mean-preserving compressed gossip with optional error feedback:
    ``m = x + r``; ``out = x + gamma*(W^T q(m) - q(m))`` grouped as
    ``x + (W^T q - q)`` when gamma == 1; ``r' = m - q`` (None without r)."""
    m = x if residual is None else x + residual
    q = quantize_rows_ref(m, absmax, bits, noise)
    diff = w.T @ q - q
    out = x + diff if gamma == 1.0 else x + gamma * diff
    return out, (None if residual is None else m - q)


def sparse_mix_csr_ref(
    x: Tensor, indptr: Tensor, indices: Tensor, data: Tensor, self_w: Tensor
) -> Tensor:
    """``out_i = self_w_i x_i + sum_{e in row i} data_e x_{indices_e}``: the
    row sums accumulate in CSR (edge) order, the self term is added last."""
    xf = _f32(x)
    rows = torch.repeat_interleave(
        torch.arange(x.shape[0], device=x.device), indptr[1:] - indptr[:-1]
    )
    acc = torch.zeros_like(xf).index_add_(0, rows, data[:, None] * xf[indices])
    return (self_w[:, None] * xf + acc).to(x.dtype)


def sparse_compressed_mix_csr_ref(
    x: Tensor,
    residual: Optional[Tensor],
    indptr: Tensor,
    indices: Tensor,
    data: Tensor,
    self_w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Mean-preserving compressed gossip over the CSR W with optional error
    feedback: ``m = x + r``, ``q = q(m)``, ``out = x + gamma*((self_w q +
    sum_row data q[indices]) - q)`` grouped as ``x + (mixed - q)`` when
    gamma == 1; ``r' = m - q`` (None without r)."""
    m = x if residual is None else x + residual
    q = quantize_rows_ref(m, absmax, bits, noise)
    diff = sparse_mix_csr_ref(q, indptr, indices, data, self_w) - q
    out = x + diff if gamma == 1.0 else x + gamma * diff
    return out, (None if residual is None else m - q)
