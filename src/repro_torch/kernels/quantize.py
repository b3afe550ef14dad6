"""K2 and K3 — the two phases of compressed gossip (CUDA source
``csrc/quantize.cu``).

* :func:`row_absmax` (K2, port of ``repro.kernels.quantize._row_scales``):
  ``max_j |x_ij + r_ij|`` per agent row, the residual optional.
* :func:`compressed_mix` (K3, port of
  ``repro.kernels.quantize.fused_compressed_mix`` extended to the error-
  feedback and damped form of ``CompressedGossip.__call__``):
  ``m = x + r``, ``q = q_bits(m)``, ``out = x + gamma (W^T q - q)``,
  ``r' = m - q``.

Both take agent-stacked (n, d) float32 rows.  Tensors on the CPU go through
the plain versions in :mod:`.ref`; tensors on a CUDA device launch the kernel
(or raise).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref


def qmax_of(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"int8 / int4 wire formats only, got bits={bits}")
    return float(2 ** (bits - 1) - 1)


def _check_rows(name: str, x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    for t in others:
        if t is not None and (t.shape != x.shape or t.dtype != torch.float32):
            raise ValueError(
                f"{name}: operand {tuple(t.shape)} {t.dtype} does not match x "
                f"{tuple(x.shape)} float32"
            )


def _contig(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def row_absmax(x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, d) -> (n,) float32 row abs-max of ``x + residual``."""
    _check_rows("row_absmax", x, residual)
    if not build.on_cuda(x, residual):
        return ref.row_absmax_ref(x, residual)
    x, residual = x.contiguous(), _contig(residual)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    err = build.library("quantize").launch_row_absmax(
        build.ptr(x), build.ptr(residual), build.ptr(out), x.shape[0], x.shape[1],
        build.stream_of(x),
    )
    build.check(err, "row_absmax")
    build.LAUNCHES["row_absmax"] += 1
    return out


def compressed_mix(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    w: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, new_residual)`` of compressed gossip over the dense ``w`` (n, n).

    ``absmax`` is K2's row abs-max of ``x + residual``; ``noise`` (uniform
    [0, 1), same shape as x) selects stochastic rounding.  Without a residual
    the second output is None (the stateless form)."""
    qmax = qmax_of(bits)
    _check_rows("compressed_mix", x, residual, noise)
    n = x.shape[0]
    if w.shape != (n, n) or w.dtype != torch.float32:
        raise ValueError(f"compressed_mix: w must be ({n}, {n}) float32, got {tuple(w.shape)}")
    if absmax.shape != (n,) or absmax.dtype != torch.float32:
        raise ValueError(f"compressed_mix: absmax must be ({n},) float32")
    if not build.on_cuda(x, residual, w, absmax, noise):
        return ref.compressed_mix_ref(x, residual, w, absmax, bits, gamma, noise)
    x, residual, w, absmax, noise = (
        _contig(t) for t in (x, residual, w, absmax, noise)
    )
    out = torch.empty_like(x)
    r_out = None if residual is None else torch.empty_like(x)
    err = build.library("quantize").launch_compressed_mix(
        build.ptr(x), build.ptr(residual), build.ptr(w), build.ptr(absmax),
        build.ptr(noise), build.ptr(out), build.ptr(r_out), n, x.shape[1],
        qmax, float(gamma), int(gamma != 1.0), build.stream_of(x),
    )
    build.check(err, "compressed_mix")
    build.LAUNCHES["compressed_mix"] += 1
    return out, r_out
