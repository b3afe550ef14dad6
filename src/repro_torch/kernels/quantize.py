"""K2, K3, K9 and the codes pass — the phases of compressed gossip (CUDA
source ``csrc/quantize.cu``).

* :func:`row_absmax` (K2, port of ``repro.kernels.quantize._row_scales``):
  ``max_j |x_ij + r_ij|`` per agent row, the residual optional; float32 or
  bfloat16 rows.  A row too long for one block (one agent's whole leaf on a
  collective mixer) is split across blocks.
* :func:`compressed_mix` (K3, port of
  ``repro.kernels.quantize.fused_compressed_mix`` extended to the error-
  feedback and damped form of ``CompressedGossip.__call__``):
  ``m = x + r``, ``q = q_bits(m)``, ``out = x + gamma (W^T q - q)``,
  ``r' = m - q``.  On the card it runs as two passes:
  :func:`quant_codes` and :func:`code_mix`, the contraction of the codes
  on the tensor cores.
* :func:`quant_codes`, the first pass of K3 and K5: each row's int8 codes
  ``c`` (``c * s`` is the q grid) and the residual ``r' = m - c s``.

* :func:`rowwise_quant_dequant` (K9, port of
  ``repro.kernels.quantize.rowwise_quant_dequant``): the per-row int8/int4
  round trip of ``m = x + r``, deterministic or stochastic, in ``x``'s
  dtype, with the error-feedback residual ``r' = m - q`` — the message a
  rank puts on the wire of a collective mixer.

They take agent-stacked (n, d) rows (K3: float32).  Tensors on the CPU go
through the plain versions in :mod:`.ref`; tensors on a CUDA device launch
the kernel (or raise).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref


def qmax_of(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"int8 / int4 wire formats only, got bits={bits}")
    return float(2 ** (bits - 1) - 1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K2 splits a row across blocks when there are too few rows to fill the
# card's 132 SMs; each block then reads at least this many elements
SPLIT_MIN_COLUMNS = 65536


def _check_rows(name: str, x: torch.Tensor, *others: Optional[torch.Tensor],
                dtypes=(torch.float32,)) -> None:
    if x.dim() != 2 or x.dtype not in dtypes:
        raise ValueError(f"{name}: x must be (n, d) {' or '.join(map(str, dtypes))}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    for t in others:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype):
            raise ValueError(
                f"{name}: operand {tuple(t.shape)} {t.dtype} does not match x "
                f"{tuple(x.shape)} {x.dtype}"
            )


def _contig(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def absmax_parts(n_rows: int, d: int) -> int:
    """Blocks per row of K2: one when the rows alone fill the card, else
    enough to put ~4 blocks on every SM, each over >= SPLIT_MIN_COLUMNS."""
    if n_rows >= 2 * 132:
        return 1
    return max(1, min(-(-d // SPLIT_MIN_COLUMNS), -(-4 * 132 // max(n_rows, 1))))


def row_absmax(x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, d) -> (n,) float32 row abs-max of ``x + residual`` (summed in f32)."""
    _check_rows("row_absmax", x, residual, dtypes=tuple(_DTYPES))
    if not build.on_cuda(x, residual):
        return ref.row_absmax_ref(x, residual)
    x, residual = x.contiguous(), _contig(residual)
    n, d = x.shape
    parts = absmax_parts(n, d)
    out = (torch.zeros if parts > 1 else torch.empty)(n, dtype=torch.float32, device=x.device)
    err = build.library("quantize").launch_row_absmax(
        build.ptr(x), build.ptr(residual), build.ptr(out), n, d, parts, _DTYPES[x.dtype],
        build.stream_of(x),
    )
    build.check(err, "row_absmax")
    build.LAUNCHES["row_absmax"] += 1
    return out


def rowwise_quant_dequant(
    x: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    residual: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(q, new_residual)``: the dequantised round trip of ``m = x (+
    residual)`` (n, d) on the int-``bits`` grid of each row's ``absmax`` (K2's
    of m), in ``x``'s dtype; ``noise`` (uniform [0, 1), float32) selects
    stochastic rounding.  ``new_residual = m - q`` with a residual, else
    None."""
    qmax = qmax_of(bits)
    _check_rows("rowwise_quant_dequant", x, residual, dtypes=tuple(_DTYPES))
    n, d = x.shape
    if noise is not None and (noise.shape != x.shape or noise.dtype != torch.float32):
        raise ValueError(f"rowwise_quant_dequant: noise must be ({n}, {d}) float32")
    if absmax.shape != (n,) or absmax.dtype != torch.float32:
        raise ValueError(f"rowwise_quant_dequant: absmax must be ({n},) float32")
    if not build.on_cuda(x, residual, absmax, noise):
        return ref.rowwise_quant_dequant_ref(x, absmax, bits, residual, noise)
    x, residual, absmax, noise = (_contig(t) for t in (x, residual, absmax, noise))
    q = torch.empty_like(x)
    r_out = None if residual is None else torch.empty_like(x)
    err = build.library("quantize").launch_quant_dequant(
        build.ptr(x), build.ptr(residual), build.ptr(absmax), build.ptr(noise), build.ptr(q),
        build.ptr(r_out), n, d, qmax, _DTYPES[x.dtype], build.stream_of(x),
    )
    build.check(err, "rowwise_quant_dequant")
    build.LAUNCHES["rowwise_quant_dequant"] += 1
    return q, r_out


def quant_codes(
    x: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    residual: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(codes, new_residual)``: the (n, d) int8 codes ``c`` of ``m = x (+
    residual)`` (float32) on the int-``bits`` grid of each row's ``absmax``
    (K2's of m), ``s = max(absmax, 1e-12) / qmax``; ``noise`` (uniform [0,
    1), float32) selects stochastic rounding.  ``new_residual = m - c s``
    with a residual, else None."""
    qmax = qmax_of(bits)
    _check_rows("quant_codes", x, residual, noise)
    n, d = x.shape
    if absmax.shape != (n,) or absmax.dtype != torch.float32:
        raise ValueError(f"quant_codes: absmax must be ({n},) float32")
    if not build.on_cuda(x, residual, absmax, noise):
        return ref.quant_codes_ref(x, residual, absmax, bits, noise)
    x, residual, absmax, noise = (_contig(t) for t in (x, residual, absmax, noise))
    codes = torch.empty(n, d, dtype=torch.int8, device=x.device)
    r_out = None if residual is None else torch.empty_like(x)
    err = build.library("quantize").launch_quant_codes(
        build.ptr(x), build.ptr(residual), build.ptr(absmax), build.ptr(noise),
        build.ptr(codes), build.ptr(r_out), n, d, qmax, build.stream_of(x),
    )
    build.check(err, "quant_codes")
    build.LAUNCHES["quant_codes"] += 1
    return codes, r_out


def _check_codes(name: str, x: torch.Tensor, codes: torch.Tensor,
                 absmax: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    if codes.shape != x.shape or codes.dtype != torch.int8:
        raise ValueError(f"{name}: codes must be {tuple(x.shape)} int8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if absmax.shape != (x.shape[0],) or absmax.dtype != torch.float32:
        raise ValueError(f"{name}: absmax must be ({x.shape[0]},) float32")


def code_mix(
    x: torch.Tensor,
    codes: torch.Tensor,
    w: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    gamma: float = 1.0,
) -> torch.Tensor:
    """K3's second pass: ``x + gamma (W'^T c - q)`` over the dense ``w`` (n,
    n) from the codes of :func:`quant_codes`, ``W'[j, i] = W[j, i] s_j``,
    ``q = c s``; on the tensor cores with W' as three bf16 terms (the CPU
    runs the plain version with that rounding, ``bf16_split=True``)."""
    qmax = qmax_of(bits)
    _check_codes("code_mix", x, codes, absmax)
    n = x.shape[0]
    if w.shape != (n, n) or w.dtype != torch.float32:
        raise ValueError(f"code_mix: w must be ({n}, {n}) float32, got {tuple(w.shape)}")
    if not build.on_cuda(x, codes, w, absmax):
        return ref.code_mix_ref(x, codes, w, absmax, bits, gamma, bf16_split=True)
    x, codes, w, absmax = (t.contiguous() for t in (x, codes, w, absmax))
    lib = build.library("quantize")
    frag = torch.empty(lib.compressed_mix_frag_bytes(n), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    err = lib.launch_compressed_mix(
        build.ptr(x), build.ptr(codes), build.ptr(w), build.ptr(absmax), build.ptr(frag),
        build.ptr(out), n, x.shape[1], qmax, float(gamma), int(gamma != 1.0),
        build.stream_of(x),
    )
    build.check(err, "compressed_mix")
    build.LAUNCHES["compressed_mix"] += 1
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
    the second output is None (the stateless form).  On the card:
    :func:`quant_codes`, then :func:`code_mix`."""
    qmax_of(bits)
    _check_rows("compressed_mix", x, residual, noise)
    n = x.shape[0]
    if w.shape != (n, n) or w.dtype != torch.float32:
        raise ValueError(f"compressed_mix: w must be ({n}, {n}) float32, got {tuple(w.shape)}")
    if absmax.shape != (n,) or absmax.dtype != torch.float32:
        raise ValueError(f"compressed_mix: absmax must be ({n},) float32")
    if not build.on_cuda(x, residual, w, absmax, noise):
        return ref.compressed_mix_ref(x, residual, w, absmax, bits, gamma, noise)
    codes, r_out = quant_codes(x, absmax, bits=bits, residual=residual, noise=noise)
    return code_mix(x, codes, w, absmax, bits=bits, gamma=gamma), r_out
