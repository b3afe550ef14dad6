"""K4 and K5 — sparse gossip and compressed sparse gossip over the CSR
mixing matrix (CUDA source ``csrc/sparse_mix.cu``), ports of
``repro.kernels.sparse_mix.sparse_mix`` and ``sparse_compressed_mix``.

Each kernel has two entry points:

* :func:`sparse_mix_csr` / :func:`sparse_compressed_mix_csr` take the CSR
  triple (``indptr``, ``indices``, ``data``) of the directed expansion sorted
  by receiver, plus the diagonal ``self_w`` — what a static sparse mixer
  precomputes once;
* :func:`sparse_mix` / :func:`sparse_compressed_mix` keep the reference's
  edge-list signature ``(x, senders, receivers, edge_w, self_w)`` and sort
  the edges into CSR (stable by receiver, so each row keeps the edge order)
  before launching.

:func:`topology_edge_arrays` gives a topology's directed edge arrays, as the
reference's helper does.  Tensors on the CPU go through the plain versions
in :mod:`.ref`; tensors on a CUDA device launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.quantize import (
    _check_rows,
    _check_codes,
    qmax_of,
    quant_codes,
    row_absmax,
)


def csr_from_edges(
    senders: torch.Tensor, receivers: torch.Tensor, edge_w: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(indptr (n+1,), indices (2m,), data (2m,)) of the directed edge list,
    rows by receiver, each row in edge order.  Raises on an agent index
    outside [0, n): the kernel gathers through these indices unchecked."""
    if not (senders.shape == receivers.shape == edge_w.shape and senders.dim() == 1):
        raise ValueError("senders, receivers and edge_w must be 1-d of one length")
    if senders.numel() and not (
        0 <= int(torch.minimum(senders.min(), receivers.min()))
        and int(torch.maximum(senders.max(), receivers.max())) < n
    ):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    receivers = receivers.to(torch.int64)
    order = torch.argsort(receivers, stable=True)
    counts = torch.bincount(receivers, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=receivers.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, senders.to(torch.int64)[order], edge_w.to(torch.float32)[order]


def _check_csr(name: str, n: int, indptr, indices, data, self_w) -> None:
    if indptr.shape != (n + 1,) or indptr.dtype != torch.int64:
        raise ValueError(f"{name}: indptr must be ({n + 1},) int64")
    if indices.dtype != torch.int64 or data.dtype != torch.float32 or indices.shape != data.shape:
        raise ValueError(f"{name}: indices int64 and data float32 of one length")
    if self_w.shape != (n,) or self_w.dtype != torch.float32:
        raise ValueError(f"{name}: self_w must be ({n},) float32")


def sparse_mix_csr(
    x: torch.Tensor,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    data: torch.Tensor,
    self_w: torch.Tensor,
) -> torch.Tensor:
    """``out_i = self_w_i x_i + sum_{e in row i} data_e x_{indices_e}`` over
    (n, d) float32 rows."""
    n = x.shape[0]
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"sparse_mix: x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    _check_csr("sparse_mix", n, indptr, indices, data, self_w)
    if not build.on_cuda(x, indptr, indices, data, self_w):
        return ref.sparse_mix_csr_ref(x, indptr, indices, data, self_w)
    x, indptr, indices, data, self_w = (
        t.contiguous() for t in (x, indptr, indices, data, self_w)
    )
    out = torch.empty_like(x)
    err = build.library("sparse_mix").launch_sparse_mix_csr(
        build.ptr(x), build.ptr(indptr), build.ptr(indices), build.ptr(data),
        build.ptr(self_w), build.ptr(out), n, x.shape[1], build.stream_of(x),
    )
    build.check(err, "sparse_mix")
    build.LAUNCHES["sparse_mix"] += 1
    return out


def sparse_mix(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_w: torch.Tensor,
    self_w: torch.Tensor,
) -> torch.Tensor:
    """Edge-list gossip ``out_i = self_w_i x_i + sum_{e: s_e -> i} w_e x_{s_e}``."""
    indptr, indices, data = csr_from_edges(senders, receivers, edge_w, x.shape[0])
    return sparse_mix_csr(x, indptr, indices, data, self_w.to(torch.float32))


def sparse_code_mix_csr(
    x: torch.Tensor,
    codes: torch.Tensor,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    data: torch.Tensor,
    self_w: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    gamma: float = 1.0,
) -> torch.Tensor:
    """K5's second pass: ``x + gamma ((self_w q + sum_{e in row} data_e
    q_{indices_e}) - q)`` over the CSR W, from the codes of
    :func:`~repro_torch.kernels.quantize.quant_codes` (``q = c s``)."""
    qmax = qmax_of(bits)
    _check_codes("sparse_code_mix", x, codes, absmax)
    n = x.shape[0]
    _check_csr("sparse_code_mix", n, indptr, indices, data, self_w)
    if not build.on_cuda(x, codes, indptr, indices, data, self_w, absmax):
        return ref.sparse_code_mix_csr_ref(
            x, codes, indptr, indices, data, self_w, absmax, bits, gamma
        )
    x, codes, indptr, indices, data, self_w, absmax = (
        t.contiguous() for t in (x, codes, indptr, indices, data, self_w, absmax)
    )
    out = torch.empty_like(x)
    err = build.library("sparse_mix").launch_sparse_code_mix_csr(
        build.ptr(x), build.ptr(codes), build.ptr(indptr), build.ptr(indices),
        build.ptr(data), build.ptr(self_w), build.ptr(absmax), build.ptr(out), n,
        x.shape[1], qmax, float(gamma), int(gamma != 1.0), build.stream_of(x),
    )
    build.check(err, "sparse_compressed_mix")
    build.LAUNCHES["sparse_compressed_mix"] += 1
    return out


def sparse_compressed_mix_csr(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    indptr: torch.Tensor,
    indices: torch.Tensor,
    data: torch.Tensor,
    self_w: torch.Tensor,
    absmax: torch.Tensor,
    *,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, new_residual)`` of compressed gossip over the CSR W:
    ``m = x + r``, ``q = q_bits(m)``, ``out = x + gamma (W q - q)``,
    ``r' = m - q``.

    ``absmax`` is K2's row abs-max of ``x + residual``; ``noise`` (uniform
    [0, 1), same shape as x) selects stochastic rounding.  Without a residual
    the second output is None (the stateless form, the reference kernel's
    function when ``noise`` is None too).  On the card: the codes pass
    (:func:`~repro_torch.kernels.quantize.quant_codes`), then
    :func:`sparse_code_mix_csr`."""
    qmax_of(bits)
    _check_rows("sparse_compressed_mix", x, residual, noise)
    n = x.shape[0]
    _check_csr("sparse_compressed_mix", n, indptr, indices, data, self_w)
    if absmax.shape != (n,) or absmax.dtype != torch.float32:
        raise ValueError(f"sparse_compressed_mix: absmax must be ({n},) float32")
    if not build.on_cuda(x, residual, indptr, indices, data, self_w, absmax, noise):
        return ref.sparse_compressed_mix_csr_ref(
            x, residual, indptr, indices, data, self_w, absmax, bits, gamma, noise
        )
    codes, r_out = quant_codes(x, absmax, bits=bits, residual=residual, noise=noise)
    out = sparse_code_mix_csr(x, codes, indptr, indices, data, self_w, absmax, bits=bits,
                              gamma=gamma)
    return out, r_out


def sparse_compressed_mix(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_w: torch.Tensor,
    self_w: torch.Tensor,
    *,
    bits: int = 8,
    gamma: float = 1.0,
) -> torch.Tensor:
    """Edge-list ``x + gamma (W q(x) - q(x))`` with round-to-nearest — the
    reference kernel's signature and function (row scales from K2)."""
    indptr, indices, data = csr_from_edges(senders, receivers, edge_w, x.shape[0])
    absmax = row_absmax(x)
    out, _ = sparse_compressed_mix_csr(
        x, None, indptr, indices, data, self_w.to(torch.float32), absmax,
        bits=bits, gamma=gamma,
    )
    return out


def topology_edge_arrays(topo) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed ``(senders, receivers, edge_w)`` (int32, int32, float32) of a
    SparseTopology: both orientations of each undirected edge, the weight
    duplicated."""
    e = topo.edges
    if len(e) == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy(), np.zeros(0, dtype=np.float32)
    senders = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
    receivers = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
    edge_w = np.concatenate([topo.edge_weight, topo.edge_weight]).astype(np.float32)
    return senders, receivers, edge_w
