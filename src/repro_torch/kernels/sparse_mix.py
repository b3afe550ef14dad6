"""K4 — sparse gossip over the CSR mixing matrix (CUDA source
``csrc/sparse_mix.cu``), port of ``repro.kernels.sparse_mix.sparse_mix``.

Two entry points over one kernel:

* :func:`sparse_mix_csr` takes the CSR triple (``indptr``, ``indices``,
  ``data``) of the directed expansion sorted by receiver, plus the diagonal
  ``self_w`` — what a static sparse mixer precomputes once;
* :func:`sparse_mix` keeps the reference's edge-list signature
  ``(x, senders, receivers, edge_w, self_w)`` and sorts the edges into CSR
  (stable by receiver, so each row keeps the edge order) before launching.

Tensors on the CPU go through the plain version in :mod:`.ref`; tensors on a
CUDA device launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref


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
    if indptr.shape != (n + 1,) or indptr.dtype != torch.int64:
        raise ValueError(f"sparse_mix: indptr must be ({n + 1},) int64")
    if indices.dtype != torch.int64 or data.dtype != torch.float32 or indices.shape != data.shape:
        raise ValueError("sparse_mix: indices int64 and data float32 of one length")
    if self_w.shape != (n,) or self_w.dtype != torch.float32:
        raise ValueError(f"sparse_mix: self_w must be ({n},) float32")
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
