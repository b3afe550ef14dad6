"""Mixing operators: the communication layer of PISCO (paper eq. 4a/4c).

One interface (:class:`MixingOps`), three static mixers over agent-stacked
dicts of tensors:

* :func:`dense_mixing` — gossip is the product with the dense W (a plain
  ``torch.matmul``, as the reference left it to XLA); global averaging is the
  mean over the agent axis.  Keeps W on the device so compressed gossip can
  contract with it inside the fused kernel (:mod:`repro_torch.core.compression`).
* :func:`sparse_mixing` — gossip over the precomputed CSR triple of a
  :class:`SparseTopology` through the sparse-gossip kernel, O(n + m) state.
  Keeps the CSR on the device so compressed gossip can run the fused
  compressed sparse-gossip kernel over it.
* :func:`identity_mixing` — no communication.

Dynamic networks (time-varying W_k, partial participation) and the
collective multi-GPU mixers are not ported yet (ROADMAP A2/A5, A17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import SparseTopology, Topology
from repro_torch.kernels.sparse_mix import sparse_mix_csr
from repro_torch.utils.pytree import tree_agent_mean, tree_agent_mix, tree_map

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MixingOps:
    """The two communication primitives Algorithm 1 needs."""

    gossip: Callable[[Tree], Tree]  # X -> X W
    global_avg: Callable[[Tree], Tree]  # X -> X J
    name: str = "dense"
    gossip_edges: int = 0  # undirected neighbor links per gossip round
    # Directed neighbor messages per gossip invocation, network-wide; None
    # => 2 * gossip_edges (one message per direction over each edge).
    gossip_messages: Optional[int] = None
    # CompressedGossip when compression is attached: ``gossip`` is then the
    # stateless compressed form and PISCO's round threads the stateful
    # error-feedback variant through its state.
    compression: Optional[Any] = None
    # The dense W (float32, on the device) for dense mixers — what the fused
    # compressed-gossip kernel contracts with; None for sparse/identity.
    w: Optional[torch.Tensor] = None
    # (indptr, indices, data, self_w) on the device for sparse mixers — what
    # the fused compressed sparse-gossip kernel walks; None otherwise.
    csr: Optional[Tuple[torch.Tensor, ...]] = None


def dense_mixing(topology: Topology, device: torch.device) -> MixingOps:
    """Reference mixers over agent-stacked dicts (leading axis = agents)."""
    w = torch.as_tensor(topology.w, dtype=torch.float32, device=device)
    return MixingOps(
        gossip=lambda tree: tree_agent_mix(tree, w),
        global_avg=tree_agent_mean,
        name=f"dense/{topology.name}",
        gossip_edges=int(topology.adj.sum()) // 2,
        w=w,
    )


def identity_mixing(n_agents: int) -> MixingOps:
    """No communication at all (an isolated baseline / ablation)."""
    return MixingOps(
        gossip=lambda t: t, global_avg=tree_agent_mean, name="identity", gossip_edges=0
    )


def sparse_mixing(topology: SparseTopology, device: torch.device) -> MixingOps:
    """Static sparse mixers: gossip runs the CSR sparse-gossip kernel over
    the topology's precomputed triple (rows by receiver, each row in
    directed-edge order, self term added last) — numerically the reference's
    ``segment_sum`` gossip, never materialising n×n."""
    n, nnz = topology.n_agents, len(topology.indices)
    if not (len(topology.indptr) == n + 1 and topology.indptr[0] == 0
            and topology.indptr[-1] == nnz and np.all(np.diff(topology.indptr) >= 0)
            and (nnz == 0 or 0 <= topology.indices.min() <= topology.indices.max() < n)):
        raise ValueError(f"malformed CSR triple for {n} agents")
    csr = (
        torch.as_tensor(topology.indptr, dtype=torch.int64, device=device),
        torch.as_tensor(topology.indices, dtype=torch.int64, device=device),
        torch.as_tensor(topology.data, dtype=torch.float32, device=device),
        torch.as_tensor(topology.self_weight, dtype=torch.float32, device=device),
    )

    def mix(x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        return sparse_mix_csr(flat, *csr).reshape(x.shape)

    return MixingOps(
        gossip=lambda tree: tree_map(mix, tree),
        global_avg=tree_agent_mean,
        name=f"sparse/{topology.name}",
        gossip_edges=topology.n_edges,
        csr=csr,
    )
