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

Collective mixers (the twins of the reference's ``shard_map`` mixers) run
with one agent per rank of a :class:`repro_torch.launch.mesh.RankMesh`; a
rank's tree holds its own agent's leaves, with no agent axis:

* :func:`collective_global_mixing` — the server round, a sum over the agent
  axes of a float32 copy, divided by n and cast back;
* :func:`collective_shift_mixing` — circulant gossip (a ring over one axis,
  a torus over two): each leaf goes to its neighbours in one batch of sends
  and receives per ``(axis, shift)`` and the weighted combine accumulates in
  float32.  On a one-axis ring the round's x-gossip instead runs
  :func:`mix_candidate`, the (4a) candidate fused with the combine (K8);
* :func:`collective_dense_mixing` — any W: a gather over the agent axes,
  then this rank's row of W;
* :func:`hierarchical_mixing` and :func:`compressed_mixing` on top.

Dynamic networks (time-varying W_k, partial participation) are not ported
yet (ROADMAP A2/A5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import SparseTopology, Topology
from repro_torch.kernels.gt_update import mix_combine_half
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
    # Collective mixers: the rank mesh (it carries the exchanges), the shift
    # table {axis: [(shift, weight), ...]} of circulant gossip and the dtype
    # its messages cross the wire in (None: the state's own).
    mesh: Optional[Any] = None
    shifts: Optional[Dict[str, list]] = None
    wire_dtype: Optional[torch.dtype] = None


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


# ---------------------------------------------------------------------------
# Collective mixers (one agent per rank of a RankMesh)
# ---------------------------------------------------------------------------

WIRE_DTYPES = {None: None, "float32": torch.float32}


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def collective_global_mixing(mesh, agent_axes: Sequence[str]) -> MixingOps:
    """Global averaging (J): a sum over the agent axes of a float32 copy of
    each leaf, divided by n, cast back."""
    agent_axes = _as_tuple(agent_axes)
    n_agents = mesh.size(agent_axes)

    def avg(tree: Tree) -> Tree:
        def leaf(x: torch.Tensor) -> torch.Tensor:
            return (mesh.all_reduce_sum(x.to(torch.float32), agent_axes) / n_agents).to(x.dtype)

        return tree_map(leaf, tree)

    return MixingOps(gossip=avg, global_avg=avg, name="collective/global", mesh=mesh)


def _self_weight(shifts: Dict[str, list]) -> float:
    return sum(w for pairs in shifts.values() for s, w in pairs if s == 0)


def _moves(shifts: Dict[str, list]):
    return [(axis, s, w) for axis, pairs in shifts.items() for s, w in pairs if s != 0]


def collective_shift_mixing(
    mesh,
    agent_axes: Sequence[str],
    shifts_per_axis: Dict[str, list],
    *,
    wire_dtype: Optional[str] = None,
) -> MixingOps:
    """Circulant gossip over the mesh.  ``shifts_per_axis`` maps a mesh axis
    to ``(shift, weight)`` pairs (shift 0 is the self weight); a ring over
    one axis is ``{axis: [(0, w0), (1, w1), (-1, w1)]}``.  Shift s delivers
    the block of the rank s steps behind.  ``wire_dtype`` is what crosses
    the wire: None sends the state's own dtype, "float32" upcasts first; the
    combine accumulates in float32 either way, neighbours in table order and
    the self term last, as the reference does."""
    agent_axes = _as_tuple(agent_axes)
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be one of {sorted(map(str, WIRE_DTYPES))}, "
                         f"got {wire_dtype!r}")
    wire = WIRE_DTYPES[wire_dtype]
    moves = _moves(shifts_per_axis)
    self_w = _self_weight(shifts_per_axis)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        xw = x if wire is None else x.to(wire)
        acc = torch.zeros_like(x, dtype=torch.float32)
        for (_, _, w), moved in zip(moves, mesh.shift(xw, [(a, s) for a, s, _ in moves])):
            acc = acc + w * moved.to(torch.float32)
        return (acc + self_w * x.to(torch.float32)).to(x.dtype)

    g = collective_global_mixing(mesh, agent_axes)
    n_agents = mesh.size(tuple(shifts_per_axis))
    return MixingOps(
        gossip=lambda tree: tree_map(leaf, tree),
        global_avg=g.global_avg,
        name="collective/shift",
        gossip_edges=len(moves),
        # every agent ships one message per nonzero shift
        gossip_messages=n_agents * len(moves),
        mesh=mesh,
        shifts={a: list(p) for a, p in shifts_per_axis.items()},
        wire_dtype=wire,
    )


def ring_of(ops: MixingOps) -> Optional[Tuple[str, float, list]]:
    """``(axis, self weight, [(shift, weight), ...])`` when ``ops`` gossips
    over a ring on one axis (shifts of +1 and/or -1), else None."""
    if ops.shifts is None:
        return None
    moves = _moves(ops.shifts)
    axes = {a for a, _, _ in moves}
    if len(axes) != 1 or not {s for _, s, _ in moves} <= {1, -1}:
        return None
    return axes.pop(), _self_weight(ops.shifts), [(s, w) for _, s, w in moves]


def mix_candidate(ops: MixingOps, x_k: Tree, x_half: Tree, eta_c: float) -> Tree:
    """The x-gossip of a PISCO round on a one-axis ring, leaf by leaf: the
    (4a) candidate ``u = (1 - eta_c) x_k + eta_c x_half`` is sent to the
    neighbours (in the wire dtype), and the fused kernel (K8) forms
    ``w_s u + w_l left + w_r right`` from ``x_k``, ``x_half`` and what came
    back, so the rank's own candidate is recomputed in float32 rather than
    read again.  The candidate sent is formed in float32 the way K8 forms
    it (one rounding per operation, no fused multiply-add), so on the
    float32 wire the neighbours receive exactly the rank's own term; the
    native wire rounds it once to the state's dtype."""
    axis, self_w, moves = ring_of(ops)

    def leaf(xk: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
        cand = xk.to(torch.float32, copy=True).mul_(1.0 - eta_c)
        cand.add_(xh.to(torch.float32, copy=True).mul_(eta_c))
        wire = cand.to(xk.dtype if ops.wire_dtype is None else ops.wire_dtype)
        received = ops.mesh.shift(wire, [(axis, s) for s, _ in moves])
        del cand, wire  # a leaf's copies are ~1 GB at full width: free before K8's output
        right = received[1] if len(moves) > 1 else None
        return mix_combine_half(xk, xh, received[0], right, eta_c=eta_c, w_self=self_w,
                                w_left=moves[0][1],
                                w_right=moves[1][1] if len(moves) > 1 else 0.0)

    return tree_map(leaf, x_k, x_half)


def collective_dense_mixing(mesh, agent_axes: Sequence[str], topology: Topology) -> MixingOps:
    """Any W on the mesh: each leaf gathered over the agent axes (float32),
    then this rank's row of W against the stack."""
    agent_axes = _as_tuple(agent_axes)
    w = torch.as_tensor(topology.w.astype(np.float32), device=mesh.device)
    idx = mesh.index(agent_axes)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        full = mesh.all_gather(x.to(torch.float32), agent_axes)  # (n, ...)
        return torch.tensordot(w[idx], full, dims=([0], [0])).to(x.dtype)

    g = collective_global_mixing(mesh, agent_axes)
    return MixingOps(
        gossip=lambda tree: tree_map(leaf, tree),
        global_avg=g.global_avg,
        name=f"collective/dense/{topology.name}",
        gossip_edges=int(topology.adj.sum()) // 2,
        mesh=mesh,
    )


def compressed_mixing(base: MixingOps, bits: int = 8) -> MixingOps:
    """Int-quantized gossip with deterministic rounding and error feedback
    over ``base``, as :mod:`repro_torch.core.compression` builds it; the
    server round stays exact."""
    from repro_torch.core.compression import StochasticQuantizer, compress_mixing

    return compress_mixing(
        base, StochasticQuantizer(bits=bits, stochastic=False), error_feedback=True
    )


def hierarchical_mixing(
    mesh,
    intra_axis: str = "data",
    inter_axes: Sequence[str] = ("pod", "data"),
    ring_weights: Sequence[float] = (0.5, 0.25, 0.25),
) -> MixingOps:
    """Gossip over a ring on the intra-pod axis only; the server round sums
    over all agent axes (``inter_axes``)."""
    w0, w1, w2 = ring_weights
    ops = collective_shift_mixing(mesh, inter_axes, {intra_axis: [(0, w0), (1, w1), (-1, w2)]})
    return dataclasses.replace(ops, name="collective/hierarchical")
