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

Dynamic networks (time-varying W_k, partial participation): the drivers
draw a block of rounds' operands on the host through a
:class:`NetworkContext` (its :class:`~repro_torch.core.topology.TopologyProcess`
and :class:`~repro_torch.core.topology.ParticipationProcess`), copy them to
the device once per block and, before each round, stage that round's
tensors in the context; the mixers read them from it when they are called.

* :func:`dynamic_dense_mixing` / :func:`make_network_mixing` — gossip with
  the round's W_k (``torch.matmul``), the server round the exact mean or,
  under partial participation, the sampled-to-sampled S_k (``torch.matmul``,
  as the reference's ``einsum``);
* :func:`dynamic_sparse_mixing` / :func:`make_sparse_network_mixing` — the
  sparse-gossip kernel (K4) over the base CSR with the round's weights
  (dropped edges kept at weight 0, so every round has the same shape), the
  server round :func:`~repro_torch.utils.pytree.tree_agent_masked_mean`.

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

The robust server rules (:func:`make_robust_agg`: trimmed mean, median,
Krum) replace ``global_avg`` under a Byzantine adversary
(:mod:`repro_torch.core.adversary`).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import (
    ParticipationProcess,
    SparseTopology,
    Topology,
    TopologyProcess,
    make_topology_process,
)
from repro_torch.kernels.gt_update import mix_combine_half
from repro_torch.kernels.sparse_mix import sparse_mix_csr
from repro_torch.utils.pytree import (
    tree_agent_krum,
    tree_agent_masked_mean,
    tree_agent_mean,
    tree_agent_median,
    tree_agent_mix,
    tree_agent_trimmed_mean,
    tree_map,
)

Tree = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Robust server-averaging rules (Byzantine-tolerant global_avg variants)
# ---------------------------------------------------------------------------

ROBUST_RULES = ("mean", "trimmed", "median", "krum")


def parse_robust_spec(spec: str):
    """``(rule, f)`` from ``"mean"`` | ``"median"`` | ``"trimmed[:f=0.2]"`` |
    ``"krum[:f=0.2]"``; ``f`` is the assumed Byzantine fraction, an agent
    count ``ceil(f n)`` when the rule is built."""
    head, _, tail = str(spec).partition(":")
    rule = head.strip()
    if rule not in ROBUST_RULES:
        raise ValueError(
            f"unknown robust_agg rule {rule!r}; options: {ROBUST_RULES}"
        )
    f = 0.2
    if tail:
        for item in tail.split(","):
            k, _, v = item.partition("=")
            if k.strip() != "f":
                raise ValueError(
                    f"robust_agg {rule!r} takes only 'f=<fraction>' "
                    f"(got {item!r})"
                )
            f = float(v)
    if rule in ("mean", "median") and tail:
        raise ValueError(f"robust_agg {rule!r} takes no arguments")
    if not 0.0 <= f < 0.5:
        raise ValueError(f"robust_agg fraction must be in [0, 0.5), got {f}")
    return rule, f


def make_robust_agg(spec: str, n_agents: int) -> Optional[Callable[[Tree], Tree]]:
    """The server rule of ``spec`` (tree -> tree, broadcast over the agents),
    or None for ``"mean"``: the caller keeps its own ``global_avg``, so the
    clean path is unchanged.  Checks that trimming leaves an agent."""
    rule, f = parse_robust_spec(spec)
    if rule == "mean":
        return None
    n_byz = int(np.ceil(f * n_agents))
    if rule == "median":
        return tree_agent_median
    if rule == "trimmed":
        if n_agents - 2 * n_byz < 1:
            raise ValueError(
                f"trimmed mean needs n - 2*ceil(f*n) >= 1 agents "
                f"(n={n_agents}, f={f} trims {n_byz} per side)"
            )
        return functools.partial(tree_agent_trimmed_mean, trim=n_byz)
    # krum: the neighbour count n - n_byz - 2 is floored at 1 inside the rule
    return functools.partial(tree_agent_krum, n_byz=n_byz)


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
    # NetworkContext of a dynamic network: the drivers draw each round's
    # operands through it and stage them there, where ``gossip`` and
    # ``global_avg`` read them.  None: the operands above are frozen.
    network: Optional["NetworkContext"] = None
    # Byzantine corruption that ``gossip`` puts on the wire but the operands
    # above do not carry (repro_torch.core.adversary): ``corrupt(q, i)`` of
    # leaf i (sorted-key order) of a payload.  Compressed gossip then writes
    # q out and corrupts it before mixing.  None without an adversary, or
    # when the operands carry it (a sign flip folded into the weights).
    wire_corrupt: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    # A collective mixer whose leaves are model shards: ``row_max(key,
    # absmax)`` turns the abs-max of a shard's row into the whole leaf's
    # (the max over the model ranks), so that a quantiser scales each leaf
    # as one row, as the reference's does on the whole leaf.  None: leaves
    # are whole.
    row_max: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
    # Collective mixers: the mesh axes the agents lie on.
    agent_axes: Optional[Tuple[str, ...]] = None
    # A collective mixer under a Byzantine adversary: the base's gossip
    # before corruption, which compressed gossip runs on the q it wrote out
    # and corrupted (wire_corrupt), and this rank's side of the adversary
    # (repro_torch.core.adversary.RankCorruption), which the ring's fused
    # candidate combine reads.
    plain_gossip: Optional[Callable[[Tree], Tree]] = None
    rank_adversary: Optional[Any] = None


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


def _csr_of(topology: SparseTopology, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(indptr, indices, data, self_w) of a SparseTopology on the device,
    after checking the triple (the kernel gathers through it unchecked)."""
    n, nnz = topology.n_agents, len(topology.indices)
    if not (len(topology.indptr) == n + 1 and topology.indptr[0] == 0
            and topology.indptr[-1] == nnz and np.all(np.diff(topology.indptr) >= 0)
            and (nnz == 0 or 0 <= topology.indices.min() <= topology.indices.max() < n)):
        raise ValueError(f"malformed CSR triple for {n} agents")
    return (
        torch.as_tensor(topology.indptr, dtype=torch.int64, device=device),
        torch.as_tensor(topology.indices, dtype=torch.int64, device=device),
        torch.as_tensor(topology.data, dtype=torch.float32, device=device),
        torch.as_tensor(topology.self_weight, dtype=torch.float32, device=device),
    )


def _csr_gossip(csr_of: Callable[[], Tuple[torch.Tensor, ...]]) -> Callable[[Tree], Tree]:
    """Gossip leaf by leaf through the sparse-gossip kernel (K4) over the
    CSR that ``csr_of()`` returns when called."""
    def gossip(tree: Tree) -> Tree:
        csr = csr_of()

        def mix(x: torch.Tensor) -> torch.Tensor:
            return sparse_mix_csr(x.reshape(x.shape[0], -1), *csr).reshape(x.shape)

        return tree_map(mix, tree)

    return gossip


def sparse_mixing(topology: SparseTopology, device: torch.device) -> MixingOps:
    """Static sparse mixers: gossip runs the CSR sparse-gossip kernel over
    the topology's precomputed triple (rows by receiver, each row in
    directed-edge order, self term added last) — numerically the reference's
    ``segment_sum`` gossip, never materialising n×n."""
    csr = _csr_of(topology, device)
    return MixingOps(
        gossip=_csr_gossip(lambda: csr),
        global_avg=tree_agent_mean,
        name=f"sparse/{topology.name}",
        gossip_edges=topology.n_edges,
        csr=csr,
    )


# ---------------------------------------------------------------------------
# Dynamic mixers: each round brings its own operands
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class NetworkContext:
    """Host-side bundle the drivers realize a dynamic network through: the
    gossip-graph process, optional partial participation, the device the
    operands go to and the round's operands, which the mixers read.

    :meth:`draw_block` is the reference's host draw for rounds ``[start,
    stop)``; :meth:`device_block` copies it to the device
    once (the sparse edge weights permuted from directed-edge order into the
    base CSR's order, ``csr_order``) and :meth:`stage` sets round i's slices
    as ``gossip_w`` and ``server_w``.  ``draw_s`` sums the host seconds of
    both.

    The staged operands: dense, ``gossip_w`` is W_k (n, n) and ``server_w``
    S_k (n, n) or None; sparse, ``gossip_w`` is the CSR (indptr, indices,
    data_k, self_w_k) and ``server_w`` the (n,) participant mask or None."""

    process: TopologyProcess
    device: torch.device
    participation: Optional[ParticipationProcess] = None
    sparse: bool = False
    # sparse mode: (indptr, indices) of the base CSR on the device, and the
    # permutation of the directed base edges (both orientations, as
    # concat([e, e]) orders them) into that CSR's order
    csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    csr_order: Optional[np.ndarray] = None
    draw_s: float = 0.0
    gossip_w: Any = None
    server_w: Optional[torch.Tensor] = None

    @property
    def n_agents(self) -> int:
        return self.process.n_agents

    def draw_block(self, start: int, stop: int):
        """``(w_gossip, w_server, messages, participants)`` for rounds
        ``[start, stop)`` as the reference draws them, on the host: dense, W
        (block, n, n) and S (block, n, n); sparse, ``{'edge_w': (block, 2m),
        'self_w': (block, n)}`` in directed base-edge order and the (block,
        n) participant mask; ``w_server`` None under full participation (the
        reference's placeholder); message and participant counts as ints."""
        block = stop - start
        if self.sparse:
            edge_w, self_w, messages = self.process.draw_sparse_block(start, stop)
            w_gossip = {"edge_w": np.concatenate([edge_w, edge_w], axis=1), "self_w": self_w}
        else:
            w_gossip, messages = self.process.draw_block(start, stop)
        if self.participation is None:
            return w_gossip, None, messages, np.full(block, self.n_agents, dtype=int)
        draw = self.participation.draw_mask_block if self.sparse else self.participation.draw_block
        w_server, participants = draw(start, stop)
        return w_gossip, w_server, messages, participants

    def device_block(self, start: int, stop: int):
        """``(operands, messages, participants)`` for rounds ``[start,
        stop)``: the block's draws on the device, one copy per array."""
        t0 = time.perf_counter()
        w_gossip, w_server, messages, participants = self.draw_block(start, stop)
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,  # noqa: E731
                                        device=self.device)
        if self.sparse:
            gossip = (put(w_gossip["edge_w"][:, self.csr_order]), put(w_gossip["self_w"]))
        else:
            gossip = put(w_gossip)
        server = None if w_server is None else put(w_server)
        self.draw_s += time.perf_counter() - t0
        return (gossip, server), messages, participants

    def stage(self, operands, i: int) -> None:
        """Stage round ``i`` of a block's device operands for the mixers."""
        gossip, server = operands
        if self.sparse:
            self.gossip_w = (*self.csr, gossip[0][i], gossip[1][i])
        else:
            self.gossip_w = gossip[i]
        self.server_w = None if server is None else server[i]


def dynamic_dense_mixing(
    process: TopologyProcess,
    device: torch.device,
    *,
    participation: float = 1.0,
) -> MixingOps:
    """Dense mixers over a time-varying network: ``gossip`` applies the W_k
    staged for the round; ``global_avg`` is the exact mean under full
    participation, else the doubly stochastic S_k (participants average
    among themselves, absentees hold: the mean is preserved, so Lemma 1
    survives)."""
    part = (None if participation >= 1.0
            else ParticipationProcess(process.n_agents, participation, seed=process.seed))
    net = NetworkContext(process=process, device=torch.device(device), participation=part)
    base = process.base
    name = f"dynamic/{process.spec()}/{base.name}"
    if part is not None:
        name += f"/m{part.m}of{part.n_agents}"
    return MixingOps(
        gossip=lambda tree: tree_agent_mix(tree, net.gossip_w),
        global_avg=(tree_agent_mean if part is None
                    else lambda tree: tree_agent_mix(tree, net.server_w)),
        name=name,
        gossip_edges=int(base.adj.sum()) // 2,
        network=net,
    )


def make_network_mixing(
    topology: Topology,
    device: torch.device,
    network: Optional[str] = None,
    participation: float = 1.0,
    *,
    seed: int = 0,
) -> MixingOps:
    """Dense mixers for an optionally dynamic network: ``network=None`` with
    full participation is the frozen-W path (:func:`dense_mixing`); anything
    else runs :func:`dynamic_dense_mixing` over the parsed process."""
    if network is None and participation >= 1.0:
        return dense_mixing(topology, device)
    process = make_topology_process(network, topology, seed=seed)
    return dynamic_dense_mixing(process, device, participation=participation)


def directed_csr_order(edges: np.ndarray) -> np.ndarray:
    """The permutation taking the directed expansion ``concat([e, e])`` of an
    undirected edge list (senders ``concat([e0, e1])``) into CSR order: a
    stable sort by receiver, as ``sparse_topology_from_edges`` builds the
    CSR."""
    receivers = np.concatenate([edges[:, 1], edges[:, 0]]) if len(edges) else np.zeros(0, int)
    return np.argsort(receivers, kind="stable")


def dynamic_sparse_mixing(
    process: TopologyProcess,
    device: torch.device,
    *,
    participation: float = 1.0,
) -> MixingOps:
    """Sparse mixers over a time-varying network: K4 over the base CSR with
    the round's weights (zero on dropped edges) and self weights; the server
    round under partial participation is the O(n) masked mean."""
    base = process.base
    if not isinstance(base, SparseTopology):
        raise TypeError(f"dynamic sparse mixing needs a SparseTopology base, got {type(base)}")
    part = (None if participation >= 1.0
            else ParticipationProcess(process.n_agents, participation, seed=process.seed))
    indptr, indices, _, _ = _csr_of(base, device)
    net = NetworkContext(process=process, device=torch.device(device), participation=part,
                         sparse=True, csr=(indptr, indices),
                         csr_order=directed_csr_order(base.edges))
    name = f"sparse-dynamic/{process.spec()}/{base.name}"
    if part is not None:
        name += f"/m{part.m}of{part.n_agents}"
    return MixingOps(
        gossip=_csr_gossip(lambda: net.gossip_w),
        global_avg=(tree_agent_mean if part is None
                    else lambda tree: tree_agent_masked_mean(tree, net.server_w)),
        name=name,
        gossip_edges=base.n_edges,
        network=net,
    )


def make_sparse_network_mixing(
    topology: SparseTopology,
    device: torch.device,
    network: Optional[str] = None,
    participation: float = 1.0,
    *,
    seed: int = 0,
) -> MixingOps:
    """Sparse counterpart of :func:`make_network_mixing`."""
    if network is None and participation >= 1.0:
        return sparse_mixing(topology, device)
    process = make_topology_process(network, topology, seed=seed)
    return dynamic_sparse_mixing(process, device, participation=participation)


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

    return MixingOps(gossip=avg, global_avg=avg, name="collective/global", mesh=mesh,
                     agent_axes=agent_axes)


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
        agent_axes=agent_axes,
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
    native wire rounds it once to the state's dtype.

    Under a Byzantine adversary (``ops.rank_adversary``) every rank puts its
    candidate through the corruption before sending it; a Byzantine rank's
    own term is what it sent: a sign flip folds into K8's self weight; any
    other corruption replaces the term, and K8 runs on the sent payload as
    both its state operands with ``eta_c = 1`` (its candidate is then the
    payload itself), in the wire dtype, its output rounded once to the
    state's dtype."""
    axis, self_w, moves = ring_of(ops)
    adv = ops.rank_adversary

    def leaf(i: int, xk: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
        cand = xk.to(torch.float32, copy=True).mul_(1.0 - eta_c)
        cand.add_(xh.to(torch.float32, copy=True).mul_(eta_c))
        wire = cand.to(xk.dtype if ops.wire_dtype is None else ops.wire_dtype)
        del cand
        if adv is not None:
            wire = adv.leaf(wire, i)
        received = ops.mesh.shift(wire, [(axis, s) for s, _ in moves])
        right = received[1] if len(moves) > 1 else None
        weights = dict(w_left=moves[0][1], w_right=moves[1][1] if len(moves) > 1 else 0.0)
        if adv is not None and adv.byzantine and not adv.folds:
            return mix_combine_half(wire, wire, received[0], right, eta_c=1.0,
                                    w_self=self_w, **weights).to(xk.dtype)
        del wire  # a leaf's copies are ~1 GB at full width: free before K8's output
        w_self = self_w * (adv.sender_weight if adv is not None else 1.0)
        return mix_combine_half(xk, xh, received[0], right, eta_c=eta_c, w_self=w_self,
                                **weights)

    return {k: leaf(i, x_k[k], x_half[k]) for i, k in enumerate(sorted(x_k))}


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
        agent_axes=agent_axes,
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
