"""Communication graphs and mixing matrices (paper §2.1), static and dynamic.

Host-side numpy, a copy of the reference ``repro.core.topology`` (the port
imports nothing of the JAX package): graph constructors, Metropolis and
best-constant weightings, spectral quantities, :class:`Topology` and the
edge-list/CSR :class:`SparseTopology`.  W and the CSR arrays are bit-equal
to the reference.  The dynamic processes (:class:`TopologyProcess` and its
five kinds, :class:`ParticipationProcess`) draw each round's graph and
participants on the host, pure in ``(seed, tag, k)``: every realization is
bit-equal to the reference's.

Definition 1 of the paper: ``W`` is nonnegative, doubly stochastic, with
``w_ij = 0`` iff ``{i,j}`` is not an edge (i != j), and the mixing rate is

    lambda_w = 1 - || W - (1/n) 11^T ||_2^2 = 1 - lambda^2,

where ``lambda`` is the second-largest singular value of ``W``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Graph constructors (adjacency, no self loops)
# ---------------------------------------------------------------------------


def ring_graph(n: int) -> np.ndarray:
    """Ring: agent i connects to (i-1) % n and (i+1) % n."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        adj[i, (i + 1) % n] = True
        adj[i, (i - 1) % n] = True
    if n <= 2:  # ring over <=2 nodes degenerates to a single edge / nothing
        adj = adj | adj.T
    np.fill_diagonal(adj, False)
    return adj


def path_graph(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    return adj


def star_graph(n: int) -> np.ndarray:
    """Agent 0 is the hub (useful as an explicit server-like gossip graph)."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, 1:] = adj[1:, 0] = True
    return adj


def fully_connected_graph(n: int) -> np.ndarray:
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def torus_graph(rows: int, cols: int) -> np.ndarray:
    """2-D torus over ``rows*cols`` agents (the natural ICI topology)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if i != j:
                    adj[i, j] = True
    return adj


def erdos_renyi_graph(n: int, prob: float, seed: int = 0) -> np.ndarray:
    """Undirected ER graph; may be disconnected (lambda_w = 0), which the
    paper explicitly exercises (Fig. 6(b)) and Assumption 1 permits when p>0."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < prob
    adj = np.triu(upper, k=1)
    adj = adj | adj.T
    return adj.astype(bool)


def disconnected_graph(n: int, n_components: int = 2) -> np.ndarray:
    """Deterministically disconnected: ``n_components`` disjoint rings."""
    adj = np.zeros((n, n), dtype=bool)
    bounds = np.linspace(0, n, n_components + 1).astype(int)
    for a, b in zip(bounds[:-1], bounds[1:]):
        size = b - a
        if size <= 1:
            continue
        sub = ring_graph(size)
        adj[a:b, a:b] = sub
    return adj


GRAPHS = {
    "ring": ring_graph,
    "path": path_graph,
    "star": star_graph,
    "full": fully_connected_graph,
    "erdos_renyi": erdos_renyi_graph,
    "disconnected": disconnected_graph,
}

# ---------------------------------------------------------------------------
# Mixing-matrix weightings
# ---------------------------------------------------------------------------


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: symmetric, doubly stochastic for any graph.

    Vectorized over the adjacency matrix — O(n^2) memory like its input, but
    no Python double loop, so dense realizations stay usable into the
    thousands of agents.  Each off-diagonal entry is the same elementwise
    ``1 / (1 + max(deg_i, deg_j))`` the loop form computed, so the result is
    bit-identical to the historical implementation.
    """
    n = adj.shape[0]
    deg = adj.sum(axis=1).astype(np.float64)
    pair_deg = np.maximum(deg[:, None], deg[None, :])
    w = np.where(adj, 1.0 / (1.0 + pair_deg), 0.0)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def metropolis_edge_weights(edges: np.ndarray, n: int):
    """Metropolis–Hastings weights from an edge list, never touching n×n.

    Returns ``(edge_w, self_w)``: one weight per undirected edge
    ``1 / (1 + max(deg_i, deg_j))`` and the per-agent diagonal
    ``1 - sum of incident edge weights``.  Agents with no realized edges get
    ``self_w = 1`` (they hold their iterate) — exactly the self-weight
    absorption :func:`metropolis_weights` performs via its diagonal fill.
    O(n + m) time and memory.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = np.bincount(edges.ravel(), minlength=n).astype(np.float64)
    if len(edges) == 0:
        return np.zeros(0, dtype=np.float64), np.ones(n, dtype=np.float64)
    edge_w = 1.0 / (1.0 + np.maximum(deg[edges[:, 0]], deg[edges[:, 1]]))
    incident = np.bincount(edges[:, 0], weights=edge_w, minlength=n)
    incident += np.bincount(edges[:, 1], weights=edge_w, minlength=n)
    return edge_w, 1.0 - incident


def best_constant_weights(adj: np.ndarray) -> np.ndarray:
    """Xiao–Boyd best-constant edge weight ``W = I - a L`` with
    ``a = 2 / (lam_1(L) + lam_{n-1}(L))`` — the single-parameter optimum from
    [XB04], a cheap stand-in for the full-SDP symmetric FDLA matrix the paper
    uses; it matches FDLA's asymptotics on the ring/path graphs we reproduce."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    lap = np.diag(deg.astype(np.float64)) - adj.astype(np.float64)
    eig = np.linalg.eigvalsh(lap)
    # eig[0] ~ 0; smallest nonzero is eig[1] (may also be 0 when disconnected)
    lam_max = eig[-1]
    lam_2 = eig[1]
    if lam_max + lam_2 <= 1e-12:  # empty graph
        return np.eye(n)
    alpha = 2.0 / (lam_max + lam_2) if lam_2 > 1e-12 else 1.0 / lam_max
    # Definition 1 requires a NONNEGATIVE W; the unconstrained best-constant
    # weight can push hub diagonals negative (e.g. star graphs) — clamp so
    # diag(W) = 1 - alpha*deg >= 0.
    deg_max = float(deg.max()) if n > 1 else 1.0
    if deg_max > 0:
        alpha = min(alpha, 1.0 / deg_max)
    return np.eye(n) - alpha * lap


WEIGHTINGS = {
    "metropolis": metropolis_weights,
    "best_constant": best_constant_weights,
}

# ---------------------------------------------------------------------------
# Spectral quantities (Definition 1)
# ---------------------------------------------------------------------------


def global_matrix(n: int) -> np.ndarray:
    """J = (1/n) 1 1^T — the server / global-averaging mixing matrix."""
    return np.full((n, n), 1.0 / n)


def second_singular_value(w: np.ndarray) -> float:
    n = w.shape[0]
    dev = w - global_matrix(n)
    return float(np.linalg.norm(dev, ord=2))


def mixing_rate(w: np.ndarray) -> float:
    """lambda_w = 1 - ||W - J||_2^2  (0 for disconnected, 1 for J itself)."""
    lam = second_singular_value(w)
    return max(0.0, 1.0 - lam * lam)


def expected_mixing_rate(lambda_w: float, p: float) -> float:
    """Assumption 1: lambda_p = lambda_w + p (1 - lambda_w)."""
    return lambda_w + p * (1.0 - lambda_w)


def is_doubly_stochastic(w: np.ndarray, tol: Optional[float] = None) -> bool:
    """Row/column-sum check with an n- and dtype-aware tolerance.

    The comparison is an *absolute* one (``rtol=0`` — the historical
    ``np.allclose`` call silently added a relative 1e-5 slack that made the
    advertised ``tol=1e-8`` meaningless for the sum checks).  A row sum
    accumulates O(sqrt(n)) rounding errors of size ``eps``, so a fixed
    absolute tolerance falsely rejects perfectly valid float32 Metropolis
    weights once ``n`` reaches the thousands.  The default scales as
    ``max(1e-8, 16 * sqrt(n) * eps(dtype))``; pass ``tol`` to override.
    """
    n = w.shape[0]
    if tol is None:
        eps = (
            float(np.finfo(w.dtype).eps)
            if np.issubdtype(w.dtype, np.floating)
            else float(np.finfo(np.float64).eps)
        )
        tol = max(1e-8, 16.0 * np.sqrt(n) * eps)
    ones = np.ones(n)
    return (
        bool(np.all(w >= -tol))
        and np.allclose(w @ ones, ones, rtol=0.0, atol=tol)
        and np.allclose(ones @ w, ones, rtol=0.0, atol=tol)
    )


def is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


# ---------------------------------------------------------------------------
# Topology: the launcher-facing bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip graph + weighting, with everything the mixers need."""

    name: str
    n_agents: int
    w: np.ndarray  # (n, n) doubly stochastic
    adj: np.ndarray  # (n, n) bool
    lambda_w: float
    connected: bool
    # For collective (ppermute) mixing: neighbor shifts valid for
    # shift-invariant graphs (ring/torus); None => dense mixing only.
    shifts: Optional[tuple] = None  # tuple of (shift, weight) incl. (0, w_self)

    def expected_rate(self, p: float) -> float:
        return expected_mixing_rate(self.lambda_w, p)


def _ring_shifts(w: np.ndarray) -> Optional[tuple]:
    """Detect a circulant structure and extract (shift, weight) pairs."""
    n = w.shape[0]
    first = w[0]
    for i in range(1, n):
        if not np.allclose(np.roll(first, i), w[i], atol=1e-10):
            return None
    shifts = tuple(
        (int(j), float(first[j])) for j in range(n) if abs(first[j]) > 1e-12
    )
    return shifts


def make_topology(
    name: str,
    n_agents: int,
    weighting: str = "metropolis",
    *,
    prob: float = 0.3,
    seed: int = 0,
    rows: Optional[int] = None,
    n_components: int = 2,
    degree: int = 4,
) -> Topology:
    """Build a named topology. ``name`` in GRAPHS, 'torus', or
    'random_regular' (the expander family shared with the sparse path)."""
    if name == "erdos_renyi":
        adj = erdos_renyi_graph(n_agents, prob, seed)
    elif name == "disconnected":
        adj = disconnected_graph(n_agents, n_components)
    elif name == "torus":
        r = rows or int(np.sqrt(n_agents))
        assert n_agents % r == 0, "torus requires rows | n_agents"
        adj = torus_graph(r, n_agents // r)
    elif name == "random_regular":
        adj = _adj_from_edges(
            n_agents, random_regular_edges(n_agents, degree=degree, seed=seed)
        )
    elif name in GRAPHS:
        adj = GRAPHS[name](n_agents)
    else:
        raise ValueError(
            f"unknown topology {name!r}; options: {sorted(GRAPHS)} + torus"
            f" + random_regular"
        )
    w = WEIGHTINGS[weighting](adj)
    return Topology(
        name=name,
        n_agents=n_agents,
        w=w,
        adj=adj,
        lambda_w=mixing_rate(w),
        connected=is_connected(adj) if n_agents > 1 else True,
        shifts=_ring_shifts(w),
    )


# ---------------------------------------------------------------------------
# Sparse topologies: edge-list / CSR representation, never materializing n×n
# ---------------------------------------------------------------------------

# Below this many agents the dense path is auto-selected (ExperimentSpec
# ``sparse=None``): dense einsum gossip is faster for small fleets and stays
# the bit-exact reference the parity tests pin against.
SPARSE_AUTO_MIN_AGENTS = 512


def use_sparse_topology(flag: Optional[bool], n_agents: int) -> bool:
    """Resolve the three-state ``sparse`` spec field: explicit True/False
    wins; ``None`` auto-selects sparse only for large fleets."""
    if flag is not None:
        return bool(flag)
    return n_agents > SPARSE_AUTO_MIN_AGENTS


def _canonical_edges(edges) -> np.ndarray:
    """(m, 2) int array, each row (i, j) with i < j, sorted lexicographically
    and deduplicated — the same order :func:`edge_list` produces from a dense
    adjacency, so sparse and dense constructions agree edge-for-edge."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if len(e) == 0:
        return np.zeros((0, 2), dtype=int)
    e = np.stack([e.min(axis=1), e.max(axis=1)], axis=1)
    e = e[e[:, 0] != e[:, 1]]  # drop self loops
    return np.unique(e, axis=0).astype(int)


def ring_edges(n: int) -> np.ndarray:
    if n <= 1:
        return np.zeros((0, 2), dtype=int)
    i = np.arange(n)
    return _canonical_edges(np.stack([i, (i + 1) % n], axis=1))


def path_edges(n: int) -> np.ndarray:
    i = np.arange(max(0, n - 1))
    return _canonical_edges(np.stack([i, i + 1], axis=1))


def star_edges(n: int) -> np.ndarray:
    j = np.arange(1, n)
    return _canonical_edges(np.stack([np.zeros_like(j), j], axis=1))


def torus_edges(rows: int, cols: int) -> np.ndarray:
    """Edges of the 2-D torus over ``rows*cols`` agents, O(n) construction."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    i = (r * cols + c).ravel()
    right = (r * cols + (c + 1) % cols).ravel()
    down = (((r + 1) % rows) * cols + c).ravel()
    return _canonical_edges(
        np.concatenate(
            [np.stack([i, right], axis=1), np.stack([i, down], axis=1)]
        )
    )


def random_regular_edges(n: int, degree: int = 4, seed: int = 0) -> np.ndarray:
    """Approximately ``degree``-regular connected graph as a union of
    ``ceil(degree / 2)`` random Hamiltonian cycles (deduplicated), O(n)
    memory.  Each cycle alone is connected, so the union always is — the
    standard cheap expander construction for large-fleet experiments."""
    if n <= 1:
        return np.zeros((0, 2), dtype=int)
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(max(1, -(-degree // 2))):
        perm = rng.permutation(n)
        parts.append(np.stack([perm, np.roll(perm, -1)], axis=1))
    return _canonical_edges(np.concatenate(parts))


SPARSE_GRAPHS = {
    "ring": ring_edges,
    "path": path_edges,
    "star": star_edges,
}

# Above this size, topologies with no O(n)-edge constructor (erdos_renyi,
# full, disconnected) refuse to fall back to dense adjacency extraction.
_SPARSE_DENSE_FALLBACK_MAX = 4096


def _connected_from_edges(n: int, edges: np.ndarray) -> bool:
    """BFS connectivity over adjacency lists — O(n + m)."""
    if n <= 1:
        return True
    if len(edges) == 0:
        return False
    nbr_idx, indptr = _csr_neighbors(n, edges)
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in nbr_idx[indptr[i] : indptr[i + 1]]:
            if not seen[j]:
                seen[j] = True
                frontier.append(int(j))
    return bool(seen.all())


def _csr_neighbors(n: int, edges: np.ndarray):
    """Neighbor indices + indptr over the directed expansion of ``edges``."""
    senders = np.concatenate([edges[:, 0], edges[:, 1]])
    receivers = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(receivers, kind="stable")
    nbr = senders[order]
    indptr = np.searchsorted(receivers[order], np.arange(n + 1))
    return nbr, indptr


@dataclasses.dataclass(frozen=True)
class SparseTopology:
    """A gossip graph in edge-list / CSR form — the large-fleet counterpart
    of :class:`Topology`, built without ever materializing an n×n array.

    ``edges`` is the canonical (i < j, lexicographic) undirected edge list;
    ``edge_weight``/``self_weight`` are its Metropolis–Hastings weights
    (:func:`metropolis_edge_weights`).  The CSR triple (``indptr``,
    ``indices``, ``data``) covers the *directed* expansion sorted by
    receiver: row ``i`` of the implicit W is ``data[indptr[i]:indptr[i+1]]``
    over senders ``indices[indptr[i]:indptr[i+1]]`` plus ``self_weight[i]``
    on the diagonal.  ``lambda_w`` is only computed for small n (dense
    spectral norm) and is ``None`` otherwise.
    """

    name: str
    n_agents: int
    edges: np.ndarray  # (m, 2) int, i < j, canonical order
    edge_weight: np.ndarray  # (m,) float64 Metropolis weights
    self_weight: np.ndarray  # (n,) float64 diagonal
    indptr: np.ndarray  # (n + 1,) CSR row pointers (directed, by receiver)
    indices: np.ndarray  # (2m,) sender index per directed edge
    data: np.ndarray  # (2m,) weight per directed edge
    connected: bool
    lambda_w: Optional[float] = None

    @property
    def n_edges(self) -> int:
        return int(len(self.edges))

    def dense_w(self) -> np.ndarray:
        """Materialize the implicit W (small-n reference / tests only)."""
        w = np.zeros((self.n_agents, self.n_agents), dtype=np.float64)
        if self.n_edges:
            i, j = self.edges[:, 0], self.edges[:, 1]
            w[i, j] = self.edge_weight
            w[j, i] = self.edge_weight
        np.fill_diagonal(w, self.self_weight)
        return w

    def expected_rate(self, p: float) -> float:
        if self.lambda_w is None:
            raise ValueError("lambda_w not computed for this fleet size")
        return expected_mixing_rate(self.lambda_w, p)


def sparse_topology_from_edges(
    name: str, n_agents: int, edges: np.ndarray
) -> SparseTopology:
    edges = _canonical_edges(edges)
    edge_w, self_w = metropolis_edge_weights(edges, n_agents)
    senders = np.concatenate([edges[:, 0], edges[:, 1]])
    receivers = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(receivers, kind="stable")
    indices = senders[order].astype(int)
    data = np.concatenate([edge_w, edge_w])[order]
    indptr = np.searchsorted(receivers[order], np.arange(n_agents + 1)).astype(int)
    lam = None
    if n_agents <= SPARSE_AUTO_MIN_AGENTS:
        w = np.zeros((n_agents, n_agents), dtype=np.float64)
        if len(edges):
            w[edges[:, 0], edges[:, 1]] = edge_w
            w[edges[:, 1], edges[:, 0]] = edge_w
        np.fill_diagonal(w, self_w)
        lam = mixing_rate(w)
    return SparseTopology(
        name=name,
        n_agents=n_agents,
        edges=edges,
        edge_weight=edge_w,
        self_weight=self_w,
        indptr=indptr,
        indices=indices,
        data=data,
        connected=_connected_from_edges(n_agents, edges),
        lambda_w=lam,
    )


def make_sparse_topology(
    name: str,
    n_agents: int,
    weighting: str = "metropolis",
    *,
    prob: float = 0.3,
    seed: int = 0,
    rows: Optional[int] = None,
    n_components: int = 2,
    degree: int = 4,
) -> SparseTopology:
    """Sparse counterpart of :func:`make_topology`.

    Topologies with an O(n)-edge constructor (ring/path/star/torus/
    random_regular) scale to millions of agents; the remaining named graphs
    fall back to dense adjacency extraction up to n = 4096 and raise beyond.
    Only Metropolis weighting has a sparse form.
    """
    if weighting != "metropolis":
        raise ValueError(
            f"sparse topologies support only metropolis weighting, got {weighting!r}"
        )
    if name == "torus":
        r = rows or int(np.sqrt(n_agents))
        assert n_agents % r == 0, "torus requires rows | n_agents"
        edges = torus_edges(r, n_agents // r)
    elif name == "random_regular":
        edges = random_regular_edges(n_agents, degree=degree, seed=seed)
    elif name in SPARSE_GRAPHS:
        edges = SPARSE_GRAPHS[name](n_agents)
    elif name in GRAPHS:
        if n_agents > _SPARSE_DENSE_FALLBACK_MAX:
            raise ValueError(
                f"topology {name!r} has no sparse constructor and "
                f"n={n_agents} exceeds the dense-fallback cap "
                f"({_SPARSE_DENSE_FALLBACK_MAX})"
            )
        kw = {}
        if name == "erdos_renyi":
            kw = {"prob": prob, "seed": seed}
        elif name == "disconnected":
            kw = {"n_components": n_components}
        edges = edge_list(GRAPHS[name](n_agents, **kw) if kw else GRAPHS[name](n_agents))
    else:
        raise ValueError(
            f"unknown topology {name!r}; options: {sorted(GRAPHS)} + torus"
            f" + random_regular"
        )
    return sparse_topology_from_edges(name, n_agents, edges)


def topology_edges(topo) -> np.ndarray:
    """Canonical undirected edge list of a :class:`Topology` or
    :class:`SparseTopology` — O(m) for sparse, O(n^2) extraction for dense."""
    edges = getattr(topo, "edges", None)
    if edges is not None:
        return edges
    return edge_list(topo.adj)


# ---------------------------------------------------------------------------
# Dynamic networks: per-round topology processes (time-varying W_k)
# ---------------------------------------------------------------------------

# Domain-separation tags so link draws and participation draws at the same
# (seed, round) never correlate.
_LINK_TAG = 0x11AA
_PART_TAG = 0x77EE


def _round_rng(seed: int, tag: int, k: int) -> np.random.Generator:
    """Per-round RNG that is a *pure function* of ``(seed, tag, k)``: every
    driver (legacy per-round loop, chunked scan, vmapped sweep) sees the
    identical realization for round ``k`` regardless of block boundaries."""
    return np.random.default_rng((int(seed), int(tag), int(k)))


def edge_list(adj: np.ndarray) -> np.ndarray:
    """Undirected edges (i < j) of ``adj`` in deterministic row-major order,
    as an (m, 2) int array."""
    i, j = np.nonzero(np.triu(adj, k=1))
    return np.stack([i, j], axis=1) if i.size else np.zeros((0, 2), dtype=int)


def _adj_from_edges(n: int, edges: np.ndarray) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    if len(edges):
        adj[edges[:, 0], edges[:, 1]] = True
        adj[edges[:, 1], edges[:, 0]] = True
    return adj


class TopologyProcess:
    """A sequence of per-round gossip graphs over a fixed base :class:`Topology`.

    Each round ``k`` realizes an edge subset of the base graph and re-weights
    it with Metropolis–Hastings weights (:func:`metropolis_weights`), whose
    diagonal fill is exactly the *self-weight absorption* a dropped link
    requires: the mass a failed edge would have carried moves onto ``w_ii``,
    keeping every realization symmetric and doubly stochastic.

    Realizations are drawn **host-side** and are pure functions of
    ``(seed, k)`` — the same contract as the Bernoulli(p) schedule in
    :mod:`repro_torch.core.driver` — so the scan driver can pre-draw a whole block
    (:meth:`draw_block`) and still agree round-for-round with the legacy loop.
    """

    kind = "abstract"

    def __init__(self, base, seed: int = 0):
        self.base = base  # Topology or SparseTopology
        self.seed = int(seed)
        self._edges = topology_edges(base)
        self._edge_index = None  # lazy (i, j) -> base row map (mask fallback)

    # -- interface ----------------------------------------------------------

    @property
    def n_agents(self) -> int:
        return self.base.n_agents

    @property
    def static(self) -> bool:
        return False

    def spec(self) -> str:
        """Round-trippable string form (parsed by :func:`make_topology_process`)."""
        return self.kind

    def edges_at(self, k: int) -> np.ndarray:
        """(m_k, 2) realized undirected edges for round ``k``."""
        raise NotImplementedError

    def edge_mask_at(self, k: int) -> np.ndarray:
        """Round-``k`` realization as a bool mask over the *base* edge list.

        The sparse drivers thread fixed-shape per-edge operands through
        ``lax.scan``, so realizations must be expressed in base-edge order
        with dropped edges zeroed, not as variable-length subsets.  Subclasses
        override with an O(m) draw; this generic fallback matches
        :meth:`edges_at` rows back to base indices.
        """
        if self._edge_index is None:
            self._edge_index = {
                (int(i), int(j)): t for t, (i, j) in enumerate(self._edges)
            }
        mask = np.zeros(len(self._edges), dtype=bool)
        for i, j in self.edges_at(k):
            mask[self._edge_index[(min(int(i), int(j)), max(int(i), int(j)))]] = True
        return mask

    # -- derived ------------------------------------------------------------

    def realize(self, k: int):
        """``(W_k, directed_messages)`` from one edge realization."""
        edges = self.edges_at(k)
        w = metropolis_weights(_adj_from_edges(self.n_agents, edges))
        return w, 2 * len(edges)

    def adjacency_at(self, k: int) -> np.ndarray:
        return _adj_from_edges(self.n_agents, self.edges_at(k))

    def weights_at(self, k: int) -> np.ndarray:
        """The round-``k`` mixing matrix W_k (symmetric, doubly stochastic)."""
        return self.realize(k)[0]

    def messages_at(self, k: int) -> int:
        """Directed neighbor messages one gossip mix moves in round ``k``."""
        return self.realize(k)[1]

    def draw_block(self, start: int, stop: int):
        """Stacked ``(W, messages)`` for rounds ``[start, stop)``: W is
        (block, n, n) float32 (a ``lax.scan`` operand), messages (block,) int
        (what the byte accountant prices)."""
        realized = [self.realize(k) for k in range(start, stop)]
        ws = np.stack([w for w, _ in realized]).astype(np.float32)
        msgs = np.array([m for _, m in realized])
        return ws, msgs

    # -- sparse realizations (edge sets instead of matrices) ----------------

    def realize_sparse(self, k: int):
        """``(edge_w, self_w, directed_messages)`` for round ``k`` in *base*
        edge order: ``edge_w`` is (m,) with zeros on dropped edges, ``self_w``
        is the (n,) Metropolis diagonal of the realized subgraph.  Same
        re-weighting as :meth:`realize` — :func:`metropolis_edge_weights` over
        the kept edges — without touching n×n."""
        mask = self.edge_mask_at(k)
        m = len(self._edges)
        edge_w = np.zeros(m, dtype=np.float64)
        kept = int(mask.sum())
        if kept:
            sub_w, self_w = metropolis_edge_weights(
                self._edges[mask], self.n_agents
            )
            edge_w[mask] = sub_w
        else:
            self_w = np.ones(self.n_agents, dtype=np.float64)
        return edge_w, self_w, 2 * kept

    def draw_sparse_block(self, start: int, stop: int):
        """Stacked ``(edge_w, self_w, messages)`` for rounds ``[start, stop)``:
        edge_w (block, m) and self_w (block, n) float32 scan operands over the
        base edge order, messages (block,) host ints for the byte accountant
        — the sparse analogue of :meth:`draw_block`."""
        realized = [self.realize_sparse(k) for k in range(start, stop)]
        edge_w = np.stack([r[0] for r in realized]).astype(np.float32)
        self_w = np.stack([r[1] for r in realized]).astype(np.float32)
        msgs = np.array([r[2] for r in realized])
        return edge_w, self_w, msgs


class StaticProcess(TopologyProcess):
    """The degenerate process: the base topology's W every round (this is the
    frozen-matrix behavior every pre-dynamic experiment had)."""

    kind = "static"

    @property
    def static(self) -> bool:
        return True

    def edges_at(self, k: int) -> np.ndarray:
        return self._edges

    def edge_mask_at(self, k: int) -> np.ndarray:
        return np.ones(len(self._edges), dtype=bool)

    def realize(self, k: int):
        # keep the base weighting (may be best_constant), skip re-realization
        w = getattr(self.base, "w", None)
        if w is None:  # SparseTopology base: materialize the implicit W
            return self.base.dense_w(), 2 * len(self._edges)
        return w, 2 * len(self._edges)

    def realize_sparse(self, k: int):
        ew = getattr(self.base, "edge_weight", None)
        if ew is not None:  # SparseTopology base: weights are precomputed
            return (
                np.asarray(ew, dtype=np.float64),
                np.asarray(self.base.self_weight, dtype=np.float64),
                2 * len(self._edges),
            )
        return super().realize_sparse(k)


class LinkFailureProcess(TopologyProcess):
    """I.i.d. Bernoulli link failures: each base edge drops independently with
    probability ``failure_prob`` each round (FedDec / sampled-link regime)."""

    kind = "bernoulli"

    def __init__(self, base: Topology, failure_prob: float = 0.2, seed: int = 0):
        super().__init__(base, seed)
        assert 0.0 <= failure_prob <= 1.0
        self.failure_prob = float(failure_prob)

    def spec(self) -> str:
        return f"bernoulli:{self.failure_prob:g}"

    def edge_mask_at(self, k: int) -> np.ndarray:
        if self.failure_prob <= 0.0:
            return np.ones(len(self._edges), dtype=bool)
        rng = _round_rng(self.seed, _LINK_TAG, k)
        return rng.random(len(self._edges)) >= self.failure_prob

    def edges_at(self, k: int) -> np.ndarray:
        return self._edges[self.edge_mask_at(k)]


class RandomMatchingProcess(TopologyProcess):
    """One random maximal matching of the base graph per round: every agent
    talks to at most one neighbor (the classic gossip-pairing model), so each
    realized W_k is a disjoint union of 1/2–1/2 edge blocks."""

    kind = "matching"

    def _picked_at(self, k: int) -> np.ndarray:
        """Base-edge indices of the round-``k`` matching, in greedy pick
        order (the order :meth:`edges_at` has always returned)."""
        rng = _round_rng(self.seed, _LINK_TAG, k)
        order = rng.permutation(len(self._edges))
        matched = np.zeros(self.n_agents, dtype=bool)
        picked = []
        for t in order:
            i, j = int(self._edges[t, 0]), int(self._edges[t, 1])
            if not matched[i] and not matched[j]:
                matched[i] = matched[j] = True
                picked.append(int(t))
        return np.array(picked, dtype=int)

    def edges_at(self, k: int) -> np.ndarray:
        picked = self._picked_at(k)
        return self._edges[picked] if len(picked) else np.zeros((0, 2), int)

    def edge_mask_at(self, k: int) -> np.ndarray:
        mask = np.zeros(len(self._edges), dtype=bool)
        mask[self._picked_at(k)] = True
        return mask


class RoundRobinProcess(TopologyProcess):
    """Deterministic cycle over ``n_parts`` edge subsets of the base graph:
    round ``k`` gossips over part ``k % n_parts``.  One full cycle touches
    every base edge exactly once (B-connectivity with period ``n_parts``)."""

    kind = "roundrobin"

    def __init__(self, base: Topology, n_parts: int = 2, seed: int = 0):
        super().__init__(base, seed)
        assert n_parts >= 1
        self.n_parts = int(n_parts)
        self._parts = [self._edges[i :: self.n_parts] for i in range(self.n_parts)]

    def spec(self) -> str:
        return f"roundrobin:{self.n_parts}"

    def edges_at(self, k: int) -> np.ndarray:
        return self._parts[k % self.n_parts]

    def edge_mask_at(self, k: int) -> np.ndarray:
        mask = np.zeros(len(self._edges), dtype=bool)
        mask[k % self.n_parts :: self.n_parts] = True
        return mask


class NeighborSampleProcess(TopologyProcess):
    """Neighbor-sampled cohorts: round ``k`` activates only the subgraph
    incident to a uniform sample of ``ceil(fraction * n)`` seed agents.

    Sampled agents gossip with *all* their base-graph neighbors (so the seed
    set's whole one-hop neighborhood participates); everyone else holds.
    This is the client-sampling analogue for decentralized rounds — the
    sampled-to-sampled analysis (PAPERS.md) shows doubly stochastic
    re-weighting over the active subgraph preserves the network mean, which
    the Metropolis re-realization here provides.  Only the active subgraph's
    edges carry nonzero weight per round, so with the sparse mixers the
    materialized per-round state is O(edges incident to the cohort).
    """

    kind = "cohort"

    def __init__(self, base, fraction: float = 0.25, seed: int = 0):
        super().__init__(base, seed)
        assert 0.0 < fraction <= 1.0
        self.fraction = float(fraction)
        self.m_seeds = max(1, min(self.n_agents, int(round(fraction * self.n_agents))))

    def spec(self) -> str:
        return f"cohort:{self.fraction:g}"

    def seeds_at(self, k: int) -> np.ndarray:
        """Sorted seed-agent indices for round ``k``."""
        if self.m_seeds >= self.n_agents:
            return np.arange(self.n_agents)
        rng = _round_rng(self.seed, _LINK_TAG, k)
        return np.sort(rng.choice(self.n_agents, size=self.m_seeds, replace=False))

    def edge_mask_at(self, k: int) -> np.ndarray:
        active = np.zeros(self.n_agents, dtype=bool)
        active[self.seeds_at(k)] = True
        e = self._edges
        if len(e) == 0:
            return np.zeros(0, dtype=bool)
        return active[e[:, 0]] | active[e[:, 1]]

    def edges_at(self, k: int) -> np.ndarray:
        return self._edges[self.edge_mask_at(k)]


TOPOLOGY_PROCESSES = ("static", "bernoulli", "matching", "roundrobin", "cohort")


def parse_process_spec(spec: Optional[str]):
    """Validate a declarative network spec and return ``(kind, arg)``.

    ``spec`` is ``'static'`` | ``'bernoulli[:failure_prob]'`` | ``'matching'``
    | ``'roundrobin[:n_parts]'`` | ``'cohort[:fraction]'`` (``None`` means
    static).  ExperimentSpec calls this at construction so a typo fails
    fast, not mid-run."""
    kind, _, arg = (spec or "static").partition(":")
    if kind not in TOPOLOGY_PROCESSES:
        raise ValueError(
            f"unknown topology process {spec!r}; options: {TOPOLOGY_PROCESSES}"
            f" (e.g. 'bernoulli:0.3', 'roundrobin:2', 'cohort:0.25')"
        )
    if arg:
        if kind == "bernoulli":
            q = float(arg)
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"failure prob must be in [0, 1], got {arg}")
            return kind, q
        if kind == "roundrobin":
            n = int(arg)
            if n < 1:
                raise ValueError(f"roundrobin needs n_parts >= 1, got {arg}")
            return kind, n
        if kind == "cohort":
            f = float(arg)
            if not 0.0 < f <= 1.0:
                raise ValueError(f"cohort fraction must be in (0, 1], got {arg}")
            return kind, f
        raise ValueError(f"topology process {kind!r} takes no argument: {spec!r}")
    return kind, None


def make_topology_process(
    spec: Optional[str], base, *, seed: int = 0
) -> TopologyProcess:
    """Parse a declarative network spec into a :class:`TopologyProcess`
    (see :func:`parse_process_spec` for the grammar).  ``base`` may be a
    :class:`Topology` or a :class:`SparseTopology`."""
    kind, arg = parse_process_spec(spec)
    if kind == "static":
        return StaticProcess(base, seed=seed)
    if kind == "bernoulli":
        return LinkFailureProcess(
            base, failure_prob=0.2 if arg is None else arg, seed=seed
        )
    if kind == "matching":
        return RandomMatchingProcess(base, seed=seed)
    if kind == "cohort":
        return NeighborSampleProcess(
            base, fraction=0.25 if arg is None else arg, seed=seed
        )
    return RoundRobinProcess(base, n_parts=2 if arg is None else arg, seed=seed)


class ParticipationProcess:
    """Uniform m-of-n partial participation for server rounds.

    Round ``k`` samples ``m = max(1, round(fraction * n))`` participants
    without replacement; the server exchange is expressed as the doubly
    stochastic *sampled-to-sampled* matrix

        S_k[i, j] = 1/m  if i, j both participate;   S_k[i, i] = 1 otherwise.

    Participants average among themselves, absentees keep their iterate.
    Because S_k is doubly stochastic the network mean is invariant — no
    re-scaling needed for unbiasedness: for a uniform sample,
    ``E[(1/m) sum_{i in S} x_i] = x_bar`` exactly.  Draws are pure functions
    of ``(seed, k)``, like :class:`TopologyProcess` realizations.
    """

    def __init__(self, n_agents: int, fraction: float, seed: int = 0):
        assert 0.0 < fraction <= 1.0
        self.n_agents = int(n_agents)
        self.fraction = float(fraction)
        self.seed = int(seed)
        self.m = max(1, min(self.n_agents, int(round(fraction * n_agents))))

    def participants_at(self, k: int) -> np.ndarray:
        """Sorted participant indices for round ``k``."""
        if self.m >= self.n_agents:
            return np.arange(self.n_agents)
        rng = _round_rng(self.seed, _PART_TAG, k)
        return np.sort(rng.choice(self.n_agents, size=self.m, replace=False))

    def server_matrix_at(self, k: int) -> np.ndarray:
        part = self.participants_at(k)
        s = np.eye(self.n_agents, dtype=np.float64)
        s[np.ix_(part, part)] = 1.0 / len(part)
        return s

    def draw_block(self, start: int, stop: int):
        """Stacked ``(S, participants)`` for rounds ``[start, stop)``."""
        ss = np.stack(
            [self.server_matrix_at(k) for k in range(start, stop)]
        ).astype(np.float32)
        counts = np.full(stop - start, self.m, dtype=int)
        return ss, counts

    def participant_mask_at(self, k: int) -> np.ndarray:
        """Round-``k`` participation as a (n,) float32 0/1 mask — the O(n)
        operand form the sparse mixers consume instead of the n×n S_k."""
        mask = np.zeros(self.n_agents, dtype=np.float32)
        mask[self.participants_at(k)] = 1.0
        return mask

    def draw_mask_block(self, start: int, stop: int):
        """Stacked ``(mask, participants)`` for rounds ``[start, stop)`` —
        the sparse analogue of :meth:`draw_block`."""
        masks = np.stack(
            [self.participant_mask_at(k) for k in range(start, stop)]
        )
        counts = np.full(stop - start, self.m, dtype=int)
        return masks, counts
