"""Agent-stacked tree arithmetic over ``dict[str, Tensor]``.

All PISCO state (model estimates ``X``, tracking variables ``Y``, last local
gradients ``G``) is a dict of tensors whose leaves carry a leading axis of
size ``n_agents``.  Leaves are always walked in sorted-key order — the order
``jax.tree`` uses for dicts — so per-leaf reductions and per-leaf random
draws line up with the reference.  Mixing accumulates in float32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.sparse_mix import sparse_mix

Tree = Dict[str, torch.Tensor]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Apply ``fn`` leafwise over dicts with identical keys, in sorted order."""
    return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}


def tree_leaves(tree: Tree):
    return [tree[k] for k in sorted(tree)]


def tree_stack(trees) -> Tree:
    """Stack a list of identically keyed trees along a new axis 0."""
    return {k: torch.stack([t[k] for t in trees], dim=0) for k in sorted(trees[0])}


def tree_unstack(tree: Tree, n: int) -> list:
    """Inverse of :func:`tree_stack`: split the leading axis into ``n`` trees."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_size(tree: Tree) -> int:
    """Total number of scalar elements."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Sum of elementwise products across all leaves (a 0-dim tensor)."""
    leaves = [torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    out = leaves[0]
    for v in leaves[1:]:
        out = out + v
    return out


def tree_sq_norm(a: Tree) -> torch.Tensor:
    return tree_dot(a, a)


def tree_agent_mean(tree: Tree) -> Tree:
    """Mean over the leading (agent) axis, broadcast back to the same shape —
    the ``X J`` of the paper.  Materialised (no ``expand`` view), so callers
    may update the result in place."""
    return tree_map(
        lambda x: x.mean(dim=0, keepdim=True).expand(x.shape).contiguous(), tree
    )


def tree_agent_mix(tree: Tree, w: torch.Tensor) -> Tree:
    """``out_i = sum_j w_ij x_j`` per leaf — with the leading-agent-axis
    layout the compact-form ``X W`` is a contraction with **W^T**."""
    wt = w.to(torch.float32).T

    def mix(x):
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        return (wt @ flat).reshape(x.shape).to(x.dtype)

    return tree_map(mix, tree)


def _agent_col(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (n,) per-agent vector shaped to broadcast over leaf ``x``."""
    return v.reshape(v.shape + (1,) * (x.dim() - 1))


def tree_agent_masked_mean(tree: Tree, mask: torch.Tensor) -> Tree:
    """Sampled-to-sampled server round in O(n): participants (``mask`` 1.0)
    average among themselves in float32, absentees hold — the dense doubly
    stochastic S_k of ``ParticipationProcess.server_matrix_at``."""
    count = torch.clamp_min(mask.sum(), 1.0)

    def leaf(x):
        xf = x.to(torch.float32)
        m = _agent_col(mask, x)
        avg = (m * xf).sum(dim=0, keepdim=True) / count
        return (m * avg + (1.0 - m) * xf).to(x.dtype)

    return tree_map(leaf, tree)


def tree_agent_weighted_mean(tree: Tree, w: torch.Tensor, keep: torch.Tensor) -> Tree:
    """Weighted server round in O(n): ``out_i = keep_i x_i + (1 - keep_i)
    sum_j w_j x_j`` in float32 (``w`` sums to one over the participants,
    ``keep`` is 1.0 for agents holding their iterate)."""

    def leaf(x):
        xf = x.to(torch.float32)
        kv = _agent_col(keep, x)
        avg = (_agent_col(w, x) * xf).sum(dim=0, keepdim=True)
        return (kv * xf + (1.0 - kv) * avg).to(x.dtype)

    return tree_map(leaf, tree)


def tree_agent_mix_sparse(tree: Tree, senders, receivers, edge_w, self_w) -> Tree:
    """Sparse gossip over directed edges without materialising W:

        out_i = self_w[i] * x_i + sum_{e : senders[e] -> i} edge_w[e] * x_{senders[e]}

    The edge-list entry of the sparse-gossip kernel
    (:func:`repro_torch.kernels.sparse_mix.sparse_mix`), leaf by leaf."""
    def mix(x):
        flat = x.reshape(x.shape[0], -1)
        return sparse_mix(flat, senders, receivers, edge_w, self_w).reshape(x.shape)

    return tree_map(mix, tree)


# ---------------------------------------------------------------------------
# Robust server rules: each aggregates over the agent axis in float32 on the
# leaf's device and broadcasts the result back (materialised) in its dtype.
# ---------------------------------------------------------------------------


def _broadcast(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return m.to(x.dtype).expand(x.shape).contiguous()


def tree_agent_trimmed_mean(tree: Tree, trim: int) -> Tree:
    """Coordinate-wise trimmed mean over the agent axis, broadcast back: per
    coordinate the ``trim`` smallest and ``trim`` largest agent values are
    dropped and the rest averaged.  Callers guarantee ``n - 2 trim >= 1``."""
    trim = int(trim)

    def leaf(x):
        n = x.shape[0]
        s = torch.sort(x.to(torch.float32), dim=0).values
        kept = s[trim:n - trim] if trim > 0 else s
        return _broadcast(kept.mean(dim=0, keepdim=True), x)

    return tree_map(leaf, tree)


def tree_agent_median(tree: Tree) -> Tree:
    """Coordinate-wise median over the agent axis, broadcast back.  As
    ``jnp.median`` (its ``midpoint`` quantile): ``(lo + hi) * 0.5`` of the
    two middle sorted values, which are one value when n is odd — not
    ``torch.median``, whose even-n median is the lower middle value."""

    def leaf(x):
        n = x.shape[0]
        s = torch.sort(x.to(torch.float32), dim=0).values
        lo, hi = s[(n - 1) // 2:(n - 1) // 2 + 1], s[n // 2:n // 2 + 1]
        return _broadcast((lo + hi) * 0.5, x)

    return tree_map(leaf, tree)


def krum_distances(tree: Tree, weights: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """(n, n) float32: the agents' squared distances summed over all leaves
    (Gram form ``|x_i|^2 + |x_j|^2 - 2 x_i . x_j`` clamped at 0), each
    leaf's term scaled by ``weights[key]`` where given."""
    keys = sorted(tree)
    n = tree[keys[0]].shape[0]
    d2 = torch.zeros((n, n), dtype=torch.float32, device=tree[keys[0]].device)
    for k in keys:
        xf = tree[k].reshape(n, -1).to(torch.float32)
        sq = torch.sum(xf * xf, dim=1)
        term = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (xf @ xf.T), 0.0)
        w = 1.0 if weights is None else weights[k]
        d2 = d2 + (term if w == 1.0 else w * term)
    return d2


def krum_scores_of(d2: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(n,) Krum scores from the distances of :func:`krum_distances`: each
    agent's sum to its ``max(1, n - n_byz - 2)`` closest peers, itself
    excluded."""
    n = d2.shape[0]
    m = max(1, n - int(n_byz) - 2)
    d2 = d2 + torch.diag(torch.full((n,), float("inf"), device=d2.device))
    return torch.sum(torch.sort(d2, dim=1).values[:, :m], dim=1)


def krum_scores(tree: Tree, n_byz: int) -> torch.Tensor:
    """(n,) Krum scores: each agent's summed squared distance (over all
    leaves, Gram form ``|x_i|^2 + |x_j|^2 - 2 x_i . x_j`` clamped at 0) to
    its ``max(1, n - n_byz - 2)`` closest peers, itself excluded."""
    return krum_scores_of(krum_distances(tree), n_byz)


def tree_agent_krum(tree: Tree, n_byz: int) -> Tree:
    """Krum-style selection over the agent axis: the agent with the lowest
    :func:`krum_scores` (the first of equal scores, as ``jnp.argmin``), its
    whole tree broadcast back — always one agent's actual submission."""
    sel = torch.argmin(krum_scores(tree, n_byz)).reshape(1)
    return tree_map(lambda x: _broadcast(x.index_select(0, sel), x), tree)


# ---------------------------------------------------------------------------
# Nested trees (the LM zoo's parameters and caches): dicts walked in sorted
# key order, lists in order, the order ``jax.tree`` uses.
# ---------------------------------------------------------------------------


def nest_map(fn: Callable, *trees):
    """``fn`` over the leaves of ``trees[0]`` (nested dicts and lists); the
    other trees are cut at those leaf positions, so a delta payload facing a
    tensor leaf of the first tree arrives whole."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: nest_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, list):
        return [nest_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def nest_leaves(tree) -> list:
    """Every tensor of a nested tree, delta payloads (NamedTuples) opened."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in nest_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in nest_leaves(x)]
    return [tree]


def nest_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested tree; ``path`` joins the dict keys
    and list indices from the root with "/"."""
    if isinstance(tree, dict):
        return {k: nest_map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [nest_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def flatten_paths(tree) -> Tree:
    """A nested tree as a flat dict keyed by leaf path (``"layers/pos0/
    mixer/in_proj"``): the layout the agent-state arithmetic walks."""
    flat: Tree = {}
    nest_map_with_path(lambda p, t: flat.__setitem__(p, t), tree)
    return flat

