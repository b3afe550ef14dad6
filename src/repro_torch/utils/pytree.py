"""Agent-stacked tree arithmetic over ``dict[str, Tensor]``.

All PISCO state (model estimates ``X``, tracking variables ``Y``, last local
gradients ``G``) is a dict of tensors whose leaves carry a leading axis of
size ``n_agents``.  Leaves are always walked in sorted-key order — the order
``jax.tree`` uses for dicts — so per-leaf reductions and per-leaf random
draws line up with the reference.  Mixing accumulates in float32.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.kernels.sparse_mix import sparse_mix

Tree = Dict[str, torch.Tensor]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Apply ``fn`` leafwise over dicts with identical keys, in sorted order."""
    return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}


def tree_leaves(tree: Tree):
    return [tree[k] for k in sorted(tree)]


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


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
