"""Placements of agent-stacked parameters over a mesh (the twin of
``repro.launch.specs``).

A placement is a tuple with one entry per dim of a leaf — a mesh axis name,
a tuple of names (the dim spread over their product), or None (whole along
that dim) — the entries of the reference's ``PartitionSpec``.  A tree of
them is a flat dict keyed by the leaf paths of
:func:`repro_torch.utils.pytree.flatten_paths`, beside a dict of tensors (or
anything with ``shape`` and ``dtype``) on the same keys.  Every function
reads a mesh by its ``shape`` dict alone, as the reference's do, so a
:class:`~repro_torch.launch.mesh.RankMesh`, a
:class:`~repro_torch.launch.mesh.CountingMesh` or a stand-in with a
``shape`` serves.

The models declare intent (heads over "model", d_ff over "model", ...); not
every dim divides every mesh axis, so :func:`sanitize_specs` replicates
what does not divide and reports it.  :func:`add_fsdp_axis` is pod-as-agent's
FSDP: each agent's replica spreads over the intra-pod data axis.
:func:`model_dims` reads, per leaf, the dim the ``model`` axis splits, and
:func:`shard_model` / :func:`gather_model` cut a rank's model shard out of a
whole tree and put the whole back from the shards.  The
reference's ``to_shardings`` (``NamedSharding`` objects for ``jax.jit``)
has no twin: the port's ranks slice their shards themselves
(:func:`repro_torch.launch.steps.build_train_steps`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.pytree import nest_map_with_path

Spec = Tuple[Any, ...]


def stack_spec_tree(spec_tree: Dict[str, Spec], agent_axes: Sequence[str]) -> Dict[str, Spec]:
    """Prefix every placement with the agent axis (the leading stacked dim):
    the axis name, or the tuple of names when there are several."""
    axes = tuple(agent_axes)
    entry = axes if len(axes) > 1 else axes[0]
    return {k: (entry,) + tuple(s) for k, s in spec_tree.items()}


def _axis_product(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


def _entries(spec, shape) -> List[Any]:
    """One entry per dim: the placement padded with None, or cut, to the
    leaf's rank."""
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    return entries[:len(shape)]


def _trim(entries: List[Any]) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def sanitize_specs(spec_tree: Dict[str, Spec], shape_tree: Dict[str, Any],
                   mesh) -> Tuple[Dict[str, Spec], List[str]]:
    """Replicate every dim its axes do not divide; returns (placements,
    report), one report line per dropped entry, in path order."""
    report: List[str] = []
    fixed = {}
    for path in sorted(spec_tree):
        shape = tuple(shape_tree[path].shape)
        entries = []
        for dim, entry in zip(shape, _entries(spec_tree[path], shape)):
            size = _axis_product(mesh, entry)
            if entry is not None and dim % size != 0:
                report.append(f"{path}: dim {dim} % {entry}({size}) != 0 -> replicated")
                entry = None
            entries.append(entry)
        fixed[path] = _trim(entries)
    return fixed, report


def add_fsdp_axis(spec_tree: Dict[str, Spec], shape_tree: Dict[str, Any], mesh,
                  axis: str = "data", *, skip_leading: int = 0,
                  min_dim: int = 1024) -> Dict[str, Spec]:
    """Greedy FSDP: on every leaf, ``axis`` goes on the first dim from
    ``skip_leading`` on that has no axis yet, is at least ``min_dim`` and
    divides by the axis's size (pod-as-agent's: axis 0 is the agent stack,
    so ``skip_leading=1``).  A leaf without such a dim stays as it was."""
    size = mesh.shape[axis]
    out = {}
    for path, spec in spec_tree.items():
        shape = tuple(shape_tree[path].shape)
        entries = _entries(spec, shape)
        for i in range(skip_leading, len(shape)):
            if entries[i] is None and shape[i] >= min_dim and shape[i] % size == 0:
                entries[i] = axis
                break
        out[path] = _trim(entries)
    return out


def shard_bytes(shape_tree: Dict[str, Any], spec_tree: Dict[str, Spec], mesh) -> int:
    """Bytes one device holds of a placed tree (logical, no padding)."""
    total = 0
    for path, shaped in shape_tree.items():
        n = int(np.prod(tuple(shaped.shape))) if len(shaped.shape) else 1
        denom = 1
        for entry in spec_tree[path]:
            denom *= _axis_product(mesh, entry)
        total += (n // max(1, denom)) * shaped.dtype.itemsize
    return total


def data_dims(spec_tree: Dict[str, Spec], axis: str = "data",
              skip_leading: int = 1) -> Dict[str, Any]:
    """Per leaf, the dim of the unstacked (per-agent) leaf that ``axis``
    splits, or None for a leaf held whole: what a rank of pod-as-agent
    slices and gathers."""
    out = {}
    for path, spec in spec_tree.items():
        dims = [i - skip_leading for i, e in enumerate(spec) if i >= skip_leading and e == axis]
        out[path] = dims[0] if dims else None
    return out


@dataclasses.dataclass(frozen=True)
class Segments:
    """A dim cut into consecutive segments, each split over the model ranks
    (True) or held whole on every rank (False); a rank's shard is its block
    of every split segment beside every whole one, in order.  The layout of
    a leaf that packs several tensors along one dim (Mamba-2's ``in_proj``:
    z, x, B, C, dt), where the reference's contiguous chunks would cross
    their boundaries."""

    dim: int
    sizes: Tuple[int, ...]
    split: Tuple[bool, ...]

    def local_sizes(self, n: int) -> Tuple[int, ...]:
        return tuple(s // n if sp else s for s, sp in zip(self.sizes, self.split))


Layout = Union[None, int, Segments]


def model_dims(spec_tree: Dict[str, Spec], axis: str = "model") -> Dict[str, Optional[int]]:
    """Per leaf, the dim that ``axis`` splits in a sanitized placement, or
    None for a leaf held whole (the twin of :func:`data_dims` for the model
    axis, over unstacked placements)."""
    return data_dims(spec_tree, axis, skip_leading=0)


def _shard_one(v: torch.Tensor, layout: Layout, n: int, i: int) -> torch.Tensor:
    if layout is None:
        return v
    if isinstance(layout, Segments):
        parts = v.split(layout.sizes, layout.dim)
        return torch.cat([p.chunk(n, layout.dim)[i] if sp else p
                          for p, sp in zip(parts, layout.split)], layout.dim).contiguous()
    return v.chunk(n, layout)[i].clone(memory_format=torch.contiguous_format)


def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _rank_on(mesh, axis) -> Tuple[int, int]:
    """``(n, i)``: the ranks over ``axis`` (a name or a tuple of names)
    and this rank's row-major position among them."""
    axes = _axes(axis)
    return mesh.size(axes), mesh.index(axes)


def shard_leaf(v: torch.Tensor, layout: Layout, mesh, axis="model") -> torch.Tensor:
    """This rank's shard of one whole leaf over ``axis`` (a name, or a
    tuple of names split as their row-major product: the idle axes); a copy,
    or the leaf itself when it is held whole."""
    return _shard_one(v, layout, *_rank_on(mesh, axis))


def shard_model(tree: Dict[str, Any], dims: Dict[str, Layout], mesh,
                axis="model") -> Dict[str, Any]:
    """This rank's model shard of each leaf of a whole, path-keyed tree:
    its block of the dim ``dims`` names (or of each split segment), the leaf
    as it is where ``dims`` is None."""
    return {k: shard_leaf(v, dims.get(k), mesh, axis) for k, v in tree.items()}


def _gather_dim(v: torch.Tensor, d: int, mesh, axis) -> torch.Tensor:
    d = d % v.dim()
    parts = mesh.all_gather(v.contiguous(), _axes(axis))  # (n, *shard)
    return parts.movedim(0, d).reshape(v.shape[:d] + (-1,) + v.shape[d + 1:])


def gather_model(shards: Dict[str, Any], dims: Dict[str, Layout], mesh,
                 axis="model") -> Dict[str, Any]:
    """The whole leaves from the model ranks' shards (an all-gather over
    ``axis`` per split leaf or segment), the inverse of
    :func:`shard_model`."""
    out = {}
    n = mesh.size(_axes(axis))
    for k, v in shards.items():
        layout = dims.get(k)
        if layout is None:
            out[k] = v
        elif isinstance(layout, Segments):
            parts = v.split(layout.local_sizes(n), layout.dim)
            out[k] = torch.cat([_gather_dim(p, layout.dim, mesh, axis) if sp else p
                                for p, sp in zip(parts, layout.split)], layout.dim)
        else:
            out[k] = _gather_dim(v, layout, mesh, axis)
    return out


def shard_tree(tree: Any, layout: Dict[str, Layout], mesh, axis="model") -> Any:
    """This rank's model shard of every leaf of a nested tree (parameters
    or a cache, keyed as :func:`~repro_torch.utils.pytree.flatten_paths`
    keys them)."""
    return nest_map_with_path(lambda p, t: shard_leaf(t, layout.get(p), mesh, axis), tree)


# ---------------------------------------------------------------------------
# A batch-1 decode over the idle axes (the reference's --opt-idle-batch)
# ---------------------------------------------------------------------------

CACHE_SEQ = ("k", "v", "c_kv", "k_rope")
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def cache_seq_dim(path: str, ndim: int) -> Optional[int]:
    """The sequence dim of a cache leaf of ``ndim`` dims by its name (the
    K/V's third from the end, MLA's latents' second), None for a leaf
    without one."""
    name = path.rsplit("/", 1)[-1]
    return ndim - 3 if name in ("k", "v") else ndim - 2 if name in CACHE_SEQ else None


def idle_entry(mesh, model_axis: str = "model"):
    """The placement entry of the idle axes: the one non-model axis, or the
    tuple of them."""
    axes = tuple(a for a in mesh.axis_names if a != model_axis)
    return axes if len(axes) > 1 else axes[0]


def optimize_idle_batch_specs(cache_specs: Dict[str, Spec], param_specs: Dict[str, Spec],
                              mesh) -> Tuple[Dict[str, Spec], Dict[str, Spec]]:
    """The twin of the reference's ``_optimize_idle_batch_specs`` over flat
    path-keyed placements: a batch-1 decode carries no batch over the
    non-model axes, so they take (a) the sequence of the KV caches (``k``,
    ``v``: the third dim from the end; ``c_kv``, ``k_rope``: the second),
    (b) the heads of the SSM state (the third from the end), (c) the first
    of the last three dims of the FFN leaves ``w_up`` / ``w_gate`` /
    ``w_down`` under ``ffn`` of three dims or more (the experts of an
    expert-stacked leaf); the conv window keeps its channels on ``model``.
    A key-based rewrite by the last path component, as the reference's;
    :func:`sanitize_specs` downstream drops what does not divide."""
    entry = idle_entry(mesh)

    def cache(path: str, spec: Spec) -> Spec:
        name, n = path.rsplit("/", 1)[-1], len(spec)
        new = list(spec)
        seq = cache_seq_dim(path, n)
        if seq is not None and 0 <= seq < n:
            new[seq] = entry
            return tuple(new)
        if name == "ssm" and n >= 3:
            new[n - 3] = entry
            return tuple(new)
        if name == "conv" and n >= 1:
            new[n - 1] = "model"  # the reference's ("model",), as its PartitionSpec holds it
            return tuple(new)
        return spec

    def param(path: str, spec: Spec) -> Spec:
        keys = path.split("/")
        if len(spec) >= 3 and keys[-1] in EXPERT_LEAVES and "ffn" in keys:
            new = list(spec)
            new[len(spec) - 3] = entry
            return tuple(new)
        return spec

    return ({k: cache(k, v) for k, v in cache_specs.items()},
            {k: param(k, v) for k, v in param_specs.items()})

