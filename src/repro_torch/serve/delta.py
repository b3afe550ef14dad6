"""Personalized fleets as shared base weights + compact per-agent deltas
(the twin of ``repro.serve.delta``).

A fleet of *n* personalized parameter sets is stored as one shared **base**
tree plus one compact **delta** per agent and leaf:

* ``dense`` — raw per-agent values (lossless, the trivial reference);
* ``topk`` — the ``k = ceil(f·d)`` coordinates where the agent deviates most
  from the base, in **set-form** ``(idx, val)``: materialisation overwrites
  ``base[idx] = val`` with the raw values, so reconstruction is bit-exact
  whenever the index set covers every differing coordinate.  With ``q8`` the
  payload is the int8-quantised difference plus one float32 scale per
  (leaf, agent) row, added back;
* ``lowrank`` — a rank-``r`` SVD of each agent's residual for leaves of two
  or more dimensions, factored as ``(shape[0], rest)`` as the reference does
  (so a layer-stacked LM leaf has rank at most its number of periods);
  1-D leaves stay ``dense``.  Approximate; the SVD is ``torch.linalg.svd``
  in float32 where the stack lies (LAPACK on the CPU, cuSOLVER on the
  card), where the reference runs numpy's: the factors are not unique, and
  their products agree with the reference's within float32 rounding.

The exporters close the train → checkpoint → serve loop:
:meth:`FleetDelta.from_history` reads a finished run's
``History.agent_params()``, :meth:`FleetDelta.from_checkpoint` a
:mod:`repro_torch.checkpoint` file (an algorithm-state tuple, ``{"x": ...}``
or a bare stacked tree, written by either package), and
:func:`export_fleet` writes a run's agent-stacked parameters as such a file.

:meth:`FleetDelta.gather` builds the slot-stacked parameters of a few agents
(what the step-mode engine does every step); :meth:`FleetDelta.gather_into`
writes one agent's parameters into one slot of a preallocated buffer, leaf
by leaf, so admitting a request never holds a second dense copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.pytree import nest_leaves, nest_map

Tree = Any

_QMAX = 127.0  # int8 symmetric grid


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Declarative delta format: ``"dense" | "topk[:f=..][,q8]" | "lowrank[:r=..]"``."""

    kind: str = "topk"
    fraction: float = 0.05  # topk: kept fraction of each leaf
    rank: int = 4  # lowrank: SVD rank per leaf of ndim >= 2
    quantize: bool = False  # topk: int8-quantise the residual payload

    def __post_init__(self):
        if self.kind not in ("dense", "topk", "lowrank"):
            raise ValueError(f"unknown delta kind {self.kind!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.quantize and self.kind != "topk":
            raise ValueError("q8 only applies to kind='topk'")

    @classmethod
    def parse(cls, spec: str) -> "DeltaSpec":
        """``"topk:f=0.05,q8"`` / ``"lowrank:r=8"`` / ``"dense"``."""
        name, _, tail = spec.partition(":")
        kw: dict = {"kind": name}
        if tail:
            for item in tail.split(","):
                item = item.strip()
                if item == "q8":
                    kw["quantize"] = True
                    continue
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(f"bad delta spec item {item!r} in {spec!r}")
                if k == "f":
                    kw["fraction"] = float(v)
                elif k == "r":
                    kw["rank"] = int(v)
                else:
                    raise ValueError(f"unknown delta spec key {k!r} in {spec!r}")
        return cls(**kw)

    @property
    def name(self) -> str:
        if self.kind == "topk":
            return f"topk:f={self.fraction:g}" + (",q8" if self.quantize else "")
        if self.kind == "lowrank":
            return f"lowrank:r={self.rank}"
        return "dense"


class DenseDelta(NamedTuple):
    val: torch.Tensor  # (n,) + leaf.shape raw values


def _index_dtype(d: int):
    """int32 flat coordinates, the reference's; int64 for a leaf of 2^31 or
    more elements (a stacked expert leaf at full width), where int32 would
    wrap (the reference's would too)."""
    return np.int32 if d <= np.iinfo(np.int32).max else np.int64


class TopKDelta(NamedTuple):
    idx: torch.Tensor  # (n, k) int32 flat coordinates (int64 past 2^31 - 1)
    val: torch.Tensor  # (n, k) float32 raw parameter values (set-form)


class QTopKDelta(NamedTuple):
    idx: torch.Tensor  # (n, k) int32 flat coordinates
    q: torch.Tensor  # (n, k) int8 quantised residual
    scale: torch.Tensor  # (n, 1) float32 per-row scale


class LowRankDelta(NamedTuple):
    u: torch.Tensor  # (n, d1, r) float32, the singular values folded in
    v: torch.Tensor  # (n, r, d2) float32


def _f32_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _encode_leaf(stacked: torch.Tensor, base: torch.Tensor, spec: DeltaSpec):
    """One agent-stacked leaf (n, *shape) -> a delta payload: top-k chosen
    on the host with numpy exactly as the reference does, the low-rank SVD
    taken with torch where the leaf lies."""
    n = stacked.shape[0]
    if spec.kind == "dense" or (spec.kind == "lowrank" and base.dim() < 2):
        return DenseDelta(val=stacked.clone())
    rows = stacked.reshape(n, -1)
    d = rows.shape[1]
    if spec.kind == "lowrank":
        # the residual factored as (shape[0], rest), one SVD per agent
        d1 = base.shape[0]
        diff = rows.to(torch.float32) - base.reshape(1, -1).to(torch.float32)
        u, sv, vt = torch.linalg.svd(diff.reshape(n, d1, d // d1), full_matrices=False)
        r = min(spec.rank, sv.shape[-1])
        return LowRankDelta(u=(u[..., :r] * sv[:, None, :r]).contiguous(),
                            v=vt[:, :r].contiguous())
    diff = _f32_numpy(rows) - _f32_numpy(base).reshape(1, -1)
    dev = stacked.device
    k = min(d, max(1, int(math.ceil(spec.fraction * d))))
    if k == d:  # every coordinate: the sorted selection is 0..d-1
        idx = np.tile(np.arange(d, dtype=_index_dtype(d)), (n, 1))
    else:
        part = np.argpartition(np.abs(diff), d - k, axis=1)[:, d - k:]
        idx = np.sort(part, axis=1).astype(_index_dtype(d))
    if spec.quantize:
        dsel = np.take_along_axis(diff, idx, axis=1)
        scale = np.maximum(np.max(np.abs(dsel), axis=1, keepdims=True), 1e-12)
        scale = (scale / _QMAX).astype(np.float32)
        q = np.clip(np.round(dsel / scale), -_QMAX, _QMAX).astype(np.int8)
        return QTopKDelta(idx=torch.from_numpy(idx).to(dev), q=torch.from_numpy(q).to(dev),
                          scale=torch.from_numpy(scale).to(dev))
    idx_t = torch.from_numpy(idx).to(dev)
    val = torch.take_along_dim(rows, idx_t.long(), dim=1)  # raw values: set-form
    return TopKDelta(idx=idx_t, val=val)


def _apply(rows: torch.Tensor, delta, ids: torch.Tensor) -> torch.Tensor:
    """Write the deltas of agents ``ids`` (S,) into ``rows`` (S, d), base
    values already in place."""
    slot = torch.arange(ids.shape[0], device=rows.device)[:, None]
    if isinstance(delta, TopKDelta):
        rows[slot, delta.idx[ids].long()] = delta.val[ids].to(rows.dtype)
    elif isinstance(delta, QTopKDelta):
        at = (slot, delta.idx[ids].long())
        corr = delta.q[ids].to(torch.float32) * delta.scale[ids]
        rows[at] = rows[at] + corr.to(rows.dtype)
    elif isinstance(delta, LowRankDelta):
        corr = torch.bmm(delta.u[ids], delta.v[ids])
        rows += corr.reshape(rows.shape).to(rows.dtype)
    else:
        raise TypeError(f"not a delta payload: {type(delta)}")
    return rows


def _gather_leaf(base: torch.Tensor, delta, ids: torch.Tensor) -> torch.Tensor:
    """Slot-stacked leaf (S, *shape) for the agents ``ids``."""
    if isinstance(delta, DenseDelta):
        return delta.val[ids]
    s = ids.shape[0]
    rows = base.reshape(1, -1).expand(s, -1).clone()
    return _apply(rows, delta, ids).reshape((s,) + tuple(base.shape))


def _tree_nbytes(tree: Tree) -> int:
    return sum(t.numel() * t.element_size() for t in nest_leaves(tree))


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device).reshape(-1)


@dataclasses.dataclass(frozen=True)
class FleetDelta:
    """A servable fleet: shared ``base`` + per-agent compact ``deltas``
    (``deltas`` mirrors ``base`` with a payload at every leaf position)."""

    base: Tree
    deltas: Tree
    spec: DeltaSpec
    n_agents: int

    @property
    def device(self) -> torch.device:
        return nest_leaves(self.base)[0].device

    @classmethod
    def from_stacked(cls, stacked: Tree, spec: DeltaSpec,
                     base: Optional[Tree] = None) -> "FleetDelta":
        """Encode an agent-stacked tree (leading axis = agents).  ``base``
        defaults to the agent mean, taken in float64 as the reference does."""
        n = nest_leaves(stacked)[0].shape[0]
        if base is None:
            base = nest_map(
                lambda l: torch.from_numpy(_f32_numpy(l).astype(np.float64).mean(axis=0))
                .to(device=l.device, dtype=l.dtype), stacked)
        deltas = nest_map(lambda b, l: _encode_leaf(l, b, spec), base, stacked)
        return cls(base=base, deltas=deltas, spec=spec, n_agents=int(n))

    @classmethod
    def from_history(cls, hist, spec: DeltaSpec, base: Optional[Tree] = None) -> "FleetDelta":
        """The servable fleet of a finished run (its ``agent_params()``)."""
        return cls.from_stacked(hist.agent_params(), spec, base=base)

    @classmethod
    def from_checkpoint(cls, path: str, spec: DeltaSpec, base: Optional[Tree] = None,
                        device: DeviceLike = None) -> "FleetDelta":
        """The fleet of a :mod:`repro_torch.checkpoint` file, written by
        either package: an algorithm-state tuple (x first), a ``{"x": ...}``
        dict or a bare agent-stacked tree.  Only the stack's arrays are read,
        onto ``device`` (the GPU when None), where it is encoded."""
        from repro_torch.checkpoint import read_manifest, restore_checkpoint

        dev = resolve_device(device)
        _, stacked = restore_checkpoint(
            path, device=dev, subtree=_stacked_path(read_manifest(path)["structure"]))
        return cls.from_stacked(stacked, spec, base=base)

    @classmethod
    def synthetic(cls, base: Tree, n_agents: int, *, fraction: float = 0.02,
                  scale: float = 0.05, seed: int = 0) -> "FleetDelta":
        """A stand-in personalised fleet (no training): each agent perturbs a
        random ``fraction`` of each leaf's coordinates.  Indices and noise are
        drawn with numpy exactly as the reference draws them, so the fleet is
        bit-equal to the reference's for the same base; the base values at
        the drawn indices are gathered on the device (never through a host
        copy of the base).  Lossless by construction."""
        rng = np.random.default_rng([seed, 0x5EED])

        def one(leaf: torch.Tensor) -> TopKDelta:
            d = leaf.numel()
            k = min(d, max(1, int(math.ceil(fraction * d))))
            idx = np.stack(
                [np.sort(rng.choice(d, size=k, replace=False)) for _ in range(n_agents)]
            ).astype(_index_dtype(d))
            noise = rng.normal(scale=scale, size=(n_agents, k)).astype(np.float32)
            idx_t = torch.from_numpy(idx).to(leaf.device)
            val = leaf.reshape(-1)[idx_t.long()].to(torch.float32) + torch.from_numpy(
                noise).to(leaf.device)
            return TopKDelta(idx=idx_t, val=val)

        deltas = nest_map(one, base)
        return cls(base=base, deltas=deltas, spec=DeltaSpec(kind="topk", fraction=fraction),
                   n_agents=n_agents)

    def gather(self, ids) -> Tree:
        """Slot-stacked parameters (S, ...) of the agents ``ids`` (S,)."""
        ids_t = _ids(ids, self.device)
        return nest_map(lambda b, dl: _gather_leaf(b, dl, ids_t), self.base, self.deltas)

    def gather_into(self, buf: Tree, slot: int, agent: int) -> None:
        """Write agent ``agent``'s parameters into ``buf[...][slot]`` in place,
        one leaf at a time."""
        ids_t = _ids([agent], self.device)

        def write(b, dl, out):
            row = out[slot]
            if isinstance(dl, DenseDelta):
                row.copy_(dl.val[agent])
                return
            row.copy_(b)
            _apply(row.view(1, -1), dl, ids_t)

        nest_map(write, self.base, self.deltas, buf)

    def nbytes(self) -> int:
        """Fleet-weights footprint: base + all per-agent delta payloads."""
        return _tree_nbytes(self.base) + _tree_nbytes(self.deltas)

    def naive_nbytes(self) -> int:
        """What n dense per-agent copies would cost."""
        return self.n_agents * _tree_nbytes(self.base)


@dataclasses.dataclass(frozen=True)
class DenseFleet:
    """The naive baseline: n dense parameter copies, gathered by row."""

    stacked: Tree
    n_agents: int

    @property
    def device(self) -> torch.device:
        return nest_leaves(self.stacked)[0].device

    @classmethod
    def from_stacked(cls, stacked: Tree) -> "DenseFleet":
        return cls(stacked=stacked, n_agents=int(nest_leaves(stacked)[0].shape[0]))

    def gather(self, ids) -> Tree:
        ids_t = _ids(ids, self.device)
        return nest_map(lambda l: l[ids_t], self.stacked)

    def gather_into(self, buf: Tree, slot: int, agent: int) -> None:
        nest_map(lambda l, out: out[slot].copy_(l[agent]), self.stacked, buf)

    def nbytes(self) -> int:
        return _tree_nbytes(self.stacked)

    def naive_nbytes(self) -> int:
        return self.nbytes()


def materialize(base: Tree, deltas: Tree, agents: Optional[Sequence[int]] = None) -> Tree:
    """Dense parameters from ``(base, deltas)``: every agent (leading axis =
    fleet) or the given ids.  Bit-exact for lossless deltas."""
    n = nest_leaves(deltas)[0].shape[0]
    ids = np.arange(n) if agents is None else np.asarray(agents)
    fleet = FleetDelta(base=base, deltas=deltas, spec=DeltaSpec(), n_agents=n)
    return fleet.gather(ids)


def materialize_fleet(fleet: FleetDelta) -> DenseFleet:
    """The dense-materialised baseline of the same personalised fleet."""
    return DenseFleet.from_stacked(materialize(fleet.base, fleet.deltas))


def _stacked_path(structure: dict) -> tuple:
    """Where the agent-stacked parameters sit in a checkpoint's structure
    descriptor (the reference's ``_stacked_of`` over the restored tree):
    a dict's ``"x"``, a sequence's first item (an algorithm state: x is its
    first field), or the whole tree."""
    if structure["kind"] == "dict":
        return ("x",) if "x" in structure["items"] else ()
    if structure["kind"] != "leaf" and structure["items"]:
        return (0,)
    return ()


def export_fleet(directory: str, hist, step: int = 0) -> str:
    """Write a finished run's agent-stacked parameters as a fleet checkpoint
    (``{"x": stacked}`` with a ``kind: fleet`` manifest tag), which
    :meth:`FleetDelta.from_checkpoint` reads in either package."""
    from repro_torch.checkpoint import save_checkpoint

    return save_checkpoint(directory, step, {"x": hist.agent_params()},
                           metadata={"kind": "fleet"})
