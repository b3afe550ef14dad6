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
  (leaf, agent) row, added back.

``lowrank`` deltas and the checkpoint exporters (``from_history``,
``from_checkpoint``, ``export_fleet``) wait for ROADMAP A15.

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

from repro_torch.utils.pytree import nest_leaves, nest_map

Tree = Any

_QMAX = 127.0  # int8 symmetric grid


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Declarative delta format: ``"dense" | "topk[:f=..][,q8]"``."""

    kind: str = "topk"
    fraction: float = 0.05  # topk: kept fraction of each leaf
    quantize: bool = False  # topk: int8-quantise the residual payload

    def __post_init__(self):
        if self.kind == "lowrank":
            raise NotImplementedError("low-rank deltas are not ported yet (ROADMAP A15)")
        if self.kind not in ("dense", "topk"):
            raise ValueError(f"unknown delta kind {self.kind!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.quantize and self.kind != "topk":
            raise ValueError("q8 only applies to kind='topk'")

    @classmethod
    def parse(cls, spec: str) -> "DeltaSpec":
        """``"topk:f=0.05,q8"`` / ``"dense"``."""
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
                elif k == "r" and name == "lowrank":
                    raise NotImplementedError("low-rank deltas are not ported yet (ROADMAP A15)")
                else:
                    raise ValueError(f"unknown delta spec key {k!r} in {spec!r}")
        return cls(**kw)

    @property
    def name(self) -> str:
        if self.kind == "topk":
            return f"topk:f={self.fraction:g}" + (",q8" if self.quantize else "")
        return "dense"


class DenseDelta(NamedTuple):
    val: torch.Tensor  # (n,) + leaf.shape raw values


class TopKDelta(NamedTuple):
    idx: torch.Tensor  # (n, k) int32 flat coordinates
    val: torch.Tensor  # (n, k) float32 raw parameter values (set-form)


class QTopKDelta(NamedTuple):
    idx: torch.Tensor  # (n, k) int32 flat coordinates
    q: torch.Tensor  # (n, k) int8 quantised residual
    scale: torch.Tensor  # (n, 1) float32 per-row scale


def _f32_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _encode_leaf(stacked: torch.Tensor, base: torch.Tensor, spec: DeltaSpec):
    """One agent-stacked leaf (n, *shape) -> a delta payload, chosen on the
    host with numpy exactly as the reference does."""
    n = stacked.shape[0]
    if spec.kind == "dense":
        return DenseDelta(val=stacked.clone())
    rows = stacked.reshape(n, -1)
    d = rows.shape[1]
    k = min(d, max(1, int(math.ceil(spec.fraction * d))))
    diff = _f32_numpy(rows) - _f32_numpy(base).reshape(1, -1)
    part = np.argpartition(np.abs(diff), d - k, axis=1)[:, d - k:]
    idx = np.sort(part, axis=1).astype(np.int32)
    dev = stacked.device
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
            ).astype(np.int32)
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
