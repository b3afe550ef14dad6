"""Rank meshes over ``torch.distributed`` (the twin of ``repro.launch.mesh``).

The reference lays a mesh with named axes over its devices and runs one
PISCO agent per position of the agent axes.  Here the same named axes lie
over the ranks of the default process group in row-major order: rank ``r``
sits at ``np.unravel_index(r, shape)``, and every axis gets one sub-group per
setting of the other coordinates (the ranks that differ on that axis alone).
The collectives the mixers need — a neighbour shift along one axis (the
reference's ``ppermute``), a sum and a gather over a set of axes (``psum``,
``all_gather``) — and pod-as-agent's reduce-scatter of a gradient over the
intra-pod data axis are methods of the mesh.

Transport.  NCCL moves CUDA tensors between cards directly.  Gloo moves host
tensors only; it runs the CPU tests, and it is the only choice when several
ranks share one card (NCCL refuses two ranks on one device).  A mesh whose
group runs gloo over CUDA tensors therefore stages every exchange through
pinned host buffers: the model, the state and the kernels stay on the card,
only the bytes in flight pass through the host.  The choice is read once
from ``dist.get_backend()`` when the mesh is built.

The agent axes, the "data" axis inside a pod-as-agent agent, the "model"
axis (tensor parallelism inside an agent) and the idle axes of a batch-1
decode (:class:`IdleAxis`: every axis but "model", which then splits the
one sequence's cache and the experts) are ported.  Over the
model axis an agent's ranks each hold their shard of every leaf the
placements split and run the forward and backward on their share of the
heads and widths; the collectives that GSPMD inserts for the reference are
written out as autograd functions over the model sub-group (:func:`enter`,
:func:`exit_sum`, :func:`gather_last`), which the models reach through a
:class:`ModelAxis` handle (None: the whole model on one rank).  Under
pod-as-agent the models reach the data axis through a :class:`DataAxis`
handle, which gathers a period's shards where the period starts and
reduce-scatters its gradient when the period's backward ends.
:func:`make_production_mesh` is the port's layout of the reference's 256-
and 512-chip meshes for the dry run, (data 16, model 16) and (pod 2, data
16, model 16), with no process group behind it; its collectives move no data
and count the bytes they would move.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.pytree import nest_map_with_path


@dataclasses.dataclass
class MeshClock:
    """Wall-clock seconds by phase ("exchange" is filled by the mesh's
    collectives, the round adds its own phases through :meth:`span`).
    Inactive unless ``on``; when on, every span synchronises the device at
    both ends, so a phase is charged only its own device work."""

    on: bool = False
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_sent: int = 0

    @contextlib.contextmanager
    def span(self, name: str, device: torch.device):
        if not self.on:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def reset(self) -> None:
        self.seconds.clear()
        self.bytes_sent = 0


@dataclasses.dataclass
class RankMesh:
    """This rank's place in a mesh of named axes over the process group."""

    shape: Dict[str, int]  # axis name -> size, in mesh order
    rank: int
    device: torch.device
    stage_on_host: bool  # gloo over CUDA tensors: exchanges go through pinned host memory
    clock: MeshClock = dataclasses.field(default_factory=MeshClock)
    _groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.shape, idx)}

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major position over ``axes`` (its agent index
        when ``axes`` are the agent axes)."""
        c = self.coords
        return int(np.ravel_multi_index([c[a] for a in axes], [self.shape[a] for a in axes]))

    def group(self, axes: Sequence[str]):
        """``(group, ranks)``: the sub-group of the ranks that share this
        rank's coordinates outside ``axes``, and their global ranks in
        row-major order over ``axes``.  Built on first use; every rank asks
        for the same groups in the same order, as ``new_group`` requires."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes not in self._groups:
            sizes = tuple(self.shape.values())
            all_ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
            moved = np.moveaxis(all_ranks, [self.axis_names.index(a) for a in axes],
                                range(len(axes)))
            classes = moved.reshape(self.size(axes), -1).T  # one row per sub-group
            mine = None
            for ranks in classes:
                g = dist.new_group([int(r) for r in ranks])
                if self.rank in ranks:
                    mine = (g, [int(r) for r in ranks])
            self._groups[axes] = mine
        return self._groups[axes]

    # -- collectives -------------------------------------------------------

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if not self.stage_on_host:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _empty_wire(self, like: torch.Tensor) -> torch.Tensor:
        if not self.stage_on_host:
            return torch.empty_like(like, memory_format=torch.contiguous_format)
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.stage_on_host else t

    def _neighbour(self, axis: str, s: int) -> int:
        """Global rank ``s`` steps ahead of this one along ``axis``."""
        c = self.coords
        c[axis] = (c[axis] + s) % self.shape[axis]
        return int(np.ravel_multi_index([c[a] for a in self.shape], tuple(self.shape.values())))

    def shift(self, x: torch.Tensor, moves: Sequence[Tuple[str, int]]) -> List[torch.Tensor]:
        """For each ``(axis, shift)``: the block of the rank ``shift`` steps
        behind along ``axis`` — what the reference's ``ppermute`` with
        ``perm = [(s, (s + shift) % size)]`` delivers.  All moves go out in
        one batch of sends and receives (none for no moves: a single agent's
        identity gossip)."""
        if not moves:
            return []
        with self.clock.span("exchange", self.device):
            send = self._to_wire(x)
            ops, recvs = [], []
            for axis, s in moves:
                recv = self._empty_wire(x)
                recvs.append(recv)
                # one batch takes one group: the default one, peers by global rank
                ops.append(dist.P2POp(dist.isend, send, self._neighbour(axis, s)))
                ops.append(dist.P2POp(dist.irecv, recv, self._neighbour(axis, -s)))
                self.clock.bytes_sent += send.numel() * send.element_size()
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return [self._from_wire(r) for r in recvs]

    def all_reduce_sum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
        with self.clock.span("exchange", self.device):
            buf = self._to_wire(x)
            if buf is x:
                buf = x.clone()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group(axes)[0])
            self.clock.bytes_sent += buf.numel() * buf.element_size()
            return self._from_wire(buf)

    def all_reduce_max(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks of ``axes`` (a new
        tensor)."""
        with self.clock.span("exchange", self.device):
            buf = self._to_wire(x)
            if buf is x:
                buf = x.clone()
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group(axes)[0])
            self.clock.bytes_sent += buf.numel() * buf.element_size()
            return self._from_wire(buf)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   host: bool = False) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` over ``axes``, in row-major
        order of their coordinates.  ``host``: the result on the host, where
        gloo's staged exchange left it (one copy from the device otherwise)."""
        with self.clock.span("exchange", self.device):
            group, ranks = self.group(axes)
            send = self._to_wire(x)
            parts = [self._empty_wire(x) for _ in ranks]
            dist.all_gather(parts, send, group=group)
            self.clock.bytes_sent += send.numel() * send.element_size()
            out = torch.stack(parts)
            return out.cpu() if host else self._from_wire(out)

    def reduce_scatter_sum(self, x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """This rank's block of the sum of ``x`` over the ranks of ``axes``:
        the sum split into n equal blocks along ``dim``, block i to the rank
        at position i (row-major over ``axes``)."""
        with self.clock.span("exchange", self.device):
            group, ranks = self.group(axes)
            n = len(ranks)
            if x.shape[dim] % n:
                raise ValueError(f"reduce_scatter_sum: dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {n} ranks")
            self.clock.bytes_sent += x.numel() * x.element_size()
            parts = [self._to_wire(c) for c in x.chunk(n, dim)]
            out = self._empty_wire(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            return self._from_wire(out)


def make_mesh(shape: Tuple[int, ...], axes: Sequence[str], device: DeviceLike = None) -> RankMesh:
    """The mesh of named ``axes`` with ``shape`` over the default process
    group (initialised by the caller; its world size must be the mesh's),
    for tensors on ``device`` (CUDA when none is given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group with this mesh's world size)")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {tuple(axes)} differ in length")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {int(np.prod(shape))} ranks, "
                         f"the group has {world}")
    dev = resolve_device(device)
    return RankMesh(shape=dict(zip(axes, (int(s) for s in shape))), rank=dist.get_rank(),
                    device=dev, stage_on_host=dist.get_backend() == "gloo" and dev.type == "cuda")


def make_debug_mesh(shape: Tuple[int, ...] = (1, 1), axes=("data", "model"),
                    device: DeviceLike = None) -> RankMesh:
    """A (data, model) mesh over the process group (1 x 1 by default)."""
    return make_mesh(shape, axes, device)


def agent_axes_for(mesh, mode: str = "flat") -> Tuple[str, ...]:
    """Which mesh axes form the PISCO agent axis.

    flat:          all non-model axes
    hierarchical:  the 'pod' axis only
    """
    names = list(mesh.axis_names)
    if mode == "hierarchical":
        if "pod" not in names:
            raise ValueError("hierarchical mode needs a pod axis")
        return ("pod",)
    return tuple(n for n in names if n != "model")


def n_agents_for(mesh, mode: str = "flat") -> int:
    n = 1
    for a in agent_axes_for(mesh, mode):
        n *= mesh.shape[a]
    return n


def rank_slice(tree: Dict, mesh: RankMesh, agent_axes: Sequence[str], axis: int = 0,
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """This rank's agent of an agent-stacked dict of arrays or tensors (the
    agent axis at ``axis``), as tensors on ``device`` (the mesh's by
    default)."""
    a = mesh.index(agent_axes)
    dev = mesh.device if device is None else device

    def take(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        return t.select(axis, a).contiguous().to(dev)

    return {k: take(v) for k, v in tree.items()}


COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclasses.dataclass
class CountingMesh:
    """A mesh of named axes with no process group (the dry run's): rank 0's
    view, on ``device`` (meta: nothing is allocated).  Its collectives
    return tensors of the shapes the real ones would and count each
    result's bytes per kind under the reference's HLO names
    (``collective-permute`` a shift, ``all-reduce`` a sum, ``all-gather`` a
    gather, ``reduce-scatter`` a reduce-scatter), as
    :meth:`collective_counts` reports them."""

    shape: Dict[str, int]
    device: torch.device
    rank: int = 0
    clock: MeshClock = dataclasses.field(default_factory=MeshClock)
    bytes_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    calls_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    model_bytes: int = 0  # of the bytes above, those over the model axis alone
    idle_bytes: int = 0  # of the bytes above, those of an IdleAxis's collectives

    axis_names = RankMesh.axis_names
    coords = RankMesh.coords
    size = RankMesh.size
    index = RankMesh.index

    def _count(self, kind: str, out: torch.Tensor, axes: Sequence[str] = ()) -> torch.Tensor:
        n = out.numel() * out.element_size()
        self.bytes_by_kind[kind] += n
        self.calls_by_kind[kind] += 1
        if tuple(axes) == ("model",):
            self.model_bytes += n
        return out

    def shift(self, x: torch.Tensor, moves: Sequence[Tuple[str, int]]) -> List[torch.Tensor]:
        return [self._count("collective-permute", torch.empty_like(x)) for _ in moves]

    def all_reduce_sum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        return self._count("all-reduce", torch.empty_like(x), axes)

    def all_reduce_max(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        return self._count("all-reduce", torch.empty_like(x), axes)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   host: bool = False) -> torch.Tensor:
        return self._count("all-gather", x.new_empty((self.size(axes),) + tuple(x.shape)), axes)

    def reduce_scatter_sum(self, x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        return self._count("reduce-scatter", x.chunk(self.size(axes), dim)[0].clone(), axes)

    def reset_counts(self) -> None:
        for k in COLLECTIVE_KINDS:
            self.bytes_by_kind[k] = self.calls_by_kind[k] = 0
        self.model_bytes = self.idle_bytes = 0

    def collective_counts(self) -> Dict[str, int]:
        """The reference's ``collective_bytes`` record: bytes and calls per
        kind, the ``wire_*`` figures (equal here: no host upcast to
        correct), ``raw_total`` and ``total``; ``model_axis``, the bytes
        of those collectives that ran over the model axis alone (tensor
        parallelism's all-reduces and all-gathers); and ``idle_axis``, those
        of a batch-1 decode's idle axes (:class:`IdleAxis`)."""
        out: Dict[str, int] = dict(self.bytes_by_kind)
        out.update({f"wire_{k}": v for k, v in self.bytes_by_kind.items()})
        out.update({f"n_{k}": v for k, v in self.calls_by_kind.items()})
        out["raw_total"] = out["total"] = sum(self.bytes_by_kind.values())
        out["model_axis"] = self.model_bytes
        out["idle_axis"] = self.idle_bytes
        return out


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "meta") -> CountingMesh:
    """The reference's production meshes: 16 agents on a ``data`` axis
    (single, 256 cards) or 2 x 16 on ``pod`` x ``data`` (multi, 512 cards),
    each agent over a ``model`` axis of 16 cards; under pod-as-agent the
    multi mesh's 2 agents spread over 16 x 16 cards each."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return CountingMesh(shape=dict(zip(axes, shape)), device=torch.device(device))


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------


def _model_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the model ranks' partial ``x``: in float32 for a 16-bit
    ``x``, rounded once to its dtype, as one device's product accumulates
    the whole contraction before it rounds."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return mesh.all_reduce_sum(x.to(torch.float32), (axis,)).to(x.dtype)
    return mesh.all_reduce_sum(x, (axis,))


class _Enter(torch.autograd.Function):
    """Identity forward, sum over the model ranks backward: where a
    replicated tensor enters a region each rank computes a share of."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.mesh, ctx.axis), None, None


class _Exit(torch.autograd.Function):
    """Sum over the model ranks forward, identity backward: the ranks'
    partial results leave the region replicated."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _model_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """The ranks' last dims concatenated forward (row-major over the model
    ranks), this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        n = mesh.shape[axis]
        ctx.n, ctx.i = n, mesh.coords[axis]
        parts = mesh.all_gather(x, (axis,))  # (n, ..., d)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.i].contiguous(), None, None


def enter(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _Enter.apply(x, mesh, axis)


def exit_sum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _Exit.apply(x, mesh, axis)


def gather_last(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _Gather.apply(x, mesh, axis)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The models' handle on an agent's model axis: the mesh and the axis
    name.  The models take None for the whole model on one rank; a leaf
    whose dim the placements leave whole is computed whole on every rank."""

    mesh: object
    axis: str = "model"

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        return self.mesh.coords[self.axis]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return enter(x, self.mesh, self.axis)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return exit_sum(x, self.mesh, self.axis)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_last(x, self.mesh, self.axis)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the model ranks (no gradient)."""
        return self.mesh.all_reduce_max(x.detach(), (self.axis,))


def model_axis(mesh, axis: str = "model") -> Optional[ModelAxis]:
    """The handle of ``mesh``'s model axis, None when it has none or it is
    of size 1."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None
    return ModelAxis(mesh, axis)


# ---------------------------------------------------------------------------
# Pod-as-agent's data axis: a period's parameters gathered where they are used
# ---------------------------------------------------------------------------


class _DataGather(torch.autograd.Function):
    """The data ranks' shards gathered along each one's data dim forward,
    the gradients reduce-scattered back to this rank's shards (summed in
    their own dtype) backward.  The shards of one dtype travel as one flat
    buffer: one all-gather and one reduce-scatter per dtype a call.  The
    forward is charged to the mesh clock's "gather", the backward to its
    "scatter"; nothing is saved for the backward but shapes."""

    @staticmethod
    def forward(ctx, handle, dims, *shards):
        mesh, n = handle.mesh, handle.size
        ctx.handle, ctx.dims = handle, dims
        ctx.shapes = [s.shape for s in shards]
        outs: List[Optional[torch.Tensor]] = [None] * len(shards)
        with mesh.clock.span("gather", mesh.device):
            for idx in _by_dtype(shards):
                parts = handle.collective("all-gather", torch.cat(
                    [shards[i].reshape(-1) for i in idx]))  # (n, total)
                off = 0
                for i in idx:
                    s, d = shards[i].shape, dims[i]
                    blk = parts[:, off:off + s.numel()].reshape((n,) + tuple(s))
                    outs[i] = blk.movedim(0, d).reshape(s[:d] + (n * s[d],) + s[d + 1:])
                    off += s.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        handle, n = ctx.handle, ctx.handle.size
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        with handle.mesh.clock.span("scatter", handle.mesh.device):
            for idx in _by_dtype(grads):
                rows = []
                for i in idx:
                    s, d = ctx.shapes[i], ctx.dims[i]
                    g = grads[i].reshape(s[:d] + (n, s[d]) + s[d + 1:])
                    rows.append(g.movedim(d, 0).reshape(n, -1))
                red = handle.collective("reduce-scatter", torch.cat(rows, 1))[0]
                for i, blk in zip(idx, red.split([ctx.shapes[i].numel() for i in idx])):
                    out[i] = blk.view(ctx.shapes[i])
        return (None, None, *out)


class _DataSum(torch.autograd.Function):
    """The sum of the data ranks' ``x`` forward and backward (a statistic
    of the agent's batch that every rank's loss reads: the gradient of the
    summed statistic is the sum of the ranks'), charged to "scatter"."""

    @staticmethod
    def forward(ctx, handle, x):
        ctx.handle = handle
        with handle.mesh.clock.span("scatter", handle.mesh.device):
            return handle.collective("all-reduce", x)

    @staticmethod
    def backward(ctx, g):
        handle = ctx.handle
        with handle.mesh.clock.span("scatter", handle.mesh.device):
            return None, handle.collective("all-reduce", g)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The positions of ``tensors`` grouped by dtype, in first-seen order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


@dataclasses.dataclass(frozen=True, eq=False)
class DataAxis:
    """The models' handle on pod-as-agent's data axis: the mesh and, per
    parameter path, the dim of the agent's leaf (its model shard under a
    model axis) that the data ranks split, None where every data rank holds
    it whole (:func:`repro_torch.launch.steps.fsdp_placement`'s ``dims``).
    A model given one runs on this rank's data shards and its share of the
    agent's batch.  It gathers each period's parameters at the top of the
    period (:meth:`gather`), inside the period's remat region; the gradient
    of a gathered leaf is reduce-scattered as soon as the period's backward
    ends.  Leaves held whole pass through: their gradients stay this rank's
    partial sums.  An MoE layer sizes and fills expert capacity over the
    agent's whole batch from the data ranks' expert counts
    (:meth:`gather_counts`), and its load-balance loss reads the router
    probabilities summed over them (:meth:`sum`).  ``split_batch``: each
    data rank holds its contiguous block of the agent's rows, rank r the
    r-th (:func:`repro_torch.launch.steps.batch_share`); False where the
    batch does not divide and every rank holds it whole.  ``stats`` counts
    the collectives over ``data`` by kind (shared by :meth:`gathered`'s
    copies)."""

    mesh: object
    dims: Dict[str, Optional[int]]
    split_batch: bool = True
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(("all-gather", "reduce-scatter", "all-reduce"), 0))

    @property
    def size(self) -> int:
        return self.mesh.shape["data"]

    @property
    def index(self) -> int:
        return self.mesh.coords["data"]

    def collective(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        """One collective over ``data``, counted in ``stats``: an
        "all-gather" ((n, *x.shape)), a "reduce-scatter" (this rank's block
        of the sum, split along dim 0) or an "all-reduce" (the sum)."""
        self.stats[kind] += 1
        if kind == "all-gather":
            return self.mesh.all_gather(x, ("data",))
        if kind == "reduce-scatter":
            return self.mesh.reduce_scatter_sum(x, ("data",), 0)
        return self.mesh.all_reduce_sum(x, ("data",))

    def reset(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def whole_shape(self, path: str, shard: torch.Tensor) -> Tuple[int, ...]:
        """The gathered shape of the leaf at ``path`` from this rank's shard."""
        s, d = tuple(shard.shape), self.dims[path]
        return s if d is None else s[:d] + (self.size * s[d],) + s[d + 1:]

    def gather(self, tree, path: str, layer: bool = False):
        """``tree`` (a leaf or a nested dict or list of leaves at ``path``
        of the parameters, "" for the root) with every sharded leaf gathered
        over the data ranks, in one collective per dtype.  ``layer``: the
        leaves are one layer of stacked leaves, whose dims count the layer
        axis first."""
        found: Dict[str, Tuple[torch.Tensor, int]] = {}

        def visit(p: str, t: torch.Tensor) -> None:
            d = self.dims[p]
            if d is not None:
                # the FSDP rule's min_dim (1,024) exceeds every depth
                assert not (layer and d == 0), f"{p}: the data axis splits the layer axis"
                found[p] = (t, d - 1 if layer else d)

        root = (path,) if path else ()
        nest_map_with_path(visit, tree, root)
        if not found:
            return tree
        keys = list(found)
        outs = dict(zip(keys, _DataGather.apply(self, tuple(found[k][1] for k in keys),
                                                *(found[k][0] for k in keys))))
        return nest_map_with_path(lambda p, t: outs.get(p, t), tree, root)

    def gathered(self, *paths: str) -> "DataAxis":
        """This handle with the leaves at ``paths`` marked whole (a leaf the
        caller has gathered once and reuses)."""
        return dataclasses.replace(self, dims={**self.dims, **dict.fromkeys(paths)})

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the data ranks' ``x``, with the summed gradient."""
        return _DataSum.apply(self, x)

    def gather_counts(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *x.shape): every data rank's ``x``, a small integer tensor,
        in rank order, with no gradient, on the host (on a
        :class:`CountingMesh` a meta tensor), counted as an "all-gather" and
        charged to the mesh clock's "scatter"."""
        self.stats["all-gather"] += 1
        with self.mesh.clock.span("scatter", self.mesh.device):
            return self.mesh.all_gather(x.detach(), ("data",), host=True)


# ---------------------------------------------------------------------------
# The idle axes of a batch-1 decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class IdleAxis:
    """The models' handle on the axes that carry no batch in a batch-1
    decode (every axis but ``model``; the reference's ``--opt-idle-batch``):
    the ranks that share a model coordinate split the sequence's KV cache,
    the SSM state's heads and the experts among them.  ``index`` is this
    rank's row-major position over ``axes``; the collectives run over them.
    Where a leaf does not divide it stays whole over the idle ranks: the
    SSM state and the experts tell it by their shapes, the attention caches
    by ``seq``.  ``stats`` counts the calls, the bytes this rank sends
    (``bytes_sent``, as the mesh clock's) and, while the mesh's clock is on,
    their seconds (the idle axes' share of the mesh's exchange).  On a
    :class:`CountingMesh` the collectives' result bytes, the measure its
    other counts use, also go to its ``idle_axis`` count."""

    mesh: object
    axes: Tuple[str, ...]
    seq: bool = True  # the attention caches' sequence split (False: whole, it does not divide)
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes_sent": 0, "seconds": 0.0})

    @property
    def size(self) -> int:
        return self.mesh.size(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.index(self.axes)

    def _run(self, fn, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = fn(x, self.axes)
        clock = self.mesh.clock
        if clock.on:
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            self.stats["seconds"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes_sent"] += x.numel() * x.element_size()
        if isinstance(self.mesh, CountingMesh):
            self.mesh.idle_bytes += out.numel() * out.element_size()
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the idle ranks."""
        return self._run(self.mesh.all_reduce_max, x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the idle ranks' partial ``x``: in float32 for a 16-bit
        ``x``, rounded once to its dtype (as :func:`_model_sum`)."""
        if x.dtype in (torch.bfloat16, torch.float16):
            return self._run(self.mesh.all_reduce_sum, x.to(torch.float32)).to(x.dtype)
        return self._run(self.mesh.all_reduce_sum, x)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The idle ranks' blocks concatenated along ``dim`` in row-major
        order of their coordinates."""
        d = dim % x.dim()
        parts = self._run(self.mesh.all_gather, x.contiguous())  # (n, *x.shape)
        return parts.movedim(0, d).reshape(x.shape[:d] + (-1,) + x.shape[d + 1:])

    def reset(self) -> None:
        self.stats.update(calls=0, bytes_sent=0, seconds=0.0)


def idle_axes_of(mesh, model: str = "model") -> Tuple[str, ...]:
    """Every axis of ``mesh`` but ``model``, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != model)


def idle_axis(mesh, model: str = "model") -> Optional[IdleAxis]:
    """The handle of ``mesh``'s idle axes, None when they hold one rank."""
    if mesh is None:
        return None
    axes = idle_axes_of(mesh, model)
    return IdleAxis(mesh, axes) if axes and mesh.size(axes) > 1 else None
