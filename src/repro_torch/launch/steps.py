"""The step functions of the launcher and the dry run (the twin of
``repro.launch.steps``).

Three step kinds per (architecture x mesh), each a :class:`StepSpec`: the
function, its arguments as meta tensors (nothing allocated) and notes.

* :func:`build_train_steps` — one PISCO round of this rank's agent: the
  gossip round and the server round (the host draws W^k = J with
  probability p and calls one of them), each a function every rank calls
  with its own state and batches.  ``agent_mode="flat"`` puts one agent on
  each rank; ``"hierarchical"`` (pod-as-agent) makes each pod one agent
  whose x, y and g are sharded over the pod's ``data`` ranks
  (:func:`fsdp_placement`, the reference's ``add_fsdp_axis``) and whose
  batch splits over them: inside each gradient call the ranks gather one
  period of the agent's parameters at a time and reduce-scatter its
  gradient as soon as the period's backward ends
  (:func:`sharded_value_and_grad`), and everything else of the round runs
  on the shards.  Gossip runs over the
  mesh's circulant topology — a ring over one agent axis, a torus over two
  — through :func:`repro_torch.core.mixing.collective_shift_mixing`, the server round
  is a sum over the agent axes.  Over a
  :class:`~repro_torch.launch.mesh.RankMesh` ranks call ``fn`` on their own
  tensors; over the dry run's
  :class:`~repro_torch.launch.mesh.CountingMesh` ``spec.lower()`` counts it.
* :func:`build_prefill_step` — inference prefill (forward and cache fill).
* :func:`build_decode_step` — one decode step against the KV/SSM cache.

  Both are one card's share: the serving batch splits over the agent axes
  when it divides across them, as the reference shards it over its batch
  axes, and each card's rows run over the agent's model ranks; the notes
  record the cards (``n_chips``: batch cards x model) that serve it.  A
  batch-1 decode with ``opt_idle_batch`` runs on every card: the idle
  axes split its cache and experts (:func:`idle_layouts`).

The "model" axis is tensor parallelism inside an agent: each rank holds its
model shard of every leaf (:func:`param_layout`: the reference's sanitized
placements, ``bundle.param_specs("model")``, but for the Mamba-2 leaves
listed in the notes' ``layout_differs``) and of the cache
(:func:`cache_layout`, ``bundle.cache_specs``), and the bundle runs on its
share (``get_bundle(cfg, device, tp=ModelAxis(mesh))``), with the model
axis's collectives written out.  Gossip and the server sum run over the
ranks with the same model coordinate; leaves held whole stay bit-identical
across the model ranks.  ``spec.lower()`` runs the function on its meta
arguments under the counters of :mod:`repro_torch.utils.roofline` and
returns their record: the port's counterpart of the reference's lowering
and compilation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.core.adversary import AgentShards
from repro_torch.core.mixing import MixingOps, collective_shift_mixing
from repro_torch.core.pisco import PiscoConfig, PiscoState, make_rank_round_fn
from repro_torch.core.topology import mixing_rate
from repro_torch.launch import input_specs as I
from repro_torch.launch.mesh import (DataAxis, agent_axes_for, idle_axes_of, idle_axis,
                                     model_axis, n_agents_for)
from repro_torch.launch.specs import (CACHE_SEQ, EXPERT_LEAVES, Layout, Segments, add_fsdp_axis,
                                      cache_seq_dim, data_dims, model_dims,
                                      optimize_idle_batch_specs, sanitize_specs, shard_bytes,
                                      shard_model, shard_tree, stack_spec_tree)
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.registry import ModelBundle, get_bundle
from repro_torch.models.transformer import dtype_of, params_from_paths
from repro_torch.utils.pytree import flatten_paths
from repro_torch.utils.roofline import count_call

META = torch.device("meta")


@dataclasses.dataclass
class StepSpec:
    name: str
    fn: Callable
    args: Tuple[Any, ...]  # meta tensors of the arguments' shapes and dtypes
    notes: Dict[str, Any]
    mixing: Optional[MixingOps] = None  # a train step's mixer
    mesh: Any = None

    def lower(self) -> Dict[str, Any]:
        """The counts of one call on the meta arguments
        (:func:`repro_torch.utils.roofline.count_call`) over the dry run's
        counting mesh."""
        return count_call(self.fn, self.args, self.mesh)


def meta_bundle(bundle: ModelBundle) -> ModelBundle:
    """The bundle's twin on the meta device (with the same model axis)."""
    return (bundle if bundle.device.type == "meta"
            else get_bundle(bundle.cfg, META, bundle.tp, bundle.idle, bundle.fsdp))


# ---------------------------------------------------------------------------
# The model axis: each leaf's split
# ---------------------------------------------------------------------------


def _norm_layout(layout: Layout, ndim: int) -> Layout:
    return layout % ndim if isinstance(layout, int) else layout


def _port_layout(cfg, dims: Dict[str, Layout], shapes: Dict[str, Any],
                 n: int) -> Tuple[Dict[str, Layout], List[str]]:
    """``(layout, differs)``: the reference's model dims with the Mamba-2
    leaves put in the port's layout (:func:`repro_torch.models.mamba2.tp_layout`),
    and the paths where the two differ."""
    out = dict(dims)
    if cfg.ssm is not None:
        mamba = M.tp_layout(cfg, n)
        for path in dims:
            name = path.rsplit("/", 1)[-1]
            if name in mamba:
                out[path] = mamba[name]
    differs = [p for p in sorted(out) if _norm_layout(out[p], len(shapes[p].shape))
               != _norm_layout(dims[p], len(shapes[p].shape))]
    return {p: _norm_layout(v, len(shapes[p].shape)) for p, v in out.items()}, differs


def param_layout(bundle: ModelBundle, mesh,
                 axis: str = "model") -> Tuple[Dict[str, Layout], List[str], List[str]]:
    """``(layout, differs, dropped)`` of the parameters over ``mesh``'s
    model axis: per leaf path the dim this rank holds a block of (or the
    :class:`~repro_torch.launch.specs.Segments` of a packed leaf, or None:
    whole), from the reference's placements sanitized on the whole shapes
    (a dim that does not divide stays whole; ``dropped`` is the sanitizer's
    report), with the Mamba-2 leaves in the port's layout (``differs``)."""
    mb = meta_bundle(bundle)
    shapes = flatten_paths(mb.init(0))
    specs, dropped = sanitize_specs(mb.param_specs(axis), shapes, mesh)
    layout, differs = _port_layout(bundle.cfg, model_dims(specs, axis), shapes,
                                   mesh.shape[axis])
    return layout, differs, dropped


def cache_layout(bundle: ModelBundle, cache: Dict, mesh,
                 axis: str = "model") -> Tuple[Dict[str, Layout], List[str]]:
    """``(layout, differs)`` of a whole cache over the model axis
    (``bundle.cache_specs`` sanitized on its shapes; the Mamba-2 conv window
    and SSM state in the port's layout)."""
    shapes = flatten_paths(cache)
    specs, _ = sanitize_specs(bundle.cache_specs(None, axis), shapes, mesh)
    return _port_layout(bundle.cfg, model_dims(specs, axis), shapes, mesh.shape[axis])



# ---------------------------------------------------------------------------
# Gossip weights on the mesh (circulant; ring over one axis, torus over two)
# ---------------------------------------------------------------------------


def mesh_gossip_shifts(mesh, agent_axes: Sequence[str]) -> Dict[str, list]:
    """Ring (one agent axis) or torus (two axes) neighbor weights.

    Self weight 1/2; the remaining 1/2 split evenly across distinct neighbor
    permutations (an axis of size 2 has a single distinct ±1 neighbor)."""
    neigh = []
    for a in agent_axes:
        if mesh.shape[a] == 1:
            continue
        neigh.append((a, [1] if mesh.shape[a] == 2 else [1, -1]))
    total = sum(len(s) for _, s in neigh)
    shifts: Dict[str, list] = {}
    w = 0.5 / max(1, total)
    for i, (a, ss) in enumerate(neigh):
        shifts[a] = ([(0, 0.5)] if i == 0 else []) + [(s, w) for s in ss]
    if not neigh:  # single agent: identity
        shifts[agent_axes[0]] = [(0, 1.0)]
    return shifts


def gossip_matrix(mesh, agent_axes: Sequence[str], shifts: Dict[str, list]) -> np.ndarray:
    """Dense equivalent of the circulant mesh gossip (for lambda_w reporting)."""
    sizes = [mesh.shape[a] for a in agent_axes]
    n = int(np.prod(sizes))
    w = np.zeros((n, n))
    idx = np.arange(n).reshape(sizes)
    self_w = sum(wt for pairs in shifts.values() for s, wt in pairs if s == 0)
    w[np.arange(n), np.arange(n)] += self_w
    for ai, a in enumerate(agent_axes):
        for s, wt in shifts.get(a, []):
            if s == 0:
                continue
            rolled = np.roll(idx, -s, axis=ai)  # dst receives src shifted by s
            w[rolled.reshape(-1), idx.reshape(-1)] += wt
    return w


def lambda_w(mesh, agent_axes: Sequence[str], shifts: Dict[str, list]) -> float:
    return float(mixing_rate(gossip_matrix(mesh, agent_axes, shifts)))


# ---------------------------------------------------------------------------
# Train steps (one PISCO round)
# ---------------------------------------------------------------------------


def flat_value_and_grad(bundle: ModelBundle) -> Callable:
    """``vg(flat_params, batch) -> (loss, flat_grads)``: the bundle's
    value-and-grad over the flat, path-keyed dicts the round carries."""
    def vg(flat, batch):
        loss, grads = bundle.value_and_grad(params_from_paths(flat, bundle.cfg), batch)
        return loss, flatten_paths(grads)

    return vg


# ---------------------------------------------------------------------------
# Pod-as-agent: an agent's leaves and batch over the intra-pod data axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _MeshView:
    """A mesh shape alone (what the placement functions read)."""

    shape: Dict[str, int]


def fsdp_placement(bundle: ModelBundle, mesh, n_agents: int,
                   agent_axes: Sequence[str] = ("pod",),
                   layout: Optional[Dict[str, Layout]] = None) -> Tuple[Dict, List[str], Dict]:
    """``(placements, dropped, dims)`` of pod-as-agent's agent-stacked
    leaves, as the reference's ``build_train_steps`` places them: the model's
    placements stacked over the agent axes, ``add_fsdp_axis(..., "data",
    skip_leading=1)``, then ``sanitize_specs`` (with its report of dropped
    entries).  ``dims`` is the per-agent leaf's dim that the data axis
    splits, None where a leaf stays whole on every data rank.  With a model
    ``layout`` (a model axis above 1) the rule runs on each leaf's model
    shard, which is what the data ranks split: the model entries keep the
    data axis off their dims, and only the data entries are sanitized."""
    mb = meta_bundle(bundle)
    leaves = flatten_paths(mb.init(0))
    if layout is not None:
        leaves = shard_model(leaves, layout, mesh)
    stacked = {k: torch.empty((n_agents,) + tuple(v.shape), dtype=v.dtype, device=META)
               for k, v in leaves.items()}
    specs = stack_spec_tree(mb.param_specs("model"), agent_axes)
    specs = add_fsdp_axis(specs, stacked, mesh, "data", skip_leading=1)
    view = mesh if layout is None else _MeshView({**mesh.shape, "model": 1})
    specs, dropped = sanitize_specs(specs, stacked, view)
    return specs, dropped, data_dims(specs, "data", skip_leading=1)


def shard_leaves(tree: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                 mesh) -> Dict[str, torch.Tensor]:
    """This rank's data shard of each of the agent's whole leaves (a copy
    that holds no reference to the whole leaf; a leaf held whole stays as it
    is)."""
    n, i = mesh.shape["data"], mesh.coords["data"]
    return {k: v if dims[k] is None else v.chunk(n, dims[k])[i].clone(
        memory_format=torch.contiguous_format) for k, v in tree.items()}


def agent_shards(whole: Dict[str, Sequence[int]], dims: Dict[str, Optional[int]],
                 mesh) -> AgentShards:
    """Where this rank's leaves sit in its agent's under pod-as-agent's
    placement, for a Byzantine adversary or Krum over the agents
    (:func:`repro_torch.core.adversary.make_adversarial_mixing`): ``whole``
    the agent's leaf shapes, ``dims`` the data dims of
    :func:`fsdp_placement`; a rank's block is its :func:`shard_leaves`
    chunk, and a leaf held whole is held by every data rank.  Not derived
    for a model axis above 1, whose ranks hold model shards as well."""
    if mesh.shape.get("model", 1) > 1:
        raise ValueError("agent_shards: a model axis above 1 also splits the leaves; "
                         "build AgentShards from the model layout as well")
    n, i = mesh.shape["data"], mesh.coords["data"]
    return AgentShards(
        shapes={k: tuple(v) for k, v in whole.items()},
        cut=lambda k, t: t if dims[k] is None else t.chunk(n, dims[k])[i],
        replicas={k: n if dims[k] is None else 1 for k in whole})


def gather_leaves(shards: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                  mesh) -> Dict[str, torch.Tensor]:
    """The agent's whole leaves from the data ranks' shards (an all-gather
    over ``data`` per sharded leaf), charged to the mesh clock's "gather":
    to rebuild an agent from its ranks (the gradient never gathers it
    whole)."""
    out = {}
    with mesh.clock.span("gather", mesh.device):
        for k, v in shards.items():
            d = dims[k]
            if d is None:
                out[k] = v
                continue
            parts = mesh.all_gather(v, ("data",))  # (n, *shard)
            out[k] = parts.movedim(0, d).reshape(v.shape[:d] + (-1,) + v.shape[d + 1:])
    return out


def moe_capacity_notes(cfg, t_rank: int, n_data: int) -> Dict[str, Any]:
    """What pod-as-agent's MoE layers buffer on a data rank of ``t_rank``
    tokens: the rows an expert's buffer has on the meta device (the
    balanced share, ``capacity(T_rank)``, which the counts above hold), the
    agent's capacity, and the worst case on the card, ``min(cap_agent,
    T_rank · k)`` rows, with its bytes a layer (E × rows × d_model)."""
    mo = cfg.moe
    cap_agent = MOE.capacity(mo, n_data * t_rank)
    worst = min(cap_agent, t_rank * mo.top_k)
    return {"tokens_per_rank": t_rank, "rows_counted": MOE.capacity(mo, t_rank),
            "cap_agent": cap_agent, "rows_worst": worst,
            "worst_buffer_bytes": mo.n_experts * worst * cfg.d_model
            * dtype_of(cfg).itemsize,
            "rule": "each data rank keeps clamp(cap_agent - before_r[e], 0, counts_r[e]) "
                    "entries of expert e (before_r: the ranks before it), in a buffer of max_e "
                    "rows, read on the host from the all-gathered expert counts"}


GATHER_NOTE = (
    "one period of the agent's model shard at a time, at the top of the period inside its "
    "remat region (re-gathered in the backward), its sharded leaves coalesced into one "
    "all-gather per dtype; each period's gradient reduce-scattered in its own dtype as soon "
    "as the period's backward ends; the head layers one at a time, the embedding, head and "
    "final norms where they are used (a tied embedding once); without remat autograd keeps "
    "each gathered period for the backward, as the reference's residuals would")


def sharded_value_and_grad(bundle: ModelBundle, mesh, dims: Dict[str, Optional[int]],
                           split_batch: bool = True) -> Callable:
    """Pod-as-agent's ``vg(shards, batch_share) -> (loss, grad shards)``:
    ``bundle``'s value-and-grad on this rank's data shards (``dims``,
    :func:`fsdp_placement`'s) and its share of the agent's batch.  Its loss
    gathers each period's parameters over ``data`` where the period starts,
    inside its remat region, and reduce-scatters each period's gradient in
    its own dtype when the period's backward ends, as the reference's FSDP
    does inside its layer scan (:class:`~repro_torch.launch.mesh.DataAxis`,
    the returned function's ``data_axis``); with remat a rank never holds
    more than one period gathered.  The gradients of leaves held whole are
    all-reduced, and every gradient is divided by the data size: the
    agent's mean gradient over its whole batch, as the reference's
    synchronous data parallelism inside a pod computes it.  The loss is the
    mean over the data ranks.  The gathers are charged to the mesh clock's
    "gather", the reductions to its "scatter" (their transfers to
    "exchange" as well).  ``split_batch``: the share is this rank's block of
    the agent's rows (:func:`batch_share` of a batch that divides over the
    data ranks, :func:`batch_splits`); False when every rank holds the whole
    batch.  An MoE layer fills expert capacity over the agent's batch from
    it (:mod:`repro_torch.models.moe`)."""
    axis = DataAxis(mesh, dims, split_batch)
    vg = flat_value_and_grad(dataclasses.replace(bundle, fsdp=axis))
    n = mesh.shape["data"]

    def vg_sharded(shards, batch):
        loss, grads = vg(shards, batch)
        out = {}
        with mesh.clock.span("scatter", mesh.device):
            for k in list(grads):
                g = grads.pop(k)
                out[k] = (g if dims[k] is not None else mesh.all_reduce_sum(g, ("data",))) / n
                del g
            loss = mesh.all_reduce_sum(loss.detach().to(torch.float32).reshape(1), ("data",))
        return (loss / n).reshape(()), out

    vg_sharded.data_axis = axis
    return vg_sharded


def batch_dims(batch: Dict[str, Any], b_per_agent: int, lead: int = 0) -> Dict[str, Optional[int]]:
    """The dim of each of one agent's batch leaves that the data axis splits
    (the reference's ``_comm_spec`` / ``_comm_spec_inner``: the first or the
    second dim after ``lead`` leading ones, whichever is the per-agent
    batch), None for a leaf no dim of which is."""
    out = {}
    for k, v in batch.items():
        inner = tuple(v.shape)[lead:]
        out[k] = (lead if len(inner) >= 1 and inner[0] == b_per_agent else
                  lead + 1 if len(inner) >= 2 and inner[1] == b_per_agent else None)
    return out


def batch_splits(batch: Dict[str, Any], dims: Dict[str, Optional[int]], mesh) -> bool:
    """Whether :func:`batch_share` hands each data rank its own block of
    every batch leaf (each batch dim divides over the data ranks)."""
    n = mesh.shape["data"]
    return all(dims[k] is None or v.shape[dims[k]] % n == 0 for k, v in batch.items())


def batch_share(batch: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                mesh) -> Dict[str, torch.Tensor]:
    """This data rank's rows of one agent's batch (copies); a leaf whose
    batch dim does not split over the data ranks is taken whole, as the
    reference's sanitizer replicates it."""
    n, i = mesh.shape["data"], mesh.coords["data"]
    return {k: v if dims[k] is None or v.shape[dims[k]] % n else
            v.chunk(n, dims[k])[i].clone(memory_format=torch.contiguous_format)
            for k, v in batch.items()}


def build_train_steps(
    bundle: ModelBundle,
    shape: InputShape,
    mesh,
    *,
    t_o: int = 1,
    eta_l: float = 1e-2,
    eta_c: float = 1.0,
    p: float = 0.1,
    agent_mode: str = "flat",
    wire_dtype: str = "float32",
) -> Dict[str, StepSpec]:
    """``{"train_gossip": ..., "train_global": ...}`` for this rank.
    ``wire_dtype`` "float32" upcasts gossip messages, "native" sends the
    state's own dtype.  ``args`` are this rank's state and batches on the
    meta device: one agent's whole, or under pod-as-agent its data shard
    (the notes' ``data_dims`` and ``batch_dims`` say which dims split;
    :func:`shard_leaves` and :func:`batch_share` cut them)."""
    agent_axes = agent_axes_for(mesh, agent_mode)
    n_agents = n_agents_for(mesh, agent_mode)
    hierarchical = agent_mode == "hierarchical" and "data" in mesh.axis_names
    pcfg = PiscoConfig(n_agents=n_agents, t_o=t_o, eta_l=eta_l, eta_c=eta_c, p=p)
    local_spec, comm_spec = I.train_inputs(bundle.cfg, shape, n_agents, t_o)
    shifts = mesh_gossip_shifts(mesh, agent_axes)
    gossip_ops = collective_shift_mixing(
        mesh, agent_axes, shifts, wire_dtype=None if wire_dtype == "native" else wire_dtype)
    tp = model_axis(mesh)
    if tp is not None:
        bundle = get_bundle(bundle.cfg, bundle.device, tp)
    # over the dry run's counting mesh the round runs on the meta device
    vg_bundle = meta_bundle(bundle) if mesh.device.type == "meta" else bundle
    vg = flat_value_and_grad(vg_bundle)
    notes = {
        "n_agents": n_agents,
        "agent_axes": agent_axes,
        "t_o": t_o,
        "gossip_shifts": {k: list(v) for k, v in shifts.items()},
        "wire_dtype": wire_dtype,
        "lambda_w": lambda_w(mesh, agent_axes, shifts),
    }
    # one agent's slice: the agent axis is first in comm, second in local
    one = {k: I.TensorSpec(v.shape[1:], v.dtype) for k, v in comm_spec.items()}
    local = {k: I.TensorSpec(v.shape[:1] + v.shape[2:], v.dtype) for k, v in local_spec.items()}
    x = flatten_paths(meta_bundle(bundle).init(0))
    local, one = I.materialize(local, META), I.materialize(one, META)
    layout = None
    if tp is not None:
        layout, differs, dropped = param_layout(bundle, mesh)
        x = shard_model(x, layout, mesh)
        split = {k for k, v in layout.items() if v is not None}
        gossip_ops = dataclasses.replace(
            gossip_ops, row_max=lambda k, a: tp.max(a) if k in split else a)
        notes.update(model_axis=tp.size, model_layout=_layout_notes(layout),
                     layout_differs=differs, dropped_shardings=dropped)
    if hierarchical:
        specs, dropped, dims = fsdp_placement(bundle, mesh, n_agents, agent_axes, layout)
        b_per_agent = shape.global_batch // n_agents
        bdims = {"comm": batch_dims(one, b_per_agent), "local": batch_dims(local, b_per_agent, 1)}
        vg = sharded_value_and_grad(vg_bundle, mesh, dims,
                                    batch_splits(one, bdims["comm"], mesh)
                                    and batch_splits(local, bdims["local"], mesh))
        x = shard_leaves(x, dims, mesh)
        local, one = batch_share(local, bdims["local"], mesh), batch_share(one, bdims["comm"], mesh)
        notes.update(agent_mode=agent_mode, placements={k: list(v) for k, v in specs.items()},
                     dropped_shardings=dropped, data_dims=dims, batch_dims=bdims,
                     gather=GATHER_NOTE)
        if "moe" in bundle.cfg.ffn_kinds():
            notes["moe_capacity"] = moe_capacity_notes(bundle.cfg, one["tokens"].numel(),
                                                       mesh.shape["data"])
    # x, y and g, each this rank's shard
    notes["state_bytes_per_card"] = 3 * sum(v.numel() * v.element_size() for v in x.values())
    state = PiscoState(x=x, y={k: torch.empty_like(v) for k, v in x.items()},
                       g={k: torch.empty_like(v) for k, v in x.items()},
                       step=torch.zeros((), dtype=torch.int32, device=META))
    args = (state, local, one)
    return {
        name: StepSpec(name, make_rank_round_fn(vg, pcfg, gossip_ops, global_round=is_global),
                       args, notes, mixing=gossip_ops, mesh=mesh)
        for name, is_global in (("train_gossip", False), ("train_global", True))
    }


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def serve_split(mesh, batch: int) -> Tuple[Optional[Tuple[str, ...]], int]:
    """``(batch_axes, cards)`` of a serving batch on ``mesh``: the
    reference's rule, every agent axis when the batch divides across them
    (each agent's model ranks serve ``batch // cards`` rows), else none (one
    agent serves the whole batch and the others idle)."""
    axes = agent_axes_for(mesh)
    cards = mesh.size(axes)
    return (tuple(axes), cards) if batch % cards == 0 else (None, 1)


def _per_card(shape: InputShape, mesh) -> Tuple[InputShape, Dict[str, Any]]:
    """One agent's share of a serving shape and the notes that record it
    (``n_chips``: the serving agents' cards, model ranks included)."""
    axes, cards = serve_split(mesh, shape.global_batch)
    rows = shape.global_batch // cards
    model = mesh.shape.get("model", 1)
    notes = {"batch_axes": axes, "n_chips": cards * model, "rows_per_chip": rows,
             "model_axis": model}
    return dataclasses.replace(shape, global_batch=rows), notes


def _layout_notes(layout: Dict[str, Layout]) -> Dict[str, Any]:
    return {k: (dataclasses.asdict(v) if isinstance(v, Segments) else v)
            for k, v in layout.items()}


def serve_args(bundle: ModelBundle, mesh, params: Any, cache: Dict,
               notes: Dict[str, Any]) -> Tuple[ModelBundle, Any, Dict]:
    """The serving bundle on ``mesh``'s model axis and this rank's model
    shards of ``params`` and ``cache`` (as they are without a model axis);
    the layouts go into ``notes``."""
    tp = model_axis(mesh)
    if tp is None:
        return bundle, params, cache
    bundle = get_bundle(bundle.cfg, bundle.device, tp)
    layout, differs, dropped = param_layout(bundle, mesh)
    c_layout, c_differs = cache_layout(bundle, cache, mesh)
    notes.update(model_layout=_layout_notes(layout), cache_layout=_layout_notes(c_layout),
                 layout_differs=differs + c_differs, dropped_shardings=dropped)
    return bundle, shard_tree(params, layout, mesh), shard_tree(cache, c_layout, mesh)


def _serve_cache(bundle: ModelBundle, shape: InputShape) -> Dict:
    if bundle.cfg.is_enc_dec:
        return bundle.init_cache(shape.global_batch, shape.seq_len, mem_len=shape.seq_len // 4)
    return bundle.init_cache(shape.global_batch, shape.seq_len)


def build_prefill_step(bundle: ModelBundle, shape: InputShape, mesh) -> StepSpec:
    """One agent's prefill of its rows of ``shape.global_batch`` sequences
    of ``shape.seq_len`` tokens into a fresh cache (:func:`serve_split`),
    each model rank on its shard of the parameters and cache."""
    mb = meta_bundle(bundle)
    card, notes = _per_card(shape, mesh)
    batch = I.materialize(I.prefill_inputs(mb.cfg, card), META)
    mb, params, cache = serve_args(mb, mesh, mb.init(0), _serve_cache(mb, card), notes)
    args = (params, batch, cache)
    return StepSpec("prefill", lambda p, b, c: mb.prefill(p, b, c), args, notes, mesh=mesh)


# ---------------------------------------------------------------------------
# A batch-1 decode over the idle axes (the reference's --opt-idle-batch)
# ---------------------------------------------------------------------------


def _meta_like(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype, device=META) for k, v in tree.items()}


def _numel(t) -> int:
    return int(np.prod(tuple(t.shape))) if len(t.shape) else 1


@dataclasses.dataclass
class IdleLayouts:
    """A batch-1 decode's placements over ``mesh``'s model and idle axes.

    ``model`` / ``model_cache``: each leaf's model layout (as
    :func:`param_layout` / :func:`cache_layout` give it, None everywhere
    without a model axis); ``params`` / ``cache``: the dim of each leaf's
    model shard that the idle axes split (None: whole over them).  The port
    splits the KV caches' (``k``, ``v``, ``c_kv``, ``k_rope``) sequence, the
    SSM state's heads (the model rank's block of them) and the experts of
    an expert-stacked FFN leaf, each where it divides.  ``reference``: the
    reference's placements (:func:`optimize_idle_batch_specs`, then
    :func:`sanitize_specs` on the whole shapes, whose report is
    ``dropped``); ``port_bytes`` / ``reference_bytes``: each leaf's bytes on
    one card; ``differs``: the leaves whose bytes differ, ``added`` the
    bytes the port's layout adds there (negative: saves).  They differ
    where the reference's key-based rewrite reads the layer axis of a
    stacked dense FFN leaf as experts, and where the model rank's heads of
    the SSM state do not divide over the idle axes (the reference splits
    all of them over the idle axes alone and holds them whole over model)."""

    axes: Tuple[str, ...]
    model: Dict[str, Layout]
    model_cache: Dict[str, Layout]
    params: Dict[str, Optional[int]]
    cache: Dict[str, Optional[int]]
    reference: Dict[str, tuple]
    dropped: List[str]
    port_bytes: Dict[str, int]
    reference_bytes: Dict[str, int]
    model_differs: List[str]

    @property
    def seq(self) -> bool:
        """Whether the attention caches' sequence is split (all of them, or
        none: they share one length)."""
        split = {d is not None for k, d in self.cache.items()
                 if k.rsplit("/", 1)[-1] in CACHE_SEQ}
        if len(split) > 1:
            raise ValueError(f"the attention caches split unevenly over {self.axes}")
        return split != {False}

    @property
    def differs(self) -> List[str]:
        return sorted(k for k in self.port_bytes if self.port_bytes[k] != self.reference_bytes[k])

    @property
    def added(self) -> Dict[str, int]:
        return {k: self.port_bytes[k] - self.reference_bytes[k] for k in self.differs}

    def shard_params(self, tree: Any, mesh) -> Any:
        """This rank's shard of a whole parameter tree: its model shard,
        then its block of that over the idle axes."""
        return shard_tree(shard_tree(tree, self.model, mesh), self.params, mesh, self.axes)

    def shard_cache(self, tree: Any, mesh) -> Any:
        return shard_tree(shard_tree(tree, self.model_cache, mesh), self.cache, mesh, self.axes)

    def notes(self) -> Dict[str, Any]:
        return {"idle_axes": list(self.axes), "model_layout": _layout_notes(self.model),
                "cache_layout": _layout_notes(self.model_cache), "idle_layout": self.params,
                "cache_idle_layout": self.cache, "reference_idle_placements":
                {k: list(v) for k, v in self.reference.items()},
                "layout_differs": sorted(set(self.model_differs) | set(self.differs)),
                "idle_bytes_added": self.added, "dropped_shardings": self.dropped}


def _idle_dim(path: str, shard, shapes: Dict[str, Any], n: int) -> Optional[int]:
    """The dim of ``path``'s model shard (``shard``) that the port splits
    over ``n`` idle ranks, or None."""
    name, nd = path.rsplit("/", 1)[-1], len(shard.shape)
    if name in CACHE_SEQ:
        d = cache_seq_dim(path, nd)
    elif name == "ssm":
        d = nd - 3
    elif (name in EXPERT_LEAVES and nd >= 3
          and path.rsplit("/", 1)[0] + "/router" in shapes):  # an expert-stacked leaf
        d = nd - 3
    else:
        return None
    return d if d >= 0 and shard.shape[d] % n == 0 else None


def idle_layouts(bundle: ModelBundle, cache: Dict, mesh) -> IdleLayouts:
    """The placements of a batch-1 decode of ``bundle`` over ``mesh``'s
    idle axes (every axis but ``model``) beside its model axis, for a whole
    ``cache`` of that decode (any device: only shapes are read); see
    :class:`IdleLayouts`."""
    mb = meta_bundle(bundle)
    axes = idle_axes_of(mesh)
    n = mesh.size(axes)
    p_shapes = flatten_paths(mb.init(0))
    c_shapes = _meta_like(flatten_paths(cache))
    c_raw, p_raw = optimize_idle_batch_specs(mb.cache_specs(None), mb.param_specs(), mesh)
    p_ref, p_drop = sanitize_specs(p_raw, p_shapes, mesh)
    c_ref, c_drop = sanitize_specs(c_raw, c_shapes, mesh)
    if mesh.shape.get("model", 1) > 1:
        layout, p_differs, _ = param_layout(mb, mesh)
        c_layout, c_differs = cache_layout(mb, c_shapes, mesh)
    else:
        layout, p_differs = dict.fromkeys(p_shapes), []
        c_layout, c_differs = dict.fromkeys(c_shapes), []

    def split(shapes, lay, ref):
        shards = shard_model(shapes, lay, mesh)
        dims = {k: _idle_dim(k, v, shapes, n) for k, v in shards.items()}
        port = {k: _numel(v) // (1 if dims[k] is None else n) * v.element_size()
                for k, v in shards.items()}
        return dims, port, {k: shard_bytes({k: shapes[k]}, {k: ref[k]}, mesh) for k in shapes}

    (pd, pp, pr), (cd, cp, cr) = split(p_shapes, layout, p_ref), split(c_shapes, c_layout, c_ref)
    return IdleLayouts(axes=axes, model=layout, model_cache=c_layout, params=pd, cache=cd,
                       reference={**p_ref, **c_ref}, dropped=p_drop + c_drop,
                       port_bytes={**pp, **cp}, reference_bytes={**pr, **cr},
                       model_differs=p_differs + c_differs)


def build_decode_step(bundle: ModelBundle, shape: InputShape, mesh, *,
                      opt_idle_batch: bool = False) -> StepSpec:
    """One agent's decode step of its rows of ``shape.global_batch``
    against a cache of ``shape.seq_len`` positions (:func:`serve_split`),
    each model rank on its shard.  With ``opt_idle_batch``, a batch that
    does not split over the agent axes (one sequence) is served by the
    whole mesh instead of one agent: the idle axes split the KV caches
    along the sequence, the SSM state by head and the experts
    (:func:`idle_layouts`, the reference's ``_optimize_idle_batch_specs``),
    and ``n_chips`` counts every card."""
    mb = meta_bundle(bundle)
    card, notes = _per_card(shape, mesh)
    token = I.materialize(I.decode_token_input(card), META)
    cache = _serve_cache(mb, card)
    idle = idle_axis(mesh) if opt_idle_batch and notes["batch_axes"] is None else None
    if idle is None:
        mb, params, cache = serve_args(mb, mesh, mb.init(0), cache, notes)
    else:
        lay = idle_layouts(mb, cache, mesh)
        idle = dataclasses.replace(idle, seq=lay.seq)
        mb = get_bundle(mb.cfg, META, model_axis(mesh), idle)
        params, cache = lay.shard_params(mb.init(0), mesh), lay.shard_cache(cache, mesh)
        notes.update(lay.notes(), n_chips=mesh.size(mesh.axis_names), idle_ranks=idle.size)
    notes["opt_idle_batch"] = opt_idle_batch
    args = (params, token, cache)
    return StepSpec("decode", lambda p, t, c: mb.decode(p, t, c), args, notes, mesh=mesh)
