"""The per-rank PISCO train steps (the twin of ``repro.launch.steps``).

:func:`build_train_steps` is the reference's ``build_train_steps`` with one
agent per rank of a :class:`repro_torch.launch.mesh.RankMesh`: it returns the
gossip round and the server round (the host draws W^k = J with probability p
and calls one of them), each a function every rank calls with its own state
and batches.  Gossip runs over the mesh's circulant topology — a ring over
one agent axis, a torus over two — through
:func:`repro_torch.core.mixing.collective_shift_mixing`, the server round is
a sum over the agent axes.  The reference's ``StepSpec.lower`` and dry-run,
and its prefill / decode step builders, have no counterpart yet (ROADMAP A17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence

import numpy as np

from repro_torch.configs.shapes import InputShape
from repro_torch.core.mixing import MixingOps, collective_shift_mixing
from repro_torch.core.pisco import PiscoConfig, make_rank_round_fn
from repro_torch.core.topology import mixing_rate
from repro_torch.launch.input_specs import train_inputs
from repro_torch.launch.mesh import agent_axes_for, n_agents_for
from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import params_from_paths
from repro_torch.utils.pytree import flatten_paths


@dataclasses.dataclass
class TrainStep:
    name: str
    fn: Callable  # (state, local_batches, comm_batch) -> (state, this agent's loss)
    mixing: MixingOps
    notes: Dict[str, Any]


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
) -> Dict[str, TrainStep]:
    """``{"train_gossip": ..., "train_global": ...}`` for this rank.
    ``wire_dtype`` "float32" upcasts gossip messages, "native" sends the
    state's own dtype."""
    if agent_mode != "flat":
        raise NotImplementedError("pod-as-agent meshes (an agent sharded over the intra-pod "
                                  "data axis) are not ported yet (ROADMAP A17)")
    agent_axes = agent_axes_for(mesh, agent_mode)
    n_agents = n_agents_for(mesh, agent_mode)
    pcfg = PiscoConfig(n_agents=n_agents, t_o=t_o, eta_l=eta_l, eta_c=eta_c, p=p)
    train_inputs(bundle.cfg, shape, n_agents, t_o)  # the batch must divide over the agents
    shifts = mesh_gossip_shifts(mesh, agent_axes)
    gossip_ops = collective_shift_mixing(
        mesh, agent_axes, shifts, wire_dtype=None if wire_dtype == "native" else wire_dtype)
    vg = flat_value_and_grad(bundle)
    notes = {
        "n_agents": n_agents,
        "agent_axes": agent_axes,
        "t_o": t_o,
        "gossip_shifts": {k: list(v) for k, v in shifts.items()},
        "wire_dtype": wire_dtype,
        "lambda_w": lambda_w(mesh, agent_axes, shifts),
    }
    return {
        name: TrainStep(name, make_rank_round_fn(vg, pcfg, gossip_ops, global_round=is_global),
                        gossip_ops, notes)
        for name, is_global in (("train_gossip", False), ("train_global", True))
    }
