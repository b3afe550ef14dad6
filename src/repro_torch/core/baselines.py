"""Baseline algorithms the paper compares against (Tables 1 & 2).

All baselines share PISCO's substrate: agent-stacked dicts of tensors, the
:class:`~repro_torch.core.mixing.MixingOps` communication layer, per-agent
loss functions and host-side schedules.

* DSGD           — gossip SGD [NO09]
* Gossip-PGA     — gossip SGD + periodic global averaging every H [CYZ+21]
* DSGT           — distributed stochastic gradient tracking [PN21]
* Periodical-GT  — GT + T_o local updates, gossip every round [LLKS24]
                   (== PISCO with p = 0; provided as a named wrapper)
* FedAvg         — T_o local SGD steps + server averaging [MMR+17, LHY+20]
* SCAFFOLD       — FedAvg + control variates [KKM+20]

Each exposes ``init(loss_fn, x0, batch0)`` and round functions with the same
signature as PISCO's, so the shared drivers run any of them.  These are the
reference's hardcoded-SGD (legacy) round functions; the pluggable update
rules are ROADMAP A9.  Under compression the gossip baselines mix through
``MixingOps.gossip``, the stateless compressed form (deterministic rounding,
no error feedback), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.mixing import MixingOps
from repro_torch.core.pisco import (
    LossFn,
    PiscoConfig,
    RoundMetrics,
    _consensus_error,
    make_round_fn,
    make_stacked_value_and_grad,
)
from repro_torch.core.pisco import init_state as pisco_init_state
from repro_torch.utils.pytree import (
    tree_add,
    tree_agent_mean,
    tree_leaves,
    tree_map,
    tree_sq_norm,
    tree_sub,
)

Tree = Dict[str, torch.Tensor]


def _metrics(loss, g_stacked: Tree, x: Tree) -> RoundMetrics:
    gbar = tree_map(lambda v: v.mean(dim=0), g_stacked)
    return RoundMetrics(
        loss=torch.mean(loss),
        grad_sq_norm=tree_sq_norm(gbar),
        consensus_err=_consensus_error(x) / tree_leaves(x)[0].shape[0],
    )


def _step0(x: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(x)[0].device)


def _round_loss(losses, loss_c, t_o: int) -> torch.Tensor:
    """Mean loss over the T_o local steps and the comm step, the local steps
    weighted by t_o, as the reference reports it."""
    return (torch.mean(torch.stack(losses)) * t_o + torch.mean(loss_c)) / (t_o + 1)


def _local_steps(step: Callable, x: Tree, local_batches: Tuple) -> Tuple[Tree, list]:
    """Run ``step(x, batch_t) -> (x, loss, grads)`` over the leading (T_o)
    axis of the local batches (the reference's ``lax.scan``)."""
    losses = []
    for t in range(local_batches[0].shape[0]):
        x, loss, _ = step(x, tuple(b[t] for b in local_batches))
        losses.append(loss)
    return x, losses


# ---------------------------------------------------------------------------
# DSGD / Gossip-PGA
# ---------------------------------------------------------------------------


class SGDState(NamedTuple):
    x: Tree
    step: torch.Tensor


def dsgd_init(loss_fn: LossFn, x0: Tree, batch0: Any) -> SGDState:
    del loss_fn, batch0
    return SGDState(x=x0, step=_step0(x0))


def make_dsgd_round_fn(
    loss_fn: LossFn, eta: float, mixing: MixingOps, *, global_round: bool, t_o: int = 1
) -> Callable:
    """One DSGD round: ``x <- mix(x - eta g)`` (T_o local SGD steps first,
    which with global mixing == FedAvg / local SGD)."""
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    mix = mixing.global_avg if global_round else mixing.gossip

    def sgd(x, batch):
        loss, g = stacked_vg(x, batch)
        return tree_map(lambda xi, gi: xi - eta * gi, x, g), loss, g

    def round_fn(state: SGDState, local_batches, comm_batch):
        x, losses = _local_steps(sgd, state.x, local_batches)
        # one more SGD step on the comm batch, then mix (keeps the same
        # gradient budget per round as PISCO: T_o + 1 evaluations)
        x, loss_c, g_c = sgd(x, comm_batch)
        x = mix(x)
        return SGDState(x=x, step=state.step + 1), _metrics(
            _round_loss(losses, loss_c, t_o), g_c, x
        )

    return round_fn


# ---------------------------------------------------------------------------
# DSGT [PN21]
# ---------------------------------------------------------------------------


class GTState(NamedTuple):
    x: Tree
    y: Tree
    g: Tree
    step: torch.Tensor


def dsgt_init(loss_fn: LossFn, x0: Tree, batch0: Any) -> GTState:
    s = pisco_init_state(loss_fn, x0, batch0)
    return GTState(x=s.x, y=s.y, g=s.g, step=s.step)


def make_dsgt_round_fn(
    loss_fn: LossFn, eta: float, mixing: MixingOps, *, global_round: bool = False
) -> Callable:
    """DSGT:  x+ = mix(x - eta y);  y+ = mix(y) + g(x+) - g(x)."""
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    mix = mixing.global_avg if global_round else mixing.gossip

    def round_fn(state: GTState, local_batches, comm_batch):
        del local_batches  # DSGT has no local phase; comm_batch is Z^{k+1}
        x_new = mix(tree_map(lambda xi, yi: xi - eta * yi, state.x, state.y))
        loss, g_new = stacked_vg(x_new, comm_batch)
        y_new = tree_add(mix(state.y), tree_sub(g_new, state.g))
        new_state = GTState(x=x_new, y=y_new, g=g_new, step=state.step + 1)
        return new_state, _metrics(loss, g_new, x_new)

    return round_fn


# ---------------------------------------------------------------------------
# Periodical-GT (PISCO p=0 named wrapper)
# ---------------------------------------------------------------------------


def make_periodical_gt_round_fn(loss_fn: LossFn, cfg: PiscoConfig, mixing: MixingOps) -> Callable:
    """[LLKS24]: gradient tracking with T_o local steps, gossip every round —
    exactly PISCO's gossip round (Remark 1).  The state carries no error-
    feedback residuals, so compressed mixing runs through the stateless path."""
    return make_round_fn(loss_fn, cfg, mixing, global_round=False, use_ef=False)


# ---------------------------------------------------------------------------
# SCAFFOLD [KKM+20] (option II control variates)
# ---------------------------------------------------------------------------


class ScaffoldState(NamedTuple):
    x: Tree  # agent-stacked copies of the server model (kept in sync)
    c_i: Tree  # agent control variates (stacked)
    c: Tree  # server control variate (stacked-broadcast for layout parity)
    step: torch.Tensor


def scaffold_init(loss_fn: LossFn, x0: Tree, batch0: Any) -> ScaffoldState:
    _, g0 = make_stacked_value_and_grad(loss_fn)(x0, batch0)
    return ScaffoldState(x=x0, c_i=g0, c=tree_agent_mean(g0), step=_step0(x0))


def make_scaffold_round_fn(
    loss_fn: LossFn, eta_l: float, eta_g: float, t_o: int, mixing: MixingOps
) -> Callable:
    """SCAFFOLD round (always agent-to-server; the federated anchor of Table 2).

    Local:  x <- x - eta_l (g_i(x) - c_i + c), T_o+1 steps.
    Then:   c_i+ = c_i - c + (x_k - x_To) / ((T_o+1) eta_l)
            x+   = x_k + eta_g * mean(x_To - x_k);  c+ = mean(c_i+)
    """
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    g_avg = mixing.global_avg
    steps = (t_o + 1) * eta_l

    def round_fn(state: ScaffoldState, local_batches, comm_batch):
        correction = tree_sub(state.c, state.c_i)

        def step(x, batch):
            loss, g = stacked_vg(x, batch)
            x = tree_map(lambda xi, gi, ci: xi - eta_l * (gi + ci), x, g, correction)
            return x, loss, g

        x_to, losses = _local_steps(step, state.x, local_batches)
        x_to, loss_c, g_c = step(x_to, comm_batch)
        c_i_new = tree_map(
            lambda ci, c, xk, xt: ci - c + (xk - xt) / steps,
            state.c_i, state.c, state.x, x_to,
        )
        delta = g_avg(tree_sub(x_to, state.x))
        x_new = tree_map(lambda xk, d: xk + eta_g * d, state.x, delta)
        new_state = ScaffoldState(x=x_new, c_i=c_i_new, c=g_avg(c_i_new), step=state.step + 1)
        return new_state, _metrics(_round_loss(losses, loss_c, t_o), g_c, x_new)

    return round_fn


# ---------------------------------------------------------------------------
# Static baseline descriptors (the runnable registry lives in
# repro_torch.core.algorithms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaselineSpec:
    name: str
    server_based: bool  # True => every comm round is agent-to-server
    uses_local_updates: bool


BASELINES = {
    "dsgd": BaselineSpec("dsgd", server_based=False, uses_local_updates=False),
    "gossip_pga": BaselineSpec("gossip_pga", server_based=False, uses_local_updates=False),
    "dsgt": BaselineSpec("dsgt", server_based=False, uses_local_updates=False),
    "periodical_gt": BaselineSpec("periodical_gt", server_based=False, uses_local_updates=True),
    "fedavg": BaselineSpec("fedavg", server_based=True, uses_local_updates=True),
    "scaffold": BaselineSpec("scaffold", server_based=True, uses_local_updates=True),
    "pisco": BaselineSpec("pisco", server_based=False, uses_local_updates=True),
}
