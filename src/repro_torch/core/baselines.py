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
signature as PISCO's, so the shared drivers run any of them.  Under
compression the gossip baselines mix through ``MixingOps.gossip``, the
stateless compressed form (deterministic rounding, no error feedback), as in
the reference.

Every baseline takes PISCO's update-rule hooks (``local_opt`` /
``server_opt`` / ``opt_policy``, :mod:`repro_torch.optim`): the local rule
replaces the ``x - eta g`` descent, a server rule makes global rounds FedOpt
updates (FedAvg + ``fedadam`` is FedAdam), and without rules the state's
``opt`` slot is ``()`` and the round is the inline arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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
from repro_torch.optim.update_rules import (
    UpdateRule,
    apply_updates,
    comm_opt_state,
    init_opt_state,
    server_step,
)
from repro_torch.optim.update_rules import sgd as sgd_rule
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


def _local_steps(step: Callable, carry: Any, local_batches: Tuple) -> Tuple[Any, list]:
    """Run ``step(carry, batch_t) -> (carry, loss, grads)`` over the leading
    (T_o) axis of the local batches (the reference's ``lax.scan``)."""
    losses = []
    for t in range(local_batches[0].shape[0]):
        carry, loss, _ = step(carry, tuple(b[t] for b in local_batches))
        losses.append(loss)
    return carry, losses


def _rules(local_opt: Optional[UpdateRule], server_opt: Optional[UpdateRule], eta: float):
    """``(has_rules, local rule)``: a server rule alone runs the rule path
    with ``sgd(eta)`` as the local rule."""
    has_rules = local_opt is not None or server_opt is not None
    return has_rules, (sgd_rule(eta) if has_rules and local_opt is None else local_opt)


def _rule_step(stacked_vg: Callable, rule: UpdateRule, shift: Optional[Tree] = None) -> Callable:
    """One rule step ``((x, opt), batch) -> ((x, opt), loss, g)``, the
    direction the gradient (plus ``shift``, SCAFFOLD's correction)."""
    def step(carry, batch):
        x, opt = carry
        loss, g = stacked_vg(x, batch)
        upd, opt = rule.update(g if shift is None else tree_add(g, shift), opt, x)
        return (apply_updates(x, upd), opt), loss, g

    return step


def _n_agents(x: Tree) -> int:
    return tree_leaves(x)[0].shape[0]


# ---------------------------------------------------------------------------
# DSGD / Gossip-PGA
# ---------------------------------------------------------------------------


class SGDState(NamedTuple):
    x: Tree
    step: torch.Tensor
    opt: Any = ()  # () without rules, else {"local": ..., "server": ...}


def dsgd_init(loss_fn: LossFn, x0: Tree, batch0: Any,
              local_opt: Optional[UpdateRule] = None,
              server_opt: Optional[UpdateRule] = None) -> SGDState:
    del loss_fn, batch0
    return SGDState(x=x0, step=_step0(x0), opt=init_opt_state(x0, local_opt, server_opt))


def make_dsgd_round_fn(
    loss_fn: LossFn, eta: float, mixing: MixingOps, *, global_round: bool, t_o: int = 1,
    local_opt: Optional[UpdateRule] = None, server_opt: Optional[UpdateRule] = None,
    opt_policy: str = "mix",
) -> Callable:
    """One DSGD round: ``x <- mix(x - eta g)`` (T_o local SGD steps first,
    which with global mixing == FedAvg / local SGD).  With rules the step is
    the local rule's, and a server rule makes the global round FedOpt."""
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    mix = mixing.global_avg if global_round else mixing.gossip
    has_rules, local_opt = _rules(local_opt, server_opt, eta)

    def sgd(x, batch):
        loss, g = stacked_vg(x, batch)
        return tree_map(lambda xi, gi: xi - eta * gi, x, g), loss, g

    def legacy_round_fn(state: SGDState, local_batches, comm_batch):
        x, losses = _local_steps(sgd, state.x, local_batches)
        # one more SGD step on the comm batch, then mix (keeps the same
        # gradient budget per round as PISCO: T_o + 1 evaluations)
        x, loss_c, g_c = sgd(x, comm_batch)
        x = mix(x)
        return SGDState(x=x, step=state.step + 1, opt=state.opt), _metrics(
            _round_loss(losses, loss_c, t_o), g_c, x
        )

    def rule_round_fn(state: SGDState, local_batches, comm_batch):
        sopt = state.opt["server"]
        step = _rule_step(stacked_vg, local_opt)
        carry, losses = _local_steps(step, (state.x, state.opt["local"]), local_batches)
        (x, lopt), loss_c, g_c = step(carry, comm_batch)
        if global_round and server_opt is not None:
            x, sopt = server_step(server_opt, sopt, mix(state.x), mix(x))
        else:
            x = mix(x)
        lopt = comm_opt_state(lopt, mix, _n_agents(state.x), opt_policy, is_global=global_round)
        return SGDState(x=x, step=state.step + 1, opt={"local": lopt, "server": sopt}), \
            _metrics(_round_loss(losses, loss_c, t_o), g_c, x)

    return rule_round_fn if has_rules else legacy_round_fn


# ---------------------------------------------------------------------------
# DSGT [PN21]
# ---------------------------------------------------------------------------


class GTState(NamedTuple):
    x: Tree
    y: Tree
    g: Tree
    step: torch.Tensor
    opt: Any = ()  # () without rules, else {"local": ..., "server": ...}


def dsgt_init(loss_fn: LossFn, x0: Tree, batch0: Any,
              local_opt: Optional[UpdateRule] = None,
              server_opt: Optional[UpdateRule] = None) -> GTState:
    s = pisco_init_state(loss_fn, x0, batch0)
    return GTState(x=s.x, y=s.y, g=s.g, step=s.step,
                   opt=init_opt_state(x0, local_opt, server_opt))


def make_dsgt_round_fn(
    loss_fn: LossFn, eta: float, mixing: MixingOps, *, global_round: bool = False,
    local_opt: Optional[UpdateRule] = None, server_opt: Optional[UpdateRule] = None,
    opt_policy: str = "mix",
) -> Callable:
    """DSGT:  x+ = mix(x - eta y);  y+ = mix(y) + g(x+) - g(x).  With rules
    the tracker step is the local rule's (the y/g recursion, and so Lemma
    1, is untouched)."""
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    mix = mixing.global_avg if global_round else mixing.gossip
    has_rules, local_opt = _rules(local_opt, server_opt, eta)

    def legacy_round_fn(state: GTState, local_batches, comm_batch):
        del local_batches  # DSGT has no local phase; comm_batch is Z^{k+1}
        x_new = mix(tree_map(lambda xi, yi: xi - eta * yi, state.x, state.y))
        loss, g_new = stacked_vg(x_new, comm_batch)
        y_new = tree_add(mix(state.y), tree_sub(g_new, state.g))
        new_state = GTState(x=x_new, y=y_new, g=g_new, step=state.step + 1, opt=state.opt)
        return new_state, _metrics(loss, g_new, x_new)

    def rule_round_fn(state: GTState, local_batches, comm_batch):
        del local_batches
        lopt, sopt = state.opt["local"], state.opt["server"]
        upd, lopt = local_opt.update(state.y, lopt, state.x)
        cand = apply_updates(state.x, upd)
        if global_round and server_opt is not None:
            x_new, sopt = server_step(server_opt, sopt, mix(state.x), mix(cand))
        else:
            x_new = mix(cand)
        loss, g_new = stacked_vg(x_new, comm_batch)
        y_new = tree_add(mix(state.y), tree_sub(g_new, state.g))
        lopt = comm_opt_state(lopt, mix, _n_agents(state.x), opt_policy, is_global=global_round)
        new_state = GTState(x=x_new, y=y_new, g=g_new, step=state.step + 1,
                            opt={"local": lopt, "server": sopt})
        return new_state, _metrics(loss, g_new, x_new)

    return rule_round_fn if has_rules else legacy_round_fn


# ---------------------------------------------------------------------------
# Periodical-GT (PISCO p=0 named wrapper)
# ---------------------------------------------------------------------------


def make_periodical_gt_round_fn(
    loss_fn: LossFn, cfg: PiscoConfig, mixing: MixingOps, *,
    local_opt: Optional[UpdateRule] = None, server_opt: Optional[UpdateRule] = None,
    opt_policy: str = "mix",
) -> Callable:
    """[LLKS24]: gradient tracking with T_o local steps, gossip every round —
    exactly PISCO's gossip round (Remark 1).  The state carries no error-
    feedback residuals, so compressed mixing runs through the stateless path."""
    return make_round_fn(loss_fn, cfg, mixing, global_round=False, use_ef=False,
                         local_opt=local_opt, server_opt=server_opt, opt_policy=opt_policy)


# ---------------------------------------------------------------------------
# SCAFFOLD [KKM+20] (option II control variates)
# ---------------------------------------------------------------------------


class ScaffoldState(NamedTuple):
    x: Tree  # agent-stacked copies of the server model (kept in sync)
    c_i: Tree  # agent control variates (stacked)
    c: Tree  # server control variate (stacked-broadcast for layout parity)
    step: torch.Tensor
    opt: Any = ()  # () without rules, else {"local": ..., "server": ...}


def scaffold_init(loss_fn: LossFn, x0: Tree, batch0: Any,
                  local_opt: Optional[UpdateRule] = None,
                  server_opt: Optional[UpdateRule] = None) -> ScaffoldState:
    _, g0 = make_stacked_value_and_grad(loss_fn)(x0, batch0)
    return ScaffoldState(x=x0, c_i=g0, c=tree_agent_mean(g0), step=_step0(x0),
                         opt=init_opt_state(x0, local_opt, server_opt))


def make_scaffold_round_fn(
    loss_fn: LossFn, eta_l: float, eta_g: float, t_o: int, mixing: MixingOps, *,
    local_opt: Optional[UpdateRule] = None, server_opt: Optional[UpdateRule] = None,
    opt_policy: str = "reset",
) -> Callable:
    """SCAFFOLD round (always agent-to-server; the federated anchor of Table 2).

    Local:  x <- x - eta_l (g_i(x) - c_i + c), T_o+1 steps.
    Then:   c_i+ = c_i - c + (x_k - x_To) / ((T_o+1) eta_l)
            x+   = x_k + eta_g * mean(x_To - x_k);  c+ = mean(c_i+)

    With rules the local rule descends along ``g_i + (c - c_i)``; the
    variate update keeps the form above, and a server rule replaces the
    eta_g step with a FedOpt update on the round pseudo-gradient.
    """
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    g_avg = mixing.global_avg
    steps = (t_o + 1) * eta_l
    has_rules, local_opt = _rules(local_opt, server_opt, eta_l)

    def variates_and_server(state, x_to, sopt):
        c_i_new = tree_map(
            lambda ci, c, xk, xt: ci - c + (xk - xt) / steps,
            state.c_i, state.c, state.x, x_to,
        )
        if server_opt is not None:
            x_new, sopt = server_step(server_opt, sopt, state.x, g_avg(x_to))
        else:
            delta = g_avg(tree_sub(x_to, state.x))
            x_new = tree_map(lambda xk, d: xk + eta_g * d, state.x, delta)
        return c_i_new, g_avg(c_i_new), x_new, sopt

    def legacy_round_fn(state: ScaffoldState, local_batches, comm_batch):
        correction = tree_sub(state.c, state.c_i)

        def step(x, batch):
            loss, g = stacked_vg(x, batch)
            x = tree_map(lambda xi, gi, ci: xi - eta_l * (gi + ci), x, g, correction)
            return x, loss, g

        x_to, losses = _local_steps(step, state.x, local_batches)
        x_to, loss_c, g_c = step(x_to, comm_batch)
        c_i_new, c_new, x_new, _ = variates_and_server(state, x_to, None)
        new_state = ScaffoldState(x=x_new, c_i=c_i_new, c=c_new, step=state.step + 1,
                                  opt=state.opt)
        return new_state, _metrics(_round_loss(losses, loss_c, t_o), g_c, x_new)

    def rule_round_fn(state: ScaffoldState, local_batches, comm_batch):
        step = _rule_step(stacked_vg, local_opt, tree_sub(state.c, state.c_i))
        carry, losses = _local_steps(step, (state.x, state.opt["local"]), local_batches)
        (x_to, lopt), loss_c, g_c = step(carry, comm_batch)
        c_i_new, c_new, x_new, sopt = variates_and_server(state, x_to, state.opt["server"])
        lopt = comm_opt_state(lopt, g_avg, _n_agents(state.x), opt_policy, is_global=True)
        new_state = ScaffoldState(x=x_new, c_i=c_i_new, c=c_new, step=state.step + 1,
                                  opt={"local": lopt, "server": sopt})
        return new_state, _metrics(_round_loss(losses, loss_c, t_o), g_c, x_new)

    return rule_round_fn if has_rules else legacy_round_fn


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
