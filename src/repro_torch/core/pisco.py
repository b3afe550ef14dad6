"""PISCO — Algorithm 1 of the paper over agent-stacked dicts of tensors.

One communication round k (two stages):

  Stage 1 — T_o *local* tracked-SGD steps, zero communication (eq. 3a-3c):
      X^{k+1,t} = X^{k+1,t-1} - eta_l * Y^{k+1,t-1}
      G^{k+1,t} = stochastic grads at X^{k+1,t}
      Y^{k+1,t} = Y^{k+1,t-1} + G^{k+1,t} - G^{k+1,t-1}

  Stage 2 — one mixing round with W^k = J w.p. p else W (eq. 4a-4c):
      X^{k+1} = ((1-eta_c) X^k + eta_c (X^{k+1,T_o} - eta_l Y^{k+1,T_o})) W^k
      G^{k+1} = stochastic grads at X^{k+1} on a fresh batch
      Y^{k+1} = (Y^{k+1,T_o} + G^{k+1} - G^{k+1,T_o}) W^k

Stage 1 runs on the fused track-step kernel
(:func:`repro_torch.kernels.gt_update.fused_track_step`): after the first
(3a), each step's (3c) is fused with the next step's (3a), and the last one
leaves exactly the ``X^{T_o} - eta_l Y^{T_o}`` term of (4a).

The W^k draw is made by the host driver.  State invariant (Lemma 1):
mean_i y_i == mean_i g_i at every round.

Update rules: with ``local_opt`` / ``server_opt`` bound
(:mod:`repro_torch.optim`), the tracker Y is the descent direction of a
pluggable rule (momentum, Adam, clipped or scheduled chains) in plain tensor
code, and a server rule makes global rounds FedOpt updates from the averaged
previous iterate.  ``sgd`` reproduces the inline arithmetic bit for bit
(``x + (-eta_l y)`` is ``x - eta_l y``: K1 rounds the product before the
subtraction).  Without rules the state's ``opt`` slot is ``()`` and the
round is the inline form above.

Two layouts.  :func:`make_round_fn` runs every agent in one process over
agent-stacked leaves (the per-agent gradients vmapped).
:func:`make_rank_round_fn` runs one agent per rank of a collective mixer
(:mod:`repro_torch.launch.mesh`): the state holds this rank's own leaves, a
flat dict keyed by leaf path, and the gradients come from the model's own
value-and-grad (vmap does not compose with an LM under activation
checkpointing).  On a one-axis ring without compression its x-gossip sends
the candidate and combines it through the fused kernel (K8,
:func:`repro_torch.core.mixing.mix_candidate`); y's gossip, a torus and
compressed gossip use the mixer's own combine, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.mixing import MixingOps, mix_candidate, ring_of
from repro_torch.kernels.gt_update import fused_track_step
from repro_torch.optim.update_rules import (
    UpdateRule,
    apply_updates,
    comm_opt_state,
    init_opt_state,
    server_step,
)
from repro_torch.optim.update_rules import sgd as sgd_rule
from repro_torch.utils.pytree import tree_add, tree_map, tree_sq_norm, tree_sub

Tree = Dict[str, torch.Tensor]
# loss_fn(params, batch) -> scalar loss for ONE agent.
LossFn = Callable[[Tree, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PiscoConfig:
    """Hyper-parameters of Algorithm 1."""

    n_agents: int
    t_o: int = 1  # number of local updates per round (T_o)
    eta_l: float = 0.05  # local-update step size
    eta_c: float = 1.0  # communication step size
    p: float = 0.1  # agent-to-server probability
    seed: int = 0

    def __post_init__(self):
        if self.t_o < 1:
            raise ValueError("T_o >= 1 (at least one local update)")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")


class PiscoState(NamedTuple):
    """Agent-stacked algorithm state (leading axis = n_agents on every leaf)."""

    x: Tree  # model estimates X^k
    y: Tree  # gradient-tracking variables Y^k
    g: Tree  # last stochastic gradients G^k
    step: torch.Tensor  # round counter k
    # () when compression is off, else {"x": residual, "y": residual,
    # "gen": torch.Generator} from CompressedGossip.init_ef.
    ef: Any = ()
    # () without update rules, else {"local": agent-stacked rule state,
    # "server": server-rule state or ()} from optim.init_opt_state.
    opt: Any = ()


class RoundMetrics(NamedTuple):
    loss: torch.Tensor  # mean over agents & local steps
    grad_sq_norm: torch.Tensor  # ||mean_i g_i||^2 (tracked-gradient proxy)
    consensus_err: torch.Tensor  # ||X - X_bar||_F^2 / n


def make_stacked_value_and_grad(loss_fn: LossFn) -> Callable:
    """``vg(params, batch) -> (losses (n,), grads)``: value-and-grad vmapped
    over the agent axis — each agent its own params slice and batch slice."""
    gv = vmap(grad_and_value(loss_fn), in_dims=(0, 0))

    def vg(params: Tree, batch):
        grads, loss = gv(params, batch)
        return loss, grads

    return vg


def init_state(loss_fn: LossFn, x0: Tree, batch0: Any,
               local_opt: Optional[UpdateRule] = None,
               server_opt: Optional[UpdateRule] = None) -> PiscoState:
    """Line 2: draw Z^0 and set Y^0 = G^0 = grads(X^0; Z^0).  ``x0`` must
    already be agent-stacked; bound rules attach their state up front."""
    _, g0 = make_stacked_value_and_grad(loss_fn)(x0, batch0)
    step = torch.zeros((), dtype=torch.int32, device=next(iter(x0.values())).device)
    return PiscoState(x=x0, y=g0, g=g0, step=step,
                      opt=init_opt_state(x0, local_opt, server_opt))


def init_compression_state(state: PiscoState, mixing: MixingOps) -> PiscoState:
    """Attach error-feedback residuals and the noise generator when
    ``mixing`` carries a compressor (no-op otherwise)."""
    if mixing.compression is None:
        return state
    return state._replace(ef=mixing.compression.init_ef(state.x))


def replicate_params(params: Tree, n_agents: int) -> Tree:
    """X^0 = x^0 1_n^T — identical start for all agents (materialised)."""
    return tree_map(
        lambda p: p[None].expand((n_agents,) + tuple(p.shape)).contiguous(), params
    )


def _batch_at(batches, t: int):
    """Local step ``t``'s batch: a tuple of tensors or a dict of them, each
    with the T_o axis first."""
    if isinstance(batches, dict):
        return {k: v[t] for k, v in batches.items()}
    return tuple(b[t] for b in batches)


def _local_phase(
    stacked_vg: Callable, state: PiscoState, local_batches, eta_l: float
) -> Tuple[Tree, Tree, Tree, torch.Tensor]:
    """Stage 1.  Returns ``(X^{T_o} - eta_l Y^{T_o}, Y^{T_o}, G^{T_o},
    mean loss)`` — the first output is the (4a) term, left by the fused
    track step of the last iteration."""
    x = tree_map(lambda xi, yi: xi - eta_l * yi, state.x, state.y)  # first (3a)
    y, g = state.y, state.g
    losses = []
    for t in range(_n_steps(local_batches)):
        loss, g_new = stacked_vg(x, _batch_at(local_batches, t))  # (3b)
        losses.append(torch.mean(loss))
        # (3c) of step t fused with (3a) of step t+1
        stepped = tree_map(
            lambda xi, yi, gn, go: fused_track_step(xi, yi, gn, go, eta_l),
            x, y, g_new, g,
        )
        x = {k: v[0] for k, v in stepped.items()}
        y = {k: v[1] for k, v in stepped.items()}
        g = g_new
    return x, y, g, torch.mean(torch.stack(losses))


def _local_phase_rule(
    stacked_vg: Callable, state: PiscoState, local_batches, rule: UpdateRule, opt0: Any
) -> Tuple[Tree, Tree, Tree, Any, torch.Tensor]:
    """Stage 1 with an update rule: the tracker Y is the descent direction
    of (3a), the rule turns it into a step.  Returns ``(X^{T_o}, Y^{T_o},
    G^{T_o}, rule state, mean loss)``."""
    x, y, g, opt = state.x, state.y, state.g, opt0
    losses = []
    for t in range(_n_steps(local_batches)):
        upd, opt = rule.update(y, opt, x)  # (3a): direction = tracker
        x = apply_updates(x, upd)
        loss, g_new = stacked_vg(x, _batch_at(local_batches, t))  # (3b)
        losses.append(torch.mean(loss))
        y = tree_add(y, tree_sub(g_new, g))  # (3c)
        g = g_new
    return x, y, g, opt, torch.mean(torch.stack(losses))


def _n_steps(local_batches) -> int:
    first = next(iter(local_batches.values())) if isinstance(local_batches, dict) \
        else local_batches[0]
    return first.shape[0]


def _consensus_error(x: Tree) -> torch.Tensor:
    errs = [torch.sum((v - v.mean(dim=0, keepdim=True)) ** 2) for v in x.values()]
    out = errs[0]
    for e in errs[1:]:
        out = out + e
    return out


def _round_metrics(cfg: PiscoConfig, mean_loss, loss_c, g_new, x_new) -> RoundMetrics:
    gbar = tree_map(lambda v: v.mean(dim=0), g_new)
    return RoundMetrics(
        loss=(mean_loss * cfg.t_o + torch.mean(loss_c)) / (cfg.t_o + 1),
        grad_sq_norm=tree_sq_norm(gbar),
        consensus_err=_consensus_error(x_new) / cfg.n_agents,
    )


def make_round_fn(
    loss_fn: LossFn,
    cfg: PiscoConfig,
    mixing: MixingOps,
    *,
    global_round: bool,
    use_ef: bool = True,
    local_opt: Optional[UpdateRule] = None,
    server_opt: Optional[UpdateRule] = None,
    opt_policy: str = "mix",
) -> Callable[[PiscoState, Any, Any], Tuple[PiscoState, RoundMetrics]]:
    """One PISCO round for a fixed W^k kind (the driver dispatches between
    the gossip and the global form per its host-side Bernoulli(p) draw).

    ``local_opt`` / ``server_opt`` bind update rules: the local rule steps
    along the tracker, ``opt_policy`` ("mix", "keep", "reset") decides what
    its agent-stacked buffers do at this round, and on global rounds the
    server rule turns the averaged iterate into a FedOpt update.  Both None
    runs the inline arithmetic with an empty ``opt`` slot; otherwise
    ``state`` must come from :func:`init_state` with the same rules.

    With a compressor attached, a gossip round's two mixes go through the
    stateful error-feedback path (residuals and generator in ``state.ef``).
    ``use_ef=False`` forces the stateless compressed gossip instead, for
    states that carry no residuals (periodical GT in
    :mod:`repro_torch.core.baselines`).

    Args to the returned fn:
      state:         PiscoState
      local_batches: tuple of tensors with leading axes (T_o, n_agents, ...)
      comm_batch:    tuple of tensors (n_agents, ...) — the fresh Z^{k+1}
    """
    stacked_vg = make_stacked_value_and_grad(loss_fn)
    mix = mixing.global_avg if global_round else mixing.gossip
    compressed = mixing.compression is not None and not global_round and use_ef
    has_rules = local_opt is not None or server_opt is not None
    if has_rules and local_opt is None:
        local_opt = sgd_rule(cfg.eta_l)

    def mix_streams(state, cand, y_to, g_to, comm_batch, server=None):
        """(4a)-(4c) from the candidate: ``(x_new, y_new, g_new, loss_c,
        ef, server state)``; ``server`` is ``(rule, state)`` on a FedOpt
        server round, else None (and so is the state returned)."""
        ef, sopt = state.ef, None
        if compressed:
            cg = mixing.compression
            x_new, res_x = cg(cand, ef["x"], ef["gen"])
            loss_c, g_new = stacked_vg(x_new, comm_batch)  # (4b)
            # (4c) compressed: the difference form preserves the agent mean,
            # so Lemma 1 (mean Y == mean G) survives exactly.
            y_new, res_y = cg(tree_add(y_to, tree_sub(g_new, g_to)), ef["y"], ef["gen"])
            ef = {"x": res_x, "y": res_y, "gen": ef["gen"]}
        else:
            if server is not None:
                # FedOpt: descend from the averaged previous iterate along
                # the round pseudo-gradient
                x_new, sopt = server_step(server[0], server[1], mix(state.x), mix(cand))
            else:
                x_new = mix(cand)
            loss_c, g_new = stacked_vg(x_new, comm_batch)  # (4b)
            y_new = mix(tree_add(y_to, tree_sub(g_new, g_to)))  # (4c)
        return x_new, y_new, g_new, loss_c, ef, sopt

    def legacy_round_fn(state: PiscoState, local_batches, comm_batch):
        x_half, y_to, g_to, mean_loss = _local_phase(
            stacked_vg, state, local_batches, cfg.eta_l
        )
        # (4a): X^{k+1} = ((1-eta_c) X^k + eta_c (X^{T_o} - eta_l Y^{T_o})) W^k
        cand = tree_map(
            lambda xk, h: (1.0 - cfg.eta_c) * xk + cfg.eta_c * h, state.x, x_half
        )
        x_new, y_new, g_new, loss_c, ef, _ = mix_streams(state, cand, y_to, g_to, comm_batch)
        new_state = PiscoState(x=x_new, y=y_new, g=g_new, step=state.step + 1, ef=ef,
                               opt=state.opt)
        return new_state, _round_metrics(cfg, mean_loss, loss_c, g_new, x_new)

    def rule_round_fn(state: PiscoState, local_batches, comm_batch):
        lopt, sopt = state.opt["local"], state.opt["server"]
        x_to, y_to, g_to, lopt, mean_loss = _local_phase_rule(
            stacked_vg, state, local_batches, local_opt, lopt
        )
        # (4a) generalized: one more rule step along the tracker gives the
        # communicated point; eta_c interpolates against X^k as before
        upd, lopt = local_opt.update(y_to, lopt, x_to)
        half = apply_updates(x_to, upd)
        cand = tree_map(lambda xk, h: (1.0 - cfg.eta_c) * xk + cfg.eta_c * h, state.x, half)
        server = (server_opt, sopt) if global_round and server_opt is not None else None
        x_new, y_new, g_new, loss_c, ef, stepped = mix_streams(
            state, cand, y_to, g_to, comm_batch, server)
        sopt = sopt if server is None else stepped
        lopt = comm_opt_state(lopt, mix, cfg.n_agents, opt_policy, is_global=global_round)
        new_state = PiscoState(x=x_new, y=y_new, g=g_new, step=state.step + 1, ef=ef,
                               opt={"local": lopt, "server": sopt})
        return new_state, _round_metrics(cfg, mean_loss, loss_c, g_new, x_new)

    return rule_round_fn if has_rules else legacy_round_fn


# ---------------------------------------------------------------------------
# One agent per rank (collective mixers)
# ---------------------------------------------------------------------------


def init_rank_state(value_and_grad: Callable, x0: Tree, batch0: Any) -> PiscoState:
    """Line 2 for this rank's agent: Y^0 = G^0 = grads(x0; Z^0).
    ``value_and_grad(params, batch) -> (loss, grads)`` over flat dicts."""
    _, g0 = value_and_grad(x0, batch0)
    step = torch.zeros((), dtype=torch.int32, device=next(iter(x0.values())).device)
    return PiscoState(x=x0, y=g0, g=g0, step=step)


def make_rank_round_fn(
    value_and_grad: Callable,
    cfg: PiscoConfig,
    mixing: MixingOps,
    *,
    global_round: bool,
) -> Callable[[PiscoState, Any, Any], Tuple[PiscoState, torch.Tensor]]:
    """One PISCO round of this rank's agent over a collective mixer (every
    rank calls it with its own state and batches).

    ``value_and_grad(params, batch) -> (loss, grads)`` over flat dicts of
    this agent's leaves.  Batches are this agent's: ``local_batches`` with
    the T_o axis first, ``comm_batch`` the fresh Z^{k+1}.  Returns the new
    state and this agent's round loss ``(T_o * mean local loss + comm loss)
    / (T_o + 1)`` (the reference's metric before its mean over agents).

    The mesh's clock, when on, charges the round's phases: "local" (every
    gradient call and the local steps), "mix" (the two mixes, which include
    the mesh's "exchange").

    Under a Byzantine adversary (:func:`repro_torch.core.adversary.make_adversarial_mixing`)
    the round hands its index, the state's step, to the mixing's
    adversarial network before it mixes, so that ``random`` corruption is
    pure in (seed, round, leaf)."""
    mix = mixing.global_avg if global_round else mixing.gossip
    compressed = mixing.compression is not None and not global_round
    fused_x = not global_round and mixing.compression is None and ring_of(mixing) is not None
    mesh = mixing.mesh
    adversarial = getattr(mixing.network, "adversarial", False)

    def span(name: str):
        return mesh.clock.span(name, mesh.device)

    def round_fn(state: PiscoState, local_batches, comm_batch):
        ef = state.ef
        if adversarial:
            mixing.network.k = int(state.step)
        with span("local"):
            x_half, y_to, g_to, mean_loss = _local_phase(
                value_and_grad, state, local_batches, cfg.eta_l)
        with span("mix"):  # (4a)
            if fused_x:
                x_new = mix_candidate(mixing, state.x, x_half, cfg.eta_c)
            else:
                cand = tree_map(lambda xk, h: (1.0 - cfg.eta_c) * xk + cfg.eta_c * h,
                                state.x, x_half)
                if compressed:
                    x_new, res_x = mixing.compression(cand, ef["x"], ef["gen"])
                else:
                    x_new = mix(cand)
                del cand
        del x_half
        with span("local"):
            loss_c, g_new = value_and_grad(x_new, comm_batch)  # (4b)
        with span("mix"):  # (4c)
            tracked = tree_add(y_to, tree_sub(g_new, g_to))
            del y_to, g_to
            if compressed:
                y_new, res_y = mixing.compression(tracked, ef["y"], ef["gen"])
                ef = {"x": res_x, "y": res_y, "gen": ef["gen"]}
            else:
                y_new = mix(tracked)
        new_state = PiscoState(x=x_new, y=y_new, g=g_new, step=state.step + 1, ef=ef)
        return new_state, (mean_loss * cfg.t_o + loss_c) / (cfg.t_o + 1)

    return round_fn


def decentralized_config(cfg: PiscoConfig) -> PiscoConfig:
    """Remark 1: p = 0, fully decentralized PISCO (gossip only)."""
    return dataclasses.replace(cfg, p=0.0)


def federated_config(cfg: PiscoConfig) -> PiscoConfig:
    """Remark 2: p = 1, federated PISCO (a server round every round)."""
    return dataclasses.replace(cfg, p=1.0)
