"""Algorithm registry — the experiment-facing protocol layer.

Each protocol (PISCO and the paper's six baselines) is one
:class:`Algorithm` entry:

* a **builder** closing the round functions over ``(loss_fn, cfg, mixing)``,
* a declarative **default schedule** (``"bernoulli"`` / ``"never"`` /
  ``"always"`` / ``"periodic"`` — line 8 of Algorithm 1 and its degenerate
  cases), and
* a :class:`CommProfile` pricing its traffic as data, re-priced at bind
  time when update rules are bound (a server rule ships one more payload,
  the "mix" policy moves each params-shaped rule buffer with the model).

Round-function contract::

    init(loss_fn, x0_stacked, comm_batch0) -> state
    round_fn(state, local_batches, comm_batch) -> (state, RoundMetrics)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import baselines as B
from repro_torch.core.mixing import MixingOps
from repro_torch.core.pisco import (
    LossFn,
    PiscoConfig,
    init_compression_state,
    init_state,
    make_round_fn,
)
from repro_torch.core.schedule import (
    AlwaysSchedule,
    NeverSchedule,
    PeriodicSchedule,
    make_schedule,
)
from repro_torch.optim.update_rules import OPT_POLICIES, UpdateRule, parse_update_rule

# builder(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0
#         [, local_opt=None, server_opt=None, opt_policy="..."])
#   -> (init, gossip_round, global_round); the rule kwargs are passed only
# when rules are bound
Builder = Callable[..., Tuple[Callable, Callable, Callable]]

SCHEDULE_KINDS = ("bernoulli", "never", "always", "periodic")


@dataclasses.dataclass(frozen=True)
class CommProfile:
    """Per-protocol communication cost, priced as data.

    ``mixes_per_round``   — mixing invocations per communication round; each
                            gossip mix moves one message per directed edge.
    ``server_payloads``   — payloads one agent moves per direction of a server
                            exchange (model only = 1; model + control variate
                            or tracking stream = 2).
    ``server_based``      — every communication round is agent-to-server.
    ``uses_local_updates``— the protocol consumes the T_o local batches.
    """

    mixes_per_round: int = 1
    server_payloads: int = 1
    server_based: bool = False
    uses_local_updates: bool = True


@dataclasses.dataclass(frozen=True)
class BoundAlgorithm:
    """An :class:`Algorithm` closed over ``(loss_fn, cfg, mixing)`` — what the
    round drivers run."""

    name: str
    init: Callable[[LossFn, Any, Any], Any]
    gossip_round: Callable
    global_round: Callable
    schedule: Callable[[int], bool]
    comm: CommProfile
    # the mixer's NetworkContext on a dynamic network (the drivers draw and
    # stage each round's operands through it); None: a frozen network
    network: Optional[Any] = None
    # the update rules this binding runs (None/None: the inline SGD) and the
    # opt-state communication policy
    local_opt: Optional[UpdateRule] = None
    server_opt: Optional[UpdateRule] = None
    opt_policy: str = "mix"


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """One registry entry: builder + declarative schedule + comm profile.

    ``avg_period`` (periodic schedules only) is the server-averaging period H
    used when ``cfg.p == 0`` gives no implied period; when ``cfg.p > 0`` the
    period is ``round(1/p)``, so a Bernoulli(p) PISCO run and a periodic
    baseline spend the same expected server budget."""

    name: str
    build: Builder
    comm: CommProfile = CommProfile()
    schedule: str = "bernoulli"
    avg_period: int = 10
    description: str = ""
    # default update rules as strings parsed at bind time (None: the inline
    # SGD), and what the rule buffers do at communication rounds
    local_opt: Optional[str] = None
    server_opt: Optional[str] = None
    opt_policy: str = "mix"

    def __post_init__(self):
        if self.schedule not in SCHEDULE_KINDS:
            raise ValueError(f"schedule {self.schedule!r} not in {SCHEDULE_KINDS}")
        if self.opt_policy not in OPT_POLICIES:
            raise ValueError(f"opt_policy {self.opt_policy!r} not in {OPT_POLICIES}")

    def make_default_schedule(self, cfg: PiscoConfig):
        if self.schedule == "never":
            return NeverSchedule()
        if self.schedule == "always":
            return AlwaysSchedule()
        if self.schedule == "periodic":
            return PeriodicSchedule(
                max(1, int(round(1.0 / cfg.p))) if cfg.p > 0 else self.avg_period
            )
        return make_schedule(cfg.p, cfg.seed)

    def bind(
        self,
        loss_fn: LossFn,
        cfg: PiscoConfig,
        mixing: MixingOps,
        *,
        eta: Optional[float] = None,
        eta_g: float = 1.0,
        schedule: Optional[Callable[[int], bool]] = None,
        local_opt: Optional[Any] = None,
        server_opt: Optional[Any] = None,
        opt_policy: Optional[str] = None,
    ) -> BoundAlgorithm:
        """Close the algorithm over a concrete problem; ``eta`` overrides the
        baselines' step size (default ``cfg.eta_l``), ``eta_g`` is SCAFFOLD's
        server step, and ``schedule`` overrides the declarative default.

        ``local_opt`` / ``server_opt`` (an :class:`UpdateRule` or its string)
        override the entry's default rules; with neither, the inline SGD
        runs.  Bound rules re-price the comm profile: a server rule ships
        one more payload per direction, and under the "mix" policy each
        params-shaped rule buffer adds a mix and a server payload."""
        lo = local_opt if local_opt is not None else self.local_opt
        so = server_opt if server_opt is not None else self.server_opt
        policy = opt_policy if opt_policy is not None else self.opt_policy
        if policy not in OPT_POLICIES:
            raise ValueError(f"opt_policy {policy!r} not in {OPT_POLICIES}")
        lr = cfg.eta_l if eta is None else eta
        if isinstance(lo, str):
            lo = parse_update_rule(lo, lr=lr)
        if isinstance(so, str):
            so = parse_update_rule(so, lr=eta_g)
        if so is not None and lo is None:
            # a server rule alone runs the rule path with the default local rule
            lo = parse_update_rule("sgd", lr=lr)
        opt_kw, comm = {}, self.comm
        if lo is not None or so is not None:
            opt_kw = dict(local_opt=lo, server_opt=so, opt_policy=policy)
            if so is not None:
                comm = dataclasses.replace(comm, server_payloads=comm.server_payloads + 1)
            if lo.n_buffers and policy == "mix":
                comm = dataclasses.replace(
                    comm,
                    mixes_per_round=comm.mixes_per_round + lo.n_buffers,
                    server_payloads=comm.server_payloads + lo.n_buffers,
                )
        init, gossip, glob = self.build(loss_fn, cfg, mixing, eta=eta, eta_g=eta_g, **opt_kw)
        return BoundAlgorithm(
            name=self.name,
            init=init,
            gossip_round=gossip,
            global_round=glob,
            schedule=schedule if schedule is not None else self.make_default_schedule(cfg),
            comm=comm,
            network=mixing.network,
            local_opt=lo,
            server_opt=so,
            opt_policy=policy,
        )


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(
    name: str,
    *,
    mixes_per_round: int = 1,
    server_payloads: Optional[int] = None,
    server_based: bool = False,
    uses_local_updates: bool = True,
    schedule: str = "bernoulli",
    avg_period: int = 10,
    local_opt: Optional[str] = None,
    server_opt: Optional[str] = None,
    opt_policy: str = "mix",
    description: str = "",
) -> Callable[[Builder], Builder]:
    """Decorator registering a builder under ``name``; ``server_payloads``
    defaults to ``mixes_per_round``; ``local_opt`` / ``server_opt`` are
    default rule strings and ``opt_policy`` the entry's buffer policy."""

    def deco(build: Builder) -> Builder:
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered")
        _REGISTRY[name] = Algorithm(
            name=name,
            build=build,
            comm=CommProfile(
                mixes_per_round=mixes_per_round,
                server_payloads=(
                    mixes_per_round if server_payloads is None else server_payloads
                ),
                server_based=server_based,
                uses_local_updates=uses_local_updates,
            ),
            schedule=schedule,
            avg_period=avg_period,
            local_opt=local_opt,
            server_opt=server_opt,
            opt_policy=opt_policy,
            description=description or (build.__doc__ or "").strip(),
        )
        return build

    return deco


def unregister_algorithm(name: str) -> None:
    """Remove a registry entry (tests, plugin reload)."""
    _REGISTRY.pop(name, None)


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def registered_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# The paper's seven protocols
# ---------------------------------------------------------------------------


def _rule_kw(local_opt, server_opt, opt_policy) -> dict:
    return dict(local_opt=local_opt, server_opt=server_opt, opt_policy=opt_policy)


@register_algorithm(
    "pisco",
    mixes_per_round=2,
    description="PISCO (Algorithm 1): tracked local updates + Bernoulli(p) server",
)
def _build_pisco(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                 local_opt=None, server_opt=None, opt_policy="mix"):
    kw = _rule_kw(local_opt, server_opt, opt_policy)
    return (
        lambda lf, x0, b0: init_compression_state(
            init_state(lf, x0, b0, local_opt, server_opt), mixing),
        make_round_fn(loss_fn, cfg, mixing, global_round=False, **kw),
        make_round_fn(loss_fn, cfg, mixing, global_round=True, **kw),
    )


@register_algorithm(
    "periodical_gt",
    mixes_per_round=2,
    schedule="never",
    description="Periodical-GT [LLKS24]: PISCO with p = 0 (gossip every round)",
)
def _build_periodical_gt(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                         local_opt=None, server_opt=None, opt_policy="mix"):
    fn = B.make_periodical_gt_round_fn(loss_fn, cfg, mixing,
                                       **_rule_kw(local_opt, server_opt, opt_policy))
    return lambda lf, x0, b0: init_state(lf, x0, b0, local_opt, server_opt), fn, fn


@register_algorithm(
    "dsgt",
    mixes_per_round=2,
    uses_local_updates=False,
    description="DSGT [PN21]: gradient tracking, one step per round",
)
def _build_dsgt(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                local_opt=None, server_opt=None, opt_policy="mix"):
    eta = cfg.eta_l if eta is None else eta
    kw = _rule_kw(local_opt, server_opt, opt_policy)
    return (
        lambda lf, x0, b0: B.dsgt_init(lf, x0, b0, local_opt, server_opt),
        B.make_dsgt_round_fn(loss_fn, eta, mixing, global_round=False, **kw),
        B.make_dsgt_round_fn(loss_fn, eta, mixing, global_round=True, **kw),
    )


def _build_dsgd_family(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                       local_opt=None, server_opt=None, opt_policy="mix"):
    eta = cfg.eta_l if eta is None else eta
    kw = _rule_kw(local_opt, server_opt, opt_policy)
    return (
        lambda lf, x0, b0: B.dsgd_init(lf, x0, b0, local_opt, server_opt),
        B.make_dsgd_round_fn(loss_fn, eta, mixing, global_round=False, t_o=cfg.t_o, **kw),
        B.make_dsgd_round_fn(loss_fn, eta, mixing, global_round=True, t_o=cfg.t_o, **kw),
    )


register_algorithm(
    "dsgd",
    mixes_per_round=1,
    uses_local_updates=False,
    schedule="never",
    description="DSGD [NO09]: gossip SGD",
)(_build_dsgd_family)

register_algorithm(
    "gossip_pga",
    mixes_per_round=1,
    uses_local_updates=False,
    schedule="periodic",
    avg_period=10,
    description="Gossip-PGA [CYZ+21]: gossip SGD + periodic global averaging",
)(_build_dsgd_family)


@register_algorithm(
    "fedavg",
    mixes_per_round=1,
    server_based=True,
    schedule="always",
    opt_policy="reset",
    description="FedAvg [MMR+17]: local SGD + server averaging every round",
)
def _build_fedavg(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                  local_opt=None, server_opt=None, opt_policy="reset"):
    eta = cfg.eta_l if eta is None else eta
    fn = B.make_dsgd_round_fn(loss_fn, eta, mixing, global_round=True, t_o=cfg.t_o,
                              **_rule_kw(local_opt, server_opt, opt_policy))
    return lambda lf, x0, b0: B.dsgd_init(lf, x0, b0, local_opt, server_opt), fn, fn


@register_algorithm(
    "scaffold",
    mixes_per_round=2,
    server_based=True,
    schedule="always",
    opt_policy="reset",
    description="SCAFFOLD [KKM+20]: model + control variate per server exchange",
)
def _build_scaffold(loss_fn, cfg, mixing, *, eta=None, eta_g=1.0,
                    local_opt=None, server_opt=None, opt_policy="reset"):
    fn = B.make_scaffold_round_fn(loss_fn, cfg.eta_l, eta_g, cfg.t_o, mixing,
                                  **_rule_kw(local_opt, server_opt, opt_policy))
    return lambda lf, x0, b0: B.scaffold_init(lf, x0, b0, local_opt, server_opt), fn, fn
