"""Algorithm registry — the experiment-facing protocol layer.

Each protocol is one :class:`Algorithm` entry: a builder closing the round
functions over ``(loss_fn, cfg, mixing)`` and a :class:`CommProfile` pricing
its traffic as data.  Only PISCO is ported; the baselines of the reference
registry (DSGD, DSGT, Gossip-PGA, periodical GT, FedAvg, SCAFFOLD) raise
``NotImplementedError``.

Round-function contract::

    init(loss_fn, x0_stacked, comm_batch0) -> state
    round_fn(state, local_batches, comm_batch) -> (state, RoundMetrics)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.core.mixing import MixingOps
from repro_torch.core.pisco import (
    LossFn,
    PiscoConfig,
    init_compression_state,
    init_state,
    make_round_fn,
)
from repro_torch.core.schedule import make_schedule

Builder = Callable[..., Tuple[Callable, Callable, Callable]]

# Registered in the reference, waiting for ROADMAP A6 (baselines).
NOT_PORTED = ("periodical_gt", "dsgt", "dsgd", "gossip_pga", "fedavg", "scaffold")


@dataclasses.dataclass(frozen=True)
class CommProfile:
    """Per-protocol communication cost, priced as data.

    ``mixes_per_round``   — mixing invocations per communication round.
    ``server_payloads``   — payloads per direction of a server exchange.
    """

    mixes_per_round: int = 1
    server_payloads: int = 1


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


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """One registry entry: builder + comm profile; the schedule is line 8 of
    Algorithm 1, Bernoulli(p) from the config's seed."""

    name: str
    build: Builder
    comm: CommProfile = CommProfile()
    description: str = ""

    def bind(self, loss_fn: LossFn, cfg: PiscoConfig, mixing: MixingOps) -> BoundAlgorithm:
        init, gossip, glob = self.build(loss_fn, cfg, mixing)
        return BoundAlgorithm(
            name=self.name,
            init=init,
            gossip_round=gossip,
            global_round=glob,
            schedule=make_schedule(cfg.p, cfg.seed),
            comm=self.comm,
        )


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(
    name: str, *, mixes_per_round: int = 1, server_payloads: int = None,
    description: str = "",
) -> Callable[[Builder], Builder]:
    """Decorator registering a builder under ``name``; ``server_payloads``
    defaults to ``mixes_per_round``."""

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
            ),
            description=description or (build.__doc__ or "").strip(),
        )
        return build

    return deco


def get_algorithm(name: str) -> Algorithm:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP A6: baselines)"
        )
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


@register_algorithm(
    "pisco",
    mixes_per_round=2,
    description="PISCO (Algorithm 1): tracked local updates + Bernoulli(p) server",
)
def _build_pisco(loss_fn, cfg, mixing):
    return (
        lambda lf, x0, b0: init_compression_state(init_state(lf, x0, b0), mixing),
        make_round_fn(loss_fn, cfg, mixing, global_round=False),
        make_round_fn(loss_fn, cfg, mixing, global_round=True),
    )
