"""Declarative experiments: ``ExperimentSpec`` + ``Experiment``.

:class:`ExperimentSpec` has every field of the reference spec and the same
JSON, so one payload loads in both packages.  ``adversary`` puts Byzantine
agents on the wire and ``robust_agg`` picks the server rule
(:mod:`repro_torch.core.adversary`).

::

    spec = ExperimentSpec.create(algo="pisco", n_agents=10, t_o=5, p=0.1,
                                 eta_l=0.3, rounds=100, eval_every=10)
    exp = Experiment(spec, loss_fn=loss_fn, params0=params0,
                     sampler_factory=make_sampler, eval_fn=eval_fn)
    hist = exp.run()                    # on the GPU; device="cpu" to opt out
    hists = exp.sweep(seeds=[0, 1, 2])  # one History per seed
    runs = exp.sweep(grid={"p": [0.0, 0.1, 1.0]})  # [(spec, History), ...]

With ``systems="<profile>"`` every round is also priced in simulated seconds
(``History.sim_time_s``, :mod:`repro_torch.sim`); ``driver="events"`` (which
needs a profile) runs the rounds on the asynchronous event clock of
:mod:`repro_torch.events`, configured by ``async_``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.adversary import (
    adversary_mask,
    make_adversarial_mixing,
    parse_adversary_spec,
    unwrap_network,
)
from repro_torch.core.algorithms import BoundAlgorithm, get_algorithm
from repro_torch.core.compression import compress_mixing, make_byte_model, make_compressor
from repro_torch.core.driver import (
    DEFAULT_BLOCK_SIZE,
    DRIVERS,
    drive_loop,
    drive_scan,
    predraw_schedule,
)
from repro_torch.core.mixing import (
    MixingOps,
    make_network_mixing,
    make_robust_agg,
    make_sparse_network_mixing,
)
from repro_torch.core.pisco import LossFn, PiscoConfig, replicate_params
from repro_torch.core.topology import (
    make_sparse_topology,
    make_topology,
    parse_process_spec,
    use_sparse_topology,
)
from repro_torch.core.trainer import History, record_wall_time
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.update_rules import (
    OPT_POLICIES,
    make_lr_schedule,
    parse_update_rule,
    resolve_update_rules,
)
from repro_torch.weights import from_jax

Tree = Dict[str, torch.Tensor]
Sampler = Callable[[int], tuple]
EvalFn = Callable[[Tree], Dict[str, float]]

_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(PiscoConfig))

@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything declarative about one training run (the reference's fields;
    see ``repro.core.experiment.ExperimentSpec`` for each one's meaning)."""

    algo: str
    config: PiscoConfig
    topology: str = "ring"
    topology_kwargs: Tuple[Tuple[str, Any], ...] = ()
    network: Optional[str] = None
    participation: float = 1.0
    # True => CSR sparse gossip, False => dense n×n, None => auto (sparse
    # above SPARSE_AUTO_MIN_AGENTS agents)
    sparse: Optional[bool] = None
    cohort: Optional[float] = None
    systems: Optional[str] = None
    async_: Optional[str] = None
    adversary: Optional[str] = None
    robust_agg: str = "mean"
    compression: Optional[str] = None  # None | "q8" | "q4" | "q8d" | "q4d" | "top<f>"
    error_feedback: bool = True
    optimizer: Optional[str] = None
    server_optimizer: Optional[str] = None
    lr_schedule: Optional[str] = None
    opt_policy: Optional[str] = None
    rounds: int = 100
    eval_every: int = 1
    driver: str = "scan"  # "scan" (block driver) | "loop" | "events" (async clock)
    block_size: int = DEFAULT_BLOCK_SIZE

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"driver {self.driver!r} not in {DRIVERS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}"
            )
        # fail fast on malformed optimizer, network and compression specs
        if self.optimizer is not None:
            parse_update_rule(self.optimizer)
        if self.server_optimizer is not None:
            parse_update_rule(self.server_optimizer)
        if self.lr_schedule is not None:
            make_lr_schedule(self.lr_schedule, 1.0, 1)
        if self.opt_policy is not None and self.opt_policy not in OPT_POLICIES:
            raise ValueError(f"opt_policy {self.opt_policy!r} not in {OPT_POLICIES}")
        if self.cohort is not None:
            if not 0.0 < self.cohort <= 1.0:
                raise ValueError(f"cohort must be in (0, 1], got {self.cohort}")
            if self.network is not None:
                raise ValueError(
                    "cohort is sugar for network='cohort:<frac>'; pass one, not both"
                )
        if self.network is not None:
            parse_process_spec(self.network)
        if self.systems is not None:
            # local import: repro_torch.sim imports the Experiment API
            from repro_torch.sim.profiles import parse_systems_spec

            parse_systems_spec(self.systems)  # fail fast on bad profiles
        if self.async_ is not None:
            from repro_torch.events.staleness import parse_async_spec

            parse_async_spec(self.async_)  # fail fast on bad async specs
            if self.driver != "events":
                raise ValueError(
                    "async_ only applies to driver='events' "
                    f"(got driver={self.driver!r})"
                )
        if self.adversary is not None:
            # the full probe: the grammar, and that f leaves an honest agent
            parse_adversary_spec(self.adversary, self.config.n_agents, self.config.seed)
        # robust rules replace the participation-aware server average
        # wholesale: they need the synchronous full fleet
        if make_robust_agg(self.robust_agg, self.config.n_agents) is not None:
            if self.participation != 1.0:
                raise ValueError(
                    f"robust_agg={self.robust_agg!r} needs participation=1.0 "
                    f"(got {self.participation}) — robust rules aggregate the "
                    "full fleet"
                )
            if self.async_ is not None:
                raise ValueError(
                    f"robust_agg={self.robust_agg!r} needs synchronous server "
                    f"rounds (async_=None, got {self.async_!r})"
                )
        if self.driver == "events" and self.systems is None:
            raise ValueError(
                "driver='events' needs a systems profile (spec.systems) — "
                "the event clock is drawn from the fleet realization"
            )
        if self.compression is not None:
            make_compressor(self.compression)  # fail fast on a malformed spec
        if isinstance(self.topology_kwargs, dict):
            object.__setattr__(
                self, "topology_kwargs", tuple(sorted(self.topology_kwargs.items()))
            )
        get_algorithm(self.algo)  # fail fast on unknown / unported algorithms

    @classmethod
    def create(cls, algo: str = "pisco", **kw) -> "ExperimentSpec":
        """Flat constructor: PiscoConfig fields may be passed directly."""
        cfg_kw = {k: kw.pop(k) for k in list(kw) if k in _CONFIG_FIELDS}
        return cls(algo=algo, config=PiscoConfig(**cfg_kw), **kw)

    def replace(self, **kw) -> "ExperimentSpec":
        """``dataclasses.replace`` that also routes PiscoConfig field names."""
        cfg_kw = {k: kw.pop(k) for k in list(kw) if k in _CONFIG_FIELDS}
        spec = self
        if cfg_kw:
            spec = dataclasses.replace(
                spec, config=dataclasses.replace(spec.config, **cfg_kw)
            )
        return dataclasses.replace(spec, **kw) if kw else spec

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["topology_kwargs"] = dict(self.topology_kwargs)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        d["config"] = PiscoConfig(**d["config"])
        d["topology_kwargs"] = tuple(sorted(dict(d.get("topology_kwargs", {})).items()))
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    # -- derived pieces -----------------------------------------------------

    @property
    def effective_network(self) -> Optional[str]:
        """The network process spec after ``cohort`` sugar is expanded."""
        if self.cohort is not None:
            return f"cohort:{self.cohort:g}"
        return self.network

    @property
    def use_sparse(self) -> bool:
        """Whether this spec routes through the sparse CSR mixer."""
        return use_sparse_topology(self.sparse, self.config.n_agents)

    def make_mixing(self, device: torch.device) -> MixingOps:
        """The spec's mixers: dense or sparse, over a frozen or a dynamic
        network (its draws seeded with ``config.seed``), with the adversary
        and the server rule, optionally compressed."""
        kw = dict(self.topology_kwargs)
        n = self.config.n_agents
        if self.use_sparse:
            mixing = make_sparse_network_mixing(
                make_sparse_topology(self.topology, n, **kw), device,
                self.effective_network, self.participation, seed=self.config.seed,
            )
        else:
            mixing = make_network_mixing(
                make_topology(self.topology, n, **kw), device,
                self.effective_network, self.participation, seed=self.config.seed,
            )
        # before compression, so the corruption rides the compressed wire
        mixing = make_adversarial_mixing(mixing, self.adversary, self.robust_agg, n_agents=n,
                                         seed=self.config.seed)
        if self.compression is not None:
            mixing = compress_mixing(
                mixing,
                make_compressor(self.compression),
                error_feedback=self.error_feedback,
                seed=self.config.seed,
            )
        return mixing


class Experiment:
    """A spec plus the runtime problem pieces; ``run()`` produces a History.

    ``device=None`` means the GPU and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path.  ``params0`` (unstacked)
    or ``x0`` (agent-stacked) may be numpy arrays or tensors; they are moved
    to the device.  ``sampler_factory(spec)`` builds the per-round sampler
    (its batches must already lie on the device).

    ``recorder`` (a :class:`~repro_torch.obs.trace.TraceRecorder`) is
    attached to every History this experiment makes, sweeps included: the
    port runs a sweep's seeds and grid points one after another, so their
    rounds follow one another on the recorder's timeline.  (The reference
    vmaps a seed sweep into one program and leaves its sweeps unrecorded.)"""

    def __init__(
        self,
        spec: ExperimentSpec,
        *,
        loss_fn: LossFn,
        params0: Optional[Mapping[str, Any]] = None,
        x0: Optional[Mapping[str, Any]] = None,
        sampler: Optional[Sampler] = None,
        sampler_factory: Optional[Callable[[ExperimentSpec], Sampler]] = None,
        eval_fn: Optional[EvalFn] = None,
        mixing: Optional[MixingOps] = None,
        stop_when: Optional[Callable[[History], bool]] = None,
        device: DeviceLike = None,
        recorder: Any = None,
    ):
        if (params0 is None) == (x0 is None):
            raise ValueError("pass exactly one of params0 (unstacked) or x0 (stacked)")
        if (sampler is None) == (sampler_factory is None):
            raise ValueError("pass exactly one of sampler or sampler_factory")
        self.device = resolve_device(device)
        self.spec = spec
        self.loss_fn = loss_fn
        self._params0 = None if params0 is None else from_jax(params0, self.device)
        self._x0 = None if x0 is None else from_jax(x0, self.device)
        self._sampler = sampler
        self._sampler_factory = sampler_factory
        self.eval_fn = eval_fn
        self._mixing = mixing
        self.stop_when = stop_when
        self.recorder = recorder

    def _pieces(self) -> dict:
        return dict(
            loss_fn=self.loss_fn,
            params0=self._params0,
            x0=self._x0,
            sampler=self._sampler,
            sampler_factory=self._sampler_factory,
            eval_fn=self.eval_fn,
            mixing=self._mixing,
            stop_when=self.stop_when,
            device=self.device,
            recorder=self.recorder,
        )

    def _make_sampler(self, spec: ExperimentSpec) -> Sampler:
        if self._sampler_factory is not None:
            return self._sampler_factory(spec)
        return self._sampler

    def _x0_stacked(self) -> Tree:
        if self._x0 is not None:
            return self._x0
        return replicate_params(self._params0, self.spec.config.n_agents)

    def _bind(self, mixing: MixingOps) -> BoundAlgorithm:
        spec = self.spec
        opt_kw = resolve_update_rules(
            spec.optimizer, spec.server_optimizer, spec.lr_schedule, spec.opt_policy,
            eta_l=spec.config.eta_l, rounds=spec.rounds, t_o=spec.config.t_o,
        )
        return get_algorithm(spec.algo).bind(self.loss_fn, spec.config, mixing, **opt_kw)

    def _fresh_history(self, mixing: MixingOps, bound: BoundAlgorithm, x0: Tree) -> History:
        hist = History(
            byte_model=make_byte_model(
                mixing, x0, self.spec.config.n_agents,
                mixes_per_round=bound.comm.mixes_per_round,
                server_payloads=bound.comm.server_payloads,
            )
        )
        if self.spec.systems is not None and self.spec.driver != "events":
            # local import: repro_torch.sim imports the Experiment API
            from repro_torch.sim.costmodel import make_time_model

            # pricing sees the base network: Byzantine agents send wrong
            # bytes, not other byte or time counts
            hist.time_model = make_time_model(self.spec, hist.byte_model,
                                              network=unwrap_network(mixing.network))
        hist.adversary_mask = adversary_mask(self.spec.adversary, self.spec.config.n_agents,
                                             self.spec.config.seed)
        hist.recorder = self.recorder
        return hist

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> History:
        mixing = self._mixing if self._mixing is not None else self.spec.make_mixing(self.device)
        return self._run(mixing, self._make_sampler(self.spec))

    def _run(self, mixing: MixingOps, sampler: Sampler) -> History:
        """One run over ``mixing`` with ``sampler``.  Binding builds the
        schedule afresh from the spec's seed, so every call draws the same
        flags."""
        spec = self.spec
        if spec.driver == "events":
            return self._run_events(mixing, sampler)
        bound = self._bind(mixing)
        _, comm0 = sampler(-1)
        x0 = self._x0_stacked()
        state = bound.init(self.loss_fn, x0, comm0)
        hist = self._fresh_history(mixing, bound, x0)
        drive = drive_scan if spec.driver == "scan" else drive_loop
        kw = {"block_size": spec.block_size} if spec.driver == "scan" else {}
        with record_wall_time(hist):
            state = drive(
                bound, state, sampler, spec.rounds, hist,
                eval_fn=self.eval_fn, eval_every=spec.eval_every,
                stop_when=self.stop_when, **kw,
            )
            self._synchronize()
        hist.final_state = state
        return hist

    def _run_events(self, mixing: MixingOps, sampler: Sampler) -> History:
        """The events driver's run (the reference's ``_run_events``).

        The event clock needs the whole flag sequence up front, so the
        Bernoulli(p) schedule is drawn once, in round order (the draws the
        sync drivers make).  When the realized fleet makes the run trivial
        (no staleness drops, exactly uniform weights) the spec's own mixing
        stays bound and the rounds are those of ``driver="scan"``, bit for
        bit; otherwise :func:`~repro_torch.events.driver.make_async_mixing`
        carries the engine's per-round decisions into the numerics."""
        from repro_torch.events.clock import make_event_engine
        from repro_torch.events.driver import drive_events, make_async_mixing

        spec = self.spec
        bound = self._bind(mixing)
        flags = predraw_schedule(bound.schedule, 0, spec.rounds)
        x0 = self._x0_stacked()
        hist = self._fresh_history(mixing, bound, x0)
        engine = make_event_engine(spec, hist.byte_model, flags,
                                   network=unwrap_network(mixing.network))
        if not engine.trivial:
            mixing = make_async_mixing(spec, self.device)
            bound = self._bind(mixing)
        _, comm0 = sampler(-1)
        state = bound.init(self.loss_fn, x0, comm0)
        hist.event_trace = engine.trace
        with record_wall_time(hist):
            state = drive_events(
                bound, state, sampler, spec.rounds, hist, engine=engine,
                eval_fn=self.eval_fn, eval_every=spec.eval_every,
                stop_when=self.stop_when, block_size=spec.block_size,
            )
            self._synchronize()
        hist.final_state = state
        return hist

    def sweep(
        self,
        seeds: Optional[Sequence[int]] = None,
        grid: Optional[Dict[str, Sequence[Any]]] = None,
    ):
        """Either a multi-seed run (``seeds=[...]`` -> one History per seed)
        or a sequential hyper-parameter grid (``grid={"p": [...], ...}`` ->
        ``(spec, History)`` over the cartesian product, in order)."""
        if (seeds is None) == (grid is None):
            raise ValueError("pass exactly one of seeds or grid")
        if grid is not None:
            out = []
            for combo in itertools.product(*grid.values()):
                spec = self.spec.replace(**dict(zip(grid.keys(), combo)))
                out.append((spec, Experiment(spec, **self._pieces()).run()))
            return out
        return self._sweep_seeds(list(seeds))

    def _sweep_seeds(self, seeds: List[int]) -> List[History]:
        """All seeds advance through one Bernoulli(p) schedule drawn from the
        spec's seed, with the same block cuts and eval points; each seed has
        its own sampler (built from ``spec.replace(seed=s)``), state and
        History.  The seeds share one mixing, so on a dynamic network every
        seed sees the same realized graphs and participants (the draws are
        pure in the spec's seed and the round).  The reference vmaps the
        seeds; the rounds here launch hand-written kernels that
        ``torch.func.vmap`` cannot batch, so the seeds run one after another,
        each through :meth:`run`'s driver.  A seed equal to the spec's
        reproduces :meth:`run` exactly."""
        if self._sampler_factory is None:
            raise ValueError("sweep(seeds=...) needs a sampler_factory")
        if self.spec.driver == "events":
            raise ValueError(
                "sweep(seeds=...) does not support driver='events'; "
                "run per-seed via sweep(grid={'seed': [...]}) instead"
            )
        mixing = self._mixing if self._mixing is not None else self.spec.make_mixing(self.device)
        return [self._run(mixing, self._make_sampler(self.spec.replace(seed=s))) for s in seeds]


def run_experiment(spec: ExperimentSpec, **pieces) -> History:
    """One-shot convenience: ``run_experiment(spec, loss_fn=..., ...)``."""
    return Experiment(spec, **pieces).run()
