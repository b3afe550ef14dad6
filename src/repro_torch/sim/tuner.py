"""The p/τ communication autotuner (paper §5's trade-off, operationalized;
the port's twin of ``repro.sim.tuner``).

The paper's central dial is *how often to pay for the server*: gossip rounds
are cheap but numerous, server rounds expensive but few, and which mixture is
fastest depends on the systems costs — not just on bytes.  ``tune`` sweeps a
``p × τ`` grid of :class:`~repro_torch.core.experiment.ExperimentSpec` variants
under a :mod:`~repro_torch.sim.profiles` systems profile and reports the simulated
**time-to-target-loss frontier**: for every configuration, the simulated
seconds (and rounds, and bytes) until the trailing-window-smoothed training
loss first crosses the target.

Two strategies:

* ``"grid"``    — run every configuration for the full round budget;
* ``"halving"`` — successive halving: run everything for a small budget,
  keep the better half by current loss, double the budget, repeat.  Each
  rung re-runs survivors from round 0 (cheap at these scales and keeps every
  run a pure function of its spec).

Because simulated time is priced post-hoc from pure ``(seed, k)`` draws,
:func:`retime` re-prices a finished tuning run under a *different* profile
without re-training — the cheap way to ask "and if the gossip links were WAN?"
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.events.staleness import parse_async_spec, with_staleness_bound
from repro_torch.sim.costmodel import price_history


def _smoothed(values: Sequence[float], window: int) -> np.ndarray:
    """Trailing moving average over ``window`` rounds — tracks the current
    loss level (unlike the all-history running mean, which is dominated by
    the early rounds and would declare every configuration 'at target'
    almost immediately)."""
    v = np.asarray(values, dtype=np.float64)
    if window <= 1 or v.size == 0:
        return v
    c = np.concatenate([[0.0], np.cumsum(v)])
    idx = np.arange(v.size) + 1
    lo = np.maximum(idx - window, 0)
    return (c[idx] - c[lo]) / (idx - lo)


def _auto_window(budget: int) -> int:
    return max(1, min(20, budget // 10))


@dataclasses.dataclass
class TunePoint:
    """One ``(p, τ[, staleness bound])`` configuration's frontier readout."""

    p: float
    t_o: int
    rounds_run: int
    final_loss: float
    total_sim_time_s: float
    time_to_target_s: Optional[float] = None
    rounds_to_target: Optional[int] = None
    bytes_to_target: Optional[int] = None
    # gossip staleness bound B (events driver only; None elsewhere)
    staleness_bound: Optional[int] = None
    # runtime attachments (excluded from to_dict)
    spec: Any = None
    history: Any = None

    def to_dict(self) -> dict:
        return {
            "p": self.p,
            "t_o": self.t_o,
            "staleness_bound": self.staleness_bound,
            "rounds_run": self.rounds_run,
            "final_loss": self.final_loss,
            "total_sim_time_s": self.total_sim_time_s,
            "time_to_target_s": self.time_to_target_s,
            "rounds_to_target": self.rounds_to_target,
            "bytes_to_target": self.bytes_to_target,
        }


@dataclasses.dataclass
class TunerResult:
    """All points, sorted fastest-to-target first."""

    points: List[TunePoint]
    target_loss: float
    systems: str
    strategy: str
    window: int = 1  # trailing-mean smoothing the target was judged on

    def __post_init__(self):
        self.points.sort(key=_point_order)

    @property
    def best(self) -> TunePoint:
        return self.points[0]

    def ranking(self) -> List[Tuple[float, int]]:
        """``(p, t_o)`` pairs, fastest simulated time-to-target first
        (configurations that never reached the target rank last, by loss)."""
        return [(pt.p, pt.t_o) for pt in self.points]

    def to_dict(self) -> dict:
        return {
            "systems": self.systems,
            "strategy": self.strategy,
            "target_loss": self.target_loss,
            "window": self.window,
            "best": self.best.to_dict() if self.points else None,
            "ranking": [[p, t] for p, t in self.ranking()],
            "points": [pt.to_dict() for pt in self.points],
        }


def _point_order(pt: TunePoint):
    reached = pt.time_to_target_s is not None
    return (
        0 if reached else 1,
        pt.time_to_target_s if reached else math.inf,
        pt.final_loss,
    )


def _readout(
    hist, spec, target_loss: float, seconds: np.ndarray, window: int
) -> TunePoint:
    series = _smoothed(hist.loss, window)
    cum_s = np.cumsum(seconds)
    cum_b = np.cumsum(hist.accountant.per_round_bytes)
    hits = np.nonzero(series <= target_loss)[0]
    async_spec = getattr(spec, "async_", None)
    pt = TunePoint(
        p=float(spec.config.p),
        t_o=int(spec.config.t_o),
        staleness_bound=(
            parse_async_spec(async_spec).bound if async_spec else None
        ),
        rounds_run=len(hist.loss),
        final_loss=float(series[-1]),
        total_sim_time_s=float(cum_s[-1]) if cum_s.size else 0.0,
        spec=spec,
        history=hist,
    )
    if hits.size:
        r = int(hits[0])
        pt.time_to_target_s = float(cum_s[r])
        pt.rounds_to_target = r + 1
        pt.bytes_to_target = int(cum_b[r])
    return pt


def tune(
    spec: Any,
    pieces: Dict[str, Any],
    *,
    p_grid: Sequence[float],
    tau_grid: Sequence[Optional[int]] = (None,),
    staleness_grid: Sequence[Optional[int]] = (None,),
    systems: Optional[str] = None,
    target_loss: Optional[float] = None,
    rounds: Optional[int] = None,
    strategy: str = "grid",
    min_rounds: int = 8,
    window: Optional[int] = None,
) -> TunerResult:
    """Sweep ``p_grid × tau_grid × staleness_grid`` variants of ``spec`` and
    rank them by simulated time-to-target-loss.

    ``pieces`` are the :class:`~repro_torch.core.experiment.Experiment` runtime
    kwargs (``loss_fn``, ``params0``/``x0``, ``device`` and a ``sampler_factory`` —
    required when ``tau_grid`` varies ``t_o``, since samplers are built per
    spec).  The loss trajectory is smoothed with a trailing ``window``-round
    mean (auto: ``min(20, budget // 10)``); ``target_loss=None`` auto-selects
    1.05× the best final smoothed loss across the sweep, so the frontier is
    populated for at least the winning configuration.

    ``staleness_grid`` is the third tuned axis (events driver only): each
    entry is a gossip staleness bound B substituted into the spec's
    ``async_`` config via :func:`~repro_torch.events.staleness.with_staleness_bound`
    — the async analogue of tuning p.  The default ``(None,)`` leaves the
    spec's async config untouched, so sync sweeps are unchanged.
    """
    from repro_torch.core.experiment import Experiment  # local: avoid import cycle

    if strategy not in ("grid", "halving"):
        raise ValueError(f"strategy {strategy!r} not in ('grid', 'halving')")
    systems = systems if systems is not None else spec.systems
    if systems is None:
        raise ValueError("tune() needs a systems profile (systems=... or spec.systems)")
    tunes_staleness = tuple(staleness_grid) != (None,)
    if tunes_staleness and spec.driver != "events":
        raise ValueError(
            "staleness_grid tunes the events driver's gossip bound; "
            f"spec.driver is {spec.driver!r} (want 'events')"
        )
    budget = int(rounds if rounds is not None else spec.rounds)
    window = _auto_window(budget) if window is None else max(1, int(window))

    configs = [
        (float(p), tau, b)
        for p in p_grid for tau in tau_grid for b in staleness_grid
    ]
    if not configs:
        raise ValueError("empty p_grid x tau_grid x staleness_grid")

    def spec_for(p: float, tau: Optional[int], b: Optional[int], r: int):
        kw: Dict[str, Any] = {"systems": systems, "p": p, "rounds": r}
        if tau is not None:
            kw["t_o"] = int(tau)
        if tunes_staleness:
            kw["async_"] = with_staleness_bound(
                getattr(spec, "async_", None), b
            )
        return spec.replace(**kw)

    def run(p: float, tau: Optional[int], b: Optional[int], r: int):
        s = spec_for(p, tau, b, r)
        return s, Experiment(s, **pieces).run()

    results: Dict[Tuple[float, Optional[int], Optional[int]], Tuple[Any, Any]] = {}
    if strategy == "grid":
        for cfg in configs:
            results[cfg] = run(*cfg, budget)
    else:
        survivors = list(configs)
        r = min(max(1, int(min_rounds)), budget)
        while True:
            for cfg in survivors:
                results[cfg] = run(*cfg, r)
            if r >= budget:
                break
            survivors.sort(
                key=lambda cfg: float(
                    _smoothed(results[cfg][1].loss, window)[-1]
                )
            )
            survivors = survivors[: max(1, math.ceil(len(survivors) / 2))]
            r = min(2 * r, budget)

    if target_loss is None:
        target_loss = 1.05 * min(
            float(_smoothed(h.loss, window)[-1]) for _, h in results.values()
        )

    points = [
        _readout(
            h, s, target_loss,
            np.asarray(h.sim_time_s, dtype=np.float64), window,
        )
        for s, h in results.values()
    ]
    return TunerResult(
        points=points, target_loss=float(target_loss),
        systems=systems, strategy=strategy, window=window,
    )


def retime(
    result: TunerResult, systems: str, *, target_loss: Optional[float] = None
) -> TunerResult:
    """Re-price a finished tuning run under another profile — no re-training.

    Keeps the original target loss by default (it is a statement about the
    optimization trajectory, which repricing does not change); pass
    ``target_loss`` to move the target too, e.g. to compare profiles at a
    threshold every configuration reaches.
    """
    target = result.target_loss if target_loss is None else float(target_loss)
    points = []
    for pt in result.points:
        seconds = price_history(pt.history, pt.spec, systems=systems)
        points.append(_readout(pt.history, pt.spec, target, seconds, result.window))
    return TunerResult(
        points=points, target_loss=target,
        systems=systems, strategy=result.strategy, window=result.window,
    )
