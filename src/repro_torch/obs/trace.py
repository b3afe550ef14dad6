"""Flight-recorder span tracing: one structured event stream for every driver
(the port's own copy of ``repro.obs.trace``: plain host data, the same spans).

The recorder is a **host-side** sink: drivers already sync per-round metrics,
bytes and simulated seconds to the host through the single
:func:`repro_torch.core.driver.record_flags` funnel, and the recorder simply turns
those values into nested spans — it never touches device data, adds no
synchronization, and when no recorder is attached (``History.recorder is
None``, the default) every hook is a single ``getattr`` returning ``None``,
so the telemetry-off path is bit-identical to a pre-obs run by construction.

Two clocks, same discipline as :class:`~repro_torch.core.trainer.History`:

* the **round timeline** (tracks ``rounds`` and ``agent <i>``) runs on
  *simulated* seconds when the experiment carries a systems profile — span
  k's duration is exactly the ``sim_time_s[k]`` the accountant recorded;
  without a profile each round gets a fixed nominal width
  (:data:`DEFAULT_ROUND_S`) so the trace still renders;
* **serve request lifecycles** (queue → prefill → decode, one track per
  agent) run on the load generator's simulated clock from
  :func:`repro_torch.serve.load.run_load`.

Spans are plain host data; :mod:`repro_torch.obs.export` serializes them to the
Chrome trace-event format for ``ui.perfetto.dev``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional

#: Nominal round width (seconds) when no systems model prices the run — the
#: trace keeps rendering with rounds as fixed-width slots.
DEFAULT_ROUND_S = 1e-3

#: The driver timeline track: one span per executed communication round.
ROUND_TRACK = "rounds"


@dataclasses.dataclass
class Span:
    """One complete slice: ``[t0, t0 + dur)`` on ``track``."""

    track: str
    name: str
    t0: float  # seconds on the recorder's clock
    dur: float
    cat: str = "span"
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Instant:
    """A zero-duration marker (eval readouts, checkpoint writes)."""

    track: str
    name: str
    t: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class TraceRecorder:
    """Collects spans from the drivers / serve loop; exported via
    :mod:`repro_torch.obs.export`.

    Attach one to a run by passing ``recorder=`` to
    :class:`~repro_torch.core.experiment.Experiment` (or ``--trace-out`` on the
    launchers); the drivers feed it through their existing recording seams.
    """

    def __init__(self, meta: Optional[Mapping[str, Any]] = None):
        self.enabled = True
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        self._round_clock = 0.0

    # -- generic API --------------------------------------------------------

    @property
    def clock_s(self) -> float:
        """Current position of the round timeline (simulated seconds)."""
        return self._round_clock

    def add_span(
        self, track: str, name: str, t0: float, dur: float,
        *, cat: str = "span", **args: Any,
    ) -> Span:
        span = Span(
            track=track, name=name, t0=float(t0), dur=max(float(dur), 0.0),
            cat=cat, args=args,
        )
        self.spans.append(span)
        return span

    def add_instant(self, track: str, name: str, t: float, **args: Any) -> None:
        self.instants.append(Instant(track=track, name=name, t=float(t), args=args))

    @contextlib.contextmanager
    def host_span(self, name: str, *, track: str = "host", **args: Any):
        """Time a host-side block (compile, export, ...) with real seconds.

        Host spans live on their own track so real wall time is never
        interleaved with the simulated round timeline.
        """
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(
                track, name, t0, time.perf_counter() - t0, cat="host", **args
            )

    # -- driver timeline ----------------------------------------------------

    def record_round(
        self,
        k: int,
        is_global: bool,
        nbytes: int,
        seconds: Optional[float] = None,
        parts: Optional[Mapping[str, float]] = None,
        **args: Any,
    ) -> None:
        """One executed communication round on the ``rounds`` track.

        ``seconds`` is the round's simulated duration (``None`` — no systems
        model — renders as a :data:`DEFAULT_ROUND_S` slot); ``parts`` is the
        optional phase decomposition (``local_steps`` + ``gossip_mix`` /
        ``server_sync`` from :meth:`RoundTimeModel.round_parts`), drawn as
        sequential child spans nested inside the round span.
        """
        if seconds is not None:
            dur = float(seconds)
        elif parts:
            dur = float(sum(parts.values()))
        else:
            dur = DEFAULT_ROUND_S
        t0 = self._round_clock
        name = "server_round" if is_global else "gossip_round"
        span_args = dict(round=int(k), bytes=int(nbytes), **args)
        if seconds is not None:
            span_args["sim_s"] = float(seconds)
        self.add_span(ROUND_TRACK, name, t0, dur, cat="round", **span_args)
        if parts:
            cursor = t0
            for phase, pdur in parts.items():
                self.add_span(
                    ROUND_TRACK, phase, cursor, float(pdur), cat="phase",
                    round=int(k),
                )
                cursor += float(pdur)
        self._round_clock = t0 + dur

    def record_agent_round(
        self, k: int, agent: int, t0: float, dur: float,
        is_global: bool, **args: Any,
    ) -> None:
        """Per-agent activity for round ``k`` (events driver: staleness,
        gating and participation per agent as its own Perfetto track)."""
        self.add_span(
            f"agent {agent}",
            "server_round" if is_global else "gossip_round",
            t0, dur, cat="agent", round=int(k), **args,
        )

    # -- serve request lifecycles -------------------------------------------

    def record_request(self, req: Any) -> None:
        """Queue → prefill → decode spans for one finished serve request,
        on the owning agent's track (timestamps from the simulated clock the
        load loop stamped onto the :class:`~repro_torch.serve.batcher.Request`)."""
        track = f"agent {req.agent_id}"
        base = dict(rid=int(req.rid))
        if getattr(req, "slot", None) is not None:
            base["slot"] = int(req.slot)
        if req.admit_s is not None and req.admit_s > req.arrival_s:
            self.add_span(
                track, "queue", req.arrival_s, req.admit_s - req.arrival_s,
                cat="serve", **base,
            )
        if req.admit_s is not None and req.first_token_s is not None:
            self.add_span(
                track, "prefill", req.admit_s,
                req.first_token_s - req.admit_s, cat="serve", **base,
            )
        if req.first_token_s is not None and req.done_s is not None:
            self.add_span(
                track, "decode", req.first_token_s,
                req.done_s - req.first_token_s, cat="serve",
                tokens=len(req.tokens), **base,
            )

    # -- readouts -----------------------------------------------------------

    def round_table(self) -> List[tuple]:
        """``(round, kind, bytes, dur)`` per round span, in record order —
        the attribution the driver-parity tests compare across drivers."""
        return [
            (s.args["round"], s.name, s.args["bytes"], s.dur)
            for s in self.spans
            if s.cat == "round"
        ]

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        for i in self.instants:
            seen.setdefault(i.track)
        return list(seen)
