"""Asynchronous event-queue execution (DESIGN.md §13; the port's twin of
``repro.events``).

The synchronous drivers advance a global barrier: every agent finishes round
k before anyone starts round k+1, so simulated time is priced by the slowest
realized agent/edge.  This package replaces the barrier with a simulated
event clock over the spec's :mod:`repro_torch.sim.profiles` fleet realization
— bounded-staleness gossip, buffered staleness-weighted server aggregation —
while running the registry round functions and the block driver's body
unchanged.

* :mod:`repro_torch.events.staleness` — ``AsyncConfig`` (the
  ``ExperimentSpec.async_`` spec string) and the constant / poly / buffer
  aggregation weight rules;
* :mod:`repro_torch.events.clock` — the :class:`EventEngine` per-agent clock
  simulation, its frozen event trace, and :func:`reprice_trace`;
* :mod:`repro_torch.events.driver` — :func:`drive_events` (the third
  registered driver) and :func:`make_async_mixing`.
"""
from repro_torch.events.clock import EventEngine, make_event_engine, reprice_trace
from repro_torch.events.driver import drive_events, make_async_mixing
from repro_torch.events.staleness import (
    RULES,
    AsyncConfig,
    parse_async_spec,
    staleness_weights,
    with_staleness_bound,
)

__all__ = [
    "AsyncConfig",
    "EventEngine",
    "RULES",
    "drive_events",
    "make_async_mixing",
    "make_event_engine",
    "parse_async_spec",
    "reprice_trace",
    "staleness_weights",
    "with_staleness_bound",
]
