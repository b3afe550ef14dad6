"""Chrome trace-event exporter: ``TraceRecorder`` → ``trace.json`` (the port's
own copy of ``repro.obs.export``: the same JSON for the same recorder).

Emits the JSON-object flavour of the Chrome Trace Event Format —
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}`` —
which both ``chrome://tracing`` and ``ui.perfetto.dev`` open directly.

Mapping:

* each recorder **track** becomes a thread (``tid``) under one process,
  named via an ``"M"`` (metadata) ``thread_name`` event, with ordering
  pinned by ``thread_sort_index`` so ``rounds`` renders above the agent
  tracks;
* every :class:`~repro_torch.obs.trace.Span` becomes an ``"X"`` (complete)
  event with ``ts``/``dur`` in microseconds;
* every :class:`~repro_torch.obs.trace.Instant` becomes an ``"i"`` event with
  thread scope.

:func:`validate_chrome_trace` is the schema check the tests and CI lean on —
it asserts exactly the invariants Perfetto's importer needs.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from repro_torch.obs.trace import ROUND_TRACK, TraceRecorder

#: Bump when the emitted structure changes shape.
TRACE_SCHEMA_VERSION = 1

_PID = 1


def _us(seconds: float) -> float:
    return float(seconds) * 1e6


def _track_order(tracks: List[str]) -> Dict[str, int]:
    """rounds first, then host, then agent tracks in numeric order."""

    def key(t: str):
        if t == ROUND_TRACK:
            return (0, 0, t)
        if t == "host":
            return (1, 0, t)
        if t.startswith("agent "):
            try:
                return (2, int(t.split()[1]), t)
            except ValueError:
                return (2, 0, t)
        return (3, 0, t)

    return {t: i for i, t in enumerate(sorted(tracks, key=key))}


def to_chrome_trace(rec: TraceRecorder) -> Dict[str, Any]:
    """Serialize a recorder to a Chrome-trace dict (pure data, no I/O)."""
    order = _track_order(rec.tracks())
    tids = {t: i + 1 for t, i in order.items()}
    events: List[Dict[str, Any]] = []
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": track},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"sort_index": order[track]},
        })
    for s in rec.spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": _us(s.t0), "dur": _us(s.dur),
            "pid": _PID, "tid": tids[s.track], "args": dict(s.args),
        })
    for i in rec.instants:
        events.append({
            "name": i.name, "ph": "i", "s": "t",
            "ts": _us(i.t), "pid": _PID, "tid": tids[i.track],
            "args": dict(i.args),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema_version": TRACE_SCHEMA_VERSION, **rec.meta},
    }


def write_trace(path: str, rec: TraceRecorder) -> Dict[str, Any]:
    """Write ``rec`` to ``path`` as Chrome-trace JSON; returns the dict."""
    obj = to_chrome_trace(rec)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj: Any) -> None:
    """Assert ``obj`` is a Perfetto-loadable Chrome trace.

    Raises ``AssertionError`` with a pointed message on the first violation.
    Used by the test suite and by CI's serve-smoke trace check.
    """
    assert isinstance(obj, dict), "trace must be the JSON-object flavour"
    assert "traceEvents" in obj, "missing traceEvents"
    events = obj["traceEvents"]
    assert isinstance(events, list) and events, "traceEvents must be non-empty"
    named_tids = set()
    for e in events:
        assert isinstance(e, dict), f"event not an object: {e!r}"
        ph = e.get("ph")
        assert ph in {"M", "X", "i", "B", "E", "C"}, f"unknown phase {ph!r}"
        assert "pid" in e and "tid" in e, f"event missing pid/tid: {e!r}"
        if ph == "M" and e.get("name") == "thread_name":
            named_tids.add((e["pid"], e["tid"]))
        if ph == "X":
            assert isinstance(e.get("ts"), (int, float)), f"X needs ts: {e!r}"
            assert isinstance(e.get("dur"), (int, float)), f"X needs dur: {e!r}"
            assert e["dur"] >= 0, f"negative dur: {e!r}"
        if ph == "i":
            assert isinstance(e.get("ts"), (int, float)), f"i needs ts: {e!r}"
    used_tids = {
        (e["pid"], e["tid"]) for e in events if e.get("ph") in {"X", "i"}
    }
    assert used_tids <= named_tids, (
        f"events on unnamed threads: {used_tids - named_tids}"
    )
