"""Metrics registry: counters / gauges / histograms with a JSONL sink (the
port's own copy of ``repro.obs.metrics``: the same snapshots and JSONL).

A :class:`MetricsRegistry` is a flat, host-side bag of named instruments.
Producers (``History.telemetry()``, ``ServeReport.telemetry()``, the
launchers) populate one and either inspect it in-process via
:meth:`MetricsRegistry.snapshot` or append it to a JSONL run log via
:meth:`MetricsRegistry.write_jsonl` — one JSON object per line, so a
directory of runs greps/streams like any other log.

Instruments are deliberately primitive — ints/floats and a value list with
summary quantiles — because everything feeding them is already reduced to
host scalars by the accountant/report layers; no locks, no label cartesian
products, no background threads.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional

#: Bump when the snapshot/JSONL structure changes shape.
METRICS_SCHEMA_VERSION = 1


class Counter:
    """Monotone accumulator (bytes sent, rounds run, tokens decoded)."""

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (final loss, tokens/s, p99 latency)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Value collector with count/sum/min/max and p50/p90/p99 readouts."""

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    def observe_many(self, values: Iterable[float]) -> None:
        self.values.extend(float(v) for v in values)

    @staticmethod
    def _quantile(sorted_vals: List[float], q: float) -> float:
        # Linear interpolation between closest ranks (numpy default).
        if not sorted_vals:
            return math.nan
        pos = q * (len(sorted_vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(sorted_vals) - 1)
        frac = pos - lo
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    def snapshot(self) -> Dict[str, Any]:
        vs = sorted(self.values)
        out: Dict[str, Any] = {"type": "histogram", "count": len(vs)}
        if vs:
            out.update(
                sum=float(sum(vs)), min=vs[0], max=vs[-1],
                p50=self._quantile(vs, 0.50),
                p90=self._quantile(vs, 0.90),
                p99=self._quantile(vs, 0.99),
            )
        return out


class MetricsRegistry:
    """Get-or-create registry of instruments, keyed by name."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self.meta: Dict[str, Any] = dict(meta or {})
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-ready dict: meta + every instrument's reduced state."""
        return {
            "schema_version": METRICS_SCHEMA_VERSION,
            "meta": dict(self.meta),
            "metrics": {
                name: self._instruments[name].snapshot()
                for name in self.names()
            },
        }

    def write_jsonl(self, path: str, **extra: Any) -> Dict[str, Any]:
        """Append this registry's snapshot as one line of ``path``."""
        snap = self.snapshot()
        if extra:
            snap["meta"].update(extra)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        return snap


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load every snapshot line from a metrics JSONL file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
