"""Observability: span tracing, Chrome-trace export, metrics, profiling and
the perf-regression gate (the twin of ``repro.obs``).

``trace``, ``export``, ``metrics`` and ``regress`` are the port's own
stdlib-only copies of the reference's modules (they import nothing of it),
so the gate runs on a bare interpreter.  :mod:`repro_torch.obs.profile`
wraps ``torch.profiler`` and times kernel-library builds.
"""
from repro_torch.obs.export import (
    to_chrome_trace,
    validate_chrome_trace,
    write_trace,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    read_jsonl,
)
from repro_torch.obs.profile import CompileStats, profile_capture, track_compile_time
from repro_torch.obs.regress import (
    GATES,
    Finding,
    MetricGate,
    bench_key,
    compare_dirs,
    compare_payloads,
    format_findings,
)
from repro_torch.obs.trace import DEFAULT_ROUND_S, ROUND_TRACK, Span, TraceRecorder

__all__ = [
    "CompileStats",
    "Counter",
    "DEFAULT_ROUND_S",
    "Finding",
    "GATES",
    "Gauge",
    "Histogram",
    "MetricGate",
    "MetricsRegistry",
    "ROUND_TRACK",
    "Span",
    "TraceRecorder",
    "bench_key",
    "compare_dirs",
    "compare_payloads",
    "format_findings",
    "profile_capture",
    "read_jsonl",
    "to_chrome_trace",
    "track_compile_time",
    "validate_chrome_trace",
    "write_trace",
]
