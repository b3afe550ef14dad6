"""Arrival-process load model + the simulated-clock request loop (the twin of
``repro.serve.load``).

The clock is **simulated** and advanced by the cost of each engine
operation, so a load sweep is reproducible.  Two cost sources:

* **measured** (``costs=None``) — each prefill / decode step is executed and
  timed on the host clock, ended by ``torch.cuda.synchronize`` on the
  engine's device; the clock advances by real engine seconds;
* **fixed** (:class:`StepCosts`) — deterministic per-op costs.

Arrivals ``"poisson:rate=R"`` or ``"bursty:rate=R,burst=B"`` and request
contents are drawn with numpy from domain-separated streams, bit-equal to
the reference's.  :func:`run_load` can hand each finished request's
queue → prefill → decode lifecycle to a
:class:`~repro_torch.obs.trace.TraceRecorder`, and
:meth:`ServeReport.telemetry` exports a session's metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.batcher import ContinuousBatcher, Request

_ARRIVAL_TAG = 0xA331  # arrival-time stream
_WORK_TAG = 0x3031  # request-content stream (agents, prompts)


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """``"poisson:rate=R"`` | ``"bursty:rate=R,burst=B"`` (requests/second)."""

    kind: str = "poisson"
    rate: float = 1.0
    burst: int = 8

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")

    @classmethod
    def parse(cls, spec: str) -> "ArrivalProcess":
        name, _, tail = spec.partition(":")
        kw: dict = {"kind": name}
        if tail:
            for item in tail.split(","):
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(f"bad arrival spec item {item!r} in {spec!r}")
                if k == "rate":
                    kw["rate"] = float(v)
                elif k == "burst":
                    kw["burst"] = int(v)
                else:
                    raise ValueError(f"unknown arrival key {k!r} in {spec!r}")
        return cls(**kw)

    @property
    def name(self) -> str:
        if self.kind == "bursty":
            return f"bursty:rate={self.rate:g},burst={self.burst}"
        return f"poisson:rate={self.rate:g}"

    def draw(self, n: int, seed: int = 0) -> np.ndarray:
        """(n,) sorted arrival times in seconds, pure in (self, n, seed)."""
        rng = np.random.default_rng([seed, _ARRIVAL_TAG])
        if self.kind == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate, size=n))
        n_groups = int(np.ceil(n / self.burst))
        gaps = rng.exponential(self.burst / self.rate, size=n_groups)
        return np.repeat(np.cumsum(gaps), self.burst)[:n]


def make_requests(process: ArrivalProcess, n_requests: int, *, n_agents: int, vocab_size: int,
                  prompt_len: int = 32, max_new_tokens: int = 16, eos_id: Optional[int] = None,
                  seed: int = 0) -> List[Request]:
    """A reproducible request trace: arrival times from the process stream,
    contents (agent ids, prompt tokens) from a separate stream."""
    arrivals = process.draw(n_requests, seed=seed)
    rng = np.random.default_rng([seed, _WORK_TAG])
    agents = rng.integers(0, n_agents, size=n_requests)
    prompts = rng.integers(0, vocab_size, size=(n_requests, prompt_len))
    return [
        Request(rid=i, agent_id=int(agents[i]), prompt=prompts[i].astype(np.int32),
                max_new_tokens=max_new_tokens, eos_id=eos_id, arrival_s=float(arrivals[i]))
        for i in range(n_requests)
    ]


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Fixed per-operation costs (seconds) for the deterministic mode."""

    prefill_s: float = 0.05
    decode_s: float = 0.01


@dataclasses.dataclass
class ServeReport:
    """Completed request records + the aggregates the benchmarks consume."""

    requests: List[Request]
    clock_s: float  # simulated time at which the last request finished

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.requests)

    @property
    def makespan_s(self) -> float:
        if not self.requests:
            return 0.0
        return max(self.clock_s - min(r.arrival_s for r in self.requests), 1e-12)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.makespan_s

    def latency_percentile(self, q: float) -> float:
        lats = [r.latency_s for r in self.requests]
        return float(np.percentile(lats, q)) if lats else 0.0

    @property
    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_s(self) -> float:
        return self.latency_percentile(99.0)

    def mean(self, field: str) -> float:
        vals = [getattr(r, field) for r in self.requests]
        return float(np.mean(vals)) if vals else 0.0

    def to_dict(self) -> dict:
        return {
            "n_requests": len(self.requests),
            "total_tokens": self.total_tokens,
            "makespan_s": self.makespan_s,
            "tokens_per_s": self.tokens_per_s,
            "p50_s": self.p50_s,
            "p99_s": self.p99_s,
            "mean_queue_wait_s": self.mean("queue_wait_s"),
            "mean_prefill_s": self.mean("prefill_s"),
            "mean_decode_s": self.mean("decode_s"),
            "requests": [r.breakdown() for r in self.requests],
        }

    def telemetry(self, meta: Optional[dict] = None):
        """This session as a :class:`~repro_torch.obs.metrics.MetricsRegistry`:
        request and token counters, latency gauges, lifecycle histograms, and
        per-slot decode occupancy (decode seconds attributed to each slot)."""
        from repro_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry(meta=dict(meta or {}))
        reg.counter("serve.requests").inc(len(self.requests))
        reg.counter("serve.tokens").inc(self.total_tokens)
        reg.gauge("serve.tokens_per_s").set(self.tokens_per_s)
        reg.gauge("serve.p50_s").set(self.p50_s)
        reg.gauge("serve.p99_s").set(self.p99_s)
        reg.gauge("serve.makespan_s").set(self.makespan_s)
        reg.histogram("serve.queue_wait_s").observe_many(r.queue_wait_s for r in self.requests)
        reg.histogram("serve.prefill_s").observe_many(r.prefill_s for r in self.requests)
        reg.histogram("serve.decode_s").observe_many(r.decode_s for r in self.requests)
        for r in self.requests:
            if r.slot is not None:
                reg.counter(f"serve.slot.{r.slot}.requests").inc()
                reg.counter(f"serve.slot.{r.slot}.decode_s").inc(r.decode_s)
        return reg


def run_load(batcher: ContinuousBatcher, requests: List[Request], *,
             costs: Optional[StepCosts] = None, recorder=None) -> ServeReport:
    """Drive ``requests`` through ``batcher`` on a simulated clock: pull due
    arrivals, admit into free slots (one prefill each), then one decode step
    for the whole batch (charged once, to every active request).

    ``recorder`` (a :class:`~repro_torch.obs.trace.TraceRecorder`) gets each
    finished request's lifecycle as spans on its agent's track, recorded
    after the loop from the timestamps the loop stamps, so recording cannot
    move the clock."""
    pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    waiting: List[Request] = []
    done: List[Request] = []
    t = 0.0

    def charge(op: Callable[[], object], fixed: float) -> float:
        if costs is not None:
            op()
            return fixed
        batcher.engine.synchronize()
        t0 = time.perf_counter()
        op()
        batcher.engine.synchronize()
        return time.perf_counter() - t0

    while pending or waiting or batcher.active:
        if not waiting and not batcher.active and pending:
            t = max(t, pending[0].arrival_s)
        while pending and pending[0].arrival_s <= t:
            waiting.append(pending.pop(0))
        while waiting and batcher.free_slots():
            req = waiting.pop(0)
            req.admit_s = t
            out: List = []
            dt = charge(lambda: out.append(batcher.admit(req)),
                        costs.prefill_s if costs is not None else 0.0)
            req.prefill_s = dt
            t += dt
            req.first_token_s = t
            if out[0]:  # finished at admission
                req.done_s = t
                done.append(req)
        if batcher.active:
            active = list(batcher.active)
            out = []
            dt = charge(lambda: out.extend(batcher.step()),
                        costs.decode_s if costs is not None else 0.0)
            t += dt
            for r in active:
                r.decode_s += dt
            for r in out:
                r.done_s = t
                done.append(r)
    if recorder is not None:
        for r in sorted(done, key=lambda r: (r.agent_id, r.arrival_s, r.rid)):
            recorder.record_request(r)
    return ServeReport(requests=done, clock_s=t)
