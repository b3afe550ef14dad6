"""Staleness-weighted aggregation rules for the async event-queue driver
(the port's own copy of ``repro.events.staleness``; pure numpy).

An :class:`AsyncConfig` is the declarative knob set of the events driver
(DESIGN.md §13), carried on ``ExperimentSpec.async_`` as a spec string::

    "<rule>[:k=v,...]"      e.g.  "poly:alpha=0.5,bound=2,buffer=4"

* ``rule`` — how the buffered-async server aggregator weights each agent's
  contribution by its staleness ``s`` (rounds since the agent last kept pace):

  - ``constant`` — uniform weights regardless of staleness (plain averaging;
    with everything else default this is "async timing, sync numerics");
  - ``poly``     — polynomial decay ``w ∝ (1 + s)^{-alpha}`` (the classic
    staleness discount of async SGD);
  - ``buffer``   — FedBuff-style: only the buffer cohort (the ``buffer``
    earliest pushes) is averaged, late pushes get weight zero this round.

* ``bound``  — the gossip staleness bound B: an agent that has fallen more
  than B rounds behind the front is dropped from its neighbors' mixes (its
  mass moves onto their self-weights — link-failure semantics) and stops
  gating round availability.  ``None``/``inf`` disables dropping.

* ``buffer`` — server buffer size m: a global round fires when the first m
  participant pushes arrive instead of waiting for the slowest (``None`` =
  everyone, the synchronous barrier).

Weights are always normalized to sum to one over the participants, so with
zero staleness everywhere every rule degenerates to the exact uniform
average — the hinge of the events driver's bit-exact degenerate mode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

RULES = ("constant", "poly", "buffer")


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Parsed form of an ``ExperimentSpec.async_`` spec string."""

    rule: str = "constant"
    alpha: float = 0.5  # poly decay exponent
    bound: Optional[int] = None  # gossip staleness bound B (None = never drop)
    buffer: Optional[int] = None  # server buffer size m (None = all participants)

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"async rule {self.rule!r} not in {RULES}")
        if self.alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if self.bound is not None and self.bound < 0:
            raise ValueError(f"bound must be >= 0, got {self.bound}")
        if self.buffer is not None and self.buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {self.buffer}")

    def spec(self) -> str:
        parts = []
        if self.alpha != 0.5:
            parts.append(f"alpha={self.alpha:g}")
        if self.bound is not None:
            parts.append(f"bound={self.bound}")
        if self.buffer is not None:
            parts.append(f"buffer={self.buffer}")
        return self.rule + (":" + ",".join(parts) if parts else "")


def parse_async_spec(spec: str) -> AsyncConfig:
    """``"poly:alpha=0.5,bound=2,buffer=4"`` -> :class:`AsyncConfig`.

    Raises ``ValueError`` on unknown rules/keys or malformed values — the
    same fail-fast contract as ``parse_systems_spec``."""
    spec = str(spec).strip()
    if not spec:
        raise ValueError("empty async spec")
    rule, _, rest = spec.partition(":")
    kw = {}
    if rest:
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq or not val.strip():
                raise ValueError(f"malformed async override {item!r} (want k=v)")
            if key == "alpha":
                kw["alpha"] = float(val)
            elif key in ("bound", "buffer"):
                v = val.strip().lower()
                if v in ("inf", "none"):
                    kw[key] = None
                else:
                    f = float(v)
                    if not f.is_integer():
                        raise ValueError(f"{key} must be an integer, got {val!r}")
                    kw[key] = int(f)
            else:
                raise ValueError(
                    f"unknown async key {key!r}; options: alpha, bound, buffer"
                )
    return AsyncConfig(rule=rule.strip(), **kw)


def with_staleness_bound(spec: Optional[str], bound: Optional[int]) -> str:
    """Return ``spec`` with its staleness bound replaced — the tuner's third
    axis edits async specs through this, like ``spec.replace(p=...)`` for p."""
    cfg = parse_async_spec(spec) if spec else AsyncConfig()
    return dataclasses.replace(cfg, bound=bound).spec()


def staleness_weights(
    staleness: np.ndarray,
    cfg: AsyncConfig,
    *,
    ontime: Optional[np.ndarray] = None,
    participants: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Normalized aggregation weights for one buffered server round.

    ``staleness`` is the per-agent effective staleness (rounds) at push time;
    ``ontime`` marks the buffer cohort (pushes that arrived before the buffer
    fired — required by the ``buffer`` rule); ``participants`` masks the
    agents in this server round (default: everyone).  Returns an (n,) vector
    summing to one over the participants, zero elsewhere."""
    s = np.asarray(staleness, dtype=np.float64)
    part = (
        np.ones_like(s, dtype=bool)
        if participants is None
        else np.asarray(participants, dtype=bool)
    )
    if cfg.rule == "constant":
        w = np.ones_like(s)
    elif cfg.rule == "poly":
        w = (1.0 + np.maximum(s, 0.0)) ** (-cfg.alpha)
    else:  # buffer
        if ontime is None:
            raise ValueError("buffer rule needs the ontime cohort mask")
        w = np.asarray(ontime, dtype=np.float64)
    w = np.where(part, w, 0.0)
    total = w.sum()
    if not math.isfinite(total) or total <= 0.0:
        # no weighable contribution (can't happen with a non-empty buffer);
        # fall back to uniform over the participants
        w = part.astype(np.float64)
        total = w.sum()
    return w / total
