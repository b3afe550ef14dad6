"""Perf-regression gate: diff fresh ``BENCH_*.json`` against baselines (the
port's own copy of ``repro.obs.regress``, over the port's payloads).

Stdlib-only on purpose: :mod:`repro_torch.figures.check_regress` runs it
against two directories of JSON payloads with nothing beyond a Python
interpreter (no torch, no numpy).  The port's baselines are its card
payloads in ``artifacts/torch/``; the reference's CPU payloads in
``artifacts/bench/`` are not comparable.

Tolerance philosophy:

* **deterministic** metrics — simulated seconds, byte counts, memory
  ratios, round counts, boolean pins — are functions of seeds and byte
  models, not of the machine, so they get tight tolerances (exact for
  counts/flags, 1.25× for simulated time: loose enough to absorb an
  intentional reshuffle, tight enough that a 2× cost-model slowdown fails);
* **wall-clock** metrics — per-round seconds, compile seconds, tokens/s —
  vary hugely between the container that committed the baseline and
  whatever CI machine re-measures them, so they only gate at 5×: a true
  order-of-magnitude cliff still fails, scheduler noise never does.

Gate kinds:

========== =============================================================
``time``    lower-is-better; fails when ``fresh > base * tol``
``higher``  higher-is-better; fails when ``fresh < base / tol``
``match``   relative difference must stay within ``tol`` (0 → exact)
``flag``    a boolean pin; fails when baseline is truthy and fresh is not
``count``   integer budget; fails when ``fresh > base + tol``
========== =============================================================
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

#: Bump when artifact/manifest layout changes shape.
BENCH_SCHEMA_VERSION = 1

_KINDS = ("time", "higher", "match", "flag", "count")

# Wall-clock measurements gate loosely: baselines come from a different
# machine than the CI runner that re-measures them.
WALL_TOL = 5.0
# Simulated time is deterministic (numpy-seeded fleets × byte models);
# 1.25x absorbs intentional retunes while a 2x cost slowdown still fails.
SIM_TOL = 1.25


@dataclasses.dataclass(frozen=True)
class MetricGate:
    """One gated metric inside a bench payload, addressed by dotted path."""

    path: str  # e.g. "results.scan.per_round_s" ("." splits keys)
    kind: str  # one of _KINDS
    tol: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown gate kind {self.kind!r}")


@dataclasses.dataclass
class Finding:
    """The verdict for one gate on one bench."""

    bench: str
    path: str
    kind: str
    status: str  # "ok" | "regressed" | "missing" | "skipped"
    base: Any = None
    fresh: Any = None
    detail: str = ""

    @property
    def failed(self) -> bool:
        return self.status in ("regressed", "missing")


# Per-bench gates, keyed by the BENCH_<key>.json key.  Paths index into the
# committed payloads; deterministic pins tight, wall-clock loose (see module
# docstring).  A path absent from BOTH payloads is skipped (schema drift in
# an old baseline), absent only from the fresh payload is a failure.
GATES: Dict[str, List[MetricGate]] = {
    "driver": [
        MetricGate("results.loop.per_round_s", "time", WALL_TOL),
        MetricGate("results.scan.per_round_s", "time", WALL_TOL),
        MetricGate("results.events.per_round_s", "time", WALL_TOL),
        MetricGate("results.scan.compile_s", "time", WALL_TOL),
        MetricGate("results.loop.a2a_rounds", "match", 0.0),
        MetricGate("results.scan.a2a_rounds", "match", 0.0),
        MetricGate("results.loop.final_loss", "match", 0.05),
        MetricGate("results.scan.final_loss", "match", 0.05),
        MetricGate("speedup", "higher", 3.0),
    ],
    "async": [
        MetricGate(
            "profiles.lognormal-stragglers.async.total_sim_time_s",
            "time", SIM_TOL,
        ),
        MetricGate(
            "profiles.lognormal-stragglers.sync.total_sim_time_s",
            "time", SIM_TOL,
        ),
        MetricGate("profiles.wan-gossip.async.total_sim_time_s", "time", SIM_TOL),
        MetricGate("profiles.free.bit_identical_loss", "flag"),
        MetricGate("reprice.self_exact", "flag"),
    ],
    "sparse": [
        MetricGate("results.n=10000.sparse_mixing_state_bytes", "match", 0.0),
        MetricGate("results.n=10000.per_round_s", "time", WALL_TOL),
        MetricGate("parity.ok", "flag"),
    ],
    "robust": [
        MetricGate("robustness_flip", "flag"),
        MetricGate("trimmed_within_10pct", "flag"),
        MetricGate("rows.signflip+trimmed.total_bytes", "match", 0.0),
    ],
    "serve": [
        MetricGate("memory.64.ratio", "higher", 1.01),
        MetricGate("bit_identity.admit_vs_dense", "flag"),
        MetricGate("bit_identity.step_vs_dense", "flag"),
        # the port's baselines are full-size card payloads: their highest
        # rate is 16 (the reference gates its quick payload's 8)
        MetricGate("rates.rate=16.tokens_per_s", "higher", WALL_TOL),
        MetricGate("rates.rate=16.p99_s", "time", WALL_TOL),
    ],
    "roofline": [
        MetricGate("summary.n_fail", "count", 0),
    ],
}


def lookup(payload: Any, path: str) -> Tuple[bool, Any]:
    """Resolve a dotted path; returns ``(found, value)``."""
    node = payload
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return False, None
        node = node[part]
    return True, node


def _check(gate: MetricGate, base: Any, fresh: Any) -> Tuple[bool, str]:
    """(ok, detail) for one gate; raw values already looked up."""
    if gate.kind == "flag":
        if base and not fresh:
            return False, "pinned flag went false"
        return True, ""
    if gate.kind == "count":
        if fresh > base + gate.tol:
            return False, f"count {fresh} > {base} + {gate.tol:g}"
        return True, ""
    base = float(base)
    fresh = float(fresh)
    if gate.kind == "time":
        limit = base * gate.tol
        if fresh > limit + 1e-12:
            return False, f"{fresh:.6g} > {base:.6g} × {gate.tol:g}"
        return True, ""
    if gate.kind == "higher":
        limit = base / gate.tol
        if fresh < limit - 1e-12:
            return False, f"{fresh:.6g} < {base:.6g} / {gate.tol:g}"
        return True, ""
    # match
    denom = max(abs(base), 1e-12)
    rel = abs(fresh - base) / denom
    if rel > gate.tol + 1e-12:
        return False, f"rel diff {rel:.3g} > {gate.tol:g}"
    return True, ""


def compare_payloads(
    bench: str, base: Dict[str, Any], fresh: Dict[str, Any],
    gates: Optional[List[MetricGate]] = None,
) -> List[Finding]:
    """Run every gate registered for ``bench`` over one payload pair."""
    findings: List[Finding] = []
    for gate in GATES.get(bench, []) if gates is None else gates:
        b_found, b_val = lookup(base, gate.path)
        f_found, f_val = lookup(fresh, gate.path)
        if not b_found and not f_found:
            findings.append(Finding(
                bench, gate.path, gate.kind, "skipped",
                detail="path absent from both payloads",
            ))
            continue
        if not b_found:
            findings.append(Finding(
                bench, gate.path, gate.kind, "skipped", fresh=f_val,
                detail="no baseline value (new metric)",
            ))
            continue
        if not f_found:
            findings.append(Finding(
                bench, gate.path, gate.kind, "missing", base=b_val,
                detail="metric disappeared from fresh artifact",
            ))
            continue
        ok, detail = _check(gate, b_val, f_val)
        findings.append(Finding(
            bench, gate.path, gate.kind, "ok" if ok else "regressed",
            base=b_val, fresh=f_val, detail=detail,
        ))
    return findings


def bench_key(path: str) -> Optional[str]:
    """``.../BENCH_driver.json`` → ``driver``; non-BENCH files → None."""
    name = os.path.basename(path)
    if not (name.startswith("BENCH_") and name.endswith(".json")):
        return None
    return name[len("BENCH_"):-len(".json")]


def load_artifacts(art_dir: str) -> Dict[str, Dict[str, Any]]:
    """Map bench key → payload for a directory of artifacts.

    Prefers the ``MANIFEST.json`` index when present (so the gate sees
    exactly what the harness declared); falls back to globbing
    ``BENCH_*.json`` for pre-manifest baselines.
    """
    out: Dict[str, Dict[str, Any]] = {}
    manifest = os.path.join(art_dir, "MANIFEST.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            m = json.load(f)
        for key, entry in m.get("benches", {}).items():
            p = os.path.join(art_dir, entry["path"])
            if os.path.exists(p):
                with open(p) as f:
                    out[key] = json.load(f)
        if out:
            return out
    for p in sorted(glob.glob(os.path.join(art_dir, "BENCH_*.json"))):
        key = bench_key(p)
        if key is not None:
            with open(p) as f:
                out[key] = json.load(f)
    return out


def compare_dirs(
    baseline_dir: str, fresh_dir: str,
    only: Optional[List[str]] = None,
) -> List[Finding]:
    """Gate every bench present in both directories; skip the rest."""
    base = load_artifacts(baseline_dir)
    fresh = load_artifacts(fresh_dir)
    findings: List[Finding] = []
    keys = sorted(set(base) | set(fresh))
    if only:
        keys = [k for k in keys if k in set(only)]
    for key in keys:
        if key not in GATES:
            continue
        if key not in fresh:
            findings.append(Finding(
                key, "*", "-", "skipped",
                detail="bench not in fresh run (subset run?)",
            ))
            continue
        if key not in base:
            findings.append(Finding(
                key, "*", "-", "skipped",
                detail="no committed baseline yet",
            ))
            continue
        findings.extend(compare_payloads(key, base[key], fresh[key]))
    return findings


def format_findings(findings: List[Finding]) -> str:
    """Fixed-width report table, one line per gate."""
    lines = [f"{'bench':<10} {'metric':<50} {'status':<10} detail"]
    for f in findings:
        vals = ""
        if f.status in ("ok", "regressed") and f.base is not None:
            vals = f" (base={f.base!r:.24} fresh={f.fresh!r:.24})"
        lines.append(
            f"{f.bench:<10} {f.path:<50} {f.status:<10} {f.detail}{vals}"
        )
    n_fail = sum(1 for f in findings if f.failed)
    n_ok = sum(1 for f in findings if f.status == "ok")
    n_skip = sum(1 for f in findings if f.status == "skipped")
    lines.append(f"-- {n_ok} ok, {n_fail} regressed, {n_skip} skipped")
    return "\n".join(lines)
