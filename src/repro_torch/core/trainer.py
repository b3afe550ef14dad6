"""History record of a training run, and the wall-clock helper.

:class:`History` keeps the reference's ``to_dict``/``from_dict`` schema key
for key (the adversary series stay empty until that subsystem is ported), so
one JSON reader serves both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.schedule import CommAccountant, RoundByteModel


@dataclasses.dataclass
class History:
    """Per-round records, numpy-backed for the benchmark harness.

    Two clocks, never to be confused: ``wall_time_s`` is the *real* host
    seconds the run took, set only by :func:`record_wall_time`;
    ``sim_time_s`` the *simulated* seconds per round under the spec's
    systems profile, recorded by the drivers through ``time_model`` (or the
    events driver's event clock), empty without a profile.
    """

    loss: List[float] = dataclasses.field(default_factory=list)
    grad_sq_norm: List[float] = dataclasses.field(default_factory=list)
    consensus_err: List[float] = dataclasses.field(default_factory=list)
    is_global: List[bool] = dataclasses.field(default_factory=list)
    eval_metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    accountant: CommAccountant = dataclasses.field(default_factory=CommAccountant)
    byte_model: Optional[RoundByteModel] = None
    wall_time_s: float = 0.0
    # Final algorithm state (agent-stacked pytree NamedTuple), set by the
    # drivers when the run completes.  Excluded from to_dict().
    final_state: Any = None
    # RoundTimeModel (repro_torch.sim.costmodel) when the spec carries a
    # systems profile; holds live process objects, so excluded from to_dict().
    time_model: Any = None
    # Events driver only: per-round per-agent staleness counters (one
    # length-n list per executed round).  Empty for the sync drivers.
    staleness: List[List[int]] = dataclasses.field(default_factory=list)
    # Events driver only: the frozen event trace (repro_torch.events.clock),
    # read by ``price_history`` to reprice the run.  Excluded from to_dict().
    event_trace: Any = None
    # Byzantine runs only (not ported): fault mask and per-group eval series.
    adversary_mask: Optional[List[bool]] = None
    eval_per_agent: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    @property
    def sim_time_s(self) -> List[float]:
        """Simulated seconds per executed round (the accountant's ledger)."""
        return self.accountant.per_round_seconds

    def agent_params(self) -> Any:
        """The agent-stacked per-agent parameters ``x`` of the finished run
        (the first field of every algorithm state)."""
        st = self.final_state
        if st is None:
            raise ValueError(
                "History has no final_state — run the experiment first "
                "(final_state is set by the drivers on completion)"
            )
        x = getattr(st, "x", None)
        if x is None and isinstance(st, (tuple, list)) and len(st) > 0:
            x = st[0]
        if x is None:
            raise ValueError(f"cannot locate agent-stacked params in {type(st).__name__}")
        return x

    def running_mean_eval(self, key: str) -> np.ndarray:
        """Running mean of one eval metric over the eval points (float64)."""
        vals = np.array([m[key] for m in self.eval_metrics], dtype=np.float64)
        return np.cumsum(vals) / (np.arange(len(vals)) + 1)

    def rounds_to_threshold(
        self, key: str, threshold: float, mode: str = "running_le"
    ) -> Optional[int]:
        """First eval index where the metric crosses ``threshold`` — its
        running mean at or below it (``"running_le"``, the paper's Fig. 4
        criterion) or the metric itself at or above it (``"ge"``).  None if
        never reached."""
        if not self.eval_metrics:
            return None
        if mode == "running_le":
            hits = np.nonzero(self.running_mean_eval(key) <= threshold)[0]
        elif mode == "ge":
            series = np.array([m[key] for m in self.eval_metrics])
            hits = np.nonzero(series >= threshold)[0]
        else:
            raise ValueError(mode)
        return int(hits[0]) if hits.size else None

    def to_dict(self) -> dict:
        """JSON-serializable view for the benchmark writers (``final_state``
        is device data and is deliberately left out)."""

        def native(v):
            # numpy scalars -> python; python int/bool/float/str pass through
            # unchanged (the 'round' index stays an int)
            if isinstance(v, np.bool_):
                return bool(v)
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            return v

        return {
            "loss": [float(v) for v in self.loss],
            "grad_sq_norm": [float(v) for v in self.grad_sq_norm],
            "consensus_err": [float(v) for v in self.consensus_err],
            "is_global": [bool(v) for v in self.is_global],
            "eval_metrics": [
                {k: native(v) for k, v in m.items()} for m in self.eval_metrics
            ],
            "accountant": dataclasses.asdict(self.accountant),
            "byte_model": (
                dataclasses.asdict(self.byte_model)
                if self.byte_model is not None
                else None
            ),
            "wall_time_s": float(self.wall_time_s),
            "sim_time_s": [float(v) for v in self.sim_time_s],
            "sim_time_total_s": float(self.accountant.total_seconds),
            # a2a/a2s split of the simulated-seconds ledger, promoted to
            # top-level keys (the accountant dict above also carries the
            # totals, but consumers of the flat schema shouldn't have to know
            # the accountant's field names); the per-kind series are the
            # per-round ledger masked by round kind
            "sim_time_a2a_total_s": float(self.accountant.agent_to_agent_seconds),
            "sim_time_a2s_total_s": float(self.accountant.agent_to_server_seconds),
            "sim_time_a2a_s": [
                float(s) for s, g in zip(self.sim_time_s, self.is_global) if not g
            ],
            "sim_time_a2s_s": [
                float(s) for s, g in zip(self.sim_time_s, self.is_global) if g
            ],
            "staleness": [[int(v) for v in row] for row in self.staleness],
            "adversary_mask": (
                [bool(v) for v in self.adversary_mask]
                if self.adversary_mask is not None
                else None
            ),
            "eval_per_agent": [
                {k: native(v) for k, v in m.items()} for m in self.eval_per_agent
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "History":
        """Rebuild a History from :meth:`to_dict` output.

        ``final_state`` (device data) is not serialized and comes back
        ``None``; everything else round-trips exactly."""
        acct_d = d.get("accountant", {})
        acct = CommAccountant(
            **{
                f.name: acct_d[f.name]
                for f in dataclasses.fields(CommAccountant)
                if f.name in acct_d
            }
        )
        bm_d = d.get("byte_model")
        byte_model = RoundByteModel(**bm_d) if bm_d is not None else None
        return cls(
            loss=list(d.get("loss", [])),
            grad_sq_norm=list(d.get("grad_sq_norm", [])),
            consensus_err=list(d.get("consensus_err", [])),
            is_global=[bool(v) for v in d.get("is_global", [])],
            eval_metrics=[dict(m) for m in d.get("eval_metrics", [])],
            accountant=acct,
            byte_model=byte_model,
            wall_time_s=float(d.get("wall_time_s", 0.0)),
            staleness=[list(row) for row in d.get("staleness", [])],
            adversary_mask=(
                [bool(v) for v in d["adversary_mask"]]
                if d.get("adversary_mask") is not None
                else None
            ),
            eval_per_agent=[dict(m) for m in d.get("eval_per_agent", [])],
        )


@contextlib.contextmanager
def record_wall_time(*hists: "History"):
    """The single *real* wall-clock authority: times the enclosed block with
    ``time.perf_counter`` and writes the duration to every history's
    ``wall_time_s`` on exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        for h in hists:
            h.wall_time_s = dt
