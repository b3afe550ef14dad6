"""The simulated-clock event queue behind the ``events`` driver (DESIGN.md §13;
the port's own copy of ``repro.events.clock``, float64 numpy as there).

Where the synchronous cost model (:mod:`repro_torch.sim.costmodel`) prices
every round by the slowest realized agent/edge — a global barrier — this module
simulates **per-agent clocks**: each agent draws its compute and link times
from the same :class:`~repro_torch.sim.profiles.SystemsParams` realization and
advances through the logical round sequence at its own speed.

Three asynchronous mechanisms replace the barrier:

* **bounded-staleness gossip** — an agent that falls behind the round front
  accrues a staleness counter ``s``; once ``s`` exceeds the configured bound
  B its edges are dropped from its neighbors' mixes (self-weight absorption,
  exactly the link-failure re-weighting of DESIGN.md §9) and it stops gating
  round availability — neighbors no longer wait for it;

* **buffered server rounds** — a global round fires when the first ``m``
  participant pushes arrive (FedBuff-style buffer-of-m) instead of waiting
  for the straggler tail; the broadcast then *re-baselines* every
  participant's clock (server pushes preempt in-flight work) and resets
  staleness to zero — server rounds double as staleness resets, which is the
  semi-decentralized p/τ story on the time axis;

* **staleness-weighted aggregation** — each push is weighted by
  :func:`~repro_torch.events.staleness.staleness_weights` of its effective
  staleness at push time, applied through the mixing layer so the registry
  round functions (and any bound FedOpt server rule) run unchanged.

Everything is host-side numpy, **pure** in ``(profile realization, flag
sequence, async config)``.  The engine separates *what happened* (the gating
decisions: active edges, buffer cohorts — the event trace) from *how long it
took* (the clock replay over a fleet realization): :func:`reprice_trace`
replays the frozen trace under a different fleet, so a finished async run can
be re-priced under another profile without re-training — and repricing under
the original profile reproduces the online seconds bit-exactly, because the
online seconds are themselves produced by the same replay.

Degenerate fleets (uniform compute, free links) keep every clock in lockstep:
no edge is ever dropped, every buffer cohort is the full fleet, every weight
vector is exactly uniform — the engine reports ``trivial=True`` and the
driver falls back to the synchronous scan path bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.topology import metropolis_edge_weights, metropolis_weights
from repro_torch.events.staleness import AsyncConfig, parse_async_spec, staleness_weights
from repro_torch.sim.costmodel import SystemsModel, make_time_model


def _edge_costs(params, edges: np.ndarray, nbytes: int, mixes: int) -> np.ndarray:
    """Per-undirected-edge message time ``mixes * (latency + bytes/bw)`` —
    zero when nothing is shipped, matching the synchronous model."""
    if len(edges) == 0 or nbytes <= 0:
        return np.zeros(len(edges), dtype=np.float64)
    i, j = edges[:, 0], edges[:, 1]
    return float(mixes) * (
        params.link_latency_s[i, j] + float(nbytes) / params.link_bw_Bps[i, j]
    )


def _server_costs(params, nbytes: int, payloads: int):
    """``(up_time (n,), down_time (n,), rtt)`` — all zero for a free server
    exchange, matching the synchronous model."""
    n = len(params.up_bw_Bps)
    if nbytes <= 0:
        z = np.zeros(n, dtype=np.float64)
        return z, z, 0.0
    b = float(payloads) * float(nbytes)
    return b / params.up_bw_Bps, b / params.down_bw_Bps, float(params.server_rtt_s)


def reprice_trace(trace: Dict[str, Any], model: SystemsModel) -> np.ndarray:
    """Replay a frozen event trace's clock recursion under ``model``.

    The trace's gating decisions (active edges, buffer cohorts, participant
    sets) are *numerics* — they determined what the executed run computed —
    so repricing keeps them fixed and only re-draws the clock arithmetic:
    "how long would this exact executed schedule have taken on that fleet?"
    """
    p = model.params
    flags = np.asarray(trace["flags"], dtype=bool)
    edges = np.asarray(trace["base_edges"], dtype=np.int64).reshape(-1, 2)
    active = np.asarray(trace["active"], dtype=bool)
    gate = np.asarray(trace["gate"], dtype=bool)
    parts = np.asarray(trace["participants"], dtype=bool)
    steps = int(trace["local_steps"])
    n = int(trace["n_agents"])
    rounds = len(flags)

    ecost = _edge_costs(p, edges, int(trace["gossip_bytes"]), int(trace["mixes"]))
    up_t, down_t, rtt = _server_costs(
        p, int(trace["server_bytes"]), int(trace["payloads"])
    )
    compute = steps * p.compute_s

    T = np.zeros(n, dtype=np.float64)
    avail = 0.0
    seconds = np.zeros(rounds, dtype=np.float64)
    for k in range(rounds):
        cd = T + compute
        if flags[k]:
            part, cohort = parts[k], gate[k]
            push = cd + up_t
            if not cohort.any():
                cohort = part if part.any() else np.ones(n, dtype=bool)
            fire = float(push[cohort].max())
            event = fire + rtt + float(down_t[cohort].max())
            T = np.where(part, fire + rtt + down_t, cd)
        else:
            t_new = cd.copy()
            act = active[k]
            if act.any():
                ii, jj = edges[act, 0], edges[act, 1]
                c = ecost[act]
                # both endpoints wait for each other's message
                np.maximum.at(t_new, ii, cd[jj] + c)
                np.maximum.at(t_new, jj, cd[ii] + c)
            cohort = gate[k]
            event = float(t_new[cohort].max() if cohort.any() else t_new.max())
            T = t_new
        nxt = max(avail, event)
        seconds[k] = nxt - avail
        avail = nxt
    return seconds


@dataclasses.dataclass(eq=False)
class EventEngine:
    """One experiment's simulated event queue, fully realized at build time.

    Holds the per-round gating decisions, staleness counters, aggregation
    weights and availability seconds for the whole flag sequence; the driver
    consumes them block-by-block (:meth:`draw_block`, :attr:`seconds`) and
    exports :attr:`trace` onto the History for post-hoc repricing.
    """

    model: SystemsModel
    cfg: AsyncConfig
    flags: np.ndarray  # (R,) bool — predrawn schedule, the driver's source of truth
    base_edges: np.ndarray  # (m, 2) base undirected edge list
    process: Optional[Any] = None  # TopologyProcess (realized edges per round)
    participation: Optional[Any] = None  # ParticipationProcess
    local_steps: int = 1
    gossip_bytes: int = 0
    server_bytes: int = 0
    mixes: int = 1
    payloads: int = 1
    sparse: bool = False

    def __post_init__(self):
        self.flags = np.asarray(self.flags, dtype=bool)
        self.base_edges = np.asarray(self.base_edges, dtype=np.int64).reshape(-1, 2)
        self._simulate()
        self.seconds = reprice_trace(self.trace, self.model)

    @property
    def n_agents(self) -> int:
        return self.model.n_agents

    # -- event simulation ---------------------------------------------------

    def _realized_mask(self, k: int) -> np.ndarray:
        if self.process is not None:
            return np.asarray(self.process.edge_mask_at(k), dtype=bool)
        return np.ones(len(self.base_edges), dtype=bool)

    def _participants_mask(self, k: int) -> np.ndarray:
        part = np.zeros(self.n_agents, dtype=bool)
        if self.participation is not None:
            part[np.asarray(self.participation.participants_at(k), dtype=int)] = True
        else:
            part[:] = True
        return part

    def _simulate(self) -> None:
        p = self.model.params
        n, rounds = self.n_agents, len(self.flags)
        edges = self.base_edges
        ecost = _edge_costs(p, edges, self.gossip_bytes, self.mixes)
        up_t, down_t, rtt = _server_costs(p, self.server_bytes, self.payloads)
        compute = self.local_steps * p.compute_s
        # the round quantum: one median-agent round — "on time" means
        # finishing within one such round of the front
        q = float(np.median(compute)) + (
            float(np.median(ecost)) if len(ecost) else 0.0
        )

        T = np.zeros(n, dtype=np.float64)
        s = np.zeros(n, dtype=np.int64)
        active = np.zeros((rounds, len(edges)), dtype=bool)
        gate = np.zeros((rounds, n), dtype=bool)
        parts = np.zeros((rounds, n), dtype=bool)
        stale = np.zeros((rounds, n), dtype=np.int64)
        weights = np.zeros((rounds, n), dtype=np.float64)
        messages = np.zeros(rounds, dtype=np.int64)
        n_parts = np.zeros(rounds, dtype=np.int64)
        trivial = True

        for k in range(rounds):
            cd = T + compute
            if self.flags[k]:
                part = self._participants_mask(k)
                npart = int(part.sum())
                push = cd + up_t
                m_eff = npart if self.cfg.buffer is None else min(
                    self.cfg.buffer, npart
                )
                fire0 = float(np.sort(push[part])[m_eff - 1])
                ontime = part & (push <= fire0)
                # effective staleness at push time: the counter, plus one for
                # pushes that missed the buffer this round
                sigma = np.where(part, s + np.where(ontime, 0, 1), 0)
                w = staleness_weights(
                    sigma, self.cfg, ontime=ontime, participants=part
                )
                if not np.all(w[part] == 1.0 / npart):
                    trivial = False
                # the broadcast resets every participant's staleness
                s = np.where(part, 0, s)
                T = np.where(part, fire0 + rtt + down_t, cd)
                gate[k], parts[k] = ontime, part
                stale[k], weights[k] = sigma, w
                n_parts[k] = npart
            else:
                front = float(cd.min())
                ontime = cd <= front + q
                s = np.where(ontime, 0, s + 1)
                cohort = (
                    np.ones(n, dtype=bool)
                    if self.cfg.bound is None
                    else s <= self.cfg.bound
                )
                realized = self._realized_mask(k)
                if len(edges):
                    act = realized & cohort[edges[:, 0]] & cohort[edges[:, 1]]
                else:
                    act = realized
                if act.sum() != realized.sum():
                    trivial = False
                t_new = cd.copy()
                if act.any():
                    ii, jj = edges[act, 0], edges[act, 1]
                    c = ecost[act]
                    np.maximum.at(t_new, ii, cd[jj] + c)
                    np.maximum.at(t_new, jj, cd[ii] + c)
                T = t_new
                active[k], gate[k] = act, cohort
                parts[k] = True
                stale[k] = s
                weights[k] = 1.0 / n
                messages[k] = 2 * int(act.sum())
                n_parts[k] = n

        self.trivial = trivial
        self.staleness = stale
        self.weights = weights
        self.messages = messages
        self.n_participants = n_parts
        self.trace: Dict[str, Any] = {
            "flags": self.flags,
            "base_edges": edges,
            "active": active,
            "gate": gate,
            "participants": parts,
            "local_steps": int(self.local_steps),
            "mixes": int(self.mixes),
            "payloads": int(self.payloads),
            "gossip_bytes": int(self.gossip_bytes),
            "server_bytes": int(self.server_bytes),
            "n_agents": n,
            "systems": self.model.profile,
        }

    # -- per-block operands for the numerics --------------------------------

    def realized(self, start: int, stop: int):
        """``(messages, participants)`` counts for the byte accountant."""
        return self.messages[start:stop], self.n_participants[start:stop]

    def _server_ops(self, start: int, stop: int):
        w = self.weights[start:stop].astype(np.float32)
        keep = 1.0 - self.trace["participants"][start:stop].astype(np.float32)
        return {"w": w, "keep": keep}

    def draw_block(self, start: int, stop: int):
        """Event-derived mixing operands for rounds ``[start, stop)`` on the
        host: dense W_k stacks (or sparse edge weights in directed base-edge
        order) for gossip, and the ``{'w', 'keep'}`` staleness weights for
        the buffered server average — same contract as
        ``NetworkContext.draw_block``; :class:`~repro_torch.events.driver.
        EventNetwork` copies them to the device."""
        n, edges = self.n_agents, self.base_edges
        active = self.trace["active"]
        if self.sparse:
            m = len(edges)
            ew = np.zeros((stop - start, m), dtype=np.float32)
            sw = np.ones((stop - start, n), dtype=np.float32)
            for t, k in enumerate(range(start, stop)):
                if self.flags[k]:
                    continue  # unused branch operand at server rounds
                mask = active[k]
                if mask.any():
                    sub_w, self_w = metropolis_edge_weights(edges[mask], n)
                    ew[t, mask] = sub_w
                    sw[t] = self_w
            w_gossip = {
                "edge_w": np.concatenate([ew, ew], axis=1), "self_w": sw
            }
        else:
            ws = np.empty((stop - start, n, n), dtype=np.float32)
            eye = np.eye(n, dtype=np.float32)
            for t, k in enumerate(range(start, stop)):
                if self.flags[k]:
                    ws[t] = eye  # unused branch operand at server rounds
                else:
                    adj = np.zeros((n, n), dtype=bool)
                    e = edges[active[k]]
                    if len(e):
                        adj[e[:, 0], e[:, 1]] = True
                        adj[e[:, 1], e[:, 0]] = True
                    ws[t] = metropolis_weights(adj)
            w_gossip = ws
        return (
            w_gossip,
            self._server_ops(start, stop),
            self.messages[start:stop],
            self.n_participants[start:stop],
        )


def make_event_engine(
    spec: Any,
    byte_model: Any,
    flags: np.ndarray,
    *,
    network: Optional[Any] = None,
    systems: Optional[str] = None,
) -> EventEngine:
    """Build the :class:`EventEngine` for an ``ExperimentSpec`` — fleet,
    wire sizes, and network processes all come from the same
    :func:`~repro_torch.sim.costmodel.make_time_model` derivation the synchronous
    pricing uses, so both clocks see identical realizations."""
    tm = make_time_model(spec, byte_model, network=network, systems=systems)
    cfg = (
        parse_async_spec(spec.async_)
        if getattr(spec, "async_", None) is not None
        else AsyncConfig()
    )
    return EventEngine(
        model=tm.model,
        cfg=cfg,
        flags=flags,
        base_edges=tm.base_edges,
        process=tm.process,
        participation=tm.participation,
        local_steps=tm.local_steps,
        gossip_bytes=tm.gossip_message_bytes,
        server_bytes=tm.server_message_bytes,
        mixes=tm.mixes_per_round,
        payloads=tm.server_payloads,
        sparse=bool(getattr(spec, "use_sparse", False)),
    )
