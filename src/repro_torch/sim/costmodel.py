"""Simulated wall-clock pricing of communication rounds (DESIGN.md §11; the
port's own copy of ``repro.sim.costmodel``, host numpy over the port's
:mod:`repro_torch.core.topology`).

The byte ledger (:class:`~repro_torch.core.schedule.RoundByteModel`) says how much
data a round moves; this module says how long the round *takes* under a
:class:`~repro_torch.sim.profiles.SystemsParams` fleet.  The synchronous-round time
model:

* **gossip round** — every agent runs its local steps (the round is gated by
  the slowest agent in the fleet), then each mix moves one compressed message
  per directed realized edge, all edges in parallel — the mix is gated by the
  *slowest realized edge* (latency + bytes/bandwidth), and the protocol's
  ``mixes_per_round`` mixes are sequential (X then Y streams);

* **server round** — the sampled participants run their local steps (gated by
  the straggler tail of the *sample*, not the fleet), then the exchange costs
  one server RTT plus the slowest participant upload and the slowest
  broadcast download of ``server_payloads`` full-precision payloads.

Everything is host-side numpy and pure in ``(spec, round)``: topology /
participation realizations are re-drawn through the same seed-deterministic
processes the drivers use, so a finished :class:`~repro_torch.core.trainer.History`
can be (re)priced under any profile after the fact (:func:`price_history`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.core.schedule import RoundByteModel
from repro_torch.core.topology import (
    ParticipationProcess,
    TopologyProcess,
    make_sparse_topology,
    make_topology,
    make_topology_process,
    topology_edges,
    use_sparse_topology,
)
from repro_torch.sim.profiles import SystemsParams, make_profile


@dataclasses.dataclass(frozen=True)
class SystemsModel:
    """A realized fleet + the round-time arithmetic over it."""

    params: SystemsParams
    profile: str = "uniform"  # the spec string this fleet was drawn from

    @property
    def n_agents(self) -> int:
        return self.params.n_agents

    # -- phases -------------------------------------------------------------

    def compute_time(
        self, local_steps: int, agents: Optional[np.ndarray] = None
    ) -> float:
        """Synchronous local-update phase: ``local_steps`` gradient steps,
        gated by the slowest of ``agents`` (default: the whole fleet)."""
        c = self.params.compute_s if agents is None else self.params.compute_s[agents]
        if c.size == 0:
            return 0.0
        return float(local_steps) * float(c.max())

    def gossip_comm_time(
        self, edges: np.ndarray, message_bytes: int, *, mixes: int = 1
    ) -> float:
        """``mixes`` sequential mixes, each gated by the slowest realized
        edge: ``latency_ij + message_bytes / bw_ij``.  No realized edges (or
        a zero-byte message) costs nothing."""
        if len(edges) == 0 or message_bytes <= 0:
            return 0.0
        i, j = edges[:, 0], edges[:, 1]
        per_edge = (
            self.params.link_latency_s[i, j]
            + message_bytes / self.params.link_bw_Bps[i, j]
        )
        return float(mixes) * float(per_edge.max())

    def server_comm_time(
        self, participants: np.ndarray, message_bytes: int, *, payloads: int = 1
    ) -> float:
        """One RTT + slowest participant upload + slowest broadcast download
        of ``payloads`` payloads each way."""
        if len(participants) == 0 or message_bytes <= 0:
            return 0.0
        nbytes = float(payloads) * float(message_bytes)
        up = float((nbytes / self.params.up_bw_Bps[participants]).max())
        down = float((nbytes / self.params.down_bw_Bps[participants]).max())
        return self.params.server_rtt_s + up + down

    # -- whole rounds -------------------------------------------------------

    def gossip_round_time(
        self, edges: np.ndarray, message_bytes: int,
        *, mixes: int = 1, local_steps: int = 1,
    ) -> float:
        return self.compute_time(local_steps) + self.gossip_comm_time(
            edges, message_bytes, mixes=mixes
        )

    def server_round_time(
        self, participants: np.ndarray, message_bytes: int,
        *, payloads: int = 1, local_steps: int = 1,
    ) -> float:
        return self.compute_time(local_steps, participants) + self.server_comm_time(
            participants, message_bytes, payloads=payloads
        )


def make_systems_model(
    systems: str, n_agents: int, *, seed: int = 0
) -> SystemsModel:
    """Realize a profile spec string into a :class:`SystemsModel`."""
    profile = make_profile(systems)
    return SystemsModel(
        params=profile.realize(n_agents, seed=seed), profile=profile.spec()
    )


@dataclasses.dataclass(frozen=True, eq=False)
class RoundTimeModel:
    """Per-round simulated seconds for one experiment — the time analogue of
    :class:`~repro_torch.core.schedule.RoundByteModel`.

    Bundles the fleet with the experiment's wire sizes (from the byte model,
    so compression shortens transfers), the protocol's mix/payload counts,
    and the realized-network processes (pure in ``(seed, k)``) that decide
    *which* edges and participants gate each round.  The drivers call
    :meth:`round_time` as rounds execute; :meth:`price_rounds` re-prices a
    finished flag sequence post-hoc.
    """

    model: SystemsModel
    gossip_message_bytes: int
    server_message_bytes: int
    mixes_per_round: int
    server_payloads: int
    local_steps: int
    base_edges: np.ndarray  # (m, 2) static-topology fallback
    process: Optional[TopologyProcess] = None
    participation: Optional[ParticipationProcess] = None

    @property
    def n_agents(self) -> int:
        return self.model.n_agents

    def edges_at(self, k: int) -> np.ndarray:
        if self.process is not None:
            return self.process.edges_at(k)
        return self.base_edges

    def participants_at(self, k: int) -> np.ndarray:
        if self.participation is not None:
            return self.participation.participants_at(k)
        return np.arange(self.n_agents)

    def round_time(self, k: int, is_global: bool) -> float:
        if is_global:
            return self.model.server_round_time(
                self.participants_at(k),
                self.server_message_bytes,
                payloads=self.server_payloads,
                local_steps=self.local_steps,
            )
        return self.model.gossip_round_time(
            self.edges_at(k),
            self.gossip_message_bytes,
            mixes=self.mixes_per_round,
            local_steps=self.local_steps,
        )

    def round_parts(self, k: int, is_global: bool) -> dict:
        """Phase decomposition of :meth:`round_time` — ``local_steps`` plus
        ``server_sync`` (global) or ``gossip_mix`` (gossip), in execution
        order.  The parts sum to ``round_time(k, is_global)`` exactly (both
        sides are the same two float adds), which the obs layer relies on to
        nest phase spans inside each round span."""
        if is_global:
            parts = self.participants_at(k)
            return {
                "local_steps": self.model.compute_time(self.local_steps, parts),
                "server_sync": self.model.server_comm_time(
                    parts, self.server_message_bytes,
                    payloads=self.server_payloads,
                ),
            }
        return {
            "local_steps": self.model.compute_time(self.local_steps),
            "gossip_mix": self.model.gossip_comm_time(
                self.edges_at(k), self.gossip_message_bytes,
                mixes=self.mixes_per_round,
            ),
        }

    def price_rounds(
        self, is_global: Sequence[bool], *, start: int = 0
    ) -> np.ndarray:
        """Simulated seconds for an executed flag sequence (round ``start``
        onward) — identical to what the drivers would have recorded online."""
        return np.array(
            [self.round_time(start + i, bool(g)) for i, g in enumerate(is_global)],
            dtype=np.float64,
        )


def make_time_model(
    spec: Any,
    byte_model: RoundByteModel,
    *,
    network: Optional[Any] = None,
    systems: Optional[str] = None,
) -> RoundTimeModel:
    """Build the :class:`RoundTimeModel` for an ``ExperimentSpec``.

    ``network`` is the live :class:`~repro_torch.core.mixing.NetworkContext` when
    the caller has one (the Experiment wiring passes ``mixing.network`` so
    online pricing shares the exact process objects the driver draws from);
    without it the processes are re-derived from the spec — bit-identical,
    because every draw is a pure function of ``(seed, k)``.  ``systems``
    overrides ``spec.systems`` (post-hoc repricing under another profile).
    """
    systems = systems if systems is not None else spec.systems
    if systems is None:
        raise ValueError("spec has no systems profile (pass systems=...)")
    n = spec.config.n_agents
    seed = spec.config.seed
    model = make_systems_model(systems, n, seed=seed)

    from repro_torch.core.algorithms import get_algorithm  # local: avoid cycle

    comm = get_algorithm(spec.algo).comm
    local_steps = spec.config.t_o if comm.uses_local_updates else 1

    if network is not None:
        process = network.process
        part = network.participation
        base_edges = topology_edges(process.base)
    else:
        # mirror the spec's dense/sparse selection so large sparse fleets are
        # priced without an O(n^2) adjacency materialization
        if use_sparse_topology(getattr(spec, "sparse", None), n):
            topo = make_sparse_topology(
                spec.topology, n, **dict(spec.topology_kwargs)
            )
        else:
            topo = make_topology(spec.topology, n, **dict(spec.topology_kwargs))
        base_edges = topology_edges(topo)
        net_spec = getattr(spec, "effective_network", spec.network)
        if net_spec is None and spec.participation >= 1.0:
            process, part = None, None  # legacy frozen-W path
        else:
            process = make_topology_process(net_spec, topo, seed=seed)
            part = (
                ParticipationProcess(n, spec.participation, seed=seed)
                if spec.participation < 1.0
                else None
            )
    return RoundTimeModel(
        model=model,
        gossip_message_bytes=byte_model.gossip_message_bytes,
        server_message_bytes=byte_model.server_message_bytes,
        mixes_per_round=byte_model.mixes_per_round,
        server_payloads=byte_model.server_payloads,
        local_steps=local_steps,
        base_edges=base_edges,
        process=process,
        participation=part,
    )


def price_history(
    hist: Any, spec: Any, *, systems: Optional[str] = None
) -> np.ndarray:
    """Per-round simulated seconds for a finished History under ``spec``
    (optionally repriced under another ``systems`` profile).

    Uses the History's own byte model (so compression wire sizes carry over)
    and its executed ``is_global`` flags; network realizations are re-drawn
    pure-in-``(seed, k)``, so this matches the online series exactly.

    Histories produced by the events driver carry a frozen event trace: its
    gating decisions (active edges, buffer cohorts) are part of the executed
    numerics, so repricing replays only the per-agent clock recursion under
    the new fleet (:func:`repro_torch.events.clock.reprice_trace`) — under the
    original profile this reproduces the online ``sim_time_s`` bit-exactly.
    """
    trace = getattr(hist, "event_trace", None)
    if trace is not None:
        # local import: the events subsystem builds on this module
        from repro_torch.events.clock import reprice_trace

        systems = systems if systems is not None else spec.systems
        if systems is None:
            raise ValueError("spec has no systems profile (pass systems=...)")
        model = make_systems_model(
            systems, int(trace["n_agents"]), seed=spec.config.seed
        )
        # the clock recursion is causal, so a full-trace replay sliced to the
        # executed prefix equals replaying the prefix (early stop_when exits)
        return reprice_trace(trace, model)[: len(hist.is_global)]
    if hist.byte_model is None:
        raise ValueError("history has no byte model; was it driven normally?")
    tm = make_time_model(spec, hist.byte_model, systems=systems)
    return tm.price_rounds(hist.is_global)
