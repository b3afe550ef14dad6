"""Host-side communication schedules and cost accounting.

The paper's line 8 — ``W^k = J w.p. p else W`` — is an i.i.d. Bernoulli(p)
sequence.  We also provide the deterministic every-H schedule of Gossip-PGA /
HL-SGD for the baseline comparisons (Table 1), and an accountant that tallies
agent-to-agent vs agent-to-server rounds (Figure 4's x/y axes) — now also in
*bytes*, so compressed-gossip runs can put bits on the x-axis: server rounds
ship full precision while gossip rounds ship whatever the attached compressor
prices (:class:`RoundByteModel`, built by
:func:`repro_torch.core.compression.make_byte_model`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CommAccountant:
    """Counts communication rounds — bytes, and simulated seconds — by kind.

    ``per_round_bytes`` keeps the realized per-round charge in round order, so
    bytes-to-target-accuracy readouts stay exact under dynamic networks where
    rounds are no longer interchangeable (link failures / partial
    participation make every round's byte cost a random variable).

    ``per_round_seconds`` is the same ledger on the *time* axis: when a
    systems model is attached (``ExperimentSpec.systems``, DESIGN.md §11) the
    drivers record each round's simulated wall-clock alongside its bytes.
    Runs without a systems model leave the seconds ledger empty — the
    pre-sim behavior, bit-identical.
    """

    agent_to_agent: int = 0
    agent_to_server: int = 0
    agent_to_agent_bytes: int = 0
    agent_to_server_bytes: int = 0
    per_round_bytes: list = dataclasses.field(default_factory=list)
    agent_to_agent_seconds: float = 0.0
    agent_to_server_seconds: float = 0.0
    per_round_seconds: list = dataclasses.field(default_factory=list)

    def record(
        self, is_global: bool, nbytes: int = 0, seconds: Optional[float] = None
    ) -> None:
        self.per_round_bytes.append(int(nbytes))
        if seconds is not None:
            self.per_round_seconds.append(float(seconds))
        if is_global:
            self.agent_to_server += 1
            self.agent_to_server_bytes += nbytes
            if seconds is not None:
                self.agent_to_server_seconds += seconds
        else:
            self.agent_to_agent += 1
            self.agent_to_agent_bytes += nbytes
            if seconds is not None:
                self.agent_to_agent_seconds += seconds

    @property
    def total(self) -> int:
        return self.agent_to_agent + self.agent_to_server

    @property
    def total_bytes(self) -> int:
        return self.agent_to_agent_bytes + self.agent_to_server_bytes

    @property
    def total_seconds(self) -> float:
        return self.agent_to_agent_seconds + self.agent_to_server_seconds


@dataclasses.dataclass(frozen=True)
class RoundByteModel:
    """Closed-form network-wide bytes for one communication round.

    A gossip round moves compressed neighbor messages; a server round moves
    full-precision uploads + broadcast downloads.  Pure arithmetic — the
    sizing lives in :func:`repro_torch.core.compression.make_byte_model`.
    """

    gossip_round_bytes: int
    server_round_bytes: int
    gossip_message_bytes: int = 0  # one agent's compressed message
    server_message_bytes: int = 0  # one agent's full-precision message
    mixes_per_round: int = 1  # mixing invocations per gossip round
    server_payloads: int = 1  # payloads per direction of a server exchange

    def round_bytes(self, is_global: bool) -> int:
        return self.server_round_bytes if is_global else self.gossip_round_bytes

    # -- realized-network pricing (dynamic topologies / participation) ------

    def realized_gossip_bytes(self, directed_messages: int) -> int:
        """Bytes for one gossip round that realized ``directed_messages``
        neighbor messages per mix (2 x realized undirected edges)."""
        return self.mixes_per_round * directed_messages * self.gossip_message_bytes

    def realized_server_bytes(self, participants: int) -> int:
        """Bytes for one server round with ``participants`` agents sampled:
        each participant uploads + downloads ``server_payloads`` payloads."""
        return self.server_payloads * 2 * participants * self.server_message_bytes

    def realized_round_bytes(
        self, is_global: bool, directed_messages: int, participants: int
    ) -> int:
        if is_global:
            return self.realized_server_bytes(participants)
        return self.realized_gossip_bytes(directed_messages)

    def total_bytes(self, n_gossip_rounds: int, n_server_rounds: int) -> int:
        """Exact total for a realized schedule (what the accountant tallies)."""
        return (
            n_gossip_rounds * self.gossip_round_bytes
            + n_server_rounds * self.server_round_bytes
        )

    def expected_bytes(self, rounds: int, p: float) -> float:
        """E[bytes] after ``rounds`` i.i.d. Bernoulli(p) draws."""
        return rounds * (
            p * self.server_round_bytes + (1.0 - p) * self.gossip_round_bytes
        )

    def periodic_bytes(self, rounds: int, period: int) -> int:
        """Exact total under the every-H schedule (server when (k+1) % H == 0)."""
        n_server = rounds // period
        return self.total_bytes(rounds - n_server, n_server)


class BernoulliSchedule:
    """PISCO's probabilistic schedule: True => server round (W^k = J)."""

    def __init__(self, p: float, seed: int = 0):
        assert 0.0 <= p <= 1.0
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, step: int) -> bool:
        if self.p <= 0.0:
            return False
        if self.p >= 1.0:
            return True
        return bool(self._rng.random() < self.p)


class PeriodicSchedule:
    """Gossip-PGA / HL-SGD style: server every H rounds (H = period)."""

    def __init__(self, period: int):
        assert period >= 1
        self.period = period

    def __call__(self, step: int) -> bool:
        return (step + 1) % self.period == 0


class NeverSchedule:
    def __call__(self, step: int) -> bool:
        return False


class AlwaysSchedule:
    def __call__(self, step: int) -> bool:
        return True


def make_schedule(p: float, seed: int = 0):
    if p <= 0.0:
        return NeverSchedule()
    if p >= 1.0:
        return AlwaysSchedule()
    return BernoulliSchedule(p, seed)
