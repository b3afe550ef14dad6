"""Named systems-heterogeneity profiles (devices + links), seed-deterministic
(the port's own copy of ``repro.sim.profiles``: the same draws, bit for bit).

A profile answers "what does the hardware under the federation look like?" —
per-agent compute throughput, peer-to-peer link latency/bandwidth, and the
server uplink/downlink path — as *declarative data*: a name plus ``k=v``
overrides, the same string grammar the rest of the repo uses for networks and
update rules.  ``ExperimentSpec.systems`` stores exactly this string.

    "uniform"                                  # homogeneous LAN-ish fleet
    "uniform:latency=0,bw=inf,rtt=0"           # free network: compute-only time
    "lognormal-stragglers"                     # per-agent lognormal compute tail
    "edge-vs-datacenter"                       # two device classes, thin uplinks
    "wan-gossip"                               # p2p links are WAN, server is DC
    "lan-gossip"                               # p2p links are LAN, server is far

Realizations are **pure functions of (profile, n_agents, seed)** — the same
contract as :class:`~repro_torch.core.topology.TopologyProcess` draws — so
the loop driver, the scan driver, and any post-hoc repricing of a finished
History see bit-identical straggler/latency draws.  Everything here is host-side numpy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np

# Domain-separation tag for profile draws, disjoint from the link (0x11AA) and
# participation (0x77EE) tags in repro_torch.core.topology.
_SIM_TAG = 0x51D3

# Parameter vocabulary (all floats; bandwidths in bytes/s, times in seconds):
#   compute        — seconds one agent spends per local gradient step
#   compute_sigma  — lognormal sigma of per-agent compute multipliers
#   latency        — one-way peer link latency
#   latency_sigma  — lognormal sigma of per-link latency multipliers
#   bw             — peer link bandwidth
#   up_bw/down_bw  — per-agent server uplink / downlink bandwidth
#   rtt            — fixed server round-trip overhead per server exchange
PARAM_KEYS = (
    "compute", "compute_sigma", "latency", "latency_sigma",
    "bw", "up_bw", "down_bw", "rtt",
)

_BASE = dict(
    compute=0.01, compute_sigma=0.0, latency=2e-3, latency_sigma=0.0,
    bw=1.25e8, up_bw=1.25e7, down_bw=2.5e7, rtt=0.04,
)

# Named scenarios.  Each is _BASE plus what makes it interesting.
PROFILES: Dict[str, Dict[str, float]] = {
    # homogeneous fleet on a fast local network
    "uniform": dict(_BASE),
    # same fleet, but per-agent compute is lognormal — the classic straggler
    # tail; gossip and server rounds are gated by the slowest realized agent
    "lognormal-stragglers": dict(_BASE, compute_sigma=0.8),
    # two device classes: the first half of the agents are datacenter nodes
    # (8x faster compute, 10x fatter server links, fast DC-DC peering), the
    # second half are edge devices (2x slower compute, thin uplinks)
    "edge-vs-datacenter": dict(_BASE, latency_sigma=0.1),
    # peer links cross the WAN (high latency, thin), the server is a nearby
    # datacenter — gossip rounds are the expensive kind here
    "wan-gossip": dict(
        _BASE, latency=0.08, latency_sigma=0.3, bw=2.5e6,
        up_bw=1.25e8, down_bw=2.5e8, rtt=0.05,
    ),
    # peer links are cheap LAN, the server is far away behind a thin pipe —
    # server rounds are the expensive kind (the paper's motivating regime)
    "lan-gossip": dict(
        _BASE, latency=5e-4, bw=1.25e9, up_bw=2.5e6, down_bw=5e6, rtt=0.3,
    ),
}

PROFILE_NAMES = tuple(sorted(PROFILES))

# The degenerate "network costs nothing" profile: zero latency, infinite
# bandwidth everywhere, no server RTT.  Under it, simulated round time
# reduces *exactly* to the compute phase (local_steps x slowest agent) —
# the reduction the sim acceptance tests pin.
FREE_NETWORK = "uniform:latency=0,bw=inf,up_bw=inf,down_bw=inf,rtt=0"


def parse_systems_spec(spec: str) -> Tuple[str, Dict[str, float]]:
    """Validate ``'name[:k=v,k=v]'`` and return ``(name, overrides)``.

    ``ExperimentSpec`` calls this at construction so typos fail fast."""
    name, _, arg = spec.partition(":")
    if name not in PROFILES:
        raise ValueError(
            f"unknown systems profile {name!r}; options: {PROFILE_NAMES}"
            f" (e.g. 'wan-gossip', 'uniform:latency=0,bw=inf,rtt=0')"
        )
    overrides: Dict[str, float] = {}
    if arg:
        for item in arg.split(","):
            key, eq, val = item.partition("=")
            if not eq or key not in PARAM_KEYS:
                raise ValueError(
                    f"bad systems override {item!r} in {spec!r}; "
                    f"expected k=v with k in {PARAM_KEYS}"
                )
            v = float(val)  # 'inf' parses to float('inf')
            # bandwidths divide the message size: zero/negative would turn
            # the seconds ledger into inf/negative garbage with no error
            if key in ("bw", "up_bw", "down_bw") and not v > 0:
                raise ValueError(
                    f"systems override {item!r} in {spec!r}: "
                    f"bandwidths must be positive (inf allowed)"
                )
            if v < 0 or (key not in ("bw", "up_bw", "down_bw") and np.isinf(v)):
                raise ValueError(
                    f"systems override {item!r} in {spec!r}: "
                    f"{key} must be finite and >= 0"
                )
            overrides[key] = v
    return name, overrides


@dataclasses.dataclass(frozen=True)
class SystemsParams:
    """One realized fleet: per-agent / per-link quantities (host numpy).

    ``link_latency_s`` / ``link_bw_Bps`` are symmetric (n, n) matrices over
    *all* pairs — which edges actually carry traffic in a round is the
    topology process's business, not the profile's.
    """

    compute_s: np.ndarray  # (n,) seconds per local gradient step
    link_latency_s: np.ndarray  # (n, n) one-way peer latency
    link_bw_Bps: np.ndarray  # (n, n) peer bandwidth
    up_bw_Bps: np.ndarray  # (n,) server uplink
    down_bw_Bps: np.ndarray  # (n,) server downlink
    server_rtt_s: float

    @property
    def n_agents(self) -> int:
        return int(self.compute_s.shape[0])

    def to_dict(self) -> dict:
        def enc(a):
            # inf survives JSON as the string "inf" (json.dumps would emit
            # the non-portable bare Infinity token)
            return np.where(np.isinf(a), None, a).tolist()

        return {
            "compute_s": self.compute_s.tolist(),
            "link_latency_s": self.link_latency_s.tolist(),
            "link_bw_Bps": enc(self.link_bw_Bps),
            "up_bw_Bps": enc(self.up_bw_Bps),
            "down_bw_Bps": enc(self.down_bw_Bps),
            "server_rtt_s": float(self.server_rtt_s),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SystemsParams":
        def dec(v):
            a = np.array(
                [[np.inf if x is None else x for x in row] for row in v]
                if v and isinstance(v[0], list)
                else [np.inf if x is None else x for x in v],
                dtype=np.float64,
            )
            return a

        return cls(
            compute_s=np.asarray(d["compute_s"], dtype=np.float64),
            link_latency_s=np.asarray(d["link_latency_s"], dtype=np.float64),
            link_bw_Bps=dec(d["link_bw_Bps"]),
            up_bw_Bps=dec(d["up_bw_Bps"]),
            down_bw_Bps=dec(d["down_bw_Bps"]),
            server_rtt_s=float(d["server_rtt_s"]),
        )


@dataclasses.dataclass(frozen=True)
class Profile:
    """A named scenario + overrides; :meth:`realize` draws one fleet."""

    name: str
    overrides: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.name not in PROFILES:
            raise ValueError(
                f"unknown systems profile {self.name!r}; options: {PROFILE_NAMES}"
            )
        if isinstance(self.overrides, dict):
            object.__setattr__(
                self, "overrides", tuple(sorted(self.overrides.items()))
            )

    # -- serialization ------------------------------------------------------

    def spec(self) -> str:
        """Round-trippable string form (``parse_systems_spec`` inverse)."""
        if not self.overrides:
            return self.name
        kv = ",".join(f"{k}={v:g}" for k, v in self.overrides)
        return f"{self.name}:{kv}"

    def to_dict(self) -> dict:
        return {"name": self.name, "overrides": dict(self.overrides)}

    @classmethod
    def from_dict(cls, d: dict) -> "Profile":
        return cls(name=d["name"], overrides=tuple(sorted(d.get("overrides", {}).items())))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Profile":
        return cls.from_dict(json.loads(s))

    # -- realization --------------------------------------------------------

    def params(self) -> Dict[str, float]:
        base = dict(PROFILES[self.name])
        base.update(dict(self.overrides))
        return base

    def realize(self, n_agents: int, *, seed: int = 0) -> SystemsParams:
        """Draw one fleet — a pure function of ``(self, n_agents, seed)``.

        Draw order is fixed (compute multipliers, then link-latency
        multipliers) so realizations are reproducible across drivers and
        across partial consumers.
        """
        p = self.params()
        n = int(n_agents)
        rng = np.random.default_rng((_SIM_TAG, int(seed)))

        compute = np.full(n, p["compute"], dtype=np.float64)
        if p["compute_sigma"] > 0:
            compute = compute * rng.lognormal(
                mean=-0.5 * p["compute_sigma"] ** 2,  # E[mult] = 1
                sigma=p["compute_sigma"], size=n,
            )

        latency = np.full((n, n), p["latency"], dtype=np.float64)
        if p["latency_sigma"] > 0:
            mult = rng.lognormal(
                mean=-0.5 * p["latency_sigma"] ** 2,
                sigma=p["latency_sigma"], size=(n, n),
            )
            mult = np.triu(mult, k=1)
            latency = latency * (mult + mult.T + np.eye(n))

        bw = np.full((n, n), p["bw"], dtype=np.float64)
        up = np.full(n, p["up_bw"], dtype=np.float64)
        down = np.full(n, p["down_bw"], dtype=np.float64)

        if self.name == "edge-vs-datacenter":
            # first half datacenter, second half edge (deterministic split)
            dc = np.arange(n) < (n + 1) // 2
            compute = np.where(dc, compute / 8.0, compute * 2.0)
            up = np.where(dc, up * 10.0, up / 10.0)
            down = np.where(dc, down * 10.0, down / 10.0)
            dc_pair = np.outer(dc, dc)
            bw = np.where(dc_pair, bw * 10.0, bw)
            latency = np.where(dc_pair, latency / 4.0, latency)

        np.fill_diagonal(latency, 0.0)
        return SystemsParams(
            compute_s=compute,
            link_latency_s=latency,
            link_bw_Bps=bw,
            up_bw_Bps=up,
            down_bw_Bps=down,
            server_rtt_s=float(p["rtt"]),
        )


def make_profile(spec: str) -> Profile:
    """Parse ``'name[:k=v,...]'`` into a :class:`Profile`."""
    name, overrides = parse_systems_spec(spec)
    return Profile(name=name, overrides=tuple(sorted(overrides.items())))
