"""Simulated systems costs: wall-clock network model, heterogeneity profiles,
and the p/τ communication autotuner (DESIGN.md §11; the port's twin of
``repro.sim``, host numpy over the port's topology processes).

The byte accountant answers "how much moved?"; this package answers "how long
did it take?" under a declarative fleet — per-agent compute, peer link
latency/bandwidth, server uplink/downlink — so experiments can be ranked by
simulated time-to-target instead of rounds or bytes.
"""
from repro_torch.sim.costmodel import (
    RoundTimeModel,
    SystemsModel,
    make_systems_model,
    make_time_model,
    price_history,
)
from repro_torch.sim.profiles import (
    FREE_NETWORK,
    PROFILE_NAMES,
    PROFILES,
    Profile,
    SystemsParams,
    make_profile,
    parse_systems_spec,
)
from repro_torch.sim.tuner import TunePoint, TunerResult, retime, tune

__all__ = [
    "FREE_NETWORK", "PROFILE_NAMES", "PROFILES", "Profile", "SystemsParams",
    "make_profile", "parse_systems_spec", "RoundTimeModel", "SystemsModel",
    "make_systems_model", "make_time_model", "price_history",
    "TunePoint", "TunerResult", "retime", "tune",
]
