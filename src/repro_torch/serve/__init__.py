"""Personalised-fleet serving: delta-compressed weights, continuous-batched
multiplexed decode, and a simulated-traffic load model (the twin of
``repro.serve``).  ``python -m repro_torch.serve`` runs the twin of the
reference's ``examples/serve_decode.py``."""
from repro_torch.serve.batcher import ContinuousBatcher, Request
from repro_torch.serve.delta import (
    DeltaSpec,
    DenseFleet,
    FleetDelta,
    materialize,
    materialize_fleet,
)
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.load import ArrivalProcess, ServeReport, StepCosts, make_requests, run_load

__all__ = [
    "ArrivalProcess",
    "ContinuousBatcher",
    "DecodeEngine",
    "DeltaSpec",
    "DenseFleet",
    "FleetDelta",
    "Request",
    "ServeReport",
    "StepCosts",
    "make_requests",
    "materialize",
    "materialize_fleet",
    "run_load",
]
