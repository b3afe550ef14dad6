"""When does async win?  Sync barrier against event-queue execution on the
port (twin of ``benchmarks/fig_async.py``).

The synchronous drivers price every round at the slowest realized
agent/edge — the barrier.  The events driver (:mod:`repro_torch.events`)
replaces it with per-agent clocks, bounded-staleness gossip, and a buffered
staleness-weighted server aggregator.  This figure runs the same §5.1 logreg
workload both ways under three fleets; the rounds run on the device (K1 for
the local steps; gossip over the engine's W_k, the server round its
staleness-weighted mean), the clock is host numpy, bit-equal to the
reference's.

Claims exercised:

* **degenerate fleet** (``FREE_NETWORK``) — the events run is trivial and
  its loss trajectory **bit-identical** to the scan driver's;
* **straggler/wan fleets** — the barrier pays the tail every round while
  the async run drops stale agents from gossip gating and fires server
  rounds at the m-th push, so simulated time-to-target flips to async;
* **repricing** — the async run's frozen event trace re-prices under
  another profile without re-training, and under its own profile reproduces
  the online ``sim_time_s`` ledger exactly.

Writes ``BENCH_async.json`` (``artifacts/torch/`` by default).

    python -m repro_torch.figures.fig_async [--quick] [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.data import RoundSampler
from repro_torch.device import resolve_device
from repro_torch.figures.common import Tally, make_logreg_workload, save_result
from repro_torch.sim import FREE_NETWORK, price_history
from repro_torch.sim.tuner import _smoothed

PROFILES_SWEPT = (
    ("free", FREE_NETWORK),
    ("lognormal-stragglers", "lognormal-stragglers"),
    ("wan-gossip", "wan-gossip"),
)


def _readout(hist, target: float, window: int) -> dict:
    series = _smoothed(hist.loss, window)
    secs = np.cumsum(np.asarray(hist.sim_time_s, dtype=np.float64))
    # the heterogeneous logreg trajectory dips below its consensus value in
    # the first few local-overfit rounds, then climbs to a peak and descends;
    # "time to target" means the descent crossing, so search from the peak
    start = int(np.argmax(series))
    hits = start + np.nonzero(series[start:] <= target)[0]
    out = {
        "rounds": len(hist.loss),
        "final_loss": float(series[-1]),
        "total_sim_time_s": float(secs[-1]) if secs.size else 0.0,
        "time_to_target_s": float(secs[hits[0]]) if hits.size else None,
    }
    if hist.staleness:
        out["peak_staleness"] = int(np.max(hist.staleness))
    return out


def async_config(n_agents: int) -> str:
    """The figure's async rule: poly decay, staleness bound 2, a server
    buffer of half the fleet."""
    return f"poly:alpha=0.5,bound=2,buffer={max(2, n_agents // 2)}"


def cell_specs(n_agents: int, systems: str, rounds: int, seed: int = 0):
    """(sync, async) specs of one profile's cell."""
    sync_spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_agents, t_o=2, eta_l=0.1, p=0.1, seed=seed,
        rounds=rounds, eval_every=rounds, driver="scan", systems=systems,
    )
    return sync_spec, sync_spec.replace(driver="events", async_=async_config(n_agents))


def cell_readout(h_sync, h_async, systems: str, window: int) -> dict:
    target = 1.05 * max(
        float(_smoothed(h_sync.loss, window)[-1]),
        float(_smoothed(h_async.loss, window)[-1]),
    )
    return {
        "systems": systems,
        "target_loss": target,
        "sync": _readout(h_sync, target, window),
        "async": _readout(h_async, target, window),
        # the degenerate-fleet acceptance pin: identical rounds
        "bit_identical_loss": list(h_sync.loss) == list(h_async.loss),
    }


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 200 if quick else 600
    window = max(1, min(20, rounds // 10))
    data, loss_fn, _eval_fn, params0 = make_logreg_workload(quick=quick, seed=seed, device=dev)
    n = data.n_agents
    b = min(256, data.samples_per_agent)
    pieces = dict(
        loss_fn=loss_fn,
        params0=params0,
        device=dev,
        sampler_factory=lambda s: RoundSampler(data, b, s.config.t_o, s.config.seed,
                                               device=dev),
    )

    profiles = {}
    reprice = None
    for label, prof in PROFILES_SWEPT:
        sync_spec, async_spec = cell_specs(n, prof, rounds, seed)
        h_sync = Experiment(sync_spec, **pieces).run()
        h_async = Experiment(async_spec, **pieces).run()
        tally.add(h_sync)
        tally.add(h_async)
        profiles[label] = cell_readout(h_sync, h_async, prof, window)
        if label == "wan-gossip":
            # the same profile must reproduce the online ledger exactly;
            # other profiles come for free
            same = price_history(h_async, async_spec)
            reprice = {
                "self_exact": bool(np.array_equal(same, np.asarray(h_async.sim_time_s))),
                "under_stragglers_total_s": float(
                    price_history(h_async, async_spec, systems="lognormal-stragglers").sum()),
            }

    payload = tally.stamp({
        "bench": "fig_async",
        "quick": quick,
        "async_config": async_config(n),
        "profiles": profiles,
        "reprice": reprice,
    })
    save_result("BENCH_async", payload, out_dir, device=dev)
    return payload


def async_flip(profiles: dict):
    """Per-profile sync/async simulated-time speedup — the flip readout.

    Uses time-to-target when both runs reach it, else total simulated time
    (same executed round count either way).  > 1 means async is faster."""
    out = {}
    for label, cell in profiles.items():
        s, a = cell["sync"], cell["async"]
        if s["time_to_target_s"] is not None and a["time_to_target_s"] is not None:
            out[label] = s["time_to_target_s"] / max(a["time_to_target_s"], 1e-12)
        else:
            out[label] = s["total_sim_time_s"] / max(a["total_sim_time_s"], 1e-12)
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    speed = async_flip(payload["profiles"])
    print(f"async config: {payload['async_config']}")
    print(f"{'profile':>22} | {'sync s->tgt':>11} | {'async s->tgt':>12} | "
          f"{'speedup':>7} | bit-identical")
    for label, cell in payload["profiles"].items():
        fmt = lambda v: f"{v:.2f}" if v is not None else "---"  # noqa: E731
        print(f"{label:>22} | {fmt(cell['sync']['time_to_target_s']):>11} | "
              f"{fmt(cell['async']['time_to_target_s']):>12} | "
              f"{speed[label]:7.2f} | {cell['bit_identical_loss']}")
    if payload["reprice"]:
        print(f"event-trace reprice self-exact: {payload['reprice']['self_exact']}")


if __name__ == "__main__":
    main()
