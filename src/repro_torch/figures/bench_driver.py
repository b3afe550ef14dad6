"""Round-driver microbenchmark: per-round host loop vs block driver vs events
(twin of ``benchmarks/bench_driver.py``).

Runs the quick Fig.-4 setting (§5.1 logreg workload, 10-agent ring, p = 0.1)
under the three drivers with identical specs and batches, three reps each,
and writes ``BENCH_driver.json`` (``artifacts/torch/`` by default).

Batches for all rounds are drawn and cached *outside* the timed region (the
data pipeline is the same for every driver), so the readout isolates the
driver's own cost:

* ``compile_s`` — the first drive's wall time minus the best warm drive's.
  The port has no jit: what the cold drive pays once is the kernels' build
  and load (``compile_events_s``, from
  :func:`repro_torch.obs.profile.track_compile_time`, zero once the
  libraries are loaded) and PyTorch's first-call set-up;
* ``per_round_s`` — the best warm drive per round: one device→host sync
  per *block* for the block and events drivers against one per *round* for
  the loop (the reference's ``scan`` is ``lax.scan``; the port's is the
  block driver, :func:`repro_torch.core.driver.drive_scan`).

The events driver runs under the degenerate ``FREE_NETWORK`` fleet, so its
rounds are the block driver's and the comparison is the event clock's own
overhead.

    python -m repro_torch.figures.bench_driver [--full] [--profile DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import ExperimentSpec, get_algorithm, replicate_params
from repro_torch.core.compression import make_byte_model
from repro_torch.core.driver import drive_loop, drive_scan, predraw_schedule
from repro_torch.core.schedule import make_schedule
from repro_torch.core.trainer import History, record_wall_time
from repro_torch.data import RoundSampler
from repro_torch.device import resolve_device
from repro_torch.figures.common import make_logreg_workload, save_result, sync
from repro_torch.obs.profile import profile_capture, track_compile_time
from repro_torch.sim import FREE_NETWORK


class _CachedSampler:
    """Replays pre-drawn batches, so warm reps measure the driver alone."""

    def __init__(self, sampler, rounds: int):
        self._batches = {k: sampler(k) for k in range(-1, rounds)}

    def __call__(self, k: int):
        return self._batches[k]


def _drive_reps(driver: str, *, rounds: int, eval_every: int, quick: bool, dev):
    """Three identical drives over cached batches (a fresh schedule each):
    one cold, two warm."""
    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=quick, seed=0, device=dev)
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=data.n_agents, t_o=1, eta_l=0.5, p=0.1, seed=0,
        rounds=rounds, eval_every=eval_every, driver=driver,
        systems=FREE_NETWORK if driver == "events" else None,
    )
    mixing = spec.make_mixing(dev)
    bound = get_algorithm(spec.algo).bind(loss_fn, spec.config, mixing)
    x0 = replicate_params(params0, spec.config.n_agents)

    def byte_model(b):
        return make_byte_model(mixing, x0, spec.config.n_agents,
                               mixes_per_round=b.comm.mixes_per_round,
                               server_payloads=b.comm.server_payloads)

    if driver == "scan":
        drive, extra = drive_scan, {"block_size": spec.block_size}
    elif driver == "events":
        from repro_torch.events.clock import make_event_engine
        from repro_torch.events.driver import drive_events

        engine = make_event_engine(spec, byte_model(bound),
                                   predraw_schedule(bound.schedule, 0, rounds),
                                   network=mixing.network)
        assert engine.trivial  # FREE_NETWORK: the block driver's rounds
        drive, extra = drive_events, {"block_size": spec.block_size, "engine": engine}
    else:
        drive, extra = drive_loop, {}

    sampler = _CachedSampler(RoundSampler(data, 256, 1, 0, device=dev), rounds)
    out = []
    for _rep in range(3):
        # a fresh, identically seeded schedule per rep
        b = dataclasses.replace(bound, schedule=make_schedule(spec.config.p, spec.config.seed))
        _, comm0 = sampler(-1)
        state = b.init(loss_fn, x0, comm0)
        hist = History(byte_model=byte_model(b))
        with record_wall_time(hist):
            state = drive(b, state, sampler, rounds, hist, eval_fn=eval_fn,
                          eval_every=eval_every, **extra)
            sync(dev)
        hist.final_state = state
        out.append(hist)
    return out


def run(quick: bool = True, profile_dir: str | None = None, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    rounds = 150 if quick else 600
    eval_every = 25 if quick else 50
    results = {}
    with profile_capture(profile_dir):
        for driver in ("loop", "scan", "events"):
            with track_compile_time() as cstats:
                cold, *warms = _drive_reps(driver, rounds=rounds, eval_every=eval_every,
                                           quick=quick, dev=dev)
            warm = min(warms, key=lambda h: h.wall_time_s)
            results[driver] = {
                "driver": driver,
                "rounds": rounds,
                "eval_every": eval_every,
                "compile_s": max(cold.wall_time_s - warm.wall_time_s, 0.0),
                "cold_wall_s": cold.wall_time_s,
                "per_round_s": warm.wall_time_s / rounds,
                "final_loss": warm.loss[-1],
                "a2a_rounds": warm.accountant.agent_to_agent,
                "a2s_rounds": warm.accountant.agent_to_server,
                "compile_events_s": cstats.seconds,
                "compile_events": dict(cstats.events),
            }
    speedup = results["loop"]["per_round_s"] / max(results["scan"]["per_round_s"], 1e-12)
    payload = {
        "bench": "driver",
        "quick": quick,
        "results": results,
        "speedup": speedup,
        "events_speedup": results["loop"]["per_round_s"]
        / max(results["events"]["per_round_s"], 1e-12),
    }
    save_result("BENCH_driver", payload, out_dir, device=dev)
    return payload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the sweep into DIR")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    payload = run(quick=not args.full, profile_dir=args.profile, device=args.device,
                  out_dir=args.out)
    for d in ("loop", "scan", "events"):
        r = payload["results"][d]
        print(f"{d:>6}:  compile {r['compile_s']:6.2f} s | "
              f"steady {r['per_round_s']*1e3:7.2f} ms/round  (loss {r['final_loss']:.4f})")
    print(f"warm speedup vs loop: scan {payload['speedup']:.2f}x, "
          f"events {payload['events_speedup']:.2f}x")


if __name__ == "__main__":
    main()
