"""fig_async's three cells at full size on the JAX package, without writing
into ``artifacts/bench/`` (``benchmarks/fig_async.run`` would).

The same specs (PISCO on the §5.1 logreg workload at its full size, T_o = 2,
η_l = 0.1, p = 0.1, 600 rounds, sync and async under each fleet of
``benchmarks.fig_async.PROFILES_SWEPT``), readouts and speedups as the
figure; the port's payload (``artifacts/torch/BENCH_async.json``) is read
against it.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/fig_async_ref.py \\
        --out artifacts/torch/fig_async_ref_full.json
"""
import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from benchmarks import fig_async
    from benchmarks.common import make_logreg_workload
    from repro.core import ExperimentSpec
    from repro.core.experiment import Experiment
    from repro.data import RoundSampler
    from repro.sim.tuner import _smoothed

    data, loss_fn, _, params0 = make_logreg_workload(quick=False, seed=0)
    n, b = data.n_agents, min(256, data.samples_per_agent)
    window = max(1, min(20, args.rounds // 10))
    pieces = dict(loss_fn=loss_fn, params0=params0, sampler_factory=lambda s: RoundSampler(
        data, batch_size=b, t_o=s.config.t_o, seed=s.config.seed))
    async_cfg = f"poly:alpha=0.5,bound=2,buffer={max(2, n // 2)}"
    profiles = {}
    for label, prof in fig_async.PROFILES_SWEPT:
        t0 = time.perf_counter()
        sync_spec = ExperimentSpec.create(
            algo="pisco", n_agents=n, t_o=2, eta_l=0.1, p=0.1, seed=0, rounds=args.rounds,
            eval_every=args.rounds, driver="scan", systems=prof)
        h_sync = Experiment(sync_spec, **pieces).run()
        h_async = Experiment(sync_spec.replace(driver="events", async_=async_cfg), **pieces).run()
        target = 1.05 * max(float(_smoothed(h.loss, window)[-1]) for h in (h_sync, h_async))
        profiles[label] = {
            "systems": prof, "target_loss": target,
            "sync": fig_async._readout(h_sync, target, window),
            "async": fig_async._readout(h_async, target, window),
            "bit_identical_loss": list(h_sync.loss) == list(h_async.loss),
        }
        print(f"{label}: {profiles[label]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    payload = {"impl": "repro (JAX) on cpu", "rounds": args.rounds, "async_config": async_cfg,
               "profiles": profiles, "speedup": fig_async.async_flip(profiles)}
    print(f"speedup {payload['speedup']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
