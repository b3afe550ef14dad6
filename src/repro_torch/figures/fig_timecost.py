"""Simulated time-to-target across systems profiles on the port (twin of
``benchmarks/fig_timecost.py``): which p/τ is fastest?

The paper ranks configurations by communication *rounds* (Fig. 4); this
figure adds simulated **wall-clock** under a systems-cost profile
(:mod:`repro_torch.sim`).  It runs the p × τ autotuner once on the §5.1
logreg workload, then re-prices the same trajectories under every profile
(the fleet and network draws are pure in ``(seed, k)``, so repricing needs
no training), and compares PISCO's frontier against FedAvg and DSGT.  The
rounds run on the device (K1 for the local steps, ``torch.matmul`` gossip);
the pricing is host numpy, bit-equal to the reference's.

Claims exercised:

* under the free-network profile the ranking over ``p`` collapses to the
  rounds/bytes ranking — time adds nothing when the network is free;
* under ``wan-gossip`` the fastest configuration moves to a *higher* ``p``
  than under ``lan-gossip``.

Writes ``BENCH_timecost.json`` (``artifacts/torch/`` by default).

    python -m repro_torch.figures.fig_timecost [--quick] [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ExperimentSpec
from repro_torch.data import RoundSampler
from repro_torch.device import resolve_device
from repro_torch.figures.common import Tally, make_logreg_workload, save_result
from repro_torch.sim import FREE_NETWORK, price_history, retime, tune
from repro_torch.sim.tuner import _smoothed

P_GRID = [0.0, 0.03, 0.1, 0.3, 1.0]
TAU_GRID = (1, 4)
PROFILES_SWEPT = (
    ("free", FREE_NETWORK),
    ("lan-gossip", "lan-gossip"),
    ("wan-gossip", "wan-gossip"),
    ("lognormal-stragglers", "lognormal-stragglers"),
    ("edge-vs-datacenter", "edge-vs-datacenter"),
)


def _curve(point, window: int, systems: str, max_points: int = 60) -> dict:
    """Downsampled (cumulative sim seconds, smoothed loss) trajectory, priced
    under ``systems`` — not the history's online ledger, which belongs to
    the profile the sweep originally ran under."""
    secs = np.cumsum(price_history(point.history, point.spec, systems=systems))
    loss = _smoothed(point.history.loss, window)
    idx = np.unique(np.linspace(0, len(secs) - 1, min(max_points, len(secs))).astype(int))
    return {"sim_time_s": secs[idx].round(4).tolist(), "loss": loss[idx].round(6).tolist()}


def _bytes_ranking(result) -> list:
    """(p, t_o) ranked by bytes-to-target — the fig4-style readout on the
    identical trajectories (unreached configs last, by loss)."""
    pts = sorted(
        result.points,
        key=lambda pt: (
            0 if pt.bytes_to_target is not None else 1,
            pt.bytes_to_target if pt.bytes_to_target is not None else 0,
            pt.final_loss,
        ),
    )
    return [[pt.p, pt.t_o] for pt in pts]


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 150 if quick else 600
    p_grid = [0.0, 0.1, 1.0] if quick else P_GRID
    tau_grid = (1,) if quick else TAU_GRID
    profiles = PROFILES_SWEPT[:3] if quick else PROFILES_SWEPT

    data, loss_fn, _eval_fn, params0 = make_logreg_workload(quick=quick, seed=seed, device=dev)
    b = min(256, data.samples_per_agent)
    pieces = dict(
        loss_fn=loss_fn,
        params0=params0,
        device=dev,
        sampler_factory=lambda s: RoundSampler(data, b, s.config.t_o, s.config.seed,
                                               device=dev),
    )

    def base_spec(algo: str, p: float = 0.1, t_o: int = 1) -> ExperimentSpec:
        return ExperimentSpec.create(
            algo=algo, n_agents=data.n_agents, t_o=t_o, eta_l=0.5, p=p,
            seed=seed, rounds=rounds, eval_every=rounds, driver="scan",
        )

    # one training pass per (p, tau); every profile is a repricing
    first = profiles[0][1]
    pisco = tune(base_spec("pisco"), pieces, p_grid=p_grid, tau_grid=tau_grid,
                 systems=first, strategy="grid")
    target = pisco.target_loss
    baselines = {
        "fedavg": tune(base_spec("fedavg"), pieces, p_grid=[1.0], systems=first,
                       target_loss=target),
        "dsgt": tune(base_spec("dsgt", p=0.1), pieces, p_grid=[0.1], systems=first,
                     target_loss=target),
    }
    for res in (pisco, *baselines.values()):
        for pt in res.points:
            tally.add(pt.history)

    per_profile = {}
    for label, prof in profiles:
        tuned = pisco if prof == first else retime(pisco, prof)
        curves = {
            f"pisco:p={tuned.best.p:g},tau={tuned.best.t_o}": _curve(
                tuned.best, tuned.window, prof)
        }
        bl = {}
        for name, res in baselines.items():
            r = res if prof == first else retime(res, prof)
            bl[name] = r.points[0].to_dict()
            curves[name] = _curve(r.points[0], tuned.window, prof)
        per_profile[label] = {
            "tuner": tuned.to_dict(),
            "best_p": tuned.best.p,
            "best_tau": tuned.best.t_o,
            "baselines": bl,
            "curves": curves,
        }

    consistency = {
        "free_time_ranking": [[p, t] for p, t in pisco.ranking()],
        "free_bytes_ranking": _bytes_ranking(pisco),
    }
    payload = tally.stamp({
        "bench": "fig_timecost",
        "quick": quick,
        "target_loss": target,
        "profiles": per_profile,
        "consistency": consistency,
    })
    save_result("BENCH_timecost", payload, out_dir, device=dev)
    return payload


def tuner_flip(results: dict):
    """Best-p under wan-gossip vs lan-gossip — the trade-off readout."""
    lan = results.get("lan-gossip")
    wan = results.get("wan-gossip")
    if not lan or not wan:
        return None
    return lan["best_p"], wan["best_p"]


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"target smoothed loss: {payload['target_loss']:.4f}")
    print(f"{'profile':>22} | {'best p':>7} {'tau':>4} | "
          f"{'sim s->target':>13} | baselines (fedavg / dsgt)")
    for label, cell in payload["profiles"].items():
        best = cell["tuner"]["best"]
        fmt = lambda v: f"{v:.2f}" if v is not None else "---"  # noqa: E731
        print(f"{label:>22} | {best['p']:7.2f} {best['t_o']:4d} | "
              f"{fmt(best['time_to_target_s']):>13} | "
              f"{fmt(cell['baselines']['fedavg']['time_to_target_s'])} / "
              f"{fmt(cell['baselines']['dsgt']['time_to_target_s'])}")
    flip = tuner_flip(payload["profiles"])
    if flip:
        print(f"best p: lan-gossip={flip[0]:g} -> wan-gossip={flip[1]:g}")


if __name__ == "__main__":
    main()
