"""Figure 5 on the port (twin of ``benchmarks/fig5_local_updates.py``): the
speed-up from multiple local updates.

PISCO with T_o in {1, 10} and p in {1, 10^-0.5, 10^-1, 0} on the ring; the
paper reports ~50 % fewer communication rounds at T_o = 10 than at T_o = 1
for p = 0.1, and p = 0.1 on par with p = 1.

    python -m repro_torch.figures.fig5_local_updates [--quick] [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Tally,
    comm_rounds_to_targets,
    make_logreg_workload,
    run_pisco_variant,
    save_result,
)
from repro_torch.figures.fig4_p_sweep import ACC_TARGET, GRAD_TARGET

P_GRID = [1.0, 10**-0.5, 10**-1, 0.0]
T_GRID = [1, 10]


def run(quick: bool = False, seeds=(0, 1), device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 120 if quick else 500
    seeds = seeds[:1] if quick else seeds
    workloads = {s: make_logreg_workload(quick=quick, seed=s, device=dev) for s in seeds}
    results = {}
    for t_o in T_GRID:
        for p in P_GRID:
            per_seed = []
            for seed in seeds:
                data, loss_fn, eval_fn, params0 = workloads[seed]
                # same per-step budget: eta_l tuned down for larger T_o
                eta_l = 0.5 if t_o == 1 else 0.25
                hist, _ = run_pisco_variant(
                    data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                    p=p, t_o=t_o, eta_l=eta_l, rounds=rounds, seed=seed, device=dev,
                )
                tally.add(hist)
                out = comm_rounds_to_targets(hist, GRAD_TARGET, ACC_TARGET)
                out["final_loss"] = hist.loss[-1]
                per_seed.append(out)
            reached = [s["train"] for s in per_seed if s["train"]]
            results[f"T_o={t_o},p={p:.4f}"] = {
                "train_rounds": float(np.mean([r["rounds"] for r in reached]))
                if reached else None,
                "final_loss": float(np.mean([s["final_loss"] for s in per_seed])),
            }
    payload = tally.stamp({"bench": "fig5_local_updates", "quick": quick, "results": results})
    save_result("fig5_local_updates", payload, out_dir, device=dev)
    return payload


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'config':>22} | {'rounds to target':>16} | {'final loss':>10}")
    for key, r in payload["results"].items():
        rr = f"{r['train_rounds']:16.1f}" if r["train_rounds"] else f"{'n/a':>16}"
        print(f"{key:>22} | {rr} | {r['final_loss']:10.4f}")


if __name__ == "__main__":
    main()
