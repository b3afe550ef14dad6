"""Figure 4 on the port (twin of ``benchmarks/fig4_p_sweep.py``):
communication rounds (agent-to-agent vs agent-to-server) to reach the
training gradient-norm and test-accuracy targets, sweeping the server
probability p on a ring of 10 agents (logistic regression + nonconvex
regularizer, sorted a9a-like split, T_o = 1).

Paper claims: a small p (~0.06-0.1) cuts agent-to-agent rounds by a large
factor against p = 0 for a handful of server rounds; p beyond ~0.1 saves no
further total rounds.

    python -m repro_torch.figures.fig4_p_sweep [--quick] [--device cpu]
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

P_GRID = [0.0, 10**-2, 10**-1.75, 10**-1.5, 10**-1.25, 10**-1, 10**-0.75, 10**-0.5, 1.0]
# thresholds of the synthetic a9a stand-in (the paper's protocol: a
# grad-norm target and ~95 % of the peak test accuracy)
GRAD_TARGET = 0.002
ACC_TARGET = 0.75


def run(quick: bool = False, seeds=(0, 1, 2), device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 150 if quick else 600
    p_grid = [0.0, 0.03, 0.1, 0.3, 1.0] if quick else P_GRID
    seeds = seeds[:1] if quick else seeds
    workloads = {s: make_logreg_workload(quick=quick, seed=s, device=dev) for s in seeds}
    results = {}
    for p in p_grid:
        per_seed = []
        for seed in seeds:
            data, loss_fn, eval_fn, params0 = workloads[seed]
            hist, _ = run_pisco_variant(
                data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                p=p, t_o=1, eta_l=0.5, rounds=rounds, seed=seed, device=dev,
            )
            tally.add(hist)
            per_seed.append(comm_rounds_to_targets(hist, GRAD_TARGET, ACC_TARGET))
        results[f"p={p:.4f}"] = _aggregate(per_seed)
    payload = tally.stamp({"bench": "fig4_p_sweep", "quick": quick, "results": results})
    save_result("fig4_p_sweep", payload, out_dir, device=dev)
    return payload


def _aggregate(per_seed):
    agg = {}
    for phase in ("train", "test"):
        vals = [s[phase] for s in per_seed if s[phase] is not None]
        if not vals:
            agg[phase] = None
            continue
        agg[phase] = {
            k: float(np.mean([v[k] for v in vals])) for k in ("rounds", "a2a", "a2s")
        }
        agg[phase]["n_reached"] = len(vals)
    return agg


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'p':>8} | {'train rounds':>12} {'a2a':>7} {'a2s':>6} | {'test rounds':>11}")
    for key, agg in payload["results"].items():
        tr, te = agg["train"], agg["test"]
        tr_s = (f"{tr['rounds']:12.1f} {tr['a2a']:7.1f} {tr['a2s']:6.1f}"
                if tr else f"{'n/a':>27}")
        te_s = f"{te['rounds']:11.1f}" if te else f"{'n/a':>11}"
        print(f"{key[2:]:>8} | {tr_s} | {te_s}")


if __name__ == "__main__":
    main()
