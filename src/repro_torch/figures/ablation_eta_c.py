"""Ablation of the communication step size eta_c on the port (twin of
``benchmarks/ablation_eta_c.py``; Theorem 1 sets eta_c =
alpha·sqrt(1 + p)·lambda_p): eta_c × p on the ring-logreg workload.

    python -m repro_torch.figures.ablation_eta_c [--quick] [--device cpu]
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Tally,
    comm_rounds_to_targets,
    make_logreg_workload,
    run_pisco_variant,
    save_result,
)
from repro_torch.figures.fig4_p_sweep import ACC_TARGET, GRAD_TARGET


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 150 if quick else 400
    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=quick, seed=seed, device=dev)
    results = {}
    for p in (0.0, 0.1):
        for eta_c in (0.25, 0.5, 1.0):
            hist, topo = run_pisco_variant(
                data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                p=p, t_o=2, eta_l=0.4, eta_c=eta_c, rounds=rounds, seed=seed, device=dev,
            )
            tally.add(hist)
            r = comm_rounds_to_targets(hist, GRAD_TARGET, ACC_TARGET)
            results[f"p={p},eta_c={eta_c}"] = {
                "rounds_to_grad": r["train"]["rounds"] if r["train"] else None,
                "final_grad_sq": hist.eval_metrics[-1]["grad_sq"],
                "lambda_p": topo.expected_rate(p),
            }
    payload = tally.stamp({"bench": "ablation_eta_c", "quick": quick, "results": results})
    save_result("ablation_eta_c", payload, out_dir, device=dev)
    return payload


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'config':>20} | {'rounds':>7} | {'final grad^2':>12} | {'lam_p':>6}")
    for key, r in payload["results"].items():
        rr = f"{r['rounds_to_grad']:7.0f}" if r["rounds_to_grad"] else f"{'n/a':>7}"
        print(f"{key:>20} | {rr} | {r['final_grad_sq']:12.6f} | {r['lambda_p']:6.3f}")


if __name__ == "__main__":
    main()
