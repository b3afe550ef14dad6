"""Figure 7 on the port (twin of ``benchmarks/fig7_cnn.py``): the CNN on the
sorted synthetic-CIFAR split.

Ring of 5 agents (agent i holds classes {i, i + 5}), batch 20, T_o = 4,
p in {1, 1/sqrt(5), 0.2, 0}.  Paper claim: p = 0 converges more slowly under
the sparse ring and extreme heterogeneity; p = 1/sqrt(5) is close to p = 1.

    python -m repro_torch.figures.fig7_cnn [--quick] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data import FederatedDataset
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.device import resolve_device
from repro_torch.figures.common import Tally, run_pisco_variant, save_result
from repro_torch.models import simple as S
from repro_torch.weights import from_jax

P_GRID = [1.0, 1.0 / np.sqrt(5), 0.2, 0.0]


def make_cifar_workload(quick: bool = False, seed: int = 0, device=None, params0=None):
    """The Fig. 7 workload on ``device``; ``params0`` defaults to the port's
    own seeded draw (``cnn_init(seed)``)."""
    dev = resolve_device(device)
    n_samples = 1500 if quick else 8000
    x, y = synthetic_cifar(n_samples, seed=seed)
    # paper split: agent i gets labels i and i + 5 => sorted split across 5
    data = FederatedDataset.from_arrays(x, y, 5, heterogeneous=True, seed=seed).to(dev)

    def eval_fn(params):
        host = torch.stack([S.cnn_loss(params, (data.x_test, data.y_test)),
                            S.cnn_accuracy(params, data.x_test, data.y_test)]).cpu()
        return {"test_loss": float(host[0]), "test_acc": float(host[1])}

    params0 = S.cnn_init(seed) if params0 is None else params0
    return data, S.cnn_loss, eval_fn, from_jax(params0, dev)


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None, params0=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 20 if quick else 120
    data, loss_fn, eval_fn, x0 = make_cifar_workload(quick, seed, dev, params0)
    results = {}
    for p in P_GRID:
        hist, _ = run_pisco_variant(
            data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=x0,
            topology_name="ring", p=p, t_o=4, eta_l=0.05, rounds=rounds,
            batch=20, seed=seed, eval_every=max(1, rounds // 15), device=dev,
        )
        tally.add(hist)
        results[f"p={p:.4f}"] = {
            "final_test_loss": hist.eval_metrics[-1]["test_loss"],
            "final_test_acc": hist.eval_metrics[-1]["test_acc"],
            "loss_curve": [m["test_loss"] for m in hist.eval_metrics],
        }
    payload = tally.stamp({
        "bench": "fig7_cnn", "quick": quick, "results": results,
        "init": f"torch cnn_init({seed})" if params0 is None else "given",
    })
    save_result("fig7_cnn", payload, out_dir, device=dev)
    return payload


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'p':>8} | {'test loss':>9} | {'test acc':>8}")
    for key, r in payload["results"].items():
        print(f"{key[2:]:>8} | {r['final_test_loss']:9.4f} | {r['final_test_acc']:8.3f}")


if __name__ == "__main__":
    main()
