"""Figure 6 on the port (twin of ``benchmarks/fig6_topology.py``):
robustness to topology and extreme heterogeneity.

A one-hidden-layer MLP (32 sigmoid units) on the sorted synthetic-MNIST
split (each agent holds ONE class), T_o = 10, over (a) a well-connected
Erdos-Renyi(0.3) graph and (b) a disconnected Erdos-Renyi(0.08) graph;
p in {1, 10^-0.5, 10^-1, 0}.

Paper claims: 0 < p < 1 tracks p = 1 closely on both graphs; p = 0 degrades
sharply on the disconnected one.

    python -m repro_torch.figures.fig6_topology [--quick] [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.data import FederatedDataset
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.device import resolve_device
from repro_torch.figures.common import Tally, run_pisco_variant, save_result
from repro_torch.models import simple as S
from repro_torch.weights import from_jax

P_GRID = [1.0, 10**-0.5, 10**-1, 0.0]
GRAPHS = {
    "er_connected": {"name": "erdos_renyi", "kw": {"prob": 0.3, "seed": 7}},
    "er_disconnected": {"name": "erdos_renyi", "kw": {"prob": 0.08, "seed": 23}},
}


def make_mnist_workload(quick: bool = False, seed: int = 0, device=None, params0=None):
    """The Fig. 6 workload on ``device``.  ``params0`` (e.g. the reference's
    ``mlp_init`` draw, as numpy) defaults to the port's own seeded draw
    (``mlp_init(seed)``): JAX's PRNG bits cannot be reproduced."""
    dev = resolve_device(device)
    n_samples = 3000 if quick else 20000
    x, y = synthetic_mnist(n_samples, seed=seed)
    data = FederatedDataset.from_arrays(x, y, 10, heterogeneous=True, seed=seed).to(dev)
    xt = data.x_train.reshape(-1, x.shape[1])
    yt = data.y_train.reshape(-1)

    def eval_fn(params):
        host = torch.stack([S.mlp_loss(params, (xt, yt)),
                            S.mlp_accuracy(params, data.x_test, data.y_test)]).cpu()
        return {"train_loss": float(host[0]), "test_acc": float(host[1])}

    params0 = S.mlp_init(seed) if params0 is None else params0
    return data, S.mlp_loss, eval_fn, from_jax(params0, dev)


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None, params0=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 60 if quick else 300
    data, loss_fn, eval_fn, x0 = make_mnist_workload(quick, seed, dev, params0)
    results = {}
    for gname, g in GRAPHS.items():
        for p in P_GRID:
            hist, topo = run_pisco_variant(
                data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=x0,
                topology_name=g["name"], topo_kwargs=g["kw"],
                p=p, t_o=10, eta_l=0.2, rounds=rounds, batch=100, seed=seed,
                eval_every=max(1, rounds // 30), device=dev,
            )
            tally.add(hist)
            results[f"{gname},p={p:.4f}"] = {
                "lambda_w": topo.lambda_w,
                "connected": bool(topo.connected),
                "final_train_loss": hist.eval_metrics[-1]["train_loss"],
                "final_test_acc": hist.eval_metrics[-1]["test_acc"],
            }
    payload = tally.stamp({
        "bench": "fig6_topology", "quick": quick, "results": results,
        "init": f"torch mlp_init({seed})" if params0 is None else "given",
    })
    save_result("fig6_topology", payload, out_dir, device=dev)
    return payload


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'config':>28} | {'lam_w':>6} | {'loss':>8} | {'test acc':>8}")
    for key, r in payload["results"].items():
        print(f"{key:>28} | {r['lambda_w']:6.3f} | {r['final_train_loss']:8.4f} | "
              f"{r['final_test_acc']:8.3f}")


if __name__ == "__main__":
    main()
