"""Optimizer sweep on the port (twin of ``benchmarks/fig_optimizers.py``):
local rule × server rule × server probability.

    local  ∈ {sgd, momentum:lr=0.1, adam:lr=0.05}  (the tracker is the direction)
    server ∈ {none, fedavgm, fedadam}              (fires at server rounds)
    p      ∈ {0.05, 0.2}

on the §5.1 logreg workload (T_o = 2, η_l = 0.3, 500 rounds); the readout
is rounds and bytes to the gradient target and the final gradient norm,
with the extra traffic priced (a server rule ships one more payload per
direction; "mix"-policy buffers ride the gossip links).  The rules run in
plain tensor code (:mod:`repro_torch.optim`), the gossip through
``torch.matmul``.

Writes ``BENCH_optimizers.json`` (``artifacts/torch/`` by default).

    python -m repro_torch.figures.fig_optimizers [--quick] [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Tally,
    make_logreg_workload,
    run_pisco_variant,
    save_result,
)

LOCAL_RULES = [None, "momentum:lr=0.1", "adam:lr=0.05"]
SERVER_RULES = [None, "fedavgm", "fedadam"]
P_GRID = [0.05, 0.2]


def label(rule) -> str:
    return "sgd" if rule is None else rule.split(":")[0]


def cell_key(local, server, p) -> str:
    return f"local={label(local)},server={server or 'none'},p={p:.2f}"


def cell_readout(hist, grad_target: float) -> dict:
    acct = hist.accountant
    cum_bytes = np.cumsum(acct.per_round_bytes)
    r = hist.rounds_to_threshold("grad_sq", grad_target, mode="running_le")
    return {
        "rounds_to_target": None if r is None else r + 1,
        "bytes_to_target": None if r is None else int(cum_bytes[r]),
        "total_bytes": int(acct.total_bytes),
        "server_rounds": int(acct.agent_to_server),
        "final_grad_sq": float(hist.grad_sq_norm[-1]),
        "final_loss": float(hist.loss[-1]),
    }


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 120 if quick else 500
    locals_ = LOCAL_RULES[:2] if quick else LOCAL_RULES
    servers = SERVER_RULES[:2] if quick else SERVER_RULES
    ps = [0.2] if quick else P_GRID
    grad_target = 0.01 if quick else 0.002
    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=quick, seed=seed, device=dev)
    results = {}
    for p in ps:
        for local in locals_:
            for server in servers:
                hist, _ = run_pisco_variant(
                    data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                    p=p, t_o=2, eta_l=0.3, rounds=rounds, seed=seed, device=dev,
                    optimizer=local, server_optimizer=server,
                )
                tally.add(hist)
                results[cell_key(local, server, p)] = cell_readout(hist, grad_target)
    payload = tally.stamp({"bench": "fig_optimizers", "quick": quick, "results": results})
    payload["best_adaptive_speedup"] = best_adaptive_speedup(results)
    save_result("BENCH_optimizers", payload, out_dir, device=dev)
    return payload


def best_adaptive_speedup(results: dict):
    """Rounds-to-target speedup of the best non-SGD cell over the plain-SGD
    cell at the same p (None if either never reached the target)."""
    speedups = []
    for key, cell in results.items():
        if key.startswith("local=sgd,server=none") or not cell["rounds_to_target"]:
            continue
        base = results.get(f"local=sgd,server=none,p={key.split(',p=')[1]}")
        if base and base["rounds_to_target"]:
            speedups.append(base["rounds_to_target"] / cell["rounds_to_target"])
    return max(speedups) if speedups else None


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'scenario':>38} | {'rounds':>7} {'MB@target':>10} {'final |g|^2':>12}")
    for key, cell in payload["results"].items():
        rt, bt = cell["rounds_to_target"], cell["bytes_to_target"]
        print(f"{key:>38} | {rt if rt is not None else '---':>7} "
              f"{bt / 1e6 if bt is not None else float('nan'):10.3f} "
              f"{cell['final_grad_sq']:12.3e}")
    s = payload["best_adaptive_speedup"]
    if s:
        print(f"best adaptive rounds-to-target speedup vs plain SGD: {s:.2f}x")


if __name__ == "__main__":
    main()
