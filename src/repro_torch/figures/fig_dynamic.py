"""Dynamic-network sweep on the port (twin of ``benchmarks/fig_dynamic.py``):
link failures × participation × topology.

PISCO runs over the dynamic :class:`~repro_torch.core.topology.TopologyProcess`
stack — i.i.d. Bernoulli link failures at several failure probabilities,
partial m-of-n server participation — on two base topologies, and the
readout is *realized* communication: the accountant prices the edges and
participants that fired each round, not the static round constants.  Each
round's W_k (and S_k) is drawn on the host once per block and gossiped with
``torch.matmul``; the local steps run K1.

Writes ``BENCH_dynamic.json`` and ``fig_dynamic.csv`` (``artifacts/torch/``
by default).

    python -m repro_torch.figures.fig_dynamic [--quick] [--device cpu]
"""
from __future__ import annotations

import csv
import os

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    ARTIFACTS,
    Tally,
    make_logreg_workload,
    run_pisco_variant,
    save_result,
)

FAILURE_GRID = [0.0, 0.3, 0.6]
PARTICIPATION_GRID = [1.0, 0.5]
TOPOLOGIES = ["ring", "full"]
GRAD_TARGET = 0.002

CSV_FIELDS = (
    "topology", "failure_prob", "participation", "rounds_to_target",
    "bytes_to_target", "gossip_bytes", "server_bytes", "total_bytes",
    "final_grad_sq",
)


def cell_readout(hist, grad_target: float) -> dict:
    """Rounds and realized bytes when the running-mean gradient norm first
    crosses the target (None when never reached), plus realized totals."""
    acct = hist.accountant
    cum_bytes = np.cumsum(acct.per_round_bytes)
    r = hist.rounds_to_threshold("grad_sq", grad_target, mode="running_le")
    return {
        "rounds_to_target": None if r is None else r + 1,
        "bytes_to_target": None if r is None else int(cum_bytes[r]),
        "gossip_bytes": int(acct.agent_to_agent_bytes),
        "server_bytes": int(acct.agent_to_server_bytes),
        "total_bytes": int(acct.total_bytes),
        "final_grad_sq": float(hist.grad_sq_norm[-1]),
    }


def cell_spec(q: float, frac: float) -> dict:
    """The run keywords of one cell: ``static`` without failures."""
    return dict(network=f"bernoulli:{q}" if q > 0 else "static", participation=frac)


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 150 if quick else 600
    failures = [0.0, 0.4] if quick else FAILURE_GRID
    topologies = ["ring"] if quick else TOPOLOGIES
    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=quick, seed=seed, device=dev)
    results, rows = {}, []
    for topo in topologies:
        for q in failures:
            for frac in PARTICIPATION_GRID:
                hist, _ = run_pisco_variant(
                    data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                    topology_name=topo, p=0.1, t_o=1, eta_l=0.5, rounds=rounds,
                    seed=seed, device=dev, **cell_spec(q, frac),
                )
                tally.add(hist)
                cell = cell_readout(hist, GRAD_TARGET)
                results[f"topo={topo},q={q:.2f},part={frac:.2f}"] = cell
                rows.append(dict(topology=topo, failure_prob=q, participation=frac, **cell))
    payload = tally.stamp({"bench": "fig_dynamic", "quick": quick, "results": results})
    payload["participation_byte_savings"] = participation_byte_savings(results)
    save_result("BENCH_dynamic", payload, out_dir, device=dev)
    out_dir = ARTIFACTS if out_dir is None else out_dir
    csv_path = os.path.join(out_dir, "fig_dynamic.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    payload["csv"] = csv_path
    return payload


def participation_byte_savings(results: dict):
    """Server-byte savings of half participation against full, same
    topology and failure probability; None if no pair is comparable."""
    savings = []
    for key, cell in results.items():
        if ",part=0.50" not in key or not cell:
            continue
        base = results.get(key.replace(",part=0.50", ",part=1.00"))
        if base and base["server_bytes"] and cell["server_bytes"]:
            savings.append(base["server_bytes"] / cell["server_bytes"])
    return max(savings) if savings else None


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'scenario':>32} | {'rounds':>7} {'MB@target':>10} {'final |g|^2':>12}")
    for key, cell in payload["results"].items():
        rt, bt = cell["rounds_to_target"], cell["bytes_to_target"]
        print(f"{key:>32} | {rt if rt is not None else '---':>7} "
              f"{bt / 1e6 if bt is not None else float('nan'):10.3f} "
              f"{cell['final_grad_sq']:12.3e}")
    print(f"csv: {payload['csv']}")


if __name__ == "__main__":
    main()
