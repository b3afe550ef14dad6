"""Compression sweep on the port (twin of ``benchmarks/fig_compression.py``):
network bytes to the target over compressor × p.

Compressed gossip (int8/int4 quantization through K2, the codes pass and
K3; top-k with error feedback through ``torch.topk`` and the dense gossip)
shrinks every agent-to-agent message, so the readout is the *bytes* spent
when the running-mean gradient norm first crosses the target (the Fig. 4
protocol with bytes on the x-axis).

Claims: int8/int4 gossip reaches the uncompressed target at a fraction of
the gossip bytes, with round counts within ~2x; compression composes with
semi-decentralization.

    python -m repro_torch.figures.fig_compression [--quick] [--device cpu]
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
from repro_torch.figures.fig4_p_sweep import GRAD_TARGET

COMPRESSORS = [None, "q8", "q4", "top0.1"]
P_GRID = [0.0, 0.05, 0.1, 0.3]


def _bytes_to_target(hist, grad_target: float):
    """(rounds, gossip_bytes, server_bytes, total_bytes) at first crossing."""
    r = hist.rounds_to_threshold("grad_sq", grad_target, mode="running_le")
    if r is None:
        return None
    n_gossip = sum(1 for g in hist.is_global[: r + 1] if not g)
    n_server = (r + 1) - n_gossip
    bm = hist.byte_model
    return {
        "rounds": r + 1,
        "gossip_bytes": n_gossip * bm.gossip_round_bytes,
        "server_bytes": n_server * bm.server_round_bytes,
        "total_bytes": bm.total_bytes(n_gossip, n_server),
    }


def run(quick: bool = False, seeds=(0, 1, 2), device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 150 if quick else 600
    p_grid = [0.05, 0.1] if quick else P_GRID
    seeds = seeds[:1] if quick else seeds
    workloads = {s: make_logreg_workload(quick=quick, seed=s, device=dev) for s in seeds}
    results = {}
    for comp in COMPRESSORS:
        for p in p_grid:
            per_seed = []
            for seed in seeds:
                data, loss_fn, eval_fn, params0 = workloads[seed]
                hist, _ = run_pisco_variant(
                    data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                    p=p, t_o=1, eta_l=0.5, rounds=rounds, seed=seed,
                    compression=comp, device=dev,
                )
                tally.add(hist)
                per_seed.append(_bytes_to_target(hist, GRAD_TARGET))
            key = f"comp={comp or 'none'},p={p:.4f}"
            vals = [s for s in per_seed if s is not None]
            if not vals:
                results[key] = None
                continue
            agg = {
                k: float(np.mean([v[k] for v in vals]))
                for k in ("rounds", "gossip_bytes", "server_bytes", "total_bytes")
            }
            agg["n_reached"] = len(vals)
            results[key] = agg
    payload = tally.stamp({"bench": "fig_compression", "quick": quick, "results": results})
    save_result("fig_compression", payload, out_dir, device=dev)
    return payload


def best_same_p_savings(results: dict):
    """Max gossip-byte savings of any compressed cell against fp32 *at the
    same p* (codec savings apart from schedule savings); None if no pair is
    comparable."""
    savings = []
    for key, agg in results.items():
        if key.startswith("comp=none") or not agg:
            continue
        base = results.get(f"comp=none,{key.split(',', 1)[1]}")
        if base:
            savings.append(base["gossip_bytes"] / max(1.0, agg["gossip_bytes"]))
    return max(savings) if savings else None


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    print(f"{'compressor,p':>20} | {'rounds':>7} {'gossip MB':>10} {'total MB':>9}")
    for key, agg in payload["results"].items():
        if agg is None:
            print(f"{key:>20} | {'target never reached':>28}")
            continue
        print(f"{key:>20} | {agg['rounds']:7.1f} "
              f"{agg['gossip_bytes'] / 1e6:10.3f} {agg['total_bytes'] / 1e6:9.3f}")


if __name__ == "__main__":
    main()
