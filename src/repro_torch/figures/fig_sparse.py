"""Sparse-substrate scaling on the port (twin of ``benchmarks/fig_sparse.py``):
per-round wall time and the mixing state's memory of the CSR gossip path
(K4) across fleets of n ∈ {64, 1024, 4096, 10^4} agents on the sparse ring,
plus the n = 64 dense-against-sparse parity that keeps the sparse path
honest.  The workload is a per-agent quadratic (loss = 0.5·mean((w −
target)^2)), so the numbers isolate the mixing substrate, not the model.

Memory is reported analytically, as the reference does: the dense path's
mixing state is the n×n float32 W; the sparse path's is the directed edge
arrays (2m weights + 2m int32 sender/receiver indices) plus the (n,)
self-weight vector.

    python -m repro_torch.figures.fig_sparse [--full] [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.core.mixing import dense_mixing, sparse_mixing
from repro_torch.core.topology import make_sparse_topology, make_topology
from repro_torch.device import resolve_device
from repro_torch.figures.common import save_result

FLEET_SIZES = (64, 1024, 4096, 10_000)
PARITY_N = 64
# dense and sparse runs agree round for round (float32, other summation order)
PARITY_RTOL, PARITY_ATOL = 1e-5, 1e-6


def _workload(n: int, d: int, device: torch.device, seed: int = 0):
    rng = np.random.default_rng(seed)
    targets = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)

    def loss_fn(params, batch):
        return 0.5 * torch.mean((params["w"] - batch[0]) ** 2)

    local = (torch.stack([targets, targets]),)

    def sampler(k):
        return local, (targets,)

    x0 = {"w": torch.zeros((n, d), dtype=torch.float32, device=device)}
    return loss_fn, sampler, x0


def _run(n: int, d: int, mixing, rounds: int, device: torch.device, seed: int = 0):
    loss_fn, sampler, x0 = _workload(n, d, device, seed)
    spec = ExperimentSpec.create(algo="pisco", n_agents=n, t_o=2, eta_l=0.1, eta_c=1.0,
                                 p=0.1, seed=seed, rounds=rounds, block_size=rounds)
    return Experiment(spec, loss_fn=loss_fn, x0=x0, sampler=sampler, mixing=mixing,
                      device=device).run()


def _mixing_state_bytes(n: int, m: int, sparse: bool) -> int:
    if sparse:
        # directed edge weights (2m f32) + senders/receivers (2m i32 each)
        # + self weights (n f32)
        return 2 * m * 4 + 2 * (2 * m * 4) + n * 4
    return n * n * 4  # the dense float32 W


def run(quick: bool = True, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    d = 8 if quick else 256
    rounds = 4 if quick else 20
    results = {}
    for n in FLEET_SIZES:
        topo = make_sparse_topology("ring", n)
        mixing = sparse_mixing(topo, dev)
        _run(n, d, mixing, 1, dev)  # warm-up: the timed run measures steady state
        t0 = time.perf_counter()
        hist = _run(n, d, mixing, rounds, dev)
        dt = time.perf_counter() - t0
        m = topo.n_edges
        results[f"n={n}"] = {
            "n_agents": n,
            "n_edges": m,
            "rounds": rounds,
            "per_round_s": dt / rounds,
            "sparse_mixing_state_bytes": _mixing_state_bytes(n, m, True),
            "dense_mixing_state_bytes": _mixing_state_bytes(n, m, False),
            "final_loss": float(hist.loss[-1]),
        }

    n = PARITY_N
    hd = _run(n, d, dense_mixing(make_topology("ring", n), dev), rounds, dev)
    hs = _run(n, d, sparse_mixing(make_sparse_topology("ring", n), dev), rounds, dev)
    max_dev = float(np.max(np.abs(np.array(hd.loss) - np.array(hs.loss))))
    parity_ok = bool(np.allclose(hd.loss, hs.loss, rtol=PARITY_RTOL, atol=PARITY_ATOL))
    if not parity_ok:
        raise AssertionError(f"dense/sparse parity broken at n={n}: max dev {max_dev}")
    payload = {
        "results": results,
        "parity": {"n": n, "ok": parity_ok, "max_loss_dev": max_dev},
        "quick": quick,
    }
    save_result("BENCH_sparse", payload, out_dir, device=dev)
    return payload


def memory_ratio(results: dict) -> float:
    """Dense/sparse mixing-state memory ratio at the largest fleet."""
    biggest = max(results.values(), key=lambda r: r["n_agents"])
    return biggest["dense_mixing_state_bytes"] / max(1, biggest["sparse_mixing_state_bytes"])


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=not args.full, device=args.device)
    for k, r in payload["results"].items():
        print(f"{k}: {r['per_round_s'] * 1e3:.2f} ms/round, "
              f"mixing state {r['sparse_mixing_state_bytes']:,} B sparse vs "
              f"{r['dense_mixing_state_bytes']:,} B dense")
    print(f"parity@n={payload['parity']['n']}: ok={payload['parity']['ok']}")


if __name__ == "__main__":
    main()
