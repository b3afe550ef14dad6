"""The chaos spread of the top-k compression cell, on the port.

Top-k gossip with error feedback at full size is chaotic in float32: where
two magnitudes sit within rounding of each other at the k-th place, a run
sends another coordinate and its trajectory parts from a twin's.  A card run
and a CPU run of the same cell part the same way, so ``chip_smoke.py`` holds
them to this run's own spread.  This tool measures it: the cell of
``fig_compression`` (top0.1, p = 0.1, ring of 10, T_o = 1, eta_l = 0.5, 600
rounds, an eval every round, the full synthetic-a9a workload) from the zero
init and from ``--inits`` inits perturbed by 1e-9 times a standard normal
(numpy, seeds 1..N), and reads the four numbers ``chip_smoke.py`` compares:

* ``rounds``: rounds to the gradient target (running mean of grad_sq <= 0.002);
* ``final_running_grad_sq``: the running mean of grad_sq at the last eval;
* ``mean_loss``: the mean of the per-round losses;
* ``final_test_acc``: test accuracy at the last eval.

The spread of each is its largest deviation from the unperturbed run
(relative; absolute for the accuracy).  ``tools/topk_spread_ref.py`` makes
the same readings on the JAX package.  With ``--limits`` this tool reads
both files and prints the limits as twice the larger of the two spreads.

    PYTHONPATH=src python tools/topk_spread.py --inits 20 --device cpu \\
        --out build/topk_spread_port.json
    PYTHONPATH=src python tools/topk_spread_ref.py --inits 20 \\
        --out build/topk_spread_ref.json
    python tools/topk_spread.py --limits build/topk_spread_port.json \\
        build/topk_spread_ref.json
"""
import argparse
import json
import time

import numpy as np

GRAD_TARGET = 0.002
CELL = dict(p=0.1, compression="top0.1", t_o=1, eta_l=0.5, rounds=600, seed=0, eval_every=1)
EPS = 1e-9
KEYS = ("rounds", "final_running_grad_sq", "mean_loss", "final_test_acc")
ABSOLUTE = ("final_test_acc",)
FACTOR = 2.0


def readings(hist) -> dict:
    r = hist.rounds_to_threshold("grad_sq", GRAD_TARGET, mode="running_le")
    return {"rounds": None if r is None else r + 1,
            "final_running_grad_sq": float(hist.running_mean_eval("grad_sq")[-1]),
            "mean_loss": float(np.mean(hist.loss)),
            "final_test_acc": float(hist.eval_metrics[-1]["test_acc"])}


def init_draw(i: int, d: int) -> np.ndarray:
    """Init ``i``: zeros for 0, else 1e-9 times a standard normal (seed i)."""
    if i == 0:
        return np.zeros((d,), np.float32)
    return (EPS * np.random.default_rng(i).standard_normal(d)).astype(np.float32)


def spread(runs: list) -> dict:
    """Each reading's largest deviation of runs[1:] from runs[0]."""
    base, out = runs[0], {}
    for k in KEYS:
        devs = [abs(r[k] - base[k]) if k in ABSOLUTE else abs(r[k] - base[k]) / abs(base[k])
                for r in runs[1:]]
        out[k] = max(devs)
    return out


def limits(*spreads: dict) -> dict:
    return {k: FACTOR * max(s[k] for s in spreads) for k in KEYS}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inits", type=int, default=20)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--limits", nargs="+", default=None,
                    help="spread files to combine into limits (no runs)")
    args = ap.parse_args()
    if args.limits:
        files = [json.load(open(f)) for f in args.limits]
        for f, name in zip(files, args.limits):
            print(name, f["impl"], "spread", f["spread"])
        print(json.dumps({"factor": FACTOR, "limits": limits(*[f["spread"] for f in files])}))
        return

    import torch

    from repro_torch.figures.common import make_logreg_workload, run_pisco_variant

    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=False, seed=0,
                                                           device=args.device)
    dev = params0["w"].device
    d = params0["w"].shape[0]
    runs = []
    for i in range(args.inits + 1):
        t0 = time.perf_counter()
        w0 = torch.from_numpy(init_draw(i, d)).to(dev)
        hist = run_pisco_variant(data=data, loss_fn=loss_fn, eval_fn=eval_fn,
                                 params0={"w": w0}, device=dev, **CELL)[0]
        runs.append(readings(hist))
        print(f"init {i}: {runs[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    payload = {"impl": f"repro_torch on {dev.type}", "cell": CELL, "eps": EPS, "runs": runs,
               "spread": spread(runs)}
    print(json.dumps(payload["spread"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
