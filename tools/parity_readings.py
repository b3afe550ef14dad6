"""How far the port's whole runs part from the JAX package's, case by case.

Runs every whole-run case of ``tests/test_torch_network.py`` and
``tests/test_torch_optim.py`` through both packages on the CPU (the tests'
own specs, data and runners) and prints, per case, the largest relative
deviation per round of the loss, of the test loss, of grad_sq and of the
consensus error, and of the final rule state the least relative tolerance
that passes at the tests' absolute floor of 1e-6.  The tests' per-case loss
limits and their rule-state limit are set from these readings.

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tools/parity_readings.py \\
        --out artifacts/torch/parity_readings.json
"""
import argparse
import json
import time

import numpy as np


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _rtol_needed(got, want, atol: float) -> float:
    """The least rtol with |got - want| <= atol + rtol * |want| everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    excess = np.abs(got - want) - atol
    return float(max(0.0, np.max(excess / np.maximum(np.abs(want), 1e-300))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import test_torch_network as tn
    import test_torch_optim as to

    out = {}
    for mod, runs in ((tn, tn.RUNS), (to, to.RUNS)):
        for case, kw in runs.items():
            t0 = time.perf_counter()
            js, ts = mod._specs(**kw)
            jh, th = mod._run_both(js, ts)
            r = {
                "loss": _rel(th.loss, jh.loss),
                "grad_sq": _rel(th.grad_sq_norm, jh.grad_sq_norm),
                "consensus_err": _rel(th.consensus_err, jh.consensus_err),
            }
            if th.eval_metrics and "test_loss" in th.eval_metrics[0]:
                r["test_loss"] = _rel([m["test_loss"] for m in th.eval_metrics],
                                      [m["test_loss"] for m in jh.eval_metrics])
            if mod is to:
                pairs = list(zip(to._flat(th.final_state.opt), to._flat(jh.final_state.opt)))
                r["opt_rtol_at_atol_1e-6"] = max(
                    (_rtol_needed(a, b, 1e-6) for a, b in pairs), default=0.0)
                r["opt_max_abs"] = max(
                    (float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
                     for a, b in pairs if np.size(a)), default=0.0)
            key = f"{mod.__name__}::{case}"
            out[key] = r
            print(f"{key}: {json.dumps(r)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"script": "tools/parity_readings.py", "cases": out}, f, indent=1)


if __name__ == "__main__":
    main()
