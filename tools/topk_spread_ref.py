"""The chaos spread of the top-k compression cell, on the JAX package.

The reference side of ``tools/topk_spread.py``: the same cell, the same
inits (zeros, then 1e-9 times a standard normal from numpy seeds 1..N) and
the same four readings, through ``benchmarks.common``.  It imports nothing
of the port: ``tools/topk_spread.py`` imports torch and the port only when
it runs.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/topk_spread_ref.py \\
        --inits 20 --out build/topk_spread_ref.json
"""
import argparse
import json
import time

# the cell, the inits and the readings are the port side's (numpy only; run
# as a script, this file's directory is on the path)
from topk_spread import CELL, EPS, init_draw, readings, spread


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inits", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from benchmarks.common import make_logreg_workload, run_pisco_variant

    data, loss_fn, eval_fn, params0 = make_logreg_workload(quick=False, seed=0)
    d = params0["w"].shape[0]
    runs = []
    for i in range(args.inits + 1):
        t0 = time.perf_counter()
        hist = run_pisco_variant(data=data, loss_fn=loss_fn, eval_fn=eval_fn,
                                 params0={"w": jnp.asarray(init_draw(i, d))}, **CELL)[0]
        runs.append(readings(hist))
        print(f"init {i}: {runs[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    payload = {"impl": "repro (JAX) on cpu", "cell": CELL, "eps": EPS, "runs": runs,
               "spread": spread(runs)}
    print(json.dumps(payload["spread"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
