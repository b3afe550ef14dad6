"""fig_robust at full size on the JAX package, without writing into
``artifacts/bench/`` (``benchmarks/fig_robust.run`` would).

The figure's own ``run(quick=False)`` (16 agents, the §5.1 logreg workload on
the iid split at its full size, 300 rounds per row) with its ``save_result``
replaced, so the payload goes only where ``--out`` says.  The port's
full-size payload (``python -m repro_torch.figures.fig_robust``) is read
against it.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/fig_robust_ref.py \\
        --out artifacts/torch/fig_robust_ref_full.json
"""
import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from benchmarks import fig_robust

    fig_robust.save_result = lambda name, payload: None
    t0 = time.perf_counter()
    payload = fig_robust.run(quick=False)
    payload = dict(payload, impl="repro (JAX) on cpu", seconds=time.perf_counter() - t0)
    for label, row in payload["rows"].items():
        print(f"{label}: final loss {row['final_loss']:.6f}, test acc {row['final_test_acc']:.4f}")
    print(f"robustness_flip {payload['robustness_flip']}, trimmed_within_10pct "
          f"{payload['trimmed_within_10pct']}, mean_within_10pct {payload['mean_within_10pct']} "
          f"({payload['seconds']:.1f} s)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
