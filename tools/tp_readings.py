#!/usr/bin/env python3
"""chip_smoke.py's tp phase at other seeds: tp-qwen3-8b and tp-mamba2-370m
with the weights, prompt and batches drawn from each seed given, on one
card.  Prints each seed's readings (the lines chip_smoke.py prints: the
logits' deviations at the whole model's top logits and over the whole
vocabulary, the greedy tokens and their margins, the first loss's and the
gradient norms' deviations from the whole model's) whether or not they pass
chip_smoke.py's limits, which were set from these readings and chip_smoke.py's
own (seed 0):

    python3 tools/tp_readings.py --seeds 1 2 3

Run from the root of a checkout, on a machine with a CUDA card.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--paths", nargs="+", default=["qwen", "mamba"],
                    choices=["qwen", "mamba", "reduced"])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("tp_readings: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda")
    failed = []
    for seed in args.seeds:
        for path in args.paths:  # one spawn each, so that every path reports
            try:
                cs.tp_paths(torch, dev, card, dict(cs.TP, seed=seed, paths=(path,)))
            except AssertionError as e:  # past a limit: printed, and on to the next
                cs.log(f"tp_readings seed {seed} {path}: {e}")
                failed.append((seed, path))
    cs.log(f"tp_readings: seeds {args.seeds}, past a limit at {failed}; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
