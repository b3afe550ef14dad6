"""Perf-regression gate over the port's ``artifacts/torch`` baselines (the
twin of ``benchmarks/check_regress.py``):

    python -m repro_torch.figures.check_regress --fresh DIR

compares freshly produced ``BENCH_*.json`` payloads of the port against its
committed card baselines with the per-metric tolerances of
:mod:`repro_torch.obs.regress` (deterministic metrics tight, wall-clock
loose) and exits 1 on any regression, or when nothing was compared.  The
baselines are full-size (``figures.run --full``), so the fresh payloads are
too.  The reference's ``artifacts/bench`` (CPU JAX numbers) is never a
baseline here.

Intentional changes re-baseline in place (then commit the payloads):

    python -m repro_torch.figures.check_regress --fresh DIR --update-baselines

Stdlib-only: the gate and this CLI import no torch and no numpy.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys

from repro_torch.obs.regress import compare_dirs, format_findings

BASELINES = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "..", "..", "..", "artifacts", "torch"))


def update_baselines(baseline_dir: str, fresh_dir: str) -> int:
    """Copy every fresh BENCH_*.json (+ MANIFEST.json) over the baselines."""
    os.makedirs(baseline_dir, exist_ok=True)
    copied = 0
    for pat in ("BENCH_*.json", "MANIFEST.json"):
        for src in sorted(glob.glob(os.path.join(fresh_dir, pat))):
            dst = os.path.join(baseline_dir, os.path.basename(src))
            shutil.copyfile(src, dst)
            print(f"updated {dst}")
            copied += 1
    return copied


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=BASELINES,
                    help="directory of committed baseline payloads (artifacts/torch)")
    ap.add_argument("--fresh", required=True,
                    help="directory of freshly produced payloads to gate")
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to these bench keys (e.g. driver async)")
    ap.add_argument("--update-baselines", action="store_true",
                    help="copy fresh payloads over the baselines instead of gating "
                         "(for intentional changes; commit the result)")
    args = ap.parse_args(argv)

    if args.update_baselines:
        n = update_baselines(args.baseline, args.fresh)
        if n == 0:
            print(f"no BENCH_*.json found under {args.fresh}", file=sys.stderr)
            return 1
        return 0

    findings = compare_dirs(args.baseline, args.fresh, only=args.only)
    print(format_findings(findings))
    if not any(f.status != "skipped" for f in findings):
        # nothing was compared (empty fresh dir, bad --only, every bench
        # missing on one side): a broken gate, not a pass
        print(f"no metrics compared (baseline={args.baseline} fresh={args.fresh})",
              file=sys.stderr)
        return 1
    if any(f.failed for f in findings):
        print("perf regression detected — see table above. "
              "If intentional, re-baseline with --update-baselines.", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
