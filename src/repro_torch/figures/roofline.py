"""Roofline aggregation of the dry run (the twin of ``benchmarks/roofline.py``):
read ``artifacts/torch/dryrun/*.json`` and emit the per-(arch x shape x mesh
x step) table and its summary.

    python -m repro_torch.figures.roofline [--dir artifacts/torch/dryrun] [--mesh single]

The records are :mod:`repro_torch.launch.dryrun`'s: per-device counts on
one H100 per agent, terms at the H100's peaks.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.figures.common import ARTIFACTS

DRYRUN_DIR = os.path.join(ARTIFACTS, "dryrun")


def load_records(art_dir: str = DRYRUN_DIR, *, with_file: bool = False) -> List[dict]:
    """Load dry-run records: a missing directory yields an empty list, and
    a malformed or unreadable file becomes a ``status="load-error"`` record
    instead of stopping the aggregation.  ``with_file`` adds each record's
    file name under ``_file``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
            if not isinstance(rec, dict):
                raise ValueError(f"expected a JSON object, got {type(rec).__name__}")
        except (OSError, ValueError) as exc:
            rec = {"status": "load-error", "arch": os.path.basename(path), "shape": "-",
                   "mesh": "-", "error": str(exc)}
        if with_file:
            rec["_file"] = os.path.basename(path)
        recs.append(rec)
    return recs


def fmt_table(recs: List[dict], mesh: Optional[str] = "single", *, useful_digits: int = 2,
              scan_corr: bool = False) -> str:
    """The roofline rows of ``mesh``; ``scan_corr`` adds the column that
    says whether a record went through the cost correction."""
    rows = [
        "| arch | shape | step | FLOPs/dev | HBM B/dev | coll B/dev | "
        "compute s | memory s | coll s | dominant | useful |" + (" scan-corr |" if scan_corr
                                                                else ""),
        "|" + "---|" * (12 if scan_corr else 11),
    ]
    for r in recs:
        if r.get("status") != "ok" or not r.get("roofline"):
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        if r.get("step") == "train_global":
            continue  # the table shows the gossip (technique) round
        ro = r["roofline"]
        useful = f"{ro['useful_ratio']:.{useful_digits}f}" if ro.get("useful_ratio") else "-"
        row = (
            f"| {r['arch']} | {r['shape']} | {r['step']} "
            f"| {ro['flops_per_device']:.2e} | {ro['hbm_bytes_per_device']:.2e} "
            f"| {ro['collective_bytes_per_device']:.2e} "
            f"| {ro['compute_s']:.2e} | {ro['memory_s']:.2e} | {ro['collective_s']:.2e} "
            f"| **{ro['dominant']}** | {useful} |"
        )
        if scan_corr:
            row += " yes |" if r.get("cost_corrected") else " RAW* |"
        rows.append(row)
    return "\n".join(rows)


def summarize(recs: List[dict]) -> Dict:
    """Counts over the records; an ``ok`` record without its roofline
    counts as a failure."""
    ok = [r for r in recs if r.get("status") == "ok" and r.get("roofline")]
    fails = [r for r in recs if r not in ok]
    doms: Dict[str, int] = {}
    for r in ok:
        dom = r["roofline"].get("dominant", "?")
        doms[dom] = doms.get(dom, 0) + 1
    worst = sorted(
        (r for r in ok if r.get("mesh") == "single" and r["roofline"].get("useful_ratio")),
        key=lambda r: r["roofline"]["useful_ratio"],
    )
    most_coll = sorted(
        (r for r in ok if r.get("mesh") == "single"),
        key=lambda r: -r["roofline"].get("collective_s", 0.0),
    )
    return {
        "n_ok": len(ok),
        "n_fail": len(fails),
        "dominant_counts": doms,
        "worst_useful": [
            (r.get("arch"), r.get("shape"), r.get("step"), r["roofline"]["useful_ratio"])
            for r in worst[:5]
        ],
        "most_collective_bound": [
            (r.get("arch"), r.get("shape"), r.get("step"), r["roofline"].get("collective_s", 0.0))
            for r in most_coll[:5]
        ],
        "failures": [
            (r.get("arch", "?"), r.get("shape", "?"), r.get("mesh", "?"), r.get("error", "?"))
            for r in fails
        ],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.figures.roofline")
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(fmt_table(recs, args.mesh))
    print()
    s = summarize(recs)
    print(f"ok={s['n_ok']} fail={s['n_fail']} dominant={s['dominant_counts']}")
    print("worst useful_ratio:", s["worst_useful"])
    print("most collective-bound:", s["most_collective_bound"])
    for f in s["failures"]:
        print("FAIL:", f)


if __name__ == "__main__":
    main()
