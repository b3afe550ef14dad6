"""Assemble the dry run's tables from its records (the twin of
``benchmarks/experiments_md.py``).

    python -m repro_torch.figures.experiments_md > TABLES.md

The meshes are the port's layouts: 16 agents (single) or 2 x 16 (multi),
one H100 each.
"""
from __future__ import annotations

import os

from repro_torch.figures.common import ARTIFACTS
from repro_torch.figures.roofline import DRYRUN_DIR, fmt_table, load_records

PERF_DIR = os.path.join(ARTIFACTS, "perf")  # variant runs (the dry run's --tag)

MESH_TITLES = {
    "single": "16 agents, one H100 each",
    "multi": "2 x 16 agents, one H100 each",
}


def load(art_dir):
    return load_records(art_dir, with_file=True)


def _gib(x):
    return f"{x/2**30:.2f}"


def dryrun_table(recs, mesh):
    rows = [
        "| arch | shape | step | compile s | args GiB/dev | temp GiB/dev | coll GiB/dev (wire) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or r["mesh"] != mesh:
            continue
        c = r["collectives"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {r.get('compile_s', 0):.1f} "
            f"| {_gib(r['memory']['argument_bytes'])} | {_gib(r['memory']['temp_bytes'])} "
            f"| {_gib(c.get('total', 0))} |"
        )
    return "\n".join(rows)


def roofline_table(recs, mesh="single"):
    return fmt_table(recs, mesh, useful_digits=3, scan_corr=True) + (
        "\n\n*RAW rows: not run through repro_torch.launch.cost_correction (the port "
        "counts eagerly, so its correction equals the direct count)."
    )


def perf_table(recs):
    rows = [
        "| variant | step | FLOPs/dev | HBM B/dev | coll B/dev (wire) | compute s | memory s "
        "| coll s | dominant |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok":
            continue
        ro = r["roofline"]
        tag = r["_file"].replace(".json", "").split("__")[-1]
        rows.append(
            f"| {r['arch'].split('-')[0]}/{r['shape']}/{tag} | {r['step']} "
            f"| {ro['flops_per_device']:.2e} | {ro['hbm_bytes_per_device']:.2e} "
            f"| {ro['collective_bytes_per_device']:.2e} "
            f"| {ro['compute_s']:.2e} | {ro['memory_s']:.2e} | {ro['collective_s']:.2e} "
            f"| {ro['dominant']} |"
        )
    return "\n".join(rows)


def fit_table(recs, mesh="single", card_gib=80.0):
    """Per (arch, shape, step): the peak GiB a card holds against its
    ``card_gib``, the dominant roofline term and the useful ratio (the
    port's own table; the reference has no counterpart)."""
    rows = [
        f"| arch | shape | step | peak GiB/dev | fits {card_gib:g} GiB | dominant | useful |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or r["mesh"] != mesh or r["step"] == "train_global":
            continue
        peak = r["memory"]["peak_bytes"] / 2**30
        ro = r["roofline"]
        useful = f"{ro['useful_ratio']:.3f}" if ro.get("useful_ratio") else "-"
        rows.append(f"| {r['arch']} | {r['shape']} | {r['step']} | {peak:.1f} "
                    f"| {'yes' if peak <= card_gib else 'no'} | {ro['dominant']} | {useful} |")
    return "\n".join(rows)


def main():
    dry = load(DRYRUN_DIR)
    perf = load(PERF_DIR)
    print("## Generated tables\n")
    print(f"### T1 — Dry-run, single ({MESH_TITLES['single']})\n")
    print(dryrun_table(dry, "single"))
    print(f"\n### T2 — Dry-run, multi ({MESH_TITLES['multi']})\n")
    print(dryrun_table(dry, "multi"))
    print(f"\n### T3 — Roofline, single ({MESH_TITLES['single']})\n")
    print(roofline_table(dry, "single"))
    print(f"\n### T4 — Roofline, multi ({MESH_TITLES['multi']})\n")
    print(roofline_table(dry, "multi"))
    print("\n### T5 — Perf iterations\n")
    print(perf_table(perf))
    print(f"\n### T6 — What one H100 holds, single ({MESH_TITLES['single']})\n")
    print(fit_table(dry, "single"))


if __name__ == "__main__":
    main()
