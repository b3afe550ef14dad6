"""Two-point cost correction of the dry run's records (the twin of
``repro.launch.cost_correction``).

XLA's ``cost_analysis()`` counts a while-loop body once, so the reference
measures two unrolled variants of each (arch x shape x step) with k = 1 and
k = 2 layer periods (full width, tiny depth) and extrapolates

    F(n_periods) = outside + n_periods · body,
    body = F(2) - F(1),   outside = F(1) - body,

then rewrites the record's ``cost_corrected``, ``roofline_raw`` and
``roofline``.  The port counts eagerly, every layer's operations one by one,
so nothing is counted once: its correction must equal the direct count
(FLOPs to the flop, bytes to within rounding), and a difference means the
counter has a bug.  The extrapolation runs in integers.

    python -m repro_torch.launch.cost_correction --dir artifacts/torch/dryrun --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import build_steps, variant_config
from repro_torch.launch.mesh import COLLECTIVE_KINDS, make_production_mesh
from repro_torch.utils.roofline import Roofline


def _variant_cfg(cfg, k: int):
    """The config with k layer periods (and k encoder layers)."""
    upd = dict(n_layers=cfg.first_k_dense + k * cfg.scan_period())
    if cfg.is_enc_dec:
        upd["n_encoder_layers"] = k
    return dataclasses.replace(cfg, **upd)


def measure(cfg, shape, step_name: str, mesh_kind: str, rec: dict) -> dict:
    """The counts of one step of ``cfg`` (the record's variant levers)."""
    variant = rec.get("variant", {})
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    spec = build_steps(cfg, shape, mesh, t_o=rec.get("t_o", 1),
                       agent_mode=rec.get("agent_mode", "flat"),
                       wire_dtype=variant.get("wire_dtype", "float32"),
                       opt_idle_batch=variant.get("opt_idle_batch", False))[step_name]
    counts = spec.lower()
    coll = counts["collectives"]
    return {
        "flops": counts["flops_int"],
        "bytes_accessed": int(counts["cost"]["bytes_accessed"]),
        "collective_total": int(coll["total"]),
        "collectives": {k: int(coll[k]) for k in COLLECTIVE_KINDS},
    }


def corrected_counts(cfg, shape, step_name: str, mesh_kind: str, rec: dict) -> dict:
    """The two-point extrapolation to ``cfg``'s depth."""
    period = cfg.scan_period()
    n_periods = (cfg.n_layers - cfg.first_k_dense) // period
    t0 = time.perf_counter()
    f1 = measure(_variant_cfg(cfg, 1), shape, step_name, mesh_kind, rec)
    f2 = measure(_variant_cfg(cfg, 2), shape, step_name, mesh_kind, rec)

    def extrapolate(key):
        body = f2[key] - f1[key]
        return max(0, f1[key] - body + n_periods * body)

    return {
        "flops": extrapolate("flops"),
        "bytes_accessed": extrapolate("bytes_accessed"),
        "collective_total": extrapolate("collective_total"),
        "n_periods": n_periods,
        "variant_1": f1,
        "variant_2": f2,
        "method": "two-point extrapolation over layer periods (see module docstring)",
        "seconds": time.perf_counter() - t0,
    }


def correct_record(path: str, *, force: bool = False) -> bool:
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return False
    if rec.get("cost_corrected") and not force:
        return False
    variant = rec.get("variant", {})
    cfg = variant_config(rec["arch"], loss_chunk=variant.get("loss_chunk", 0),
                         remat_policy=variant.get("remat_policy", "full"),
                         ssm_chunk=variant.get("ssm_chunk", 0))
    corrected = corrected_counts(cfg, SHAPES[rec["shape"]], rec["step"], rec["mesh"], rec)
    rec["cost_corrected"] = corrected
    rec["roofline_raw"] = rec["roofline"]
    rec["roofline"] = Roofline.from_counts(
        float(corrected["flops"]), float(corrected["bytes_accessed"]),
        float(corrected["collective_total"]),
        model_flops=rec["roofline"].get("model_flops"), n_chips=rec["n_chips"],
    ).to_dict()
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.cost_correction",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="artifacts/torch/dryrun")
    ap.add_argument("--mesh", default=None, help="only correct this mesh kind")
    ap.add_argument("--glob", default="*.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    n = 0
    for path in sorted(glob.glob(os.path.join(args.dir, args.glob))):
        with open(path) as f:
            rec = json.load(f)
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        try:
            if correct_record(path, force=args.force):
                with open(path) as f:
                    r = json.load(f)["roofline"]
                print(f"corrected {os.path.basename(path)}: "
                      f"flops/dev={r['flops_per_device']:.3e} dominant={r['dominant']} "
                      f"useful={r['useful_ratio'] and round(r['useful_ratio'], 3)}")
                n += 1
        except Exception as e:  # noqa: BLE001
            print(f"FAILED {os.path.basename(path)}: {type(e).__name__}: {e}")
    print(f"corrected {n} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
