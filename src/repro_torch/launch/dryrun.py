"""Dry run: every (architecture x input shape) step at full width on the
port's production layouts, traced on the meta device, with its memory,
operation, collective and roofline record (the twin of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/torch/dryrun

Parameters, caches and batches are meta tensors: nothing is allocated on
any device, and the step runs its plain PyTorch path (the kernels' plain
versions), as the reference lowers its jnp path.  The meshes are
:func:`repro_torch.launch.mesh.make_production_mesh`'s, the reference's: 16
agents (single, 256 H100s) or 2 x 16 (multi, 512), each agent over a model
axis of 16 cards.  A train step is one card's model shard of its agent's
round (tensor parallelism inside the agent); a prefill or decode is one
card's model shard of its agent's rows of the serving batch, which splits
over the agents when it divides across them and otherwise runs on one
agent's 16 cards (the record's ``n_chips``).  The counts are per device and step
(:mod:`repro_torch.utils.roofline`): ``memory`` (arguments, outputs,
transients, peak live bytes, outputs written in place), ``cost`` (matmul
FLOPs, unfused bytes accessed, transcendental elements), ``collectives``
(the mesh's bytes per kind, and ``model_axis``: those of the model axis) and
``roofline`` at the H100's peaks.
``lower_s`` is the trace's host seconds; eager PyTorch compiles nothing,
so ``compile_s`` is 0.  Each run writes one JSON per (arch, shape, mesh,
step), which :mod:`repro_torch.figures.roofline` aggregates, and exits 1
when any record failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_steps
from repro_torch.models.registry import get_bundle
from repro_torch.utils.roofline import Roofline

SKIP_LONG_DECODE_NOTE = (
    "long_500k skipped: pure full-attention decode (unbounded KV cache is "
    "not sub-quadratic); see DESIGN.md §4"
)


def applicable(arch: str, shape_name: str) -> bool:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        return cfg.supports_long_decode()
    return True


def variant_config(arch: str, *, loss_chunk: int = 0, remat_policy: str = "full",
                   ssm_chunk: int = 0):
    """The full-width config with the dry run's levers applied (the
    reference's: a chunked loss, the ``dots`` remat policy, the SSD chunk)."""
    cfg = dataclasses.replace(get_config(arch), remat_policy=remat_policy)
    if loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    if ssm_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    return cfg


def build_steps(cfg, shape, mesh, *, t_o: int = 1, agent_mode: str = "flat",
                wire_dtype: str = "float32", opt_idle_batch: bool = False) -> dict:
    """The step specs of one (config, shape) on ``mesh``, by name."""
    bundle = get_bundle(cfg, "meta")
    if shape.kind == "train":
        return build_train_steps(bundle, shape, mesh, t_o=t_o, agent_mode=agent_mode,
                                 wire_dtype=wire_dtype)
    if shape.kind == "prefill":
        return {"prefill": build_prefill_step(bundle, shape, mesh)}
    return {"decode": build_decode_step(bundle, shape, mesh, opt_idle_batch=opt_idle_batch)}


def _step_names(shape) -> list:
    return {"train": ["train_gossip", "train_global"], "prefill": ["prefill"],
            "decode": ["decode"]}[shape.kind]


def run_one(arch: str, shape_name: str, mesh_kind: str, *, t_o: int = 1,
            agent_mode: str = "flat", steps_filter=None,
            wire_dtype: str = "float32", loss_chunk: int = 0,
            remat_policy: str = "full", ssm_chunk: int = 0,
            opt_idle_batch: bool = False) -> list:
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size(mesh.axis_names)
    base = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "n_chips": n_chips,
        "agent_mode": agent_mode,
        "t_o": t_o,
        "variant": {
            "wire_dtype": wire_dtype, "loss_chunk": loss_chunk,
            "remat_policy": remat_policy, "ssm_chunk": ssm_chunk,
            "opt_idle_batch": opt_idle_batch,
        },
    }
    try:
        cfg = variant_config(arch, loss_chunk=loss_chunk, remat_policy=remat_policy,
                             ssm_chunk=ssm_chunk)
        steps = build_steps(cfg, shape, mesh, t_o=t_o, agent_mode=agent_mode,
                            wire_dtype=wire_dtype, opt_idle_batch=opt_idle_batch)
    except Exception as e:  # noqa: BLE001 — record the failure per step, keep going
        recs = []
        for name in _step_names(shape):
            if steps_filter and name not in steps_filter:
                continue
            recs.append(dict(base, step=name, notes={}, status="error",
                             error=f"{type(e).__name__}: {e}",
                             traceback=traceback.format_exc()[-4000:]))
        return recs

    results = []
    for name, spec in steps.items():
        if steps_filter and name not in steps_filter:
            continue
        # a serving batch that does not split runs on one card of the mesh
        rec = dict(base, step=name, notes=_json_safe(spec.notes),
                   n_chips=spec.notes.get("n_chips", n_chips))
        try:
            counts = spec.lower()
            rec["lower_s"] = counts["trace_s"]
            rec["compile_s"] = 0.0
            rec["memory"] = counts["memory"]
            rec["cost"] = counts["cost"]
            rec["collectives"] = counts["collectives"]
            rec["roofline"] = Roofline.from_counts(
                rec["cost"]["flops"],
                rec["cost"]["bytes_accessed"],
                float(rec["collectives"]["total"]),
                model_flops=_model_flops(cfg, shape, name, t_o),
                n_chips=rec["n_chips"],
            ).to_dict()
            rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — record the failure, keep going
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
        results.append(rec)
    return results


def _json_safe(obj):
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def _model_flops(cfg, shape, step_name: str, t_o: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), whole step.

    Train rounds run t_o + 1 gradient evaluations (forward+backward = 3× fwd);
    prefill is one forward (2·N·D); decode is one token (D = batch)."""
    n_active = cfg.active_param_count()
    if step_name.startswith("train"):
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens * (t_o + 1)
    if step_name == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS) + ["qwen3-8b-swa"])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every applicable pair")
    ap.add_argument("--t-o", type=int, default=1)
    ap.add_argument("--agent-mode", choices=["flat", "hierarchical"], default="flat")
    ap.add_argument("--steps", nargs="*", default=None,
                    help="subset of step names (train_gossip train_global ...)")
    ap.add_argument("--wire-dtype", default="float32", choices=["float32", "native"],
                    help="gossip payload dtype (Perf lever)")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help=">0: chunked CE loss (Perf lever)")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="override SSD chunk length (Perf lever)")
    ap.add_argument("--opt-idle-batch", action="store_true",
                    help="batch-1 decode: seq/expert-shard over the idle data axis")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES if applicable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        pairs = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch, shape_name in pairs:
        if not applicable(arch, shape_name):
            print(f"SKIP {arch} x {shape_name}: {SKIP_LONG_DECODE_NOTE}")
            continue
        for mesh_kind in meshes:
            for rec in run_one(
                arch, shape_name, mesh_kind,
                t_o=args.t_o, agent_mode=args.agent_mode,
                steps_filter=args.steps,
                wire_dtype=args.wire_dtype, loss_chunk=args.loss_chunk,
                remat_policy=args.remat_policy, ssm_chunk=args.ssm_chunk,
                opt_idle_batch=args.opt_idle_batch,
            ):
                tag = f"{arch}__{shape_name}__{mesh_kind}__{rec['step']}"
                if args.agent_mode != "flat":
                    tag += f"__{args.agent_mode}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(
                        f"OK   {tag}: trace={rec['lower_s']:.1f}s "
                        f"flops/dev={rec['cost']['flops']:.3e} "
                        f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB "
                        f"coll={rec['collectives']['total']/2**20:.1f}MiB "
                        f"dominant={r['dominant']}"
                    )
                    print(f"     memory_analysis: {rec['memory']}")
                    print(f"     cost_analysis:   {rec['cost']}")
                    print(f"     collectives:     {rec['collectives']}")
                else:
                    n_fail += 1
                    print(f"FAIL {tag}: {rec['error']}")
                sys.stdout.flush()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
