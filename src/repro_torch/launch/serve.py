"""Personalised-fleet serving driver: delta-multiplexed continuous-batched
decode under simulated traffic (the twin of ``repro.launch.serve``).

Serves a *fleet* of per-agent models — a trained checkpoint (``--ckpt`` /
``--ckpt-dir``, e.g. one written by
``python -m repro_torch.examples.train_federated_lm`` or
:func:`repro_torch.serve.export_fleet`, or by the reference's twins) or a
synthetic stand-in fleet (``--agents``) — as shared base weights plus
compact per-agent deltas, and drives a reproducible Poisson/bursty request
trace through the continuous batcher:

    python -m repro_torch.launch.serve --arch qwen3-8b --reduced \\
        --agents 64 --requests 32 --arrival poisson:rate=4 --slots 4

    python -m repro_torch.launch.serve --ckpt-dir ckpt --delta topk:f=0.05,q8 \\
        --trace-out trace.json --metrics-out metrics.jsonl

``--arch`` is optional with a checkpoint whose manifest carries the model
config: the bundle is rebuilt from the checkpoint alone.  ``--device``
defaults to the GPU.  A synthetic fleet's base weights are drawn from the
port's own seeded generator, so they are not the reference's.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import latest_checkpoint, read_manifest
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import config_from_dict, get_bundle
from repro_torch.obs import TraceRecorder, write_trace
from repro_torch.serve import (
    ArrivalProcess,
    ContinuousBatcher,
    DecodeEngine,
    DeltaSpec,
    FleetDelta,
    StepCosts,
    make_requests,
    materialize_fleet,
    run_load,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="a ported architecture id (qwen3-8b, ...)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None, help="fleet/state checkpoint file")
    ap.add_argument("--ckpt-dir", default=None, help="directory; serves latest_checkpoint")
    ap.add_argument("--agents", type=int, default=16,
                    help="synthetic fleet size when no checkpoint is given")
    ap.add_argument("--delta", default="topk:f=0.05",
                    help="delta format for checkpoint fleets (synthetic fleets are always "
                         "lossless top-k): dense | topk[:f=F][,q8] | lowrank[:r=R]")
    ap.add_argument("--dense-baseline", action="store_true",
                    help="serve n dense copies instead of deltas (memory baseline)")
    ap.add_argument("--materialize", choices=("admit", "step"), default="admit",
                    help="apply deltas once at admission, or inside every decode step")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--arrival", default="poisson:rate=2")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-costs", default=None, metavar="PREFILL_S,DECODE_S",
                    help="deterministic per-op costs instead of measured engine time")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the session (per-agent tracks of "
                         "queue→prefill→decode request spans; open at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="append the session's metrics-registry snapshot as one line of "
                         "this JSONL file")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return ap


def run(argv=None):
    """The launcher's session: parse ``argv``, serve, print the report and
    return ``(report, fleet)`` (the fleet as built from the checkpoint or
    drawn, before any dense materialisation)."""
    args = build_parser().parse_args(argv)

    path = args.ckpt
    if path is None and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir!r}")

    if args.arch is not None:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    elif path is not None:
        meta = read_manifest(path).get("metadata", {})
        if "model" not in meta:
            raise SystemExit(f"{path!r} has no model config in its manifest — pass --arch")
        cfg = config_from_dict(meta["model"])
    else:
        raise SystemExit("pass --arch (synthetic fleet) or a checkpoint")
    bundle = get_bundle(cfg, args.device)

    spec = DeltaSpec.parse(args.delta)
    if path is not None:
        fleet = FleetDelta.from_checkpoint(path, spec, device=bundle.device)
        print(f"fleet: {path} ({fleet.n_agents} agents, delta={spec.name})")
    else:
        fleet = FleetDelta.synthetic(bundle.init(args.seed), args.agents, seed=args.seed)
        print(f"fleet: synthetic ({fleet.n_agents} agents, delta={fleet.spec.name})")

    ratio = fleet.naive_nbytes() / max(fleet.nbytes(), 1)
    print(f"fleet memory: {fleet.nbytes()/2**20:.2f} MiB delta vs "
          f"{fleet.naive_nbytes()/2**20:.2f} MiB naive dense ({ratio:.1f}x)")
    served = materialize_fleet(fleet) if args.dense_baseline else fleet

    engine = DecodeEngine(bundle, served, n_slots=args.slots,
                          max_seq=args.prompt_len + args.gen + 8, materialize=args.materialize)
    batcher = ContinuousBatcher(engine, temperature=args.temperature, seed=args.seed)
    requests = make_requests(
        ArrivalProcess.parse(args.arrival), args.requests, n_agents=fleet.n_agents,
        vocab_size=cfg.vocab_size, prompt_len=args.prompt_len, max_new_tokens=args.gen,
        seed=args.seed,
    )
    costs = None
    if args.fixed_costs:
        pre, dec = (float(v) for v in args.fixed_costs.split(","))
        costs = StepCosts(prefill_s=pre, decode_s=dec)

    recorder = None
    if args.trace_out:
        recorder = TraceRecorder(meta={
            "kind": "serve", "arch": cfg.name, "n_agents": fleet.n_agents,
            "n_slots": args.slots, "arrival": args.arrival,
        })

    report = run_load(batcher, requests, costs=costs, recorder=recorder)
    if args.trace_out:
        write_trace(args.trace_out, recorder)
        print(f"trace written to {args.trace_out} (open at ui.perfetto.dev)")
    if args.metrics_out:
        report.telemetry(meta={
            "kind": "serve", "arch": cfg.name, "arrival": args.arrival,
        }).write_jsonl(args.metrics_out)
        print(f"metrics appended to {args.metrics_out}")
    print(f"arch={cfg.name} slots={args.slots} arrival={args.arrival} "
          f"materialize={args.materialize}" + (" dense-baseline" if args.dense_baseline else ""))
    print(f"served {len(report.requests)} requests, {report.total_tokens} tokens in "
          f"{report.makespan_s:.3f} s -> {report.tokens_per_s:.1f} tok/s")
    print(f"latency p50={report.p50_s*1e3:.1f} ms p99={report.p99_s*1e3:.1f} ms "
          f"(mean queue={report.mean('queue_wait_s')*1e3:.1f} "
          f"prefill={report.mean('prefill_s')*1e3:.1f} "
          f"decode={report.mean('decode_s')*1e3:.1f})")
    for r in sorted(report.requests, key=lambda r: r.rid)[:4]:
        print(f"  req{r.rid} agent={r.agent_id} tokens={r.tokens[:8]}"
              + ("..." if len(r.tokens) > 8 else ""))
    print(f"device: {bundle.device}")
    return report, fleet


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
