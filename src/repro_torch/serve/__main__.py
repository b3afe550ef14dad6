"""Continuous-batched serving of a synthetic personalised fleet, with a
per-request latency breakdown (the twin of the reference's
``examples/serve_decode.py``):

    python -m repro_torch.serve --arch mamba2-370m            # full width, on the GPU
    python -m repro_torch.serve --arch qwen3-8b --reduced --device cpu

Each request belongs to a different agent of the fleet; one decode step
advances every occupied slot under that slot's own weights.  The table at
the end splits each request's latency into queue wait, prefill and decode.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.registry import get_bundle
from repro_torch.serve import (
    ArrivalProcess,
    ContinuousBatcher,
    DecodeEngine,
    FleetDelta,
    make_requests,
    run_load,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true", help="the reduced (test-size) config")
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--fraction", type=float, default=0.02, help="perturbed share of each leaf")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--materialize", default="admit", choices=("admit", "step"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival", default="poisson:rate=4")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    bundle = get_bundle(cfg, args.device)
    base = bundle.init(args.seed)
    fleet = FleetDelta.synthetic(base, args.agents, fraction=args.fraction, seed=args.seed)
    print(f"arch={cfg.name} on {bundle.device}, fleet={fleet.n_agents} agents "
          f"({fleet.spec.name}): {fleet.nbytes() / 2**20:.2f} MiB vs "
          f"{fleet.naive_nbytes() / 2**20:.2f} MiB naive "
          f"({fleet.naive_nbytes() / max(fleet.nbytes(), 1):.1f}x smaller)")

    engine = DecodeEngine(bundle, fleet, n_slots=args.slots,
                          max_seq=args.prompt_len + args.gen + 8, materialize=args.materialize)
    batcher = ContinuousBatcher(engine, seed=args.seed)
    requests = make_requests(
        ArrivalProcess.parse(args.arrival), args.requests, n_agents=fleet.n_agents,
        vocab_size=cfg.vocab_size, prompt_len=args.prompt_len, max_new_tokens=args.gen,
        seed=args.seed,
    )
    report = run_load(batcher, requests)  # measured engine time

    print(f"served {len(report.requests)} requests / {report.total_tokens} tokens: "
          f"{report.tokens_per_s:.1f} tok/s, p50={report.p50_s * 1e3:.0f} ms "
          f"p99={report.p99_s * 1e3:.0f} ms")
    print(f"{'req':>4} {'agent':>5} {'tok':>4} {'queue_ms':>9} {'prefill_ms':>11} "
          f"{'decode_ms':>10} {'latency_ms':>11}")
    for r in sorted(report.requests, key=lambda r: r.rid):
        b = r.breakdown()
        print(f"{b['rid']:>4} {b['agent']:>5} {b['tokens']:>4} {b['queue_wait_s'] * 1e3:>9.1f} "
              f"{b['prefill_s'] * 1e3:>11.1f} {b['decode_s'] * 1e3:>10.1f} "
              f"{b['latency_s'] * 1e3:>11.1f}")


if __name__ == "__main__":
    main()
