"""Serving-path benchmark: delta-multiplexed continuous-batched decode (twin
of ``benchmarks/fig_serve.py``).

Three readouts, each with the reference's assert:

* **memory** — fleet-weights footprint of the delta representation against
  ``n`` dense copies at fleet sizes up to 64+ agents (>= 10x at n = 64);
* **bit_identity** — token streams of the delta engine (both materialise
  modes) against the dense-materialised fleet under one request trace
  (identical for lossless top-k deltas);
* **rates** — measured tokens/s and p50/p99 request latency of the delta
  engine under Poisson traffic at two or more request rates.

The model is the reference's ``TINY`` (2 layers, head dim 16, float32): its
prefill runs K6's float32 kernel at D = 16, two launches a request.  Base
weights come from the port's seeded generator (not the reference's PRNG);
the memory table depends only on shapes and is the reference's.

Writes ``BENCH_serve.json`` (``artifacts/torch/`` by default).

    python -m repro_torch.figures.fig_serve [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.device import resolve_device
from repro_torch.figures.common import save_result, sync
from repro_torch.models import ModelConfig, get_bundle
from repro_torch.serve import (
    ArrivalProcess,
    ContinuousBatcher,
    DecodeEngine,
    FleetDelta,
    StepCosts,
    make_requests,
    materialize_fleet,
    run_load,
)

_INIT_TAG = 0x1217  # the seed of the base weights

TINY = ModelConfig(
    name="serve-tiny",
    arch_type="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mlp_type="swiglu",
    dtype="float32",
    attn_chunk=64,
    remat=False,
)


def _tokens_of(report) -> dict:
    return {r.rid: list(r.tokens) for r in report.requests}


def _trace(fleet, n_requests, rate, seed=0, prompt_len=16, gen=8):
    return make_requests(
        ArrivalProcess(kind="poisson", rate=rate), n_requests,
        n_agents=fleet.n_agents, vocab_size=TINY.vocab_size,
        prompt_len=prompt_len, max_new_tokens=gen, seed=seed,
    )


def memory_table(base, quick: bool) -> dict:
    """Delta against naive bytes of synthetic fleets of 8, 64 (and 256)."""
    memory = {}
    for n in (8, 64) if quick else (8, 64, 256):
        f = FleetDelta.synthetic(base, n, seed=1)
        memory[str(n)] = {
            "n_agents": n,
            "delta_bytes": f.nbytes(),
            "naive_bytes": f.naive_nbytes(),
            "ratio": f.naive_nbytes() / f.nbytes(),
        }
    return memory


def run(quick: bool = True, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    t_start = time.perf_counter()
    bundle = get_bundle(TINY, dev)
    base = bundle.init(_INIT_TAG)
    slots = 4
    n_requests = 10 if quick else 32
    gen = 8 if quick else 16
    max_seq = 16 + gen + 8

    # -- memory: delta vs naive dense copies over fleet sizes ---------------
    memory = memory_table(base, quick)
    assert memory["64"]["ratio"] >= 10.0, (
        f"delta fleet must be >=10x smaller than dense copies at n=64, "
        f"got {memory['64']['ratio']:.1f}x"
    )

    # -- bit identity: delta engine (both modes) vs dense baseline ----------
    fleet = FleetDelta.synthetic(base, 16, seed=1)
    dense = materialize_fleet(fleet)
    costs = StepCosts(prefill_s=0.05, decode_s=0.01)
    streams = {}
    engines = {}
    for name, (fl, mode) in {
        "dense": (dense, "admit"),
        "delta_admit": (fleet, "admit"),
        "delta_step": (fleet, "step"),
    }.items():
        eng = DecodeEngine(bundle, fl, n_slots=slots, max_seq=max_seq, materialize=mode)
        rep = run_load(ContinuousBatcher(eng), _trace(fleet, n_requests, 4.0, gen=gen),
                       costs=costs)
        streams[name] = _tokens_of(rep)
        engines[name] = eng
    bit_identical = (streams["delta_admit"] == streams["dense"]
                     and streams["delta_step"] == streams["dense"])
    assert bit_identical, (
        "delta engine must be bit-identical to the dense-materialized "
        "baseline for lossless top-k deltas"
    )
    bit_identity = {
        "n_requests": n_requests,
        "admit_vs_dense": streams["delta_admit"] == streams["dense"],
        "step_vs_dense": streams["delta_step"] == streams["dense"],
    }

    # -- measured throughput/latency vs request rate ------------------------
    eng = engines["delta_admit"]
    # warm-up trace: the first launches build and load the kernels
    run_load(ContinuousBatcher(eng), _trace(fleet, 2, 100.0, gen=2))
    rates = {}
    for rate in (2.0, 8.0) if quick else (1.0, 4.0, 16.0):
        rep = run_load(ContinuousBatcher(eng), _trace(fleet, n_requests, rate, gen=gen))
        row = {
            "rate": rate,
            "n_requests": len(rep.requests),
            "total_tokens": rep.total_tokens,
            "tokens_per_s": rep.tokens_per_s,
            "p50_s": rep.p50_s,
            "p99_s": rep.p99_s,
            "mean_queue_wait_s": rep.mean("queue_wait_s"),
        }
        assert row["tokens_per_s"] > 0, f"no throughput at rate={rate}"
        assert row["p99_s"] >= row["p50_s"] > 0
        rates[f"rate={rate:g}"] = row

    sync(dev)
    payload = {
        "quick": quick,
        "arch": TINY.name,
        "n_slots": slots,
        "memory": memory,
        "bit_identity": bit_identity,
        "rates": rates,
        "seconds": time.perf_counter() - t_start,
    }
    save_result("BENCH_serve", payload, out_dir, device=dev)
    return payload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    payload = run(quick=not args.full, device=args.device, out_dir=args.out)
    print(f"memory ratio @64 agents: {payload['memory']['64']['ratio']:.1f}x")
    print(f"bit identity: {payload['bit_identity']}")
    for k, v in payload["rates"].items():
        print(f"{k}: {v['tokens_per_s']:.1f} tok/s "
              f"p50={v['p50_s']*1e3:.1f}ms p99={v['p99_s']*1e3:.1f}ms")


if __name__ == "__main__":
    main()
