#!/usr/bin/env python3
"""Pod-as-agent's gradient call, the whole-agent gather against the
per-period gather, on one card: four gloo ranks (mesh pod 2 x data 2 x
model 1, as chip_smoke.py's collective-hierarchical-mamba2-370m), each on
its data shard of its pod's agent at full width in bf16 and one row of
``--seq`` tokens.  Each rank calls the gradient in turn as

* ``whole``: the agent's whole leaves gathered before the call, the
  gradient, then each sharded leaf's gradient reduce-scattered and each
  whole one all-reduced — what ``sharded_value_and_grad`` did before the
  per-period gather (``tests/_torch_fsdp.py``, the tests' oracle);
* ``period``: ``sharded_value_and_grad``: each period gathered where it
  starts, inside its remat region, its gradient reduce-scattered when its
  backward ends;

in the order whole, period, period, whole (``--repeat`` times), and prints
per call the peak it adds above the memory allocated before it, its wall
milliseconds with the mesh clock's gather and scatter shares, the
per-period call's all-gathers and reduce-scatters over data (its handle's
counts), and whether its loss and
gradient shards are bit-equal to the first whole call's.  The summary line
(JSON) goes to stdout and to ``--out``.

    python3 tools/fsdp_gather_ab.py --arch mamba2-370m --seq 256

Run from the root of a checkout, on a machine with a CUDA card (``--device
cpu --layers 2`` rehearses it on the CPU, without the memory figures).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def rank_main(rank, args, port, out_dir):
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]
    import dataclasses

    import torch
    import torch.distributed as dist

    from _torch_fsdp import whole_gather_value_and_grad
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh, rank_slice
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    try:
        cfg = get_config(args.arch, "bfloat16")
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        bundle = get_bundle(cfg, dev)
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), dev)
        shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq, global_batch=4)
        notes = S.build_train_steps(bundle, shape, mesh, t_o=1,
                                    agent_mode="hierarchical")["train_gossip"].notes
        dims = notes["data_dims"]
        comm = make_lm_sampler(cfg, 2, 2, args.seq, 1, seed=0)(0)[1]
        batch = S.batch_share(rank_slice(comm, mesh, ("pod",), device=dev),
                              notes["batch_dims"]["comm"], mesh)
        shards = S.shard_leaves(flatten_paths(bundle.init(seed=0)), dims, mesh)
        if cuda:
            torch.cuda.empty_cache()
        fns = {"whole": whole_gather_value_and_grad(bundle, mesh, dims),
               "period": S.sharded_value_and_grad(bundle, mesh, dims)}
        gathered = sum(v.numel() * v.element_size() * (1 if dims[k] is None else 2)
                       for k, v in shards.items())
        rows, first = [], None
        for name in ("whole", "period", "period", "whole") * args.repeat:
            counts = fns["period"].data_axis.stats
            fns["period"].data_axis.reset()
            mesh.clock.reset()
            mesh.clock.on = True
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev) if cuda else 0
            t0 = time.perf_counter()
            loss, grads = fns[name](shards, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            mesh.clock.on = False
            added = torch.cuda.max_memory_allocated(dev) - before if cuda else 0
            if first is None:
                first = (loss, grads)
            equal = bool(torch.equal(loss, first[0])) and all(
                torch.equal(grads[k], first[1][k]) for k in grads)
            secs = mesh.clock.seconds
            rows.append(dict(variant=name, added_gib=added / 2**30, before_gib=before / 2**30,
                             ms=ms, gather_ms=1e3 * secs.get("gather", 0.0),
                             scatter_ms=1e3 * secs.get("scatter", 0.0),
                             n_gather=counts["all-gather"] if name == "period" else None,
                             n_scatter=counts["reduce-scatter"] if name == "period" else None,
                             bit_equal_to_first_whole=equal))
            del loss, grads
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rows=rows, gathered_gib=gathered / 2**30,
                           state_bytes_per_card=notes["state_bytes_per_card"],
                           n_sharded=sum(d is not None for d in dims.values()),
                           n_leaves=len(dims)), f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal (no memory figures)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "fsdp_gather_ab.json"))
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fsdp_gather_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)), "fsdp_gather_ab_ranks")
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(args, port, out_dir), nprocs=4, join=True, start_method="spawn")
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        for row in res["rows"]:
            print(f"rank {r} {row['variant']:6s}: adds {row['added_gib']:.3f} GiB above "
                  f"{row['before_gib']:.3f} GiB, {row['ms']:.1f} ms (gather "
                  f"{row['gather_ms']:.1f}, scatter {row['scatter_ms']:.1f}), "
                  + (f"{row['n_gather']} all-gathers, {row['n_scatter']} reduce-scatters, "
                     if row["n_gather"] is not None else "")
                  + f"bit-equal to the first whole call: {row['bit_equal_to_first_whole']}")
    summary = dict(arch=args.arch, seq=args.seq, card=card,
                   gathered_gib=ranks[0]["gathered_gib"], n_sharded=ranks[0]["n_sharded"],
                   n_leaves=ranks[0]["n_leaves"], ranks=[res["rows"] for res in ranks])
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"card: {card}")
    print(json.dumps({k: v for k, v in summary.items() if k != "ranks"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
