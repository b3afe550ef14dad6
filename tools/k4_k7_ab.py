#!/usr/bin/env python3
"""K4 and K7 across source trees, in turn, on one card.

For each tree given (its own process, building its own kernels):

* K4 at sparse-10k's w1 leaf (10^4 agents x 25,088 f32 over the degree-4
  expander): CUDA-event ms per call back to back, device ms (profiler), and
  ``torch.sparse.mm``'s device ms on the same inputs;
* K7 at Mamba2-370m's prefill shape (1, 2048, 32, 64, 1, 128) bf16: device
  ms per call;
* one Mamba2-370m prefill at full width in bf16, the 1000-token served
  prompt of chip_smoke.py's serve-mamba2-370m: wall ms (a mean of 5 after a
  warm-up), device ms and K7's share of one traced prefill, K7's calls and
  device kernels, and the last-position logits through the kernels against
  the plain versions on the card (max |err| / (1 + max |logit|), the greedy
  tokens of both and the plain logits' top-2 margin).

Compare a change with its parent on one card, parent / change / change /
parent:

    git archive <parent> | tar -x -C build/parent
    python3 tools/k4_k7_ab.py build/parent . . build/parent
"""
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_config
from repro_torch.core.topology import make_sparse_topology
from repro_torch.kernels import ops
from repro_torch.models.registry import get_bundle
from repro_torch.serve import ArrivalProcess, DecodeEngine, FleetDelta, make_requests

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)


def device_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def event_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


row = dict(tree=sys.argv[1])
topo = make_sparse_topology("random_regular", 10000)
csr = (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
       torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
       torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))
x = torch.randn(10000, 25088, generator=gen, device=dev)
diag = torch.arange(10000, device=dev)
rows = torch.repeat_interleave(diag, csr[0][1:] - csr[0][:-1])
w = torch.sparse_coo_tensor(torch.stack([torch.cat([rows, diag]), torch.cat([csr[1], diag])]),
                            torch.cat([csr[2], csr[3]]), (10000, 10000)).coalesce().to_sparse_csr()
row.update(k4_ms=event_ms(lambda: ops.sparse_mix_csr(x, *csr)),
           k4_device_ms=device_ms(lambda: ops.sparse_mix_csr(x, *csr)),
           sparse_mm_device_ms=device_ms(lambda: torch.sparse.mm(w, x)))
del x, w
torch.cuda.empty_cache()

args = (torch.randn(1, 2048, 32, 64, generator=gen, device=dev).bfloat16(),
        (0.001 + 0.099 * torch.rand(1, 2048, 32, generator=gen, device=dev)).bfloat16(),
        -(1.0 + 15.0 * torch.rand(32, generator=gen, device=dev)),
        torch.randn(1, 2048, 1, 128, generator=gen, device=dev).bfloat16(),
        torch.randn(1, 2048, 1, 128, generator=gen, device=dev).bfloat16())
row["k7_device_ms_L2048"] = device_ms(lambda: ops.ssd_scan(*args, chunk=256))
del args

bundle = get_bundle(get_config("mamba2-370m"), dev)
fleet = FleetDelta.synthetic(bundle.init(seed=0), 8, fraction=0.02, seed=0)
engine = DecodeEngine(bundle, fleet, n_slots=4, max_seq=1040, materialize="admit")
req = make_requests(ArrivalProcess.parse("poisson:rate=4"), 12, n_agents=8,
                    vocab_size=bundle.cfg.vocab_size, prompt_len=1000, max_new_tokens=32,
                    seed=0)[0]
engine.admit(0, req.agent_id, req.prompt)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    engine.admit(0, req.agent_id, req.prompt)
torch.cuda.synchronize()
wall = (time.perf_counter() - t0) / 5 * 1e3
ops.reset_launch_counts()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    logits = engine.admit(0, req.agent_id, req.prompt)
    torch.cuda.synchronize()
ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
k7 = [e for e in ev if "ssd_" in e.name]
span = lambda es: sum(e.time_range.end - e.time_range.start for e in es) / 1e3
plain = engine.admit(0, req.agent_id, req.prompt, use_kernels=False)
top2 = np.sort(plain)[-2:]
row.update(prefill_wall_ms=wall, prefill_device_ms=span(ev), k7_prefill_ms=span(k7),
           k7_calls=ops.launch_counts()["ssd_scan"], k7_device_kernels=len(k7),
           logit_err=float(np.abs(logits - plain).max()) / (1.0 + float(np.abs(plain).max())),
           greedy=[int(np.argmax(logits)), int(np.argmax(plain))],
           plain_top2_margin=float(top2[1] - top2[0]))
print(json.dumps(row))
'''


def main():
    trees = sys.argv[1:] or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree)],
                             capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"{tree}: rc {out.returncode}\n{out.stderr[-4000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
