#!/usr/bin/env python3
"""K6's share of one Qwen3-8B prefill (full width, bf16, the 500-token
served prompt of chip_smoke.py's serve-qwen3-8b) for each source tree given,
in turn, on one card: the prefill's wall time (a mean of 5, after a
warm-up), its device time and K6's (one traced prefill), K6's launches, and
the last-position logits through the kernels against the plain versions
(max |err| / (1 + max |logit|), the check of chip_smoke.py).  Compare a
change with its parent on one card:

    git archive <parent> | tar -x -C build/parent
    python3 tools/k6_prefill_ab.py build/parent . . build/parent

Each tree runs in its own process and builds its own kernels.
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
from repro_torch.models.registry import get_bundle
from repro_torch.serve import ArrivalProcess, DecodeEngine, FleetDelta, make_requests

dev = torch.device("cuda")
bundle = get_bundle(get_config("qwen3-8b"), dev)
fleet = FleetDelta.synthetic(bundle.init(seed=0), 4, fraction=0.001, seed=0)
engine = DecodeEngine(bundle, fleet, n_slots=2, max_seq=524, materialize="admit")
req = make_requests(ArrivalProcess.parse("poisson:rate=4"), 6, n_agents=4,
                    vocab_size=bundle.cfg.vocab_size, prompt_len=500, max_new_tokens=16,
                    seed=0)[0]
engine.admit(0, req.agent_id, req.prompt)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    engine.admit(0, req.agent_id, req.prompt)
torch.cuda.synchronize()
wall = (time.perf_counter() - t0) / 5 * 1e3
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    engine.admit(0, req.agent_id, req.prompt)
    torch.cuda.synchronize()
ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
k6 = [e for e in ev if "flash_fwd" in e.name]
span = lambda es: sum(e.time_range.end - e.time_range.start for e in es) / 1e3
kern = engine.admit(0, req.agent_id, req.prompt)
plain = engine.admit(0, req.agent_id, req.prompt, use_kernels=False)
print(json.dumps(dict(
    tree=sys.argv[1], prefill_wall_ms=wall, device_ms=span(ev), k6_ms=span(k6),
    k6_launches=len(k6), k6_kernel=k6[0].name[:60] if k6 else None,
    logit_err=float(np.abs(kern - plain).max()) / (1.0 + float(np.abs(plain).max())),
    greedy=[int(np.argmax(kern)), int(np.argmax(plain))])))
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
