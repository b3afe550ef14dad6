#!/usr/bin/env python3
"""K3 and K5 across source trees, in turn, on one card.

For each tree given (its own process, building its own kernels):

* K3 at dense-q8's w1 leaf (512 x 25,088 f32, Erdos-Renyi(0.3) W, residual
  and noise: stochastic int8 with error feedback): device ms per call
  (``torch.profiler``, every kernel the call launches);
* K5 at sparse-10k's leaves (10^4 agents over the degree-4 expander; d =
  25,088, 320, 32 and 10), in the error-feedback form (residual and noise)
  and the stateless form: device ms per call;
* the device ms a round of dense-q8 and sparse-10k-q8, and their idle
  shares, from ``chip_smoke.profile_rounds`` of the tree (four traced
  gossip rounds), with the heaviest device ops of each round.

Compare a change with its parent on one card, parent / change / change /
parent:

    git archive <parent> | tar -x -C build/parent
    python3 tools/k3_k5_ab.py build/parent . . build/parent
"""
import json
import os
import subprocess
import sys

CHILD = r'''
import contextlib, io, json, re, sys
tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.core import ExperimentSpec
from repro_torch.core.topology import make_sparse_topology, make_topology
from repro_torch.data import FederatedDataset
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.kernels import ops
from repro_torch.models import simple as models

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


row = dict(tree=tree)
w = torch.as_tensor(make_topology("erdos_renyi", 512, prob=0.3, seed=7).w, dtype=torch.float32,
                    device=dev)
x = torch.randn(512, 25088, generator=gen, device=dev)
r = 0.01 * torch.randn(512, 25088, generator=gen, device=dev)
noise = torch.rand(512, 25088, generator=gen, device=dev)
am = ops.row_absmax(x, r)
row["k3_device_ms"] = device_ms(lambda: ops.compressed_mix(x, r, w, am, bits=8, noise=noise))
topo = make_sparse_topology("random_regular", 10000)
csr = (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
       torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
       torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))
for d in (25088, 320, 32, 10):
    x = torch.randn(10000, d, generator=gen, device=dev)
    r = 0.01 * torch.randn(10000, d, generator=gen, device=dev)
    noise = torch.rand(10000, d, generator=gen, device=dev)
    am, am0 = ops.row_absmax(x, r), ops.row_absmax(x)
    row[f"k5_ef_device_ms_d{d}"] = device_ms(
        lambda: ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, noise=noise))
    row[f"k5_stateless_device_ms_d{d}"] = device_ms(
        lambda: ops.sparse_compressed_mix_csr(x, None, *csr, am0, bits=8))
del x, r, noise
torch.cuda.empty_cache()

mlp0 = models.mlp_init(0)
paths = []
xs, ys = synthetic_mnist(512 * 80, seed=0)
paths.append(("dense-q8", ExperimentSpec.create(
    algo="pisco", n_agents=512, t_o=2, eta_l=0.1, p=0.1, seed=0, topology="erdos_renyi",
    topology_kwargs={"prob": 0.3, "seed": 7}, compression="q8", rounds=20, eval_every=10),
    FederatedDataset.from_arrays(xs, ys, n_agents=512)))
xs, ys = synthetic_mnist(10000 * 20, seed=0)
paths.append(("sparse-10k-q8", ExperimentSpec.create(
    algo="pisco", n_agents=10000, t_o=2, eta_l=0.1, p=0.05, seed=0, topology="random_regular",
    topology_kwargs={"degree": 4}, sparse=True, compression="q8", rounds=20, eval_every=10),
    FederatedDataset.from_arrays(xs, ys, n_agents=10000)))
for label, spec, data in paths:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.profile_rounds(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    text = buf.getvalue()
    m = re.search(r"idle ([0-9.]+)%\), device time ([0-9.]+) ms/round", text)
    row[f"{label}_device_ms_per_round"] = float(m.group(2))
    row[f"{label}_idle_pct"] = float(m.group(1))
    row[f"{label}_top"] = [[float(a), b] for a, b in re.findall(
        r"profile [^:]+:\s+([0-9.]+) ms/round  (.{1,60})", text)][:6]
    del data
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
