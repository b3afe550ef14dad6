#!/usr/bin/env python3
"""Ablation of K4's gather kernel on the card.

Builds ``src/repro_torch/kernels/csrc/sparse_mix.cu`` as it stands and
variants of it, each with one part of the design changed by a text
substitution, and prints the device time of each (``torch.profiler``,
kernels only, a mean over 20 calls, two repetitions in turn) at the leaves
of sparse-10k's MLP (10^4 agents over the degree-4 expander; d = 25,088,
320, 32 and 10), beside the L2 read rate (``chip_smoke.l2_read_rate``) and
the floor it sets for K4's gathered bytes.  Run from the
repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k4_ablation.py

Every variant computes the same output; ``chip_smoke.py`` holds the kernel
itself against its plain version.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import l2_read_rate  # noqa: E402
from repro_torch.core.topology import make_sparse_topology  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "k4_ablation")

VARIANTS = {
    "base": [],
    # two and four edges' gathers issued before their adds
    "batch2": [("constexpr int MIX_BATCH = 1;", "constexpr int MIX_BATCH = 2;")],
    "batch4": [("constexpr int MIX_BATCH = 1;", "constexpr int MIX_BATCH = 4;")],
    # 4-byte loads everywhere
    "scalar": [("const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out);",
                "const bool vec = false;")],
    # 128- and 512-column tiles (one and four 16-byte loads per lane and row)
    "tile128": [("constexpr int MIX_VEC = 2;", "constexpr int MIX_VEC = 1;")],
    "tile512": [("constexpr int MIX_VEC = 2;", "constexpr int MIX_VEC = 4;")],
    # receivers as the slow index: the blocks in flight span every tile
    "receiver_major": [(
        "const int64_t tile = blockIdx.x / recv_blocks;\n"
        "  const int64_t i = (blockIdx.x - tile * recv_blocks) * MIX_WARPS + (threadIdx.x >> 5);",
        "const int64_t tiles = gridDim.x / recv_blocks, tile = blockIdx.x % tiles;\n"
        "  const int64_t i = (blockIdx.x / tiles) * MIX_WARPS + (threadIdx.x >> 5);")],
    # out stored with evict-first hints (16-byte path)
    "evict_first_store": [(
        "*reinterpret_cast<float4*>(row + c) =\n"
        "            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);",
        "__stcs(reinterpret_cast<float4*>(row + c),\n"
        "               make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));")],
    # eight receivers per block
    "warps8": [("constexpr int MIX_WARPS = 4;", "constexpr int MIX_WARPS = 8;")],
}
WIDTHS = (25088, 320, 32, 10)


def build_variants():
    src = open(os.path.join(CSRC, "sparse_mix.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source any more")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        open(cu, "w").write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", CSRC, "-o",
               os.path.join(OUT, f"lib{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).launch_sparse_mix_csr
        fn.argtypes = build.SIGNATURES["sparse_mix"]["launch_sparse_mix_csr"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def main():
    if not torch.cuda.is_available():
        print("k4_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fns = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    topo = make_sparse_topology("random_regular", 10000)
    csr = (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
           torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))
    n, nnz = topo.n_agents, int(topo.indptr[-1])
    l2_rate = l2_read_rate(torch, gen, dev)
    res = {name: {} for name in fns}
    floors = {}
    for d in WIDTHS:
        x = torch.randn(n, d, generator=gen, device=dev)
        out = torch.empty_like(x)
        want = ref.sparse_mix_csr_ref(x, *csr)
        floors[d] = 1e3 * (nnz + n) * d * 4 / l2_rate

        def call(fn):
            err = fn(x.data_ptr(), *(t.data_ptr() for t in csr), out.data_ptr(), n, d, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for name, fn in fns.items():  # every variant computes the same output
            call(fn)
            torch.cuda.synchronize()
            if float((out - want).abs().max()) > 2e-5 * (1.0 + float(x.abs().max())):
                raise SystemExit(f"variant {name} disagrees with the plain version at d = {d}")
        for _ in range(2):
            for name, fn in fns.items():
                res[name].setdefault(f"d{d}", []).append(device_ms(lambda: call(fn)))
        del x, out, want
    print(card)
    print(json.dumps({"card": card, "n": n, "nnz": nnz, "l2_read_tb_s": l2_rate / 1e12,
                      "l2_floor_ms": {f"d{d}": v for d, v in floors.items()},
                      "device_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
