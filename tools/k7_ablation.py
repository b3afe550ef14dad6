#!/usr/bin/env python3
"""Ablation of K7's three chunk-parallel passes on the card.

Builds ``src/repro_torch/kernels/csrc/ssd_scan.cu`` as it stands and
variants of it, each with one part of the design removed or changed by a
text substitution, and prints each variant's device time per pass
(``torch.profiler``, kernels only, a mean over 20 calls, two repetitions in
turn) at Mamba2-370m's prefill shapes in bf16, (B, H, P, G, N) =
(1, 32, 64, 1, 128) at L = 2048 and the served L = 1000.  Run from the
repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k7_ablation.py

The variants that drop work compute wrong outputs; they only say what that
work costs.  ``chip_smoke.py`` holds the kernel itself against its plain
version.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "k7_ablation")

VARIANTS = {
    "base": [],
    # tiles staged through registers, one element an access (no cp.async)
    "no_cp_async": [("return vec ? launch_passes", "return false ? launch_passes")],
    # pass (a) without its product (w∘X)ᵀ·B (wrong output)
    "no_state_product": [("warp_mma_wx(acc, sX, lp, sW, sB, ln, m0, n0, T, lane);", "")],
    # no scan over the chunk states (wrong output)
    "no_scan": [("  if (pn % 4 == 0)\n    ssd_state_scan_kernel<4>",
                 "  if (false)\n    ssd_state_scan_kernel<4>"),
                ("  else\n    ssd_state_scan_kernel<1>",
                 "  else if (false)\n    ssd_state_scan_kernel<1>")],
    # pass (c) without C·Bᵀ (G = 0; wrong output)
    "no_cb": [("if (n0 <= m0 + 15) warp_mma<false>(acc, sC, ln, 0, 1, sB, ln, m0, n0, np, lane);",
               "")],
    # pass (c) without G·X (wrong output)
    "no_gx": [("warp_mma<true>(acc, sG, lt, T * lt, S, sX, lp, m0, n0, m0 + 16, lane);", ";")],
    # pass (c) without h_in: neither its copy nor C·h_inᵀ (wrong output)
    "no_h_in": [("const bool has_state = z > 0;", "const bool has_state = false;")],
    # G·X with G in one bf16 term, not three (less accurate)
    "g_one_term": [("warp_mma<true>(acc, sG, lt, T * lt, S, sX, lp, m0, n0, m0 + 16, lane);",
                    "warp_mma<true>(acc, sG, lt, T * lt, 1, sX, lp, m0, n0, m0 + 16, lane);")],
}
SHAPES = ((1, 2048, 32, 64, 1, 128), (1, 1000, 32, 64, 1, 128))


def build_variants():
    src = open(os.path.join(CSRC, "ssd_scan.cu")).read()
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
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).launch_ssd_scan
        fn.argtypes = build.SIGNATURES["ssd_scan"]["launch_ssd_scan"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def pass_ms(fn, iters=20):
    """Device ms per call, by pass (kernel name) and in all."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in ("chunk_state", "state_scan", "chunk_output") if k in e.name),
                       "other")
            out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / iters
    out["total"] = sum(out.values())
    return out


def main():
    if not torch.cuda.is_available():
        print("k7_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fns = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {name: {} for name in fns}
    for b, l, h, p, g, n in SHAPES:
        x = torch.randn(b, l, h, p, generator=gen, device=dev).bfloat16()
        dt = (0.001 + 0.099 * torch.rand(b, l, h, generator=gen, device=dev)).bfloat16()
        a = -(1.0 + 15.0 * torch.rand(h, generator=gen, device=dev))
        bm, cm = (torch.randn(b, l, g, n, generator=gen, device=dev).bfloat16() for _ in range(2))
        y = torch.empty_like(x)
        hfin = torch.empty(b, h, p, n, device=dev)
        nc = -(-l // 64)
        states = torch.empty(b, h, nc, p, n, device=dev)
        decay = torch.empty(b, h, nc, device=dev)
        strides = [*x.stride()[:3], *dt.stride(), *bm.stride()[:3], *cm.stride()[:3]]

        def call(fn):
            err = fn(*(t.data_ptr() for t in (x, dt, a, bm, cm, y, hfin, states, decay)), b, l, h,
                     g, p, n, *strides, 1, 1, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for _ in range(2):
            for name, fn in fns.items():
                res[name].setdefault(f"L{l}", []).append(pass_ms(lambda: call(fn)))
    print(card)
    print(json.dumps({"card": card, "shapes": SHAPES, "dtype": "bfloat16", "device_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
