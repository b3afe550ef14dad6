#!/usr/bin/env python3
"""Ablation of K6's tensor-core kernel on the card.

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it stands and
variants of it, each with one part of the design changed or removed by a
text substitution, and prints the device time of each (``torch.profiler``,
kernels only, a mean over 20 calls, two repetitions in turn) at Qwen3-8B's
attention shape, (B, Hq, Hkv, D) = (1, 32, 8, 128) in bf16: S = 2048 causal
and not, and the served S = 500 causal, without the attention logit softcap,
and S = 2048 causal with Gemma-2's cap of 50; beside each time, the largest
error against the (capped) plain version.  Run from the repository root on a
machine with an H100 and ``nvcc``:

    python3 tools/k6_ablation.py

The variants that drop work (``no_exp``, ``no_softmax``, ``no_pv``) compute
wrong outputs; they only say what that work costs.  ``chip_smoke.py`` holds
the kernel itself against its plain version.
"""
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import tma_strides  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "k6_ablation")

STEADY_SOFTMAX = ("softmax_tile<BK, CAP>(sc, m, alpha, rs, it.k_begin + t * BK, r0, row, col, "
                  "sk,\n                                causal, window, scale_log2, cap_k, cap);")
VARIANTS = {
    "base": [],
    # 64 keys per tile instead of 128
    "bk64": [("static constexpr int BK = D == 192 ? 64 : 128;", "static constexpr int BK = 64;")],
    # a two-stage K/V ring instead of three
    "ns2": [("NSTAGE_FIT < 4 ? NSTAGE_FIT : 4", "2")],
    # one work item per block, blocks in the hardware's order (not persistent)
    "one_item_per_block": [("const int blocks = (int)(n_items < sms[device] ? n_items : "
                            "sms[device]);", "const int blocks = (int)n_items;")],
    # both consumer warpgroups start each item together
    "no_stagger": [('asm volatile("bar.sync %0, 256;\\n" ::"n"(id) : "memory");', ""),
                   ('asm volatile("bar.arrive %0, 256;\\n" ::"n"(id) : "memory");', "")],
    # the accurate exp2f (subnormals kept) for the probabilities
    "exp2f": [("ex2(fmaf(sc[i], scale_log2, -msc[r]))",
               "exp2f(fmaf(sc[i], scale_log2, -msc[r]))")],
    # no exponentials at all (wrong output)
    "no_exp": [("ex2(fmaf(sc[i], scale_log2, -msc[r]))", "fmaf(sc[i], scale_log2, -msc[r])")],
    # no softmax after the first tile (wrong output)
    "no_softmax": [(STEADY_SOFTMAX, "alpha[0] = alpha[1] = 1.f; rs[0] = rs[1] = 0.f;")],
    # no P V product after the first tile (wrong output)
    "no_pv": [("issue_pv<D>(acc, pa, stage_k(kt - 1) + C::KV_BYTES);", "wg_commit();")],
    # the softcap's tanh as cap - 2 cap / (2^x + 1) from an ex2.approx and an
    # IEEE division (two SFU operations, relative error ~2^-22) instead of
    # one tanh.approx.f32 (~2^-11); 2.8853901 = 2 log2(e)
    "softcap_ex2_div": [(
        '  asm("tanh.approx.f32 %0, %1;\\n" : "=f"(t) : "f"(s * k));\n  return cap * t;',
        "  t = cap - __fdiv_rn(2.f * cap, ex2(s * k * 2.8853901f) + 1.f);\n  return t;")],
}
# (S, causal, softcap)
CASES = ((2048, True, None), (2048, False, None), (500, True, None), (2048, True, 50.0))


def build_variants():
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
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
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).launch_flash_attention
        fn.argtypes = build.SIGNATURES["flash_attention"]["launch_flash_attention"]
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
        print("k6_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fns = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {name: {} for name in fns}
    errs = {name: {} for name in fns}
    for s, causal, cap in CASES:
        # q as the prefill hands it over: a (B, H, S, D) view of (B, S, H, D)
        q = torch.randn(1, s, 32, 128, generator=gen, device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn(1, 8, s, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
        out = torch.empty(1, 32, s, 128, dtype=torch.bfloat16, device=dev)
        strides = [x for t, n in ((q, "q"), (k, "k"), (v, "v")) for x in tma_strides(t, n)]

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 32, 8, s, s,
                     128, *strides, 1.0 / math.sqrt(128), int(causal), 0,
                     0.0 if cap is None else cap, 1, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        key = f"S{s}" + ("_causal" if causal else "") + ("" if cap is None else f"_softcap{cap:g}")
        want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=cap).float()
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            errs[name][key] = float((out.float() - want).abs().max())
        for _ in range(2):
            for name, fn in fns.items():
                res[name].setdefault(key, []).append(device_ms(lambda: call(fn)))
    print(card)
    print(json.dumps({"card": card, "shape": [1, 32, 8, "S", 128], "dtype": "bfloat16",
                      "device_ms": res, "max_abs_err": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
