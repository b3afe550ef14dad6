#!/usr/bin/env python3
"""How closely K7's bf16 output tracks the exact SSD, across source trees.

For each tree (this one first, then any given on the command line, each
tree's ``csrc/ssd_scan.cu`` built with ``nvcc`` as it stands) and each case,
counts the bf16 outputs y that round otherwise than an f64 oracle's (the
chunked SSD with every step in float64, rounded to bf16 once), and the scaled
error that ``chip_smoke.py`` checks: max |y - plain| / (1 + max |plain|)
against the f32 plain version ``ref.ssd_scan_ref`` (limit 2^-8).  The plain
version's own count is reported beside them.  Cases, at Mamba2-370m's heads
(H 32, P 64, G 1, N 128) in bf16: chip_smoke.py's own K7 inputs (captured
from its ``lm_kernel_checks``), ten random draws at the served L = 1000,
strong decay (dt 0.1, A -16) and one more L = 2048.  Run on a machine with an
H100 and ``nvcc`` from the repository root:

    git archive <parent> | tar -x -C build/parent
    python3 tools/k7_accuracy.py build/parent
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "k7_accuracy")
P_ = ctypes.c_void_p
OLD_ARGS = [P_] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2 + [P_]


def tree_kernel(tree, name):
    """(launch function, takes scratch) of a tree's ssd_scan.cu."""
    src = os.path.join(tree, "src", "repro_torch", "kernels", "csrc", "ssd_scan.cu")
    lib = os.path.join(OUT, f"lib{name}.so")
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(lib).launch_ssd_scan
    scratch = "void* states" in open(src).read()
    fn.argtypes = build.SIGNATURES["ssd_scan"]["launch_ssd_scan"] if scratch else OLD_ARGS
    fn.restype = ctypes.c_int
    return fn, scratch


def run(kernel, args):
    fn, scratch = kernel
    x, dt, a, bm, cm = args
    b, l, h, p = x.shape
    g, n = bm.shape[2:]
    y, hf = torch.empty_like(x), torch.empty(b, h, p, n, device=x.device)
    extra = []
    if scratch:
        nc = -(-l // 64)
        extra = [torch.empty(b, h, nc, p, n, device=x.device),
                 torch.empty(b, h, nc, device=x.device)]
    strides = [*x.stride()[:3], *dt.stride(), *bm.stride()[:3], *cm.stride()[:3]]
    err = fn(*(t.data_ptr() for t in (x, dt, a, bm, cm, y, hf, *extra)), b, l, h, g, p, n,
             *strides, 1, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return y


def oracle(x, dt, a, bm, cm, chunk=64):
    """The chunked SSD with every step in float64."""
    x, dt, a, bm, cm = (t.double() for t in (x, dt, a, bm, cm))
    b, l, h, p = x.shape
    g, n = bm.shape[2:]
    pad = -l % chunk
    x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc, dtc = x.reshape(b, nc, chunk, h, p), dt.reshape(b, nc, chunk, h)
    bc, cc = (torch.repeat_interleave(t.reshape(b, nc, chunk, g, n), h // g, dim=3)
              for t in (bm, cm))
    cum = torch.cumsum(dtc * a, dim=2)
    ch = cum.movedim(-1, 2)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal, torch.exp(torch.where(causal, ch[..., :, None] - ch[..., None, :],
                                                    0.0)), 0.0)
    gm = torch.einsum("bzlhn,bzshn->bzhls", cc, bc) * seg * dtc.movedim(-1, 2)[..., None, :]
    y = torch.einsum("bzhls,bzshp->bzlhp", gm, xc)
    states = torch.einsum("bzshp,bzshn->bzhpn", (dtc * torch.exp(cum[:, :, -1:] - cum))[..., None]
                          * xc, bc)
    dec = torch.exp(cum[:, :, -1])
    carry, prev = torch.zeros_like(states[:, 0]), []
    for z in range(nc):
        prev.append(carry)
        carry = carry * dec[:, z, :, None, None] + states[:, z]
    y = y + torch.einsum("bzlhn,bzhpn->bzlhp", cc, torch.stack(prev, 1)) * torch.exp(cum)[..., None]
    return y.reshape(b, -1, h, p)[:, :l]


def smoke_inputs(torch, dev):
    """The K7 inputs of chip_smoke.lm_kernel_checks, in its order, each once
    (its timing loops call K7 again on the same tensors)."""
    captured, seen, real, check = [], set(), ops.ssd_scan, chip_smoke.check

    def spy(*args, **kw):
        key = (tuple(args[0].shape), args[0].data_ptr(), float(args[0].float().abs().sum()))
        if key not in seen:
            seen.add(key)
            captured.append(tuple(t.clone() for t in args))
        return real(*args, **kw)

    ops.ssd_scan, chip_smoke.check = spy, (lambda cond, what: None)
    try:
        chip_smoke.lm_kernel_checks(torch, dev)
    finally:
        ops.ssd_scan, chip_smoke.check = real, check
    return captured


def main():
    if not torch.cuda.is_available():
        print("k7_accuracy: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    trees = {"this": ROOT, **{f"tree{i}": t for i, t in enumerate(sys.argv[1:], 1)}}
    kernels = {name: tree_kernel(t, name) for name, t in trees.items()}
    gen = torch.Generator(device=dev).manual_seed(123)

    def draw(l, strong=False):
        x = torch.randn(1, l, 32, 64, generator=gen, device=dev).bfloat16()
        dt = (0.001 + 0.099 * torch.rand(1, l, 32, generator=gen, device=dev)).bfloat16()
        a = -(1.0 + 15.0 * torch.rand(32, generator=gen, device=dev))
        if strong:
            dt, a = torch.full_like(dt, 0.1), torch.full_like(a, -16.0)
        bm, cm = (torch.randn(1, l, 1, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
        return x, dt, a, bm, cm

    smoke = [c for c in smoke_inputs(torch, dev)
             if c[0].dtype == torch.bfloat16 and c[0].shape[2:] == (32, 64)]
    cases = [(f"chip_smoke {tuple(c[0].shape)}" + (" strong" if float(c[2][0]) == -16.0 else ""), c)
             for c in smoke]
    cases += [(f"random L1000 #{i}", draw(1000)) for i in range(10)]
    cases += [("random L1000 strong", draw(1000, True)), ("random L2048", draw(2048))]
    rows = []
    for label, args in cases:
        truth = oracle(*args).to(torch.bfloat16).float()
        plain, _ = ref.ssd_scan_ref(*args, chunk=256)
        scale = 1.0 + float(plain.float().abs().max())
        row = dict(case=label, outputs=truth.numel(),
                   plain_misrounded=int((plain.float() != truth).sum()))
        for name, kernel in kernels.items():
            y = run(kernel, args).float()
            e = float((y - plain.float()).abs().max()) / scale
            row[name] = dict(misrounded=int((y != truth).sum()), check_err=e,
                             passes=e <= chip_smoke.SSD_TOL["bfloat16"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"card": card, "trees": trees, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
