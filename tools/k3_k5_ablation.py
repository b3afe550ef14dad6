#!/usr/bin/env python3
"""Ablation of K3's and K5's two-pass designs on the card.

Builds ``src/repro_torch/kernels/csrc/quantize.cu`` and ``sparse_mix.cu`` as
they stand and variants of each, with one part of the design changed by a
text substitution, and prints device times (``torch.profiler``, kernels
only, a mean over 20 calls, three repetitions in turn):

* each pass alone: the codes pass (EF and stateless forms) at K5's and K3's
  main shapes, K5's gather and K3's contraction;
* the codes pass with 16 elements a thread per step (a 16-byte store of
  codes) and with the grid capped at 32 blocks an SM or not at all;
* K5's gather at the leaves of sparse-10k's MLP (10^4 agents over the
  degree-4 expander; d = 25,088, 320, 32 and 10): one lane width for every
  d (16, 8 or 4 codes a lane), a lane's 8 columns as one contiguous run
  instead of K4's interleaved runs of four, one or two edges' codes
  gathered before their adds instead of four, one-byte loads, eight warps
  a block, receivers as the grid's slow index, conversion instructions for
  the codes, evict-first stores, and the stateless one-pass kernel that
  re-quantises every gathered element from x;
* K3's contraction at dense-q8's w1 leaf (512 x 25,088): W' formed in the
  A tile's staging instead of a pre-pass, the codes re-quantised from x in
  every row tile's staging (4x at n = 512), a 2-stage ring, two blocks an
  SM, conversion instructions, and the accumulation without a fresh
  partial per k-step or with two (W''s leading term apart from the small
  ones); with each variant's max and mean |error| against an f64
  contraction of the same q, beside cuBLAS f32's.

Every K5 variant is held against the plain version (MIX_TOL) and every K3
variant against the f64 contraction (4x cuBLAS's max error, as
``chip_smoke.py``); the accuracy variants are reported, not held.  Run
from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k3_k5_ablation.py
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

from chip_smoke import K3_F64_ERR_RATIO, MIX_TOL  # noqa: E402
from repro_torch.core.topology import make_sparse_topology, make_topology  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "k3_k5_ablation")

# K5's gather (sparse_mix.cu)
_K5_LAUNCH = "  auto launch = d <= LANE_SWITCH ? launch_code_mix<4> : launch_code_mix<8>;"
_K5_REQUANT = [
    # every q re-quantised from x (the stateless form: no residual, no noise)
    ("      uint32_t w[EDGE_BATCH][LANE / 4];", "      float w[EDGE_BATCH][LANE];"),
    ("load_codes<VEC, LANE>(codes + j * d, c0, lane, d, w[u]);",
     "load_x<VEC, LANE>(x + j * d, c0, lane, d, w[u]);"),
    ("          codes_to_q<LANE>(w[u], s, q);",
     "          for (int k = 0; k < LANE; ++k) q[k] = quant_value(w[u][k], s, qmax, false, 0.f);"),
    ("  load_codes<VEC, LANE>(codes + i * d, c0, lane, d, ws);", ""),
    ("  codes_to_q<LANE>(ws, row_scale(absmax, i, qmax), qs);",
     "  for (int k = 0; k < LANE; ++k)\n"
     "    qs[k] = quant_value(xs[k], row_scale(absmax, i, qmax), qmax, false, 0.f);"),
]
K5_VARIANTS = {
    "base": [],
    # one lane width for every d: 16, 8 or 4 codes a lane (512-, 256- and
    # 128-column tiles)
    "lane16": [(_K5_LAUNCH, "  auto launch = launch_code_mix<16>;")],
    "lane8": [(_K5_LAUNCH, "  auto launch = launch_code_mix<8>;")],
    "lane4": [(_K5_LAUNCH, "  auto launch = launch_code_mix<4>;")],
    # 8 codes a lane as one contiguous run (c0 + 8 lane ..), not K4's
    # interleaved runs of four
    "runs": [(_K5_LAUNCH, "  auto launch = launch_code_mix<8>;"),
             ("  return c0 + 128 * q + 4 * lane;", "  return c0 + 8 * lane + 4 * q;")],
    # one or two edges' codes gathered before their adds
    "batch1": [("constexpr int EDGE_BATCH = 4;", "constexpr int EDGE_BATCH = 1;")],
    "batch2": [("constexpr int EDGE_BATCH = 4;", "constexpr int EDGE_BATCH = 2;")],
    "bytes": [("const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out) && "
               "aligned16(codes);", "const bool vec = false;")],
    "warps8": [("constexpr int MIX_WARPS = 4;", "constexpr int MIX_WARPS = 8;")],
    "receiver_major": [(
        "  const int64_t tile = blockIdx.x / recv_blocks;\n"
        "  const int64_t i = (blockIdx.x - tile * recv_blocks) * MIX_WARPS + (threadIdx.x >> 5);\n"
        "  if (i >= n) return;  // the whole warp: i is uniform across it\n"
        "  const int64_t c0 = tile * (32 * LANE);",
        "  const int64_t tiles = gridDim.x / recv_blocks, tile = blockIdx.x % tiles;\n"
        "  const int64_t i = (blockIdx.x / tiles) * MIX_WARPS + (threadIdx.x >> 5);\n"
        "  if (i >= n) return;\n"
        "  const int64_t c0 = tile * (32 * LANE);")],
    "cvt": [("q[k] = __fmul_rn(code_at(w[k / 4] ^ SIGN_BITS, k % 4), s);",
             "q[k] = __fmul_rn((float)(int8_t)(w[k / 4] >> (8 * (k % 4))), s);")],
    "evict_first": [(  # out stored with evict-first hints
        "        *reinterpret_cast<float4*>(row + c) =\n"
        "            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);",
        "        __stcs(reinterpret_cast<float4*>(row + c),\n"
        "               make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));")],
    "one_pass": _K5_REQUANT,
}
ONE_PASS = ("one_pass",)  # stateless only, codes unused

# K3's contraction (quantize.cu)
_K3_GLOBALS = (
    "constexpr uint32_t SIGN_BITS = 0x80808080u;\n",
    "constexpr uint32_t SIGN_BITS = 0x80808080u;\n"
    "__device__ const float* g_w;\n__device__ const float* g_x;\n"
    "__device__ const float* g_absmax;\n__device__ float g_qmax;\n")
_K3_SET = (
    "  const bool vec = d % 16 == 0 && aligned16(x) && aligned16(out) && aligned16(codes);\n",
    "  cudaMemcpyToSymbolAsync(g_w, &w, sizeof(void*), 0, cudaMemcpyHostToDevice, s);\n"
    "  cudaMemcpyToSymbolAsync(g_x, &x, sizeof(void*), 0, cudaMemcpyHostToDevice, s);\n"
    "  cudaMemcpyToSymbolAsync(g_absmax, &absmax, sizeof(void*), 0, cudaMemcpyHostToDevice, s);\n"
    "  cudaMemcpyToSymbolAsync(g_qmax, &qmax, sizeof(float), 0, cudaMemcpyHostToDevice, s);\n"
    "  const bool vec = d % 16 == 0 && aligned16(x) && aligned16(out) && aligned16(codes);\n")
_K3_PARTIAL = (
    "        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the small terms first\n"
    "        mma16816(p, a[mi][2], b);\n"
    "        mma16816(p, a[mi][1], b);\n"
    "        mma16816(p, a[mi][0], b);\n"
    "#pragma unroll\n"
    "        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = __fadd_rn(acc[mi][nt][e], p[e]);\n")
K3_VARIANTS = {
    "base": [],
    # W' formed from W and the scales in each stage, no pre-pass
    "staging": [_K3_GLOBALS, _K3_SET, (
        "  for (int e = threadIdx.x; e < CM_FRAGS; e += CM_THREADS) cp16(a_s + e, src + e, true);",
        "  (void)src;\n  {\n    uint4 f[3];\n    const int ml = threadIdx.x / 32, ln = threadIdx.x % 32;\n"
        "    operand_frag(g_w, g_absmax, n, bm * CM_MT + ml, ks, ln, g_qmax, f);\n"
        "    for (int term = 0; term < 3; ++term) a_s[ml * 96 + term * 32 + ln] = f[term];\n  }"), (
        "  code_mix_operand_kernel<<<(unsigned)((frags + 255) / 256), 256, 0, s>>>(\n"
        "      (const float*)w, (const float*)absmax, (uint4*)frag, n, mt_n, ks_n, qmax);\n",
        "  (void)frags;\n")],
    # the codes re-quantised from x (stateless form) in every row tile's staging
    "requant": [_K3_GLOBALS, _K3_SET, (
        "      cp16(b_s + r * CM_LDB + 16 * q, in ? codes + (int64_t)(j0 + r) * d + c : codes, in);",
        "      const float s = in ? row_scale(g_absmax, j0 + r, g_qmax) : 1.0f;\n"
        "      for (int k = 0; k < 16; ++k)\n"
        "        b_s[r * CM_LDB + 16 * q + k] = in ? (uint8_t)(int)quant_code(\n"
        "            g_x[(int64_t)(j0 + r) * d + c + k], s, g_qmax, false, 0.0f) : 0;")],
    "stages2": [("constexpr int CM_STAGES = 3;", "constexpr int CM_STAGES = 2;")],
    "minblocks2": [("__global__ void __launch_bounds__(CM_THREADS)\ncode_mix_kernel",
                    "__global__ void __launch_bounds__(CM_THREADS, 2)\ncode_mix_kernel")],
    "cvt": [(
        "          bf16_pair(code_at(bw[0][nt >> 2], nt & 3), code_at(bw[1][nt >> 2], nt & 3)),\n"
        "          bf16_pair(code_at(bw[2][nt >> 2], nt & 3), code_at(bw[3][nt >> 2], nt & 3))};",
        "          cvt_pair(bw[0][nt >> 2], bw[1][nt >> 2], nt & 3),\n"
        "          cvt_pair(bw[2][nt >> 2], bw[3][nt >> 2], nt & 3)};"), (
        "// W'^T in mma m16n8k16 A-fragment order.",
        "__device__ __forceinline__ uint32_t cvt_pair(uint32_t a, uint32_t b, int k) {\n"
        "  const __nv_bfloat162 h = __floats2bfloat162_rn(\n"
        "      (float)(int8_t)((a ^ SIGN_BITS) >> (8 * k)), (float)(int8_t)((b ^ SIGN_BITS) >> (8 * k)));\n"
        "  return *reinterpret_cast<const uint32_t*>(&h);\n}\n\n"
        "// W'^T in mma m16n8k16 A-fragment order.")],
    # accuracy: the three products straight into the running sum, or two
    # fresh partials a k-step (W''s leading term apart from the small ones)
    "no_partials": [(_K3_PARTIAL,
                     "        mma16816(acc[mi][nt], a[mi][2], b);\n"
                     "        mma16816(acc[mi][nt], a[mi][1], b);\n"
                     "        mma16816(acc[mi][nt], a[mi][0], b);\n")],
    "two_partials": [(_K3_PARTIAL,
                      "        float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
                      "        mma16816(lo, a[mi][2], b);\n"
                      "        mma16816(lo, a[mi][1], b);\n"
                      "        mma16816(hi, a[mi][0], b);\n"
                      "#pragma unroll\n"
                      "        for (int e = 0; e < 4; ++e)\n"
                      "          acc[mi][nt][e] = __fadd_rn(acc[mi][nt][e], __fadd_rn(hi[e], lo[e]));\n")],
}
K3_ACCURACY_ONLY = ("no_partials", "two_partials")
# the codes pass (quantize.cu): 16 elements a thread per step (a 16-byte
# store of codes), and the grid's cap at 32 blocks an SM or none
CODES_VARIANTS = {
    "base": [],
    "codes_vec16": [("constexpr int CODES_VEC = 8;", "constexpr int CODES_VEC = 16;")],
    "codes_grid32": [("constexpr int CODES_BLOCKS = 132 * 16;",
                      "constexpr int CODES_BLOCKS = 132 * 32;")],
    "codes_nocap": [("constexpr int CODES_BLOCKS = 132 * 16;",
                     "constexpr int CODES_BLOCKS = 1 << 30;")],
}
WIDTHS = (25088, 320, 32, 10)
REPS = 3  # repetitions of every variant, in turn


def build_variants(source, variants, entry, tag):
    src = open(os.path.join(CSRC, source)).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{source} variant {name}: {old!r} is not in the source any more")
            text = text.replace(old, new)
        stem = f"{tag}_{name}"
        cu = os.path.join(OUT, f"{stem}.cu")
        open(cu, "w").write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", CSRC, "-o",
               os.path.join(OUT, f"lib{stem}.so"), cu]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {stem}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{stem}.so"))
        module = source.split(".")[0]
        for fn_name in entry:
            fn = getattr(lib, fn_name)
            fn.argtypes = build.SIGNATURES[module][fn_name]
            fn.restype = build.RESTYPES.get(fn_name, ctypes.c_int)
        libs[name] = lib
    return libs


def device_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def checked(err):
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def k5_ablation(gen, dev, stream):
    libs = build_variants("sparse_mix.cu", K5_VARIANTS, ["launch_sparse_code_mix_csr"], "k5")
    topo = make_sparse_topology("random_regular", 10000)
    csr = (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
           torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))
    n = topo.n_agents
    res = {name: {} for name in libs}
    passes = {}
    for d in WIDTHS:
        x = torch.randn(n, d, generator=gen, device=dev)
        r = 0.01 * torch.randn(n, d, generator=gen, device=dev)
        noise = torch.rand(n, d, generator=gen, device=dev)
        am, am0 = ops.row_absmax(x, r), ops.row_absmax(x)
        codes, _ = ops.quant_codes(x, am, bits=8, residual=r, noise=noise)
        codes0, _ = ops.quant_codes(x, am0, bits=8)
        out = torch.empty_like(x)
        if d == WIDTHS[0]:
            passes.update(
                codes_ef=device_ms(lambda: ops.quant_codes(x, am, bits=8, residual=r, noise=noise)),
                codes_stateless=device_ms(lambda: ops.quant_codes(x, am0, bits=8)),
            )

        def call(lib, c, a):
            checked(lib.launch_sparse_code_mix_csr(
                x.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in csr), a.data_ptr(),
                out.data_ptr(), n, d, 127.0, 1.0, 0, stream))

        for name, lib in libs.items():  # every variant computes the same output
            stateless = name in ONE_PASS
            c, a = (codes0, am0) if stateless else (codes, am)
            call(lib, c, a)
            torch.cuda.synchronize()
            want = ref.sparse_code_mix_csr_ref(x, c, *csr, a, 8)
            if float((out - want).abs().max()) > MIX_TOL * (1.0 + float(x.abs().max())):
                raise SystemExit(f"K5 variant {name} disagrees with the plain version at d = {d}")
        for _ in range(REPS):
            for name, lib in libs.items():
                c, a = (codes0, am0) if name in ONE_PASS else (codes, am)
                res[name].setdefault(f"d{d}", []).append(device_ms(lambda: call(lib, c, a)))
        del x, r, noise, codes, codes0, out
        torch.cuda.empty_cache()
    return {"passes": passes, "gather_device_ms": res}


def k3_ablation(gen, dev, stream):
    libs = build_variants("quantize.cu", K3_VARIANTS,
                          ["launch_compressed_mix", "compressed_mix_frag_bytes"], "k3")
    n, d = 512, 25088
    w = torch.as_tensor(make_topology("erdos_renyi", n, prob=0.3, seed=7).w,
                        dtype=torch.float32, device=dev)
    x = torch.randn(n, d, generator=gen, device=dev)
    r = 0.01 * torch.randn(n, d, generator=gen, device=dev)
    noise = torch.rand(n, d, generator=gen, device=dev)
    am = ops.row_absmax(x, r)
    # the stateless deterministic codes of x: what the requant variant makes
    am0 = ops.row_absmax(x)
    codes, _ = ops.quant_codes(x, am0, bits=8)
    q = codes.float() * (am0.clamp_min(1e-12) / torch.full_like(am0, 127.0))[:, None]
    exact = w.double().T @ q.double() - q.double()
    lib_err = (w.T @ q - q) - exact
    frag = torch.empty(libs["base"].compressed_mix_frag_bytes(n), dtype=torch.uint8, device=dev)
    zero = torch.zeros_like(x)
    out = torch.empty_like(x)

    def call(lib, xin):
        checked(lib.launch_compressed_mix(
            xin.data_ptr(), codes.data_ptr(), w.data_ptr(), am0.data_ptr(), frag.data_ptr(),
            out.data_ptr(), n, d, 127.0, 1.0, 0, stream))

    errors = {"cublas": dict(max=float(lib_err.abs().max()), mean=float(lib_err.abs().mean()))}
    for name, lib in libs.items():
        call(lib, zero if name != "requant" else x)
        torch.cuda.synchronize()
        if name == "requant":  # x feeds the staging, so compare the full output
            e = out.double() - (x.double() + exact)
        else:
            e = out.double() - exact
        errors[name] = dict(max=float(e.abs().max()), mean=float(e.abs().mean()))
        if name not in K3_ACCURACY_ONLY and name != "requant" and (
                errors[name]["max"] > K3_F64_ERR_RATIO * errors["cublas"]["max"]):
            raise SystemExit(f"K3 variant {name}: {errors[name]} against f64, cuBLAS "
                             f"{errors['cublas']}")
        if name == "requant":
            call(libs["base"], x)
            torch.cuda.synchronize()
            want = out.clone()
            call(lib, x)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit("K3 variant requant differs from the codes it re-quantises")
    res = {name: [] for name in libs}
    for _ in range(REPS):
        for name, lib in libs.items():
            res[name].append(device_ms(lambda: call(lib, x)))
    passes = dict(
        codes_ef=device_ms(lambda: ops.quant_codes(x, am, bits=8, residual=r, noise=noise)),
        codes_stateless=device_ms(lambda: ops.quant_codes(x, am0, bits=8)),
    )
    return {"passes": passes, "contraction_device_ms": res, "f64_err": errors}


def codes_ablation(gen, dev, stream):
    libs = build_variants("quantize.cu", CODES_VARIANTS, ["launch_quant_codes"], "codes")
    res = {name: {} for name in libs}
    for label, n, d in (("k5_w1", 10000, 25088), ("k3_w1", 512, 25088)):
        x = torch.randn(n, d, generator=gen, device=dev)
        r = 0.01 * torch.randn(n, d, generator=gen, device=dev)
        noise = torch.rand(n, d, generator=gen, device=dev)
        am, am0 = ops.row_absmax(x, r), ops.row_absmax(x)
        codes = torch.empty(n, d, dtype=torch.int8, device=dev)
        r_out = torch.empty_like(x)
        forms = {"ef": (r, noise, r_out, am), "stateless": (None, None, None, am0)}

        def call(lib, form):
            rr, nn, ro, a = forms[form]
            checked(lib.launch_quant_codes(
                x.data_ptr(), None if rr is None else rr.data_ptr(), a.data_ptr(),
                None if nn is None else nn.data_ptr(), codes.data_ptr(),
                None if ro is None else ro.data_ptr(), n, d, 127.0, stream))

        for name, lib in libs.items():
            for form, (rr, nn, _, a) in forms.items():
                call(lib, form)
                torch.cuda.synchronize()
                want, want_r = ref.quant_codes_ref(x, rr, a, 8, nn)
                if not torch.equal(codes, want) or (
                        rr is not None and not torch.equal(r_out, want_r)):
                    raise SystemExit(f"codes variant {name} ({form}) differs from its plain "
                                     "version")
        for _ in range(REPS):
            for name, lib in libs.items():
                for form in forms:
                    res[name].setdefault(f"{label}_{form}", []).append(
                        device_ms(lambda: call(lib, form)))
        del x, r, noise, codes, r_out
        torch.cuda.empty_cache()
    return res


def main():
    if not torch.cuda.is_available():
        print("k3_k5_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    k3 = k3_ablation(gen, dev, stream)
    print(json.dumps({"k3": k3}), flush=True)
    codes = codes_ablation(gen, dev, stream)
    print(json.dumps({"codes_device_ms": codes}), flush=True)
    k5 = k5_ablation(gen, dev, stream)
    print(card)
    print(json.dumps({"card": card, "k3": k3, "codes_device_ms": codes, "k5": k5}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
