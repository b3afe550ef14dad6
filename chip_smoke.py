#!/usr/bin/env python3
"""GPU check of the PyTorch port (``src/repro_torch``): run from the repo root,

    python3 chip_smoke.py

on a machine with one NVIDIA H100 and the CUDA toolkit.  It

1. builds the hand-written Hopper kernels from ``src/repro_torch/kernels/csrc``
   (K1-K9 and the codes pass that K3 and K5 run first; one ``nvcc`` per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at ragged shapes, and times kernel,
   plain version and (where one PyTorch call computes the same function) the
   library call, beside the least time the card could take (``bound_ms``);
3. drives the main paths through ``Experiment.run`` — PISCO on the paper's
   logreg fleet ("paper"), a 512-agent MLP fleet with int8 compressed gossip
   ("dense-q8"), a 10,000-agent MLP fleet on sparse gossip ("sparse-10k")
   and the same fleet with stochastic int8 compressed gossip and error
   feedback ("sparse-10k-q8"); the paper's six baselines on the paper's fleet
   ("baselines-paper"); and DSGT on the 10,000-agent fleet with int8
   compressed gossip ("dsgt-sparse-10k-q8d") — with every launch counter
   zeroed just before each run and read just after, and checks each against
   the same spec run on the CPU (the 10,000-agent paths at 1,024 agents);
   then the paper's figures through ``repro_torch.figures`` ("figures"): Fig.
   4's p = 0 and p = 0.1 cells at full size (600 rounds, an eval every
   round) and the compression sweep's top-k cell, card against CPU with
   their (rounds, a2a, a2s) readouts; its int8 cell (K2, the codes pass, K3)
   with the bytes held to the byte model; the paper spec's 3-seed
   ``Experiment.sweep``, seed 0 bit-equal to ``run()``; and the sparse-fleet
   scaling (K4, 64 to 10,000 agents at d = 256, dense/sparse parity at 64);
   then dynamic networks and update rules ("dynamic"): sparse-10k under
   Bernoulli(0.3) link failures with half participation (K4 over each
   round's CSR weights), sparse-10k-q8 over neighbour-sampled cohorts (K5
   the same), dense-q8 over random matchings with half participation (K3
   over a new W_k every round), the paper spec over the static process
   (bit-equal to the paper path), fig_dynamic's ring cell and
   fig_optimizers' Adam + FedAdam cell card against CPU, and the paper spec
   with optimizer="sgd" (bit-equal to the inline path); each with its host
   time of the per-block draws; then simulated systems costs and
   asynchronous execution ("async"): sparse-10k and sparse-10k-q8 on the
   event clock under lognormal stragglers (K4 and K5 over the engine's CSR
   weights, the staleness-weighted server mean), their simulated time
   against the barrier's and their trace repriced, dense-q8 under
   wan-gossip (K3 over the engine's W_k), the paper spec under the free and
   uniform fleets bit-equal to the scan driver, and fig_async's straggler
   cell and fig_timecost's tuner at full size, card against CPU; each with
   its engine's host seconds and the share of its block draws;
4. serves the two decoder-only models that fit the card at full width, in
   bf16, through ``FleetDelta.synthetic`` -> ``DecodeEngine`` ->
   ``ContinuousBatcher`` -> ``run_load``: Qwen3-8B ("serve-qwen3-8b": flash
   attention, K6, 36 launches per admitted request, all on the tensor cores,
   with their share of a traced prefill's device time; its prefill logits
   held against the plain versions on the card) and Mamba2-370m
   ("serve-mamba2-370m": the SSD scan, K7, 48 launches per request; admit,
   step and dense-fleet token streams bit-identical), then both models at
   their reduced widths on the card and on the CPU ("serve-reduced");
5. trains across four ranks (spawned processes, one PISCO agent each, all on
   the one card and joined by gloo through pinned host memory, since NCCL
   refuses two ranks on one device): Mamba2-370m at full width in bf16 on a
   ring ("collective-mamba2-370m": a gossip round through the fused
   candidate combine K8, a server round, then an int8 compressed gossip
   round through K2's one-row form and K9), held to invariants (x
   bit-equal on every rank after the server round, the ring's mean of x, y
   and an eta_c = 0.7 candidate, Lemma 1, finite losses); and the reduced
   model over a ring, a ring with deterministic int8 gossip, a 2 x 2 torus,
   the hierarchical mixer and a dense Erdos-Renyi W, on the card against the
   same ranks on the CPU, and over a ring with stochastic int8 gossip (noise
   drawn on each device) held to its invariants on both ("collective-reduced");
6. prints the card's name and power limit, one JSON line of per-kernel
   results, and as its last line ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line.  Without CUDA, or outside a checkout of the repository, it exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Peak rates of one H100 SXM (NVIDIA data sheet; dense, at the 700 W limit):
# device memory and float32 arithmetic outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate

# (name, CUDA source, the Pallas call it replaces)
KERNELS = (
    ("fused_local_step", "src/repro_torch/kernels/csrc/gt_update.cu",
     "src/repro/kernels/gt_update.py:85"),
    ("row_absmax", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:86"),
    ("compressed_mix", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:145"),
    ("sparse_mix", "src/repro_torch/kernels/csrc/sparse_mix.cu",
     "src/repro/kernels/sparse_mix.py:144"),
    ("sparse_compressed_mix", "src/repro_torch/kernels/csrc/sparse_mix.cu",
     "src/repro/kernels/sparse_mix.py:188"),
    # the first pass of K3 and K5: the quantiser inside both Pallas calls
    ("quant_codes", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:145"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:117"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:106"),
    ("fused_mix_combine", "src/repro_torch/kernels/csrc/gt_update.cu",
     "src/repro/kernels/gt_update.py:112"),
    ("rowwise_quant_dequant", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:111"),
)

# Tolerances of the on-card kernel checks.  K1 and K2 compute the same
# roundings as their plain versions and must match exactly, as must the
# codes pass and the quantizer grid of K3 and K5 (checked through the
# residual r' = m - q).
# K3's W^T q and the neighbour sums of K4 and K5 add in another order than
# cuBLAS / index_add_ (whose atomics have no fixed order):
# max |err| <= TOL * (1 + max |input|).
MIX_TOL = 2e-5
# K6 against its plain version (the ROADMAP's): f32 2e-6 absolute (online
# against one-pass softmax); bf16 2e-2 absolute (the output rounds to bf16).
# K7 (the ROADMAP's 5e-4, scaled by 1 + max |plain|): f32 y and the f32
# state within 5e-4; bf16 y within one bf16 ulp (2^-8) of the same scale.
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# K6's bf16 (tensor-core) path against the plain version that rounds P to
# bf16 as the kernel does (ref.flash_attention_ref(p_dtype=bfloat16)): one
# bf16 ulp of the plain value (the two outputs may round apart) plus
# FLASH_P_ATOL (the kernel rounds each p against its running max, the plain
# version against the final one); tighter than 2e-2 wherever |out| < 4.
FLASH_P_ATOL = 2.0 ** -8
SSD_TOL = {"float32": 5e-4, "bfloat16": 2.0 ** -8}
# serve-qwen3-8b: last-position prefill logits through K6 against the plain
# versions, both on the card, in bf16 through 36 layers: within 5e-2 of
# 1 + max |logit| (a few bf16 ulps; attention outputs may round one ulp
# apart and that carries through the residual stream)
PREFILL_LOGIT_TOL = 5e-2
# K3's contraction on the tensor cores against an f64 contraction of the
# same q: its max |err| at most this many times cuBLAS's f32 w.T @ q's
K3_F64_ERR_RATIO = 4.0

# Path sizes: the paper's quickstart fleet, the largest dense fleet (n = 512,
# topology.SPARSE_AUTO_MIN_AGENTS) and the documented large-fleet deployment
# (10^4 agents, 16 samples each); "compare" is the fleet size of the
# sparse GPU-vs-CPU checks.
SIZES = dict(paper_samples=32560, paper_rounds=100, dense_agents=512, dense_rounds=20,
             sparse_agents=10000, sparse_rounds=20, compare_agents=1024, dsgt_rounds=10)

# The paper's baselines (Figs. 4-7, Table 2), run on the paper's fleet.
BASELINES = ("dsgd", "gossip_pga", "dsgt", "periodical_gt", "fedavg", "scaffold")
SERVER_BASED = ("fedavg", "scaffold")

# GPU-vs-CPU agreement of whole runs (float32, different summation orders):
# per-round losses within this relative deviation; flags and bytes equal.
# Deterministic rounding (q8d) may flip at ties, hence the looser limit.
PATH_LOSS_RTOL = {"paper": 1e-4, "dense-q8d": 1e-3, "sparse-1024": 1e-4,
                  "sparse-1024-q8d": 1e-3, "baselines-paper": 1e-4, "paper-static-process": 1e-4,
                  "sparse-1024-bern": 1e-4, "sparse-1024-q8d-cohort": 1e-3,
                  "dense-q8d-matching": 1e-3, "sparse-1024-momentum": 1e-4,
                  "sparse-1024-async": 1e-4, "sparse-1024-q8d-async": 1e-3,
                  "dense-q8d-async": 1e-3, "fig-async-full": 1e-4, "fig-timecost-cell": 1e-4}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events around
    the run, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls: the
    time of the kernels, copies and fills it launched, from a
    ``torch.profiler`` trace (CUDA activity only).  Host launch costs are
    left out: at small shapes a wrapper's host time exceeds its kernel's,
    and ``time_ms`` then measures the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def queued_ms(torch, fn, iters: int = 100) -> float:
    """Mean device milliseconds per call of ``fn``: CUDA events around
    ``iters`` calls queued behind a ~20 ms sleep kernel, so the host has
    enqueued them all before the device reaches the first and the events
    time the kernels back to back, not the host's dispatch."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def l2_read_rate(torch, gen, dev) -> float:
    """Bytes per second of a streaming read from L2: ``torch.mv`` over an
    8 MiB and a 24 MiB float32 matrix (each stays in the 50 MB L2 from call
    to call), the 16 MiB between them over the difference of their device
    times, so the fixed cost of a launch cancels."""
    v = torch.randn(1024, generator=gen, device=dev)
    t = {}
    for mib in (8, 24):
        a = torch.randn(mib * 256, 1024, generator=gen, device=dev)
        t[mib] = queued_ms(torch, lambda: torch.mv(a, v))
        del a
    check(t[24] > t[8], f"L2 probe: torch.mv took {t} ms at 8 and 24 MiB")
    return 16 * 2**20 / (1e-3 * (t[24] - t[8]))


def flash_p_tol(torch, model):
    """Elementwise limit of |K6 - plain(p_dtype=bf16)| at the plain values:
    one bf16 ulp of each (2^(e - 7) for |x| in [2^e, 2^(e+1))) + FLASH_P_ATOL."""
    ulp = torch.exp2(torch.floor(torch.log2(model.abs().clamp_min(2.0 ** -126))) - 7)
    return ulp + FLASH_P_ATOL


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version on the card
# ---------------------------------------------------------------------------


def kernel_checks(torch, dev):
    from repro_torch.core.topology import make_sparse_topology, make_topology
    from repro_torch.kernels import ops, ref

    timer = lambda fn, iters=10: time_ms(torch, fn, iters)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    rows = {}

    # K1 — every leaf shape of the MLP fleets and the logreg fleet, ragged
    # bf16; timed at the largest leaf of sparse-10k (w1: 10,000 x 32 x 784)
    shapes = [((10000, 32, 784), torch.float32), ((10000, 32), torch.float32),
              ((10000, 10, 32), torch.float32), ((10000, 10), torch.float32),
              ((512, 32, 784), torch.float32), ((10, 124), torch.float32),
              ((7, 3, 5), torch.bfloat16), ((1,), torch.float32)]
    err = 0.0
    for shape, dt in shapes:
        x, y, gn, go = (randn(*shape).to(dt) for _ in range(4))
        for fn, rf in ((ops.fused_track_step, ref.fused_track_step_ref),
                       (ops.fused_local_step, ref.fused_local_step_ref)):
            got, want = fn(x, y, gn, go, 0.1), rf(x, y, gn, go, 0.1)
            e = max(max_err(a, b) for a, b in zip(got, want))
            check(e == 0.0, f"K1 {fn.__name__} {shape} {dt}: max |err| {e} (must be exact)")
            err = max(err, e)
    x, y, gn, go = (randn(10000, 32, 784) for _ in range(4))
    n = x.numel()
    b_ms, b_by = bound_ms(6 * 4 * n, 3 * n)
    rows["fused_local_step"] = dict(
        shape=list(x.shape), max_abs_err=err,
        ms=timer(lambda: ops.fused_track_step(x, y, gn, go, 0.1)),
        plain_ms=timer(lambda: ref.fused_track_step_ref(x, y, gn, go, 0.1)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    del x, y, gn, go

    # K2 + K3 (the codes pass, then the contraction on the tensor cores) —
    # dense-q8's w1 leaf (512 agents x 25,088) with residual and noise
    # (stochastic int8 + error feedback), plus ragged and int4/gamma cases
    w512 = torch.as_tensor(
        make_topology("erdos_renyi", 512, prob=0.3, seed=7).w, dtype=torch.float32, device=dev
    )
    def codes_check(x, r, am, bits, noise, label):
        """The codes pass against its plain version: codes and r' exact."""
        codes, r_c = ops.quant_codes(x, am, bits=bits, residual=r, noise=noise)
        codes_p, r_c_p = ref.quant_codes_ref(x, r, am, bits, noise)
        e = max_err(codes, codes_p)
        if r is not None:
            e = max(e, max_err(r_c, r_c_p))
        check(e == 0.0 and (r_c is None) == (r is None),
              f"quant_codes {label} q{bits}: max |err| {e} (must be exact)")
        return e

    err2 = err3 = err_codes = 0.0
    # the figures' compression sweep runs K3 at (10, 124) over the ring of 10,
    # int8 and int4, with residual and noise
    w10 = torch.as_tensor(make_topology("ring", 10).w, dtype=torch.float32, device=dev)
    cases = [(512, 25088, 8, 1.0, True, True), (512, 32, 8, 1.0, True, True),
             (512, 320, 4, 0.5, True, False), (512, 10, 8, 1.0, False, False),
             (37, 1000, 4, 0.5, True, True), (3, 5, 8, 1.0, False, True),
             (10, 124, 8, 1.0, True, True), (10, 124, 4, 1.0, True, True)]
    for n_rows, d, bits, gamma, with_res, with_noise in cases:
        x = randn(n_rows, d)
        r = 0.01 * randn(n_rows, d) if with_res else None
        noise = torch.rand(n_rows, d, generator=gen, device=dev) if with_noise else None
        w = {512: w512, 10: w10}.get(n_rows)
        if w is None:
            w = torch.softmax(randn(n_rows, n_rows), dim=0)
        am = ops.row_absmax(x, r)
        e2 = max_err(am, ref.row_absmax_ref(x, r))
        check(e2 == 0.0, f"K2 ({n_rows}, {d}): max |err| {e2} (must be exact)")
        err_codes = max(err_codes, codes_check(x, r, am, bits, noise, f"K3 ({n_rows}, {d})"))
        out, r_new = ops.compressed_mix(x, r, w, am, bits=bits, gamma=gamma, noise=noise)
        out_p, r_new_p = ref.compressed_mix_ref(x, r, w, am, bits, gamma, noise)
        if with_res:
            e = max_err(r_new, r_new_p)
            check(e == 0.0, f"K3 q grid ({n_rows}, {d}, q{bits}): residual max |err| {e}")
        e3 = max_err(out, out_p)
        check(e3 <= MIX_TOL * (1.0 + float(x.abs().max())),
              f"K3 ({n_rows}, {d}, q{bits}, gamma={gamma}): max |err| {e3}")
        err2, err3 = max(err2, e2), max(err3, e3)
    x, r = randn(512, 25088), 0.01 * randn(512, 25088)
    noise = torch.rand(512, 25088, generator=gen, device=dev)
    m = x + r
    am = ops.row_absmax(x, r)
    check(torch.equal(ops.row_absmax(m), torch.linalg.vector_norm(m, ord=float("inf"), dim=1)),
          "K2 without the residual differs from vector_norm(ord=inf)")
    nd = x.numel()
    b_ms, b_by = bound_ms(2 * 4 * nd + 4 * 512, 2 * nd)
    rows["row_absmax"] = dict(
        shape=[512, 25088], max_abs_err=err2,
        ms=timer(lambda: ops.row_absmax(x, r), iters=50),
        plain_ms=timer(lambda: ref.row_absmax_ref(x, r), iters=50),
        # the fair pair: K2's no-residual form and vector_norm over one m
        # (the same function, the same bytes); ms and bound_ms above are the
        # form the path runs, which also reads the residual
        library_ms=timer(lambda: torch.linalg.vector_norm(m, ord=float("inf"), dim=1), iters=50),
        no_residual_ms=timer(lambda: ops.row_absmax(m), iters=50),
        no_residual_bound_ms=bound_ms(4 * nd + 4 * 512, nd)[0],
        # the pair's device time (profiler): at ~0.02 ms a call the event
        # times above can be the host's dispatch, not the kernels'
        no_residual_device_ms=device_ms(torch, lambda: ops.row_absmax(m), iters=50),
        library_device_ms=device_ms(
            torch, lambda: torch.linalg.vector_norm(m, ord=float("inf"), dim=1), iters=50),
        bound_ms=b_ms, bound_by=b_by,
    )
    # K3's contraction alone (x = 0: out = W'^T c - q) against an f64
    # contraction of the same q, beside cuBLAS's f32 w.T @ q - q
    codes, _ = ops.quant_codes(x, am, bits=8, residual=r, noise=noise)
    q = codes.float() * (am.clamp_min(1e-12) / torch.full_like(am, 127.0))[:, None]
    exact = w512.double().T @ q.double() - q.double()
    tc = ops.code_mix(torch.zeros_like(x), codes, w512, am, bits=8) - exact
    lib = (w512.T @ q - q) - exact
    k3_f64 = dict(max=float(tc.abs().max()), mean=float(tc.abs().mean()),
                  cublas_max=float(lib.abs().max()), cublas_mean=float(lib.abs().mean()))
    log(f"K3 check: W'^T c - q against f64 at (512, 25088): max |err| {k3_f64['max']:.3e} "
        f"(mean {k3_f64['mean']:.3e}), cuBLAS f32 w.T @ q - q {k3_f64['cublas_max']:.3e} "
        f"(mean {k3_f64['cublas_mean']:.3e}); limit {K3_F64_ERR_RATIO}x cuBLAS's max")
    check(k3_f64["max"] <= K3_F64_ERR_RATIO * k3_f64["cublas_max"],
          f"K3 against f64: {k3_f64} beyond {K3_F64_ERR_RATIO}x cuBLAS's")
    del q, exact, tc, lib
    # bound: x, r, noise, W read and out, r' written once (the tensor cores'
    # 3 x 2 n^2 d bf16 flops take half as long); the f32-FMA floor of one
    # contraction beside it, and the two passes' bytes (the codes pass reads
    # x, r, noise and writes codes and r'; the contraction reads the codes,
    # x and W, writes and reads W' in fragment order, writes out)
    b_ms, b_by = bound_ms(5 * 4 * nd + 4 * 512 * 512 + 4 * 512, 3 * 2 * 512 * nd,
                          BF16_FLOP_PER_S)
    rows["compressed_mix"] = dict(
        shape=[512, 25088], max_abs_err=err3,
        ms=timer(lambda: ops.compressed_mix(x, r, w512, am, bits=8, noise=noise), iters=20),
        device_ms=device_ms(torch, lambda: ops.compressed_mix(x, r, w512, am, bits=8,
                                                              noise=noise)),
        pass1_device_ms=device_ms(
            torch, lambda: ops.quant_codes(x, am, bits=8, residual=r, noise=noise)),
        pass2_device_ms=device_ms(torch, lambda: ops.code_mix(x, codes, w512, am, bits=8)),
        plain_ms=timer(lambda: ref.compressed_mix_ref(x, r, w512, am, 8, 1.0, noise), iters=20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        f32_fma_bound_ms=bound_ms(0, 2 * 512 * nd)[0],
        two_pass_floor_ms=bound_ms(26 * nd + 16 * 512 * 512 + 4 * 512, 0)[0],
        f64_err=k3_f64,
    )
    del x, r, noise, m, codes

    # K4 — sparse-10k's w1 leaf over the degree-4 expander, plus ragged cases
    def csr_on(topo):
        return (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
                torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
                torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))

    # the 16-byte path (d % 4 == 0, aligned rows) and the 4-byte one: ragged
    # d, and rows whose base sits 4 bytes past a 16-byte boundary
    err4 = 0.0
    for n_ag, d, name, unaligned in ((10000, 25088, "random_regular", False),
                                     (10000, 10, "random_regular", False),
                                     (1024, 320, "random_regular", False),
                                     (1024, 1001, "random_regular", True),
                                     (1024, 1000, "random_regular", True),
                                     (7, 3, "ring", False), (1, 5, "ring", False)):
        topo = make_sparse_topology(name, n_ag)
        csr = csr_on(topo)
        x = randn(n_ag * d + 1)[1:].view(n_ag, d) if unaligned else randn(n_ag, d)
        e4 = max_err(ops.sparse_mix_csr(x, *csr), ref.sparse_mix_csr_ref(x, *csr))
        check(e4 <= MIX_TOL * (1.0 + float(x.abs().max())),
              f"K4 ({n_ag}, {d}, unaligned={unaligned}): max |err| {e4}")
        err4 = max(err4, e4)
        if n_ag == 10000 and d == 25088:
            big, big_csr, big_topo = x, csr, topo
    # a receiver with no in-edges: its output is self_w x alone
    x = randn(3, 9)
    empty = (torch.tensor([0, 0, 2, 3], device=dev), torch.tensor([0, 2, 1], device=dev),
             torch.tensor([0.3, 0.2, 0.5], device=dev), torch.tensor([1.0, 0.5, 0.5], device=dev))
    out = ops.sparse_mix_csr(x, *empty)
    check(torch.equal(out[0], x[0]) and max_err(out, ref.sparse_mix_csr_ref(x, *empty))
          <= MIX_TOL * (1.0 + float(x.abs().max())), "K4: a receiver without in-edges")
    x, csr, topo = big, big_csr, big_topo
    nnz = int(topo.indptr[-1])
    n_ag = n_ag_big = topo.n_agents
    d_big = x.shape[1]
    diag = torch.arange(n_ag, device=dev)
    rows_idx = torch.repeat_interleave(diag, csr[0][1:] - csr[0][:-1])
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore", UserWarning)
        w_csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat([rows_idx, diag]), torch.cat([csr[1], diag])]),
            torch.cat([csr[2], csr[3]]), (n_ag, n_ag), check_invariants=True,
        ).coalesce().to_sparse_csr()
    e_lib = max_err(torch.sparse.mm(w_csr, x), ref.sparse_mix_csr_ref(x, *csr))
    check(e_lib <= MIX_TOL * (1.0 + float(x.abs().max())), f"torch.sparse.mm disagrees: {e_lib}")
    b_ms, b_by = bound_ms(2 * 4 * x.numel() + 8 * (n_ag + 1) + 12 * nnz + 4 * n_ag,
                          2 * (nnz + n_ag) * x.shape[1])
    # K4's L2 floor: every gathered row (deg + 1 per output) passes through L2
    l2_rate = l2_read_rate(torch, gen, dev)
    rows["sparse_mix"] = dict(
        shape=[n_ag, x.shape[1]], max_abs_err=err4,
        ms=timer(lambda: ops.sparse_mix_csr(x, *csr)),
        device_ms=device_ms(torch, lambda: ops.sparse_mix_csr(x, *csr)),
        plain_ms=timer(lambda: ref.sparse_mix_csr_ref(x, *csr), iters=5),
        library_ms=timer(lambda: torch.sparse.mm(w_csr, x)),
        library_device_ms=device_ms(torch, lambda: torch.sparse.mm(w_csr, x)),
        bound_ms=b_ms, bound_by=b_by, l2_read_tb_s=l2_rate / 1e12,
        l2_floor_ms=1e3 * 4 * (nnz + n_ag) * x.shape[1] / l2_rate,
    )
    del x, big, w_csr
    torch.cuda.empty_cache()

    # K5 — sparse-10k's w1 leaf over the same expander in the error-feedback
    # form (residual and noise: what sparse-10k-q8 runs) and the stateless
    # form (the Pallas kernel's function: what the gossip baselines run under
    # q8d), plus ragged cases with int4 and gamma = 0.5
    err5 = 0.0
    for n_ag, d, bits, gamma, ef in ((10000, 25088, 8, 1.0, True), (10000, 25088, 8, 1.0, False),
                                     (1024, 320, 4, 0.5, True), (1024, 10, 8, 1.0, False),
                                     (7, 10, 4, 0.5, True), (7, 5, 8, 1.0, False),
                                     (1, 5, 4, 0.5, True)):
        c = csr if n_ag == n_ag_big else csr_on(
            make_sparse_topology("random_regular" if n_ag > 7 else "ring", n_ag))
        x = randn(n_ag, d)
        r = 0.01 * randn(n_ag, d) if ef else None
        noise = torch.rand(n_ag, d, generator=gen, device=dev) if ef else None
        am = ops.row_absmax(x, r)
        err_codes = max(err_codes, codes_check(x, r, am, bits, noise, f"K5 ({n_ag}, {d})"))
        out, r_new = ops.sparse_compressed_mix_csr(x, r, *c, am, bits=bits, gamma=gamma,
                                                   noise=noise)
        out_p, r_new_p = ref.sparse_compressed_mix_csr_ref(x, r, *c, am, bits, gamma, noise)
        if ef:
            e = max_err(r_new, r_new_p)
            check(e == 0.0, f"K5 q grid ({n_ag}, {d}, q{bits}): residual max |err| {e}")
        else:
            check(r_new is None and r_new_p is None, "K5 stateless: a residual came back")
        e5 = max_err(out, out_p)
        check(e5 <= MIX_TOL * (1.0 + float(x.abs().max())),
              f"K5 ({n_ag}, {d}, q{bits}, gamma={gamma}, ef={ef}): max |err| {e5}")
        if n_ag <= 1024:  # the plain version on the CPU adds in edge order, as K5 does
            cpu = [None if t is None else t.cpu() for t in (x, r, *c, am, noise)]
            want, _ = ref.sparse_compressed_mix_csr_ref(*cpu[:7], bits, gamma, cpu[7])
            check(torch.equal(out.cpu(), want),
                  f"K5 ({n_ag}, {d}): not bit-equal to the plain version on the CPU")
        err5 = max(err5, e5)
        del x, r, noise, out, r_new, out_p, r_new_p
    torch.cuda.empty_cache()
    # the small leaves of sparse-10k's MLP (b1, w2, b2), EF form: two launches each
    small = {}
    for d in (10, 32, 320):
        x, r = randn(n_ag_big, d), 0.01 * randn(n_ag_big, d)
        noise = torch.rand(n_ag_big, d, generator=gen, device=dev)
        am = ops.row_absmax(x, r)
        small[d] = device_ms(
            torch, lambda: ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, noise=noise))
    x, r = randn(n_ag_big, d_big), 0.01 * randn(n_ag_big, d_big)
    noise = torch.rand(n_ag_big, d_big, generator=gen, device=dev)
    am, am0 = ops.row_absmax(x, r), ops.row_absmax(x)
    nd = x.numel()
    csr_bytes = 8 * (n_ag_big + 1) + 12 * nnz + 4 * n_ag_big
    # one-pass bounds: the EF form reads x, r, noise and writes out, r'; the
    # stateless form reads x and writes out.  Two-pass floors: the codes pass
    # reads x (r, noise) and writes the codes (and r'); the gather reads the
    # codes and x and writes out.
    b_ms, b_by = bound_ms(5 * 4 * nd + csr_bytes + 4 * n_ag_big,
                          2 * (nnz + n_ag_big) * d_big + 10 * nd)
    b0_ms, b0_by = bound_ms(2 * 4 * nd + csr_bytes + 4 * n_ag_big,
                            2 * (nnz + n_ag_big) * d_big + 7 * nd)
    codes, _ = ops.quant_codes(x, am, bits=8, residual=r, noise=noise)
    ef = lambda: ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, noise=noise)  # noqa: E731
    stateless = lambda: ops.sparse_compressed_mix_csr(x, None, *csr, am0, bits=8)  # noqa: E731
    rows["sparse_compressed_mix"] = dict(
        shape=[n_ag_big, d_big], max_abs_err=err5,
        ms=timer(ef), device_ms=device_ms(torch, ef),
        pass1_device_ms=device_ms(
            torch, lambda: ops.quant_codes(x, am, bits=8, residual=r, noise=noise)),
        pass2_device_ms=device_ms(
            torch, lambda: ops.sparse_code_mix_csr(x, codes, *csr, am, bits=8)),
        plain_ms=timer(lambda: ref.sparse_compressed_mix_csr_ref(x, r, *csr, am, 8, 1.0, noise),
                       iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        two_pass_floor_ms=bound_ms(4 * (3 * nd + nd) + nd + nd + 4 * 2 * nd + csr_bytes, 0)[0],
        stateless_ms=timer(stateless), stateless_device_ms=device_ms(torch, stateless),
        stateless_pass1_device_ms=device_ms(torch, lambda: ops.quant_codes(x, am0, bits=8)),
        stateless_plain_ms=timer(
            lambda: ref.sparse_compressed_mix_csr_ref(x, None, *csr, am0, 8), iters=3),
        stateless_bound_ms=b0_ms, stateless_bound_by=b0_by,
        stateless_two_pass_floor_ms=bound_ms(4 * nd + nd + nd + 4 * 2 * nd + csr_bytes, 0)[0],
        small_leaf_device_ms={f"d{d}": v for d, v in small.items()},
        noise_ms=timer(lambda: torch.rand(n_ag_big, d_big, generator=gen, device=dev)),
    )
    # the codes pass alone at the same leaf, EF form (what sparse-10k-q8 runs);
    # its yardstick: torch.quantize_per_channel over the same m (the
    # deterministic, no-residual form: int8 codes of each row on its scale)
    m = x + r
    scale = am.clamp_min(1e-12) / torch.full_like(am, 127.0)
    zero = torch.zeros(n_ag_big, dtype=torch.int64, device=dev)
    warnings.filterwarnings("ignore", message="torch.quantize_per_tensor")  # deprecation notice
    lib_codes = torch.quantize_per_channel(m, scale, zero, 0, torch.qint8).int_repr()
    own_codes, _ = ops.quant_codes(m, am, bits=8)
    rows["quant_codes"] = dict(
        shape=[n_ag_big, d_big], max_abs_err=err_codes,
        ms=timer(lambda: ops.quant_codes(x, am, bits=8, residual=r, noise=noise)),
        device_ms=device_ms(torch, lambda: ops.quant_codes(x, am, bits=8, residual=r,
                                                           noise=noise)),
        plain_ms=timer(lambda: ref.quant_codes_ref(x, r, am, 8, noise), iters=3),
        bound_ms=bound_ms(4 * 4 * nd + nd + 4 * n_ag_big, 5 * nd)[0], bound_by="bytes",
        no_residual_ms=timer(lambda: ops.quant_codes(m, am, bits=8)),
        no_residual_device_ms=device_ms(torch, lambda: ops.quant_codes(m, am, bits=8)),
        no_residual_bound_ms=bound_ms(4 * nd + nd + 4 * n_ag_big, 2 * nd)[0],
        library_ms=timer(
            lambda: torch.quantize_per_channel(m, scale, zero, 0, torch.qint8)),
        library_device_ms=device_ms(
            torch, lambda: torch.quantize_per_channel(m, scale, zero, 0, torch.qint8)),
        # codes that differ: quantize_per_channel multiplies by 1 / s
        library_codes_differ=int((lib_codes != own_codes).sum()),
    )
    del x, r, noise, csr, big_csr, codes, m, lib_codes, own_codes
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"kernel {name}: {json.dumps(row)}")
    return rows


# ---------------------------------------------------------------------------
# Phases 2-4: the main path, on the card and against the CPU
# ---------------------------------------------------------------------------


def run_path(torch, dev, spec, loss_fn, params0, data, batch, eval_fn=None, mixing=None):
    from repro_torch.core import Experiment
    from repro_torch.data import RoundSampler

    resident = data.to(dev)
    return Experiment(
        spec, loss_fn=loss_fn, params0=params0, eval_fn=eval_fn, device=dev, mixing=mixing,
        sampler_factory=lambda s: RoundSampler(
            resident, batch, s.config.t_o, s.config.seed, device=dev
        ),
    ).run()


def drive(torch, dev, label, *args, **kw):
    """One main-path run with every launch counter zeroed just before it and
    read just after."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = run_path(torch, dev, *args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rounds = len(hist.loss)
    log(f"path {label}: {rounds} rounds in {wall:.3f} s "
        f"({1e3 * hist.wall_time_s / rounds:.3f} ms/round in the driver), "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
        f"launches {counts} ({ {k: v / rounds for k, v in counts.items()} } per round)")
    return hist, counts


def profile_rounds(torch, dev, label, spec, loss_fn, params0, data, batch, active=4):
    """Trace ``active`` steady gossip rounds of one path with
    ``torch.profiler`` (block driver, no eval): device busy share over the
    traced window and the device time per round of the heaviest kernels.

    The window is the first run of ``active`` consecutive gossip rounds after
    round 1 in the spec's Bernoulli(p) draw (gossip rounds are 1 - p of
    all).  The profiler's step is advanced by the sampler, which the driver
    calls once per round, after a synchronize — so the idle share includes
    one host sync per round that an untraced block would not make."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import Experiment
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data import RoundSampler

    draw = make_schedule(spec.config.p, spec.config.seed)
    flags = [draw(k) for k in range(256)]
    first = next(k for k in range(2, 256 - active) if not any(flags[k:k + active]))
    resident = data.to(dev)
    # profiler steps: set-up, the init probe sampler(-1), then one per round
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=first + 1, warmup=1, active=active, repeat=1)) as prof:
        def sampler_factory(s):
            inner = RoundSampler(resident, batch, s.config.t_o, s.config.seed, device=dev)

            def sampler(k):
                torch.cuda.synchronize()  # a round's device work ends in its own step
                prof.step()
                return inner(k)

            return sampler

        hist = Experiment(spec.replace(rounds=first + active + 1, eval_every=1),
                          loss_fn=loss_fn, params0=params0,
                          sampler_factory=sampler_factory, device=dev).run()
        torch.cuda.synchronize()
    traced = hist.is_global[first:first + active]
    check(not any(traced), f"profile {label}: a server round in the gossip window")
    window, busy, top = device_share(prof, label)
    log(f"profile {label}: gossip rounds {first}-{first + active - 1}, "
        f"window {window / 1e3 / active:.3f} ms/round, "
        f"device busy {100.0 * busy / window:.1f}% (idle {100.0 - 100.0 * busy / window:.1f}%), "
        f"device time {busy / 1e3 / active:.3f} ms/round")
    for name, us in top[:10]:
        log(f"profile {label}:   {us / 1e3 / active:8.3f} ms/round  {name[:110]}")


def device_share(prof, label):
    """(window µs, device-busy µs, every device op as (name, µs), heaviest
    first) of a finished ``torch.profiler`` trace.  Busy time is the union of the
    intervals of device work — kernels, copies and fills, not the step
    annotations the profiler also puts on the device timeline."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
    dev_iv = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    check(len(dev_iv) > 0, f"profile {label}: the trace holds no device activity")
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in dev_iv:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    per_kernel = {}
    for e in dev_events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return window, busy, sorted(per_kernel.items(), key=lambda kv: -kv[1])


def check_run(torch, label, hist, rounds, n_agents, template, lemma1=True):
    """Losses finite, the final state's shapes and values; Lemma 1 (mean y ==
    mean g) where the server round preserves the mean: not under the events
    driver's staleness-weighted server mean (``lemma1=False``), which moves
    the mean of y in both packages."""
    import numpy as np

    check(len(hist.loss) == rounds and np.all(np.isfinite(hist.loss)), f"{label}: losses")
    st = hist.final_state
    for k, v in template.items():
        check(tuple(st.x[k].shape) == (n_agents,) + tuple(v.shape), f"{label}: shape of {k}")
        check(bool(torch.isfinite(st.x[k]).all()), f"{label}: non-finite {k}")
        if not hasattr(st, "y") or not lemma1:  # no tracking (DSGD family, SCAFFOLD)
            continue
        # Lemma 1: mean_i y_i == mean_i g_i
        dev_l1 = float((st.y[k].mean(0) - st.g[k].mean(0)).abs().max())
        scale = 1.0 + float(st.g[k].abs().max())
        check(dev_l1 <= 1e-4 * scale, f"{label}: Lemma 1 off by {dev_l1} on {k}")
    for m in hist.eval_metrics:
        check(all(np.isfinite(v) for v in m.values()), f"{label}: eval {m}")


def compare_cpu(torch, label, gpu_hist, cpu_hist):
    """Flags and bytes equal, per-round losses within the path's limit
    (looked up by the label up to its first "/")."""
    import dataclasses

    import numpy as np

    limit = PATH_LOSS_RTOL[label.split("/")[0]]
    check(gpu_hist.is_global == cpu_hist.is_global, f"{label}: is_global differs")
    check(dataclasses.asdict(gpu_hist.accountant) == dataclasses.asdict(cpu_hist.accountant),
          f"{label}: accountant bytes differ")
    g, c = np.asarray(gpu_hist.loss), np.asarray(cpu_hist.loss)
    rel = float(np.max(np.abs(g - c) / np.abs(c)))
    log(f"compare {label}: GPU vs CPU max relative loss deviation {rel:.3e} "
        f"(limit {limit}), is_global and bytes equal")
    check(rel <= limit, f"{label}: losses deviate by {rel}")


def main_path(torch, dev):
    import dataclasses

    from repro_torch.core import ExperimentSpec
    from repro_torch.data import FederatedDataset
    from repro_torch.data.synthetic import synthetic_a9a, synthetic_mnist
    from repro_torch.models import simple as models

    cpu = torch.device("cpu")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- paper: the quickstart / Fig-4 configuration -------------------------
    x, y = synthetic_a9a(SIZES["paper_samples"], seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=10)
    spec = ExperimentSpec.create(algo="pisco", n_agents=10, t_o=5, eta_l=0.3, p=0.1,
                                 seed=0, topology="ring", rounds=SIZES["paper_rounds"],
                                 eval_every=10)
    loss = lambda p, b: models.logreg_loss(p, b, rho=0.01)  # noqa: E731
    params0 = models.logreg_init(124)

    def logreg_eval(dev_):
        xt, yt = (torch.as_tensor(a, device=dev_) for a in (data.x_test, data.y_test))
        return lambda p: {"test_acc": float(models.logreg_accuracy(p, xt, yt)),
                          "test_loss": float(loss(p, (xt, yt)))}

    hist, counts = drive(torch, dev, "paper", spec, loss, params0, data, 128, logreg_eval(dev))
    add(counts)
    check_run(torch, "paper", hist, spec.rounds, 10, params0)
    check(counts["fused_local_step"] > 0, "paper: K1 not launched")
    ev = hist.eval_metrics
    log(f"paper: test loss {ev[0]['test_loss']:.6f} -> {ev[-1]['test_loss']:.6f}, "
        f"test acc {ev[-1]['test_acc']:.4f}, server rounds {hist.accountant.agent_to_server}")
    check(ev[-1]["test_loss"] < ev[0]["test_loss"], "paper: test loss did not fall")
    profile_rounds(torch, dev, "paper", spec, loss, params0, data, 128)
    cpu_hist = run_path(torch, cpu, spec, loss, params0, data, 128)
    compare_cpu(torch, "paper", hist, cpu_hist)

    # -- baselines-paper: the paper's six baselines on the same fleet --------
    for algo in BASELINES:
        label = f"baselines-paper/{algo}"
        bspec = spec.replace(algo=algo)
        hist, counts = drive(torch, dev, label, bspec, loss, params0, data, 128, logreg_eval(dev))
        add(counts)
        check_run(torch, label, hist, bspec.rounds, 10, params0)
        ev = hist.eval_metrics
        log(f"{label}: test loss {ev[0]['test_loss']:.6f} -> {ev[-1]['test_loss']:.6f}, "
            f"test acc {ev[-1]['test_acc']:.4f}, server rounds {hist.accountant.agent_to_server}")
        if algo in SERVER_BASED:
            check(all(hist.is_global), f"{label}: a round without the server")
        else:
            check(ev[-1]["test_loss"] < ev[0]["test_loss"], f"{label}: test loss did not fall")
        compare_cpu(torch, label, hist, run_path(torch, cpu, bspec, loss, params0, data, 128))

    # -- dense-q8: the largest dense fleet, MLP, stochastic int8 with EF -----
    n_dense = SIZES["dense_agents"]
    x, y = synthetic_mnist(n_dense * 80, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n_dense)
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_dense, t_o=2, eta_l=0.1, p=0.1, seed=0,
        topology="erdos_renyi", topology_kwargs={"prob": 0.3, "seed": 7}, compression="q8",
        rounds=SIZES["dense_rounds"], eval_every=10,
    )
    mlp0 = models.mlp_init(0)

    def mlp_eval(dev_, d):
        xt, yt = (torch.as_tensor(a, device=dev_) for a in (d.x_test, d.y_test))
        return lambda p: {"test_acc": float(models.mlp_accuracy(p, xt, yt)),
                          "test_loss": float(models.mlp_loss(p, (xt, yt)))}

    hist, counts = drive(torch, dev, "dense-q8", spec, models.mlp_loss, mlp0, data, 16,
                         mlp_eval(dev, data))
    add(counts)
    check_run(torch, "dense-q8", hist, spec.rounds, n_dense, mlp0)
    for k in ("fused_local_step", "row_absmax", "quant_codes", "compressed_mix"):
        check(counts[k] > 0, f"dense-q8: {k} not launched")
    log(f"dense-q8: loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}, "
        f"gossip bytes/round {hist.byte_model.gossip_round_bytes}, "
        f"server bytes/round {hist.byte_model.server_round_bytes}")
    profile_rounds(torch, dev, "dense-q8", spec, models.mlp_loss, mlp0, data, 16)
    short = spec.replace(compression="q8d", rounds=3)
    gpu_h = run_path(torch, dev, short, models.mlp_loss, mlp0, data, 16)
    cpu_h = run_path(torch, cpu, short, models.mlp_loss, mlp0, data, 16)
    compare_cpu(torch, "dense-q8d", gpu_h, cpu_h)

    # -- sparse-10k: 10,000 agents on a degree-4 expander, MLP ---------------
    n_sparse = SIZES["sparse_agents"]
    x, y = synthetic_mnist(n_sparse * 20, seed=0)  # 16 train samples per agent
    data = FederatedDataset.from_arrays(x, y, n_agents=n_sparse)
    check(data.samples_per_agent == 16, "sparse-10k: 16 samples per agent")
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_sparse, t_o=2, eta_l=0.1, p=0.05, seed=0,
        topology="random_regular", topology_kwargs={"degree": 4}, sparse=True,
        rounds=SIZES["sparse_rounds"], eval_every=10,
    )
    hist, counts = drive(torch, dev, "sparse-10k", spec, models.mlp_loss, mlp0, data, 16,
                         mlp_eval(dev, data))
    add(counts)
    check_run(torch, "sparse-10k", hist, spec.rounds, n_sparse, mlp0)
    for k in ("fused_local_step", "sparse_mix"):
        check(counts[k] > 0, f"sparse-10k: {k} not launched")
    log(f"sparse-10k: {1e3 * hist.wall_time_s / spec.rounds:.3f} ms/round, "
        f"loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}")
    profile_rounds(torch, dev, "sparse-10k", spec, models.mlp_loss, mlp0, data, 16)
    del hist

    # -- sparse-10k-q8: the same fleet, stochastic int8 + error feedback -----
    spec_q8 = spec.replace(compression="q8")
    hist, counts = drive(torch, dev, "sparse-10k-q8", spec_q8, models.mlp_loss, mlp0, data, 16,
                         mlp_eval(dev, data))
    add(counts)
    check_run(torch, "sparse-10k-q8", hist, spec_q8.rounds, n_sparse, mlp0)
    for k in ("fused_local_step", "row_absmax", "quant_codes", "sparse_compressed_mix"):
        check(counts[k] > 0, f"sparse-10k-q8: {k} not launched")
    log(f"sparse-10k-q8: {1e3 * hist.wall_time_s / spec_q8.rounds:.3f} ms/round, "
        f"loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}, "
        f"gossip bytes/round {hist.byte_model.gossip_round_bytes}, "
        f"server bytes/round {hist.byte_model.server_round_bytes}")
    profile_rounds(torch, dev, "sparse-10k-q8", spec_q8, models.mlp_loss, mlp0, data, 16)
    del hist

    # -- dsgt-sparse-10k-q8d: DSGT on the same fleet, deterministic int8 -----
    # (the stateless K5: the gossip baselines carry no residuals)
    spec_dsgt = spec.replace(algo="dsgt", compression="q8d", rounds=SIZES["dsgt_rounds"])
    hist, counts = drive(torch, dev, "dsgt-sparse-10k-q8d", spec_dsgt, models.mlp_loss, mlp0,
                         data, 16)
    add(counts)
    check_run(torch, "dsgt-sparse-10k-q8d", hist, spec_dsgt.rounds, n_sparse, mlp0)
    for k in ("row_absmax", "quant_codes", "sparse_compressed_mix"):
        check(counts[k] > 0, f"dsgt-sparse-10k-q8d: {k} not launched")
    log(f"dsgt-sparse-10k-q8d: {1e3 * hist.wall_time_s / spec_dsgt.rounds:.3f} ms/round, "
        f"loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}")
    del hist
    profile_rounds(torch, dev, "dsgt-sparse-10k-q8d", spec_dsgt, models.mlp_loss, mlp0, data, 16)
    del data

    n_cmp = SIZES["compare_agents"]
    x, y = synthetic_mnist(n_cmp * 20, seed=1)
    small = FederatedDataset.from_arrays(x, y, n_agents=n_cmp)
    for label, cspec in (("sparse-1024", spec), ("sparse-1024-q8d", spec_q8.replace(
            compression="q8d"))):
        short = cspec.replace(n_agents=n_cmp, rounds=3, p=0.3)
        gpu_h = run_path(torch, dev, short, models.mlp_loss, mlp0, small, 16)
        cpu_h = run_path(torch, cpu, short, models.mlp_loss, mlp0, small, 16)
        check(dataclasses.asdict(gpu_h.byte_model) == dataclasses.asdict(cpu_h.byte_model),
              f"{label}: byte model differs")
        compare_cpu(torch, label, gpu_h, cpu_h)
    return launches


# ---------------------------------------------------------------------------
# Phase 2b: the paper's figures through repro_torch.figures
# ---------------------------------------------------------------------------

# Card against CPU in the figure paths: the per-eval full-data gradient norm
# within 1e-3 relative (it is read at x̄ after 600 rounds of float32 in two
# summation orders), test accuracy within two test samples.
FIG_GRAD_RTOL = 1e-3
FIG_ACC_SAMPLES = 2
# Top-k gossip with error feedback at full size is chaotic in float32: where
# two magnitudes sit within float error of each other at the k-th place a
# run sends another coordinate, and from there its trajectory parts from a
# twin's by percents.  tools/topk_spread.py (the port on the CPU) and
# tools/topk_spread_ref.py (the JAX package) run the cell from the zero init
# and from 20 inits perturbed by 1e-9 and read each number below's largest
# deviation from the unperturbed run (relative; the accuracy absolute):
# rounds to the target 0.0621 / 0.0476, the final running mean of grad_sq
# 0.0581 / 0.0684, the mean loss 0.0195 / 0.0145, the final test accuracy
# 0.00200 / 0.00246 (port / JAX; artifacts/torch/topk_spread_*.json).  The
# card is held to the CPU at twice the larger of the two (the tool's
# --limits), and the function itself to the CPU's from the same state: one
# compressed-gossip call at the card's final state, the residual exact and
# the mixed output within MIX_TOL.
TOPK_SPREAD = {"rounds": 0.12413793103448276, "final_running_grad_sq": 0.13672050065024582,
               "mean_loss": 0.0390841684780271, "final_test_acc": 0.004913926124572754}
# sweep(seeds): every seed's losses on the card within this of the same
# sweep on the CPU
SWEEP_RTOL = 1e-4
FIG_SIZES = dict(fig4_rounds=600, fig4_p=(0.0, 0.1), sweep_seeds=(0, 1, 2))


def counted(torch, dev, label, fn):
    """One figure run with every launch counter zeroed just before it and
    read just after: (fn's result, counts, seconds)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"path {label}: {seconds:.3f} s, launches {counts}")
    return out, counts, seconds


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _figure_deviations(label, gpu, cpu):
    """Flags and bytes equal; the per-round loss, per-eval grad_sq and
    test-accuracy deviations of a card run from its CPU twin, logged."""
    import dataclasses

    import numpy as np

    check(gpu.is_global == cpu.is_global, f"{label}: is_global differs")
    check(dataclasses.asdict(gpu.accountant) == dataclasses.asdict(cpu.accountant),
          f"{label}: accountant bytes differ")
    loss = _rel(gpu.loss, cpu.loss)
    gsq = _rel([m["grad_sq"] for m in gpu.eval_metrics], [m["grad_sq"] for m in cpu.eval_metrics])
    acc = np.abs(np.subtract([m["test_acc"] for m in gpu.eval_metrics],
                             [m["test_acc"] for m in cpu.eval_metrics]))
    parted = np.nonzero(loss > PATH_LOSS_RTOL["paper"])[0]
    log(f"compare {label}: loss max {loss.max():.3e} (median {np.median(loss):.3e}), "
        f"grad_sq max {gsq.max():.3e} (median {np.median(gsq):.3e}), "
        f"test_acc max {acc.max():.4e}; losses part beyond {PATH_LOSS_RTOL['paper']} "
        f"{'nowhere' if not parted.size else f'first at round {parted[0]}'}")
    return loss, gsq, acc


def compare_figure_run(torch, label, gpu, cpu, n_test):
    """A figure run on the card against the same run on the CPU: flags and
    bytes equal; losses, the gradient norm and test accuracy per eval within
    their limits; the Fig. 4 readout (rounds, a2a, a2s to each target) equal,
    or else a tie: the crossing's margin from its target within the series'
    tolerance on both devices."""
    import numpy as np

    from repro_torch.figures.common import comm_rounds_to_targets
    from repro_torch.figures.fig4_p_sweep import ACC_TARGET, GRAD_TARGET

    loss, gsq, acc = _figure_deviations(label, gpu, cpu)
    check(loss.max() <= PATH_LOSS_RTOL["paper"], f"{label}: losses deviate by {loss.max()}")
    check(gsq.max() <= FIG_GRAD_RTOL, f"{label}: grad_sq deviates by {gsq.max()}")
    check(acc.max() * n_test <= FIG_ACC_SAMPLES + 1e-3,
          f"{label}: test_acc off by {acc.max() * n_test} samples")
    got = comm_rounds_to_targets(gpu, GRAD_TARGET, ACC_TARGET)
    want = comm_rounds_to_targets(cpu, GRAD_TARGET, ACC_TARGET)
    log(f"readout {label}: card {got}, CPU {want}")
    for phase, key, target, tol in (("train", "grad_sq", GRAD_TARGET, FIG_GRAD_RTOL * GRAD_TARGET),
                                    ("test", "test_acc", ACC_TARGET, FIG_ACC_SAMPLES / n_test)):
        if got[phase] == want[phase]:
            continue
        # the first crossing on either device; both series' margins there
        first = min(r["rounds"] for r in (got[phase], want[phase]) if r is not None) - 1
        margins = {}
        for name, h in (("card", gpu), ("CPU", cpu)):
            series = (h.running_mean_eval(key) if phase == "train"
                      else np.array([m[key] for m in h.eval_metrics]))
            margins[name] = float(series[first] - target)
        log(f"readout {label} {phase}: differs; margins from {target} at eval {first}: "
            f"{margins} (a tie within {tol:.3e})")
        check(all(abs(v) <= tol for v in margins.values()),
              f"{label}: {phase} readout differs beyond a tie: {got[phase]} vs {want[phase]}")


def compare_topk_run(torch, label, gpu, cpu, card_cg, cpu_cg):
    """The top-k cell on the card against the CPU (see TOPK_SPREAD): flags
    and bytes equal, the figure's readouts within the spread of the run's
    own chaos, and one compressed-gossip call from the card's final state
    through each run's own ``CompressedGossip`` (``card_cg``, ``cpu_cg``):
    the residual bit-equal, the output within MIX_TOL."""
    import numpy as np

    from repro_torch.figures.fig4_p_sweep import GRAD_TARGET
    from repro_torch.figures.fig_compression import _bytes_to_target

    _figure_deviations(label, gpu, cpu)
    got, want = _bytes_to_target(gpu, GRAD_TARGET), _bytes_to_target(cpu, GRAD_TARGET)
    stats = {}
    for name, h in (("card", gpu), ("CPU", cpu)):
        stats[name] = {"final_running_grad_sq": float(h.running_mean_eval("grad_sq")[-1]),
                       "mean_loss": float(np.mean(h.loss)),
                       "final_test_acc": float(h.eval_metrics[-1]["test_acc"])}
    log(f"readout {label}: bytes to the target card {got}, CPU {want}; {stats}")
    check(got is not None and want is not None, f"{label}: the target was not reached")
    check(abs(got["rounds"] - want["rounds"]) <= TOPK_SPREAD["rounds"] * want["rounds"],
          f"{label}: rounds to the target {got['rounds']} vs {want['rounds']}")
    for k in ("final_running_grad_sq", "mean_loss"):
        dev_ = abs(stats["card"][k] - stats["CPU"][k]) / abs(stats["CPU"][k])
        check(dev_ <= TOPK_SPREAD[k], f"{label}: {k} deviates by {dev_}")
    check(abs(stats["card"]["final_test_acc"] - stats["CPU"]["final_test_acc"])
          <= TOPK_SPREAD["final_test_acc"], f"{label}: final test_acc {stats}")
    st = gpu.final_state
    for stream in ("x", "y"):
        tree, res = getattr(st, stream), st.ef[stream]
        out_d, res_d = card_cg(tree, res, None)
        out_c, res_c = cpu_cg({k: v.cpu() for k, v in tree.items()},
                              {k: v.cpu() for k, v in res.items()}, None)
        for k in tree:
            check(torch.equal(res_d[k].cpu(), res_c[k]),
                  f"{label}: the {stream} residual differs from the CPU's from the same state")
            e = max_err(out_d[k].cpu(), out_c[k])
            check(e <= MIX_TOL * (1.0 + float(tree[k].abs().max())),
                  f"{label}: {stream} gossip from the same state off by {e}")
    log(f"{label}: one top-k gossip call from the card's final state: residuals bit-equal "
        f"to the CPU's, outputs within {MIX_TOL}")


def figures_paths(torch, dev):
    """The paper's figures at full size through ``repro_torch.figures``:
    Fig. 4's p = 0 and p = 0.1 cells (600 rounds, an eval every round), the
    compression sweep's top-k and int8 cells, the paper spec's 3-seed sweep
    and the sparse-fleet scaling; card against CPU where a figure's numbers
    are read."""
    import dataclasses

    import numpy as np

    from repro_torch.core import Experiment, ExperimentSpec
    from repro_torch.data import FederatedDataset, RoundSampler
    from repro_torch.data.synthetic import synthetic_a9a
    from repro_torch.figures import fig_sparse
    from repro_torch.figures.common import make_logreg_workload, run_pisco_variant
    from repro_torch.models import simple as models

    cpu = torch.device("cpu")
    launches, summary = {}, {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    work = {d: make_logreg_workload(quick=False, seed=0, device=d) for d in (dev, cpu)}
    n_test = len(work[cpu][0].y_test)

    def fig_run(d, **kw):
        data, loss_fn, eval_fn, params0 = work[d]
        return run_pisco_variant(data=data, loss_fn=loss_fn, eval_fn=eval_fn, params0=params0,
                                 t_o=1, eta_l=0.5, rounds=FIG_SIZES["fig4_rounds"], seed=0,
                                 device=d, **kw)[0]

    # -- fig4-full: Fig. 4's cells at full size, an eval every round --------
    for p in FIG_SIZES["fig4_p"]:
        label = f"fig4-full/p={p}"
        gpu_h, counts, secs = counted(torch, dev, label, lambda: fig_run(dev, p=p))
        add(counts)
        check(counts.get("fused_local_step", 0) > 0, f"{label}: K1 not launched")
        t0 = time.perf_counter()
        cpu_h = fig_run(cpu, p=p)
        log(f"{label}: card {1e3 * secs / len(gpu_h.loss):.3f} ms/round "
            f"({1e3 * gpu_h.wall_time_s / len(gpu_h.loss):.3f} in the driver), "
            f"CPU {1e3 * (time.perf_counter() - t0) / len(cpu_h.loss):.3f} ms/round; "
            f"final grad_sq {gpu_h.eval_metrics[-1]['grad_sq']:.6e}, "
            f"test_acc {gpu_h.eval_metrics[-1]['test_acc']:.4f}")
        compare_figure_run(torch, label, gpu_h, cpu_h, n_test)
        summary[label] = 1e3 * secs / len(gpu_h.loss)
    # the rounds of Fig. 4's cell without its per-round eval
    data, loss_fn, _, params0 = work[dev]
    profile_rounds(torch, dev, "fig4-full", ExperimentSpec.create(
        algo="pisco", n_agents=10, t_o=1, eta_l=0.5, p=0.1, seed=0, topology="ring",
        rounds=FIG_SIZES["fig4_rounds"]), loss_fn, params0, data, 256)

    # -- compression-top: the compression sweep's top-k cell; its int8 cell -
    label = "compression-top/top0.1,p=0.1"
    # each run's own operator, kept for the same-state gossip call
    top_mix = {d: ExperimentSpec.create(n_agents=10, topology="ring", compression="top0.1",
                                        seed=0).make_mixing(d) for d in (dev, cpu)}
    gpu_h, counts, secs = counted(torch, dev, label, lambda: fig_run(
        dev, p=0.1, compression="top0.1", mixing=top_mix[dev]))
    add(counts)
    check(counts.get("fused_local_step", 0) > 0, f"{label}: K1 not launched")
    compare_topk_run(torch, label, gpu_h,
                     fig_run(cpu, p=0.1, compression="top0.1", mixing=top_mix[cpu]),
                     top_mix[dev].compression, top_mix[cpu].compression)
    check(gpu_h.byte_model.gossip_message_bytes == 13 * 8,
          f"{label}: a top-k message of 13 (value, index) pairs is 104 bytes")
    summary[label] = 1e3 * secs / len(gpu_h.loss)
    label = "compression-top/q8,p=0.1"
    gpu_h, counts, secs = counted(torch, dev, label, lambda: fig_run(dev, p=0.1, compression="q8"))
    add(counts)
    for k in ("fused_local_step", "row_absmax", "quant_codes", "compressed_mix"):
        check(counts.get(k, 0) > 0, f"{label}: {k} not launched")
    bm, acct = gpu_h.byte_model, gpu_h.accountant
    # ring of 10: 20 directed messages a mix, two mixes a round; 124 int8
    # codes and one f32 scale a message
    check(bm.gossip_message_bytes == (124 * 8 + 32) // 8 and bm.gossip_round_bytes == 2 * 20 * 128
          and acct.agent_to_agent_bytes == acct.agent_to_agent * bm.gossip_round_bytes
          and acct.agent_to_server_bytes == acct.agent_to_server * bm.server_round_bytes,
          f"{label}: bytes {dataclasses.asdict(acct)} against the byte model {bm}")
    # the sorted split's per-agent losses rise as consensus forms: read the
    # full-data gradient norm at x̄
    ev = gpu_h.eval_metrics
    check(np.all(np.isfinite(gpu_h.loss)) and ev[-1]["grad_sq"] < ev[0]["grad_sq"],
          f"{label}: grad_sq {ev[0]['grad_sq']} -> {ev[-1]['grad_sq']}")
    log(f"{label}: gossip bytes/round {bm.gossip_round_bytes}, loss {gpu_h.loss[0]:.6f} -> "
        f"{gpu_h.loss[-1]:.6f}, final grad_sq {gpu_h.eval_metrics[-1]['grad_sq']:.6e}")
    summary[label] = 1e3 * secs / len(gpu_h.loss)

    # -- sweep: the paper spec over three seeds ------------------------------
    x, y = synthetic_a9a(SIZES["paper_samples"], seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=10)
    spec = ExperimentSpec.create(algo="pisco", n_agents=10, t_o=5, eta_l=0.3, p=0.1,
                                 seed=0, topology="ring", rounds=SIZES["paper_rounds"],
                                 eval_every=10)
    loss = lambda p, b: models.logreg_loss(p, b, rho=0.01)  # noqa: E731

    def experiment(d):
        resident = data.to(d)
        xt, yt = resident.x_test, resident.y_test
        return Experiment(
            spec, loss_fn=loss, params0=models.logreg_init(124), device=d,
            eval_fn=lambda p: {"test_loss": float(loss(p, (xt, yt)))},
            sampler_factory=lambda s: RoundSampler(resident, 128, s.config.t_o, s.config.seed,
                                                   device=d),
        )

    exp = experiment(dev)
    hists, counts, secs = counted(torch, dev, "sweep", lambda: exp.sweep(
        seeds=list(FIG_SIZES["sweep_seeds"])))
    add(counts)
    check(counts.get("fused_local_step", 0) > 0, "sweep: K1 not launched")
    single = exp.run()
    check(hists[0].loss == single.loss and hists[0].eval_metrics == single.eval_metrics
          and all(torch.equal(hists[0].final_state.x[k], single.final_state.x[k])
                  for k in single.final_state.x),
          "sweep: seed 0 is not bit-equal to run() on the card")
    cpu_hists = experiment(cpu).sweep(seeds=list(FIG_SIZES["sweep_seeds"]))
    worst = 0.0
    for s, g, c in zip(FIG_SIZES["sweep_seeds"], hists, cpu_hists):
        check(g.is_global == c.is_global, f"sweep seed {s}: is_global differs")
        worst = max(worst, float(_rel(g.loss, c.loss).max()))
    log(f"sweep: {len(hists)} seeds x {spec.rounds} rounds in {secs:.3f} s "
        f"({1e3 * secs / (len(hists) * spec.rounds):.3f} ms per seed-round), seed 0 bit-equal "
        f"to run(), card against CPU max relative loss deviation {worst:.3e} "
        f"(limit {SWEEP_RTOL}), final test loss "
        f"{[round(h.eval_metrics[-1]['test_loss'], 6) for h in hists]}")
    check(worst <= SWEEP_RTOL, f"sweep: losses deviate by {worst}")
    summary["sweep"] = 1e3 * secs / (len(hists) * spec.rounds)

    # -- fig-sparse-full: fleets of 64 to 10^4 agents, d = 256 --------------
    out_dir = os.path.join(ROOT, "build", "figures_smoke")
    payload, counts, secs = counted(torch, dev, "fig-sparse-full",
                                    lambda: fig_sparse.run(quick=False, device=dev,
                                                           out_dir=out_dir))
    add(counts)
    check(counts.get("sparse_mix", 0) > 0, "fig-sparse-full: K4 not launched")
    check(payload["parity"]["ok"], f"fig-sparse-full: parity {payload['parity']}")
    for key, r in payload["results"].items():
        check(np.isfinite(r["final_loss"]), f"fig-sparse-full {key}: loss {r['final_loss']}")
    log(f"fig-sparse-full: per-round ms "
        f"{ {k: round(1e3 * r['per_round_s'], 3) for k, r in payload['results'].items()} }, "
        f"n = 64 dense/sparse max loss deviation {payload['parity']['max_loss_dev']:.3e} "
        f"(rtol {fig_sparse.PARITY_RTOL}, atol {fig_sparse.PARITY_ATOL})")
    summary["fig-sparse-full/n=10000"] = 1e3 * payload["results"]["n=10000"]["per_round_s"]
    log(f"figures: {time.perf_counter() - t_phase:.1f} s; ms/round on the card {summary}")
    return launches


# ---------------------------------------------------------------------------
# Phase 2c: dynamic networks and update rules
# ---------------------------------------------------------------------------

DYN_SIZES = dict(rounds=20, fig_dynamic_rounds=600, fig_optimizers_rounds=500)


def drive_dynamic(torch, dev, label, spec, *args, **kw):
    """``drive`` over the spec's own mixing, kept to read its network's host
    draw time; logs the draws' seconds and their share of the run."""
    mixing = spec.make_mixing(dev)
    hist, counts = drive(torch, dev, label, spec, *args, mixing=mixing, **kw)
    rounds = len(hist.loss)
    draw = mixing.network.draw_s if mixing.network is not None else 0.0
    log(f"path {label}: host draws of the network {1e3 * draw / rounds:.3f} ms/round "
        f"({100.0 * draw / hist.wall_time_s:.1f}% of the run)")
    return hist, counts, mixing


def first_difference(a, b):
    """Index of the first round whose losses differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def check_bit_equal(torch, label, hist, want, what):
    diff = first_difference(hist.loss, want.loss)
    same_x = all(torch.equal(hist.final_state.x[k], want.final_state.x[k])
                 for k in want.final_state.x)
    if diff is not None or not same_x or hist.is_global != want.is_global:
        log(f"{label}: differs from {what} first at round {diff} "
            f"({hist.loss[diff] if diff is not None else None} against "
            f"{want.loss[diff] if diff is not None else None}); final x equal: {same_x}")
    check(diff is None and same_x and hist.is_global == want.is_global,
          f"{label}: not bit-equal to {what}")
    log(f"{label}: bit-equal to {what} on the card ({len(hist.loss)} rounds, final x equal)")


def dynamic_paths(torch, dev):
    """Dynamic networks and update rules at full width: three paths over
    per-round weights (K4, K5, K3), the sgd and momentum rules at sparse-10k
    against its inline path, the static process against the paper path, and
    one cell each of fig_dynamic and fig_optimizers, card against CPU."""
    from repro_torch.core import ExperimentSpec
    from repro_torch.data import FederatedDataset
    from repro_torch.data.synthetic import synthetic_a9a, synthetic_mnist
    from repro_torch.figures import fig_dynamic, fig_optimizers
    from repro_torch.figures.common import make_logreg_workload, run_pisco_variant
    from repro_torch.models import simple as models

    cpu = torch.device("cpu")
    launches, summary = {}, {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    mlp0 = models.mlp_init(0)
    rounds = DYN_SIZES["rounds"]

    # -- sparse-10k-bern: link failures q = 0.3, half participation --------
    n_sparse = SIZES["sparse_agents"]
    x, y = synthetic_mnist(n_sparse * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n_sparse)
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_sparse, t_o=2, eta_l=0.1, p=0.05, seed=0,
        topology="random_regular", topology_kwargs={"degree": 4}, sparse=True,
        network="bernoulli:0.3", participation=0.5, rounds=rounds,
    )
    label = "sparse-10k-bern"
    hist, counts, mixing = drive_dynamic(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_sparse, mlp0)
    n_gossip = rounds - sum(hist.is_global)
    check(counts.get("sparse_mix", 0) == 2 * 4 * n_gossip and counts["fused_local_step"] > 0,
          f"{label}: K4 launches {counts.get('sparse_mix')} for {n_gossip} gossip rounds "
          f"(2 mixes x 4 leaves each), K1 {counts.get('fused_local_step')}")
    acct = hist.accountant
    base_msgs = 2 * mixing.network.process.base.n_edges
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round, loss {hist.loss[0]:.6f} -> "
        f"{hist.loss[-1]:.6f}, realized gossip bytes {acct.agent_to_agent_bytes} against the "
        f"static {n_gossip * hist.byte_model.gossip_round_bytes} ({base_msgs} directed base "
        f"edges), server bytes {acct.agent_to_server_bytes}")
    check(0 < acct.agent_to_agent_bytes < n_gossip * hist.byte_model.gossip_round_bytes,
          f"{label}: realized gossip bytes {acct.agent_to_agent_bytes}")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    profile_rounds(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    del hist

    # -- sparse-10k-q8-cohort: stochastic int8 + EF over sampled cohorts ---
    spec_q8 = spec.replace(network=None, participation=1.0, cohort=0.25, compression="q8")
    label = "sparse-10k-q8-cohort"
    hist, counts, _ = drive_dynamic(torch, dev, label, spec_q8, models.mlp_loss, mlp0, data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_sparse, mlp0)
    n_gossip = rounds - sum(hist.is_global)
    for k in ("fused_local_step", "row_absmax", "quant_codes"):
        check(counts.get(k, 0) > 0, f"{label}: {k} not launched")
    check(counts.get("sparse_compressed_mix", 0) == 2 * 4 * n_gossip,
          f"{label}: K5 launches {counts.get('sparse_compressed_mix')} for {n_gossip} gossip "
          "rounds")
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round, loss {hist.loss[0]:.6f} -> "
        f"{hist.loss[-1]:.6f}, realized gossip bytes {hist.accountant.agent_to_agent_bytes}")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    profile_rounds(torch, dev, label, spec_q8, models.mlp_loss, mlp0, data, 16)
    del hist

    # -- sparse-10k rules: the inline step (K1) against the rule path ------
    # The rule path takes the (3a)/(3c) steps in plain PyTorch, as the
    # reference's takes them in plain jnp: sgd is bit-equal to the inline
    # run and launches no K1; momentum's trace moves through K4 as a third
    # mix (the "mix" policy), four leaves each.
    static = spec.replace(network=None, participation=1.0)
    want, counts = drive(torch, dev, "sparse-10k-inline", static, models.mlp_loss, mlp0, data,
                         16)
    add(counts)
    summary["sparse-10k-inline"] = 1e3 * want.wall_time_s / rounds
    profile_rounds(torch, dev, "sparse-10k-inline", static, models.mlp_loss, mlp0, data, 16)
    for label, rule, mixes in (("sparse-10k-sgd-rule", "sgd", 2),
                               ("sparse-10k-momentum", "momentum:lr=0.1", 3)):
        rspec = static.replace(optimizer=rule)
        hist, counts = drive(torch, dev, label, rspec, models.mlp_loss, mlp0, data, 16)
        add(counts)
        check_run(torch, label, hist, rounds, n_sparse, mlp0)
        n_gossip = rounds - sum(hist.is_global)
        check(counts.get("fused_local_step", 0) == 0
              and counts.get("sparse_mix", 0) == mixes * 4 * n_gossip,
              f"{label}: K1 launches {counts.get('fused_local_step')}, K4 "
              f"{counts.get('sparse_mix')} for {n_gossip} gossip rounds ({mixes} mixes x 4 leaves)")
        if rule == "sgd":
            check_bit_equal(torch, label, hist, want, "the inline path")
        summary[label] = 1e3 * hist.wall_time_s / rounds
        log(f"{label}: {summary[label]:.3f} ms/round against the inline path's "
            f"{summary['sparse-10k-inline']:.3f}, loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}")
        profile_rounds(torch, dev, label, rspec, models.mlp_loss, mlp0, data, 16)
        del hist
    del want, data

    n_cmp = SIZES["compare_agents"]
    x, y = synthetic_mnist(n_cmp * 20, seed=1)
    small = FederatedDataset.from_arrays(x, y, n_agents=n_cmp)
    for label, cspec in (("sparse-1024-bern", spec),
                         ("sparse-1024-q8d-cohort", spec_q8.replace(compression="q8d")),
                         ("sparse-1024-momentum", static.replace(optimizer="momentum:lr=0.1"))):
        short = cspec.replace(n_agents=n_cmp, rounds=3, p=0.3)
        gpu_h = run_path(torch, dev, short, models.mlp_loss, mlp0, small, 16)
        cpu_h = run_path(torch, cpu, short, models.mlp_loss, mlp0, small, 16)
        check(gpu_h.accountant.per_round_bytes == cpu_h.accountant.per_round_bytes,
              f"{label}: realized bytes differ")
        compare_cpu(torch, label, gpu_h, cpu_h)

    # -- dense-q8-matching: K3 over a new W_k every round ------------------
    n_dense = SIZES["dense_agents"]
    x, y = synthetic_mnist(n_dense * 80, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n_dense)
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_dense, t_o=2, eta_l=0.1, p=0.1, seed=0,
        topology="erdos_renyi", topology_kwargs={"prob": 0.3, "seed": 7}, compression="q8",
        network="matching", participation=0.5, rounds=rounds,
    )
    label = "dense-q8-matching"
    hist, counts, mixing = drive_dynamic(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_dense, mlp0)
    gossip = [k for k, g in enumerate(hist.is_global) if not g]
    check(counts.get("compressed_mix", 0) == 2 * 4 * len(gossip)
          and counts.get("quant_codes", 0) == counts["compressed_mix"],
          f"{label}: K3 launches {counts.get('compressed_mix')} for {len(gossip)} gossip rounds")
    ws, _ = mixing.network.process.draw_block(0, rounds)
    distinct = len({ws[k].tobytes() for k in gossip})
    check(distinct == len(gossip), f"{label}: {distinct} distinct W_k in {len(gossip)} rounds")
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round, {len(gossip)} gossip rounds "
        f"over {distinct} distinct matchings, loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    profile_rounds(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    short = spec.replace(compression="q8d", rounds=3)
    compare_cpu(torch, "dense-q8d-matching",
                run_path(torch, dev, short, models.mlp_loss, mlp0, data, 16),
                run_path(torch, cpu, short, models.mlp_loss, mlp0, data, 16))
    del hist, data, mixing

    # -- paper-static-process: the static process is the frozen W ----------
    x, y = synthetic_a9a(SIZES["paper_samples"], seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=10)
    paper = ExperimentSpec.create(algo="pisco", n_agents=10, t_o=5, eta_l=0.3, p=0.1,
                                  seed=0, topology="ring", rounds=SIZES["paper_rounds"],
                                  eval_every=10)
    loss = lambda p, b: models.logreg_loss(p, b, rho=0.01)  # noqa: E731
    params0 = models.logreg_init(124)
    want = run_path(torch, dev, paper, loss, params0, data, 128)
    label = "paper-static-process"
    static = paper.replace(network="static")
    hist, counts, _ = drive_dynamic(torch, dev, label, static, loss, params0, data, 128)
    add(counts)
    check(counts.get("fused_local_step", 0) > 0, f"{label}: K1 not launched")
    check_bit_equal(torch, label, hist, want, "the paper path")
    summary[label] = 1e3 * hist.wall_time_s / len(hist.loss)
    profile_rounds(torch, dev, label, static, loss, params0, data, 128)
    compare_cpu(torch, label, hist, run_path(torch, cpu, static, loss, params0, data, 128))
    label = "paper-sgd-rule"
    hist, counts = drive(torch, dev, label, paper.replace(optimizer="sgd"), loss, params0, data,
                         128)
    check_bit_equal(torch, label, hist, want, "the inline path")

    # -- fig-dynamic: ring, q = 0.3, half participation, 600 rounds -------
    work = {d: make_logreg_workload(quick=False, seed=0, device=d) for d in (dev, cpu)}
    n_test = len(work[cpu][0].y_test)

    def fig_run(d, **kw):
        data_, loss_fn, eval_fn, p0 = work[d]
        return run_pisco_variant(data=data_, loss_fn=loss_fn, eval_fn=eval_fn, params0=p0,
                                 seed=0, device=d, **kw)[0]

    label = "fig-dynamic/ring,q=0.3,part=0.5"
    cell = dict(topology_name="ring", p=0.1, t_o=1, eta_l=0.5,
                rounds=DYN_SIZES["fig_dynamic_rounds"], **fig_dynamic.cell_spec(0.3, 0.5))
    gpu_h, counts, secs = counted(torch, dev, label, lambda: fig_run(dev, **cell))
    add(counts)
    t0 = time.perf_counter()
    cpu_h = fig_run(cpu, **cell)
    cpu_s = time.perf_counter() - t0
    got = fig_dynamic.cell_readout(gpu_h, fig_dynamic.GRAD_TARGET)
    want_r = fig_dynamic.cell_readout(cpu_h, fig_dynamic.GRAD_TARGET)
    log(f"readout {label}: card {got}, CPU {want_r}; card {1e3 * secs / len(gpu_h.loss):.3f} "
        f"ms/round, CPU {1e3 * cpu_s / len(cpu_h.loss):.3f}")
    compare_figure_run(torch, label, gpu_h, cpu_h, n_test)
    check(got["gossip_bytes"] == want_r["gossip_bytes"]
          and got["server_bytes"] == want_r["server_bytes"], f"{label}: bytes differ")
    check_readout_tie(label, gpu_h, cpu_h, got, want_r, fig_dynamic.GRAD_TARGET)
    summary[label] = 1e3 * secs / len(gpu_h.loss)

    # -- fig-optimizers: Adam (lr 0.05) + FedAdam at p = 0.2, 500 rounds ---
    label = "fig-optimizers/adam+fedadam,p=0.2"
    cell = dict(p=0.2, t_o=2, eta_l=0.3, rounds=DYN_SIZES["fig_optimizers_rounds"],
                optimizer="adam:lr=0.05", server_optimizer="fedadam")
    gpu_h, counts, secs = counted(torch, dev, label, lambda: fig_run(dev, **cell))
    add(counts)
    t0 = time.perf_counter()
    cpu_h = fig_run(cpu, **cell)
    cpu_s = time.perf_counter() - t0
    got = fig_optimizers.cell_readout(gpu_h, 0.002)
    want_r = fig_optimizers.cell_readout(cpu_h, 0.002)
    log(f"readout {label}: card {got}, CPU {want_r}; card {1e3 * secs / len(gpu_h.loss):.3f} "
        f"ms/round, CPU {1e3 * cpu_s / len(cpu_h.loss):.3f}")
    compare_figure_run(torch, label, gpu_h, cpu_h, n_test)
    check_readout_tie(label, gpu_h, cpu_h, got, want_r, 0.002)
    summary[label] = 1e3 * secs / len(gpu_h.loss)
    log(f"dynamic: {time.perf_counter() - t_phase:.1f} s; ms/round on the card {summary}")
    return launches


def check_readout_tie(label, gpu, cpu, got, want, target):
    """The rounds to the gradient target equal on card and CPU, or else a
    tie: both running means within FIG_GRAD_RTOL of the target where the
    first of them crosses it."""
    if got["rounds_to_target"] == want["rounds_to_target"]:
        check(got == dict(want, final_grad_sq=got["final_grad_sq"],
                          **({"final_loss": got["final_loss"]} if "final_loss" in got else {})),
              f"{label}: readouts differ at equal rounds: {got} vs {want}")
        return
    first = min(r for r in (got["rounds_to_target"], want["rounds_to_target"]) if r) - 1
    margins = {name: float(h.running_mean_eval("grad_sq")[first] - target)
               for name, h in (("card", gpu), ("CPU", cpu))}
    log(f"readout {label}: rounds differ; margins from {target} at eval {first}: {margins}")
    check(all(abs(v) <= FIG_GRAD_RTOL * target for v in margins.values()),
          f"{label}: rounds to the target differ beyond a tie")


# ---------------------------------------------------------------------------
# Phase 2d: simulated systems costs and asynchronous execution
# ---------------------------------------------------------------------------

ASYNC_SIZES = dict(rounds=20, compare_rounds=6, fig_async_rounds=600, fig_timecost_rounds=600)
# fig_async's rule at n agents: poly decay, staleness bound 2, a server
# buffer of half the fleet
ASYNC_RULE = "poly:alpha=0.5,bound=2,buffer={}"
# events under a uniform fleet against the scan driver: the per-round
# seconds of the event clock and of the barrier model differ only in the
# order of their float64 additions
UNIFORM_SIM_RTOL = 1e-9


class EventProbe:
    """Records, for the runs started while it is open, each events run's
    engine and the network it drives (``repro_torch.events``' entry points
    wrapped, and restored on close) and the host seconds of each engine's
    construction (fleet realization included)."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        from repro_torch.events import clock, driver

        self._saved = (clock.make_event_engine, driver.drive_events)
        make_engine, drive_events = self._saved

        def make_event_engine(*a, **kw):
            t0 = time.perf_counter()
            engine = make_engine(*a, **kw)
            self.runs.append({"engine": engine, "engine_s": time.perf_counter() - t0})
            return engine

        def drive(bound, *a, **kw):
            self.runs[-1]["network"] = bound.network
            return drive_events(bound, *a, **kw)

        clock.make_event_engine, driver.drive_events = make_event_engine, drive
        return self

    def __exit__(self, *exc):
        from repro_torch.events import clock, driver

        clock.make_event_engine, driver.drive_events = self._saved
        return False


def drive_events_path(torch, dev, label, spec, *args, trivial=False, **kw):
    """``drive`` of an events run, with its engine: logs the engine's host
    seconds, the share of the run in the engine's block draws and their one
    copy to the card, the peak staleness, and checks the engine's
    triviality."""
    import numpy as np

    with EventProbe() as probe:
        hist, counts = drive(torch, dev, label, spec, *args, **kw)
    run = probe.runs[-1]
    engine, net = run["engine"], run["network"]
    check(engine.trivial == trivial, f"{label}: engine trivial={engine.trivial}")
    draw = getattr(net, "draw_s", 0.0) if net is not None else 0.0
    rounds = len(hist.loss)
    log(f"path {label}: engine built in {run['engine_s']:.3f} s on the host (fleet realized "
        f"inside), block draws and their copy {1e3 * draw / rounds:.3f} ms/round "
        f"({100.0 * draw / hist.wall_time_s:.1f}% of the run), peak staleness "
        f"{int(np.max(hist.staleness))}, simulated {sum(hist.sim_time_s):.6f} s")
    return hist, counts, engine


def compare_events_cpu(torch, label, gpu, cpu):
    """``compare_cpu`` plus the event clock: sim_time_s and staleness equal."""
    compare_cpu(torch, label, gpu, cpu)
    check(gpu.sim_time_s == cpu.sim_time_s, f"{label}: sim_time_s differs")
    check(gpu.staleness == cpu.staleness, f"{label}: staleness differs")
    log(f"compare {label}: sim_time_s and staleness equal ({sum(gpu.sim_time_s):.6f} s "
        f"simulated, peak staleness {max(max(r) for r in gpu.staleness)})")


def check_async_readout(label, gpu, cpu, got, want, target, window):
    """fig_async's readouts on card and CPU: seconds and rounds equal; where
    the time to the target differs, a tie — both smoothed losses within
    PATH_LOSS_RTOL["paper"] of the target at the first crossing."""
    import numpy as np

    from repro_torch.sim.tuner import _smoothed

    same = {k: v for k, v in got.items() if k != "final_loss"} == \
        {k: v for k, v in want.items() if k != "final_loss"}
    if same:
        return
    secs = np.cumsum(gpu.sim_time_s)
    first = min(int(np.searchsorted(secs, t)) for t in (got["time_to_target_s"],
                                                         want["time_to_target_s"]) if t)
    margins = {name: float(_smoothed(h.loss, window)[first] / target - 1.0)
               for name, h in (("card", gpu), ("CPU", cpu))}
    log(f"readout {label}: differs; relative margins from {target} at round {first}: {margins}")
    check(all(abs(v) <= PATH_LOSS_RTOL["paper"] for v in margins.values()),
          f"{label}: readouts differ beyond a tie: {got} vs {want}")


def async_paths(torch, dev):
    """Simulated systems costs and asynchronous execution at full width:
    the 10,000-agent fleet on the event clock under lognormal stragglers
    (K4, then K5 with int8 gossip, over the engine's CSR weights; the
    weighted server mean), dense-q8 under wan-gossip (K3 over the engine's
    W_k), the free and uniform fleets against the scan driver, the event
    trace's repricing, and fig_async's and fig_timecost's cells, card
    against CPU."""
    import numpy as np

    from repro_torch.core import ExperimentSpec
    from repro_torch.data import FederatedDataset
    from repro_torch.data.synthetic import synthetic_a9a, synthetic_mnist
    from repro_torch.figures import fig_async, fig_timecost
    from repro_torch.figures.common import make_logreg_workload
    from repro_torch.models import simple as models
    from repro_torch.sim import FREE_NETWORK, make_profile, price_history, retime, tune

    cpu = torch.device("cpu")
    launches, summary = {}, {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    mlp0 = models.mlp_init(0)
    rounds = ASYNC_SIZES["rounds"]

    # -- fleet realizations at 10^4 agents on the host ----------------------
    n_sparse = SIZES["sparse_agents"]
    for prof in ("lognormal-stragglers", "wan-gossip"):
        t0 = time.perf_counter()
        fleet = make_profile(prof).realize(n_sparse, seed=0)
        log(f"realize {prof}: {n_sparse} agents in {time.perf_counter() - t0:.3f} s on the "
            f"host ({2 * fleet.link_latency_s.nbytes / 2**30:.2f} GiB of (n, n) link arrays)")
        del fleet

    # -- sparse-10k-async: stragglers, bounded staleness, buffered server ---
    x, y = synthetic_mnist(n_sparse * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n_sparse)
    sync = ExperimentSpec.create(
        algo="pisco", n_agents=n_sparse, t_o=2, eta_l=0.1, p=0.05, seed=0,
        topology="random_regular", topology_kwargs={"degree": 4}, sparse=True,
        rounds=rounds, systems="lognormal-stragglers",
    )
    spec = sync.replace(driver="events", async_=ASYNC_RULE.format(n_sparse // 2))
    label = "sparse-10k-async"
    hist, counts, engine = drive_events_path(torch, dev, label, spec, models.mlp_loss, mlp0,
                                             data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_sparse, mlp0, lemma1=False)
    n_gossip = rounds - sum(hist.is_global)
    check(counts.get("sparse_mix", 0) == 2 * 4 * n_gossip and counts["fused_local_step"] > 0,
          f"{label}: K4 launches {counts.get('sparse_mix')} for {n_gossip} gossip rounds "
          f"(2 mixes x 4 leaves each), K1 {counts.get('fused_local_step')}")
    check(int(np.max(hist.staleness)) > 0, f"{label}: nobody straggled")
    dropped = int((engine.trace["active"][~engine.flags].sum(1) < len(engine.base_edges)).sum())
    want, _ = drive(torch, dev, "sparse-10k-sync", sync, models.mlp_loss, mlp0, data, 16)
    check(sum(hist.sim_time_s) < sum(want.sim_time_s),
          f"{label}: simulated {sum(hist.sim_time_s)} s, the barrier {sum(want.sim_time_s)} s")
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round (the sync run "
        f"{1e3 * want.wall_time_s / rounds:.3f}), loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}; "
        f"simulated {sum(hist.sim_time_s):.6f} s against the barrier's "
        f"{sum(want.sim_time_s):.6f} s ({sum(want.sim_time_s) / sum(hist.sim_time_s):.3f}x); "
        f"{dropped} of {n_gossip} gossip rounds dropped stale edges; realized gossip bytes "
        f"{hist.accountant.agent_to_agent_bytes} against the barrier's "
        f"{want.accountant.agent_to_agent_bytes}")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    del want
    # reprice: the frozen trace under its own profile is the online ledger
    t0 = time.perf_counter()
    same = price_history(hist, spec)
    t_same = time.perf_counter() - t0
    t0 = time.perf_counter()
    wan = price_history(hist, spec, systems="wan-gossip")
    t_wan = time.perf_counter() - t0
    check(np.array_equal(same, np.asarray(hist.sim_time_s)),
          "reprice: the trace does not reprice to its own ledger")
    check(not np.array_equal(wan, same), "reprice: wan-gossip prices as the stragglers do")
    log(f"reprice {label}: own profile equal to the online ledger ({t_same:.3f} s on the host), "
        f"under wan-gossip {wan.sum():.6f} s against {same.sum():.6f} ({t_wan:.3f} s)")
    profile_rounds(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    del hist, engine

    # -- sparse-10k-q8-async: the same with stochastic int8 + EF (K5) ------
    spec_q8 = spec.replace(compression="q8")
    label = "sparse-10k-q8-async"
    hist, counts, _ = drive_events_path(torch, dev, label, spec_q8, models.mlp_loss, mlp0,
                                        data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_sparse, mlp0, lemma1=False)
    n_gossip = rounds - sum(hist.is_global)
    for k in ("fused_local_step", "row_absmax", "quant_codes"):
        check(counts.get(k, 0) > 0, f"{label}: {k} not launched")
    check(counts.get("sparse_compressed_mix", 0) == 2 * 4 * n_gossip,
          f"{label}: K5 launches {counts.get('sparse_compressed_mix')} for {n_gossip} gossip "
          "rounds")
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round, loss {hist.loss[0]:.6f} -> "
        f"{hist.loss[-1]:.6f}, simulated {sum(hist.sim_time_s):.6f} s")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    profile_rounds(torch, dev, label, spec_q8, models.mlp_loss, mlp0, data, 16)
    del hist, data

    n_cmp = SIZES["compare_agents"]
    x, y = synthetic_mnist(n_cmp * 20, seed=1)
    small = FederatedDataset.from_arrays(x, y, n_agents=n_cmp)
    for label, cspec in (("sparse-1024-async", spec),
                         ("sparse-1024-q8d-async", spec_q8.replace(compression="q8d"))):
        short = cspec.replace(n_agents=n_cmp, rounds=ASYNC_SIZES["compare_rounds"], p=0.3,
                              async_=ASYNC_RULE.format(n_cmp // 2))
        with EventProbe() as probe:
            gpu_h = run_path(torch, dev, short, models.mlp_loss, mlp0, small, 16)
            cpu_h = run_path(torch, cpu, short, models.mlp_loss, mlp0, small, 16)
        check(not any(r["engine"].trivial for r in probe.runs), f"{label}: a trivial engine")
        compare_events_cpu(torch, label, gpu_h, cpu_h)

    # -- dense-q8-async: K3 over the engine's W_k under wan-gossip ---------
    n_dense = SIZES["dense_agents"]
    x, y = synthetic_mnist(n_dense * 80, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n_dense)
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n_dense, t_o=2, eta_l=0.1, p=0.1, seed=0,
        topology="erdos_renyi", topology_kwargs={"prob": 0.3, "seed": 7}, compression="q8",
        rounds=rounds, driver="events", systems="wan-gossip",
        async_=ASYNC_RULE.format(n_dense // 2),
    )
    label = "dense-q8-async"
    hist, counts, _ = drive_events_path(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    add(counts)
    check_run(torch, label, hist, rounds, n_dense, mlp0, lemma1=False)
    n_gossip = rounds - sum(hist.is_global)
    check(counts.get("compressed_mix", 0) == 2 * 4 * n_gossip
          and counts.get("quant_codes", 0) == counts["compressed_mix"]
          and counts.get("row_absmax", 0) > 0,
          f"{label}: K3 launches {counts.get('compressed_mix')} for {n_gossip} gossip rounds")
    log(f"{label}: {1e3 * hist.wall_time_s / rounds:.3f} ms/round, loss {hist.loss[0]:.6f} -> "
        f"{hist.loss[-1]:.6f}, simulated {sum(hist.sim_time_s):.6f} s")
    summary[label] = 1e3 * hist.wall_time_s / rounds
    profile_rounds(torch, dev, label, spec, models.mlp_loss, mlp0, data, 16)
    short = spec.replace(compression="q8d", rounds=ASYNC_SIZES["compare_rounds"], p=0.3)
    compare_events_cpu(torch, "dense-q8d-async",
                       run_path(torch, dev, short, models.mlp_loss, mlp0, data, 16),
                       run_path(torch, cpu, short, models.mlp_loss, mlp0, data, 16))
    del hist, data

    # -- paper-events-free / -uniform: the trivial engine is the scan driver
    x, y = synthetic_a9a(SIZES["paper_samples"], seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=10)
    paper = ExperimentSpec.create(algo="pisco", n_agents=10, t_o=5, eta_l=0.3, p=0.1,
                                  seed=0, topology="ring", rounds=SIZES["paper_rounds"],
                                  eval_every=10)
    loss = lambda p, b: models.logreg_loss(p, b, rho=0.01)  # noqa: E731
    params0 = models.logreg_init(124)
    for label, systems in (("paper-events-free", FREE_NETWORK), ("paper-events-uniform",
                                                                  "uniform")):
        want = run_path(torch, dev, paper.replace(systems=systems), loss, params0, data, 128)
        events = paper.replace(systems=systems, driver="events")
        hist, counts, _ = drive_events_path(torch, dev, label, events, loss, params0, data, 128,
                                            trivial=True)
        add(counts)
        check(counts.get("fused_local_step", 0) > 0, f"{label}: K1 not launched")
        check_bit_equal(torch, label, hist, want, "the scan driver")
        dev_s = float(np.max(np.abs(np.subtract(hist.sim_time_s, want.sim_time_s))
                             / np.asarray(want.sim_time_s)))
        log(f"{label}: sim_time_s against the scan driver's: max relative deviation "
            f"{dev_s:.3e} (limit {UNIFORM_SIM_RTOL})")
        check(dev_s <= UNIFORM_SIM_RTOL, f"{label}: sim_time_s deviates by {dev_s}")
        summary[label] = 1e3 * hist.wall_time_s / len(hist.loss)

    # -- fig-async-full: the stragglers cell, 600 rounds, sync and async ---
    work = {d: make_logreg_workload(quick=False, seed=0, device=d) for d in (dev, cpu)}
    rounds_f = ASYNC_SIZES["fig_async_rounds"]
    window = max(1, min(20, rounds_f // 10))

    def fig_runs(d):
        from repro_torch.core import Experiment
        from repro_torch.data import RoundSampler

        data_, loss_fn, _, p0 = work[d]
        b = min(256, data_.samples_per_agent)
        return [Experiment(s, loss_fn=loss_fn, params0=p0, device=d,
                           sampler_factory=lambda s_: RoundSampler(data_, b, s_.config.t_o,
                                                                   s_.config.seed, device=d)).run()
                for s in fig_async.cell_specs(data_.n_agents, "lognormal-stragglers", rounds_f)]

    label = "fig-async-full/lognormal-stragglers"
    (g_sync, g_async), counts, secs = counted(torch, dev, label, lambda: fig_runs(dev))
    add(counts)
    check(counts.get("fused_local_step", 0) > 0, f"{label}: K1 not launched")
    t0 = time.perf_counter()
    c_sync, c_async = fig_runs(cpu)
    cpu_s = time.perf_counter() - t0
    compare_cpu(torch, "fig-async-full/sync", g_sync, c_sync)
    compare_events_cpu(torch, "fig-async-full/async", g_async, c_async)
    got = fig_async.cell_readout(g_sync, g_async, "lognormal-stragglers", window)
    want = fig_async.cell_readout(c_sync, c_async, "lognormal-stragglers", window)
    speed = fig_async.async_flip({"card": got, "CPU": want})
    log(f"readout {label}: card {got}, CPU {want}; async speedup card {speed['card']:.4f}, "
        f"CPU {speed['CPU']:.4f}; card {1e3 * secs / (2 * rounds_f):.3f} ms/round, CPU "
        f"{1e3 * cpu_s / (2 * rounds_f):.3f}")
    for name, g, c in (("sync", g_sync, c_sync), ("async", g_async, c_async)):
        check_async_readout(f"{label}/{name}", g, c, got[name], want[name], got["target_loss"],
                            window)
    # the figure's claim (async faster to the target) is read, not held: the
    # readouts above hold the card to the CPU
    log(f"{label}: async faster to the target than the barrier: card {speed['card'] > 1.0}, "
        f"CPU {speed['CPU'] > 1.0}")
    summary[label] = 1e3 * secs / (2 * rounds_f)

    # -- fig-timecost-cell: the PISCO tuner at full size, free profile -----
    def tuner(d):
        from repro_torch.data import RoundSampler

        data_, loss_fn, _, p0 = work[d]
        b = min(256, data_.samples_per_agent)
        base = ExperimentSpec.create(algo="pisco", n_agents=data_.n_agents, t_o=1, eta_l=0.5,
                                     p=0.1, seed=0, rounds=ASYNC_SIZES["fig_timecost_rounds"],
                                     eval_every=ASYNC_SIZES["fig_timecost_rounds"],
                                     driver="scan")
        return tune(base, dict(loss_fn=loss_fn, params0=p0, device=d,
                               sampler_factory=lambda s: RoundSampler(
                                   data_, b, s.config.t_o, s.config.seed, device=d)),
                    p_grid=fig_timecost.P_GRID, tau_grid=fig_timecost.TAU_GRID,
                    systems=FREE_NETWORK, strategy="grid")

    label = "fig-timecost-cell/free"
    g_res, counts, secs = counted(torch, dev, label, lambda: tuner(dev))
    add(counts)
    n_rounds = sum(pt.rounds_run for pt in g_res.points)
    t0 = time.perf_counter()
    c_res = tuner(cpu)
    cpu_s = time.perf_counter() - t0
    for prof in (FREE_NETWORK, "wan-gossip", "lan-gossip"):
        g = g_res if prof == FREE_NETWORK else retime(g_res, prof)
        c = c_res if prof == FREE_NETWORK else retime(c_res, prof)
        gb, cb = g.best.to_dict(), c.best.to_dict()
        log(f"readout {label} {prof}: best (p, tau) card ({gb['p']}, {gb['t_o']}), CPU "
            f"({cb['p']}, {cb['t_o']}); time to target card {gb['time_to_target_s']}, CPU "
            f"{cb['time_to_target_s']}; ranking card {g.ranking()}, CPU {c.ranking()}")
        check((gb["p"], gb["t_o"]) == (cb["p"], cb["t_o"]),
              f"{label} {prof}: best (p, tau) differs")
    for g, c in zip(sorted(g_res.points, key=lambda pt: (pt.p, pt.t_o)),
                    sorted(c_res.points, key=lambda pt: (pt.p, pt.t_o))):
        compare_cpu(torch, f"fig-timecost-cell/p={g.p},tau={g.t_o}", g.history, c.history)
        check(g.history.sim_time_s == c.history.sim_time_s, f"{label}: sim_time_s differs")
    log(f"{label}: {len(g_res.points)} configurations, {n_rounds} rounds in {secs:.3f} s on the "
        f"card ({1e3 * secs / n_rounds:.3f} ms/round), CPU {1e3 * cpu_s / n_rounds:.3f} ms/round")
    summary[label] = 1e3 * secs / n_rounds
    log(f"async: {time.perf_counter() - t_phase:.1f} s; ms/round on the card {summary}")
    return launches


# ---------------------------------------------------------------------------
# Phase 1b: the serving path's kernels (K6, K7) against their plain versions
# ---------------------------------------------------------------------------


def flash_cost(b, hq, hkv, sq, sk, d, window, itemsize):
    """(bytes, flops) of one causal attention call: q, k, v read and o
    written once; 4·D flops per unmasked (query, key) pair."""
    pairs = 0
    for i in range(sq):
        lo = 0 if window is None else max(0, i - window + 1)
        pairs += min(i, sk - 1) - lo + 1
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    return nbytes, 4.0 * b * hq * d * pairs


def ssd_cost(b, l, h, p, g, n, chunk, itemsize):
    """(bytes, flops) of one SSD scan with the model's chunk: x, dt, B, C read
    and y written once, the f32 final state written; per chunk of length c
    and head, C·Bᵀ and its product with x over the causal triangle
    (c(c+1)/2 · 2(N + P)), the state read-out and update (2 · 2·c·P·N)."""
    flops = 0.0
    for c0 in range(0, l, chunk):
        c = min(chunk, l - c0)
        flops += c * (c + 1) / 2 * 2 * (n + p) + 4 * c * p * n
    nbytes = itemsize * (2 * b * l * h * p + b * l * h + 2 * b * l * g * n) + 4 * b * h * p * n
    return nbytes, b * h * flops


def lm_kernel_checks(torch, dev):
    """K6 at Qwen3-8B's prefill shape (B 1, Hq 32, Hkv 8, D 128, S 2048, bf16,
    causal; its tensor-core path), at the served prompt (S 500), at S 1000
    with a 256 window (bf16 and f32) and at ragged small shapes, timed at
    S 2048 and S 500 beside SDPA; K7 at Mamba2-370m's (B 1, L 2048, H 32, P 64, G 1,
    N 128, chunk 256, bf16) and at a ragged L of 1000 in f32."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    rows = {}

    def attn_inputs(b, hq, hkv, s, d, dt):
        # q as the prefill hands it over: a (B, H, S, D) view of (B, S, H, D)
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dt).transpose(1, 2)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt) for _ in range(2))
        return q, k, v

    err6 = err6_p = 0.0
    for b, hq, hkv, s, d, window, dt in ((1, 32, 8, 2048, 128, None, torch.bfloat16),
                                         (1, 32, 8, 500, 128, None, torch.bfloat16),
                                         (1, 32, 8, 1000, 128, 256, torch.bfloat16),
                                         (2, 8, 2, 333, 64, None, torch.bfloat16),
                                         (1, 32, 8, 1000, 128, 256, torch.float32),
                                         (2, 4, 2, 77, 32, None, torch.float32)):
        q, k, v = attn_inputs(b, hq, hkv, s, d, dt)
        ops.reset_launch_counts()
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        tc = ops.launch_counts()["flash_attention_tc"]
        check(tc == (dt == torch.bfloat16), f"K6 {(b, hq, hkv, s, d, window, dt)}: {tc} "
              "tensor-core launches")
        e = max_err(out, ref.flash_attention_ref(q, k, v, causal=True, window=window))
        check(e <= FLASH_TOL[names[dt]], f"K6 {(b, hq, hkv, s, d, window, dt)}: max |err| {e}")
        msg = f"K6 check {(b, hq, hkv, s, d, window, names[dt])}: max |err| {e:.3e}"
        if dt == torch.bfloat16:
            # against the plain version that rounds P to bf16 as the kernel does
            model = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                            p_dtype=torch.bfloat16).float()
            over = float(((out.float() - model).abs() - flash_p_tol(torch, model)).max())
            e_p = max_err(out, model)
            check(over <= 0.0, f"K6 {(b, hq, hkv, s, d, window)}: max |err| {e_p} against the "
                  f"bf16-P plain version, {over} beyond one bf16 ulp + 2^-8")
            msg += (f" (f32 oracle, limit {FLASH_TOL['bfloat16']}); {e_p:.3e} against the bf16-P "
                    f"plain version (limit one bf16 ulp of it + 2^-8; margin {-over:.3e}); "
                    "tensor cores")
            err6_p = max(err6_p, e_p)
            del model
        log(msg)
        err6 = max(err6, e)
        del q, k, v, out

    def k6_times(s):
        """K6 (bf16, causal) at Qwen3-8B's heads and S: CUDA-event ms per call
        back to back, device ms (profiler), and the same for SDPA."""
        q, k, v = attn_inputs(1, 32, 8, s, 128, torch.bfloat16)
        nb, fl = flash_cost(1, 32, 8, s, s, 128, None, 2)
        b_ms, b_by = bound_ms(nb, fl, BF16_FLOP_PER_S)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        e_lib = max_err(lib(), ref.flash_attention_ref(q, k, v, causal=True))
        check(e_lib <= FLASH_TOL["bfloat16"], f"SDPA disagrees with the plain version: {e_lib}")
        kern = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
        t = dict(ms=time_ms(torch, kern, iters=20), device_ms=device_ms(torch, kern),
                 plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True),
                                  iters=3),
                 library_ms=time_ms(torch, lib, iters=20), library_device_ms=device_ms(torch, lib),
                 bound_ms=b_ms, bound_by=b_by, gflop=fl / 1e9, mbytes=nb / 1e6)
        return t

    full = k6_times(2048)
    served = k6_times(500)
    rows["flash_attention"] = dict(
        shape=[1, 32, 8, 2048, 128], dtype="bfloat16", max_abs_err=err6,
        max_abs_err_p_bf16=err6_p, **full,
        served_shape=[1, 32, 8, 500, 128], **{f"served_{k_}": v_ for k_, v_ in served.items()},
        f32_window_ms=None,
    )
    q, k, v = attn_inputs(1, 32, 8, 1000, 128, torch.float32)
    rows["flash_attention"]["f32_window_ms"] = time_ms(
        torch, lambda: ops.flash_attention(q, k, v, causal=True, window=256))
    del q, k, v

    def ssd_inputs(b, l, h, p, g, n, dt):
        x = torch.randn(b, l, h, p, generator=gen, device=dev).to(dt)
        # softplus(dt) of the model lies in [dt_min, dt_max] = [0.001, 0.1]
        dtt = (0.001 + 0.099 * torch.rand(b, l, h, generator=gen, device=dev)).to(dt)
        a = -(1.0 + 15.0 * torch.rand(h, generator=gen, device=dev))  # A = -[1, 16]
        bm, cm = (torch.randn(b, l, g, n, generator=gen, device=dev).to(dt) for _ in range(2))
        return x, dtt, a, bm, cm

    # "strong": dt = 0.1 and A = -16, so a 64-step chunk decays by e^-102
    # (exp(-cum) overflows f32); L = 1 and 65 sit at the kernel's 64-step chunk
    err7 = 0.0
    for b, l, h, p, g, n, dt, strong in ((1, 2048, 32, 64, 1, 128, torch.bfloat16, False),
                                         (1, 1000, 32, 64, 1, 128, torch.bfloat16, False),
                                         (1, 1000, 32, 64, 1, 128, torch.float32, False),
                                         (2, 77, 8, 32, 2, 16, torch.float32, False),
                                         (2, 77, 8, 32, 2, 16, torch.bfloat16, False),
                                         (1, 1, 32, 64, 1, 128, torch.bfloat16, False),
                                         (1, 65, 32, 64, 1, 128, torch.bfloat16, False),
                                         (1, 1000, 32, 64, 1, 128, torch.bfloat16, True),
                                         (1, 1000, 32, 64, 1, 128, torch.float32, True)):
        args = ssd_inputs(b, l, h, p, g, n, dt)
        if strong:
            args = (args[0], torch.full_like(args[1], 0.1), torch.full_like(args[2], -16.0),
                    *args[3:])
        ops.reset_launch_counts()
        y, hf = ops.ssd_scan(*args, chunk=256)
        check(ops.launch_counts()["ssd_scan"] == 1, "K7: one launch counted per call")
        y2, hf2 = ref.ssd_scan_ref(*args, chunk=256)
        check(bool(torch.isfinite(y.float()).all() and torch.isfinite(hf).all()),
              f"K7 {(b, l, h, p, g, n, dt, strong)}: non-finite output")
        ey = max_err(y, y2) / (1.0 + float(y2.float().abs().max()))
        eh = max_err(hf, hf2) / (1.0 + float(hf2.abs().max()))
        check(ey <= SSD_TOL[names[dt]] and eh <= SSD_TOL["float32"],
              f"K7 {(b, l, h, p, g, n, dt, strong)}: scaled max |err| y {ey}, state {eh}")
        log(f"K7 check {(b, l, h, p, g, n, names[dt])}{' strong decay' if strong else ''}: "
            f"max |err| / (1 + max |plain|) y {ey:.3e} (limit {SSD_TOL[names[dt]]:.3e}), "
            f"state {eh:.3e}")
        err7 = max(err7, max_err(y, y2), max_err(hf, hf2))
        del args, y, hf, y2, hf2
    args = ssd_inputs(1, 2048, 32, 64, 1, 128, torch.bfloat16)
    nb, fl = ssd_cost(1, 2048, 32, 64, 1, 128, 256, 2)
    b_ms, b_by = bound_ms(nb, fl, BF16_FLOP_PER_S)
    rows["ssd_scan"] = dict(
        shape=[1, 2048, 32, 64, 1, 128], dtype="bfloat16", max_abs_err=err7,
        ms=time_ms(torch, lambda: ops.ssd_scan(*args, chunk=256)),
        device_ms=device_ms(torch, lambda: ops.ssd_scan(*args, chunk=256)),
        plain_ms=time_ms(torch, lambda: ref.ssd_scan_ref(*args, chunk=256), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    del args
    torch.cuda.empty_cache()
    for name in ("flash_attention", "ssd_scan"):
        log(f"kernel {name}: {json.dumps(rows[name])}")
    return rows


# ---------------------------------------------------------------------------
# Phase 1c: the collective path's kernels (K8, K9, K2's one-row form)
# ---------------------------------------------------------------------------

# One agent's in_proj leaf of Mamba2-370m (d_model 1024 x (2 * 2048 + 2 * 128
# + 32) = 4384 per layer, 48 layers): the largest leaf the collective path
# mixes, one row of 215.5 M elements per rank.
IN_PROJ = (48, 1024, 4384)


def collective_kernel_checks(torch, dev, rows):
    """K8 (both forms), K9 (deterministic, stochastic, with and without a
    residual) and K2's one-row form at the in_proj leaf in bf16 and f32, and
    at ragged shapes; each must equal its plain version bit for bit (same
    roundings, f32 math).  Times the forms the collective path runs: K8 from
    x_half with the f32 wire, K9 and K2 with the error-feedback residual, all
    over bf16 state.  Adds K8 and K9 to ``rows`` and the one-row numbers to
    K2's row."""
    import math

    from repro_torch.kernels import ops, ref

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    n = math.prod(IN_PROJ)

    def randn(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    # K8: (shape, state dtype, wire dtype, with y_to (the reference's form), with right)
    err8 = 0.0
    for shape, dt, wire, has_y, has_r in ((IN_PROJ, bf16, bf16, True, True),
                                          (IN_PROJ, bf16, f32, False, True),
                                          (IN_PROJ, f32, f32, False, True),
                                          ((1001, 3), bf16, f32, False, False),
                                          ((7,), f32, f32, True, True)):
        xk, xt = randn(shape, dt), randn(shape, dt)
        yt = randn(shape, dt) if has_y else None
        left, right = randn(shape, wire), (randn(shape, wire) if has_r else None)
        coef = (0.9, 0.01 if has_y else 0.0, 0.5, 0.25, 0.25 if has_r else 0.0)
        got = ops.fused_mix_combine(xk, xt, yt, left, right, eta_c=coef[0], eta_l=coef[1],
                                    w_self=coef[2], w_left=coef[3], w_right=coef[4]) \
            if has_y else ops.mix_combine_half(xk, xt, left, right, eta_c=coef[0],
                                               w_self=coef[2], w_left=coef[3], w_right=coef[4])
        want = ref.fused_mix_combine_ref(xk, xt, yt, left, right, *coef)
        e = max_err(got, want)
        check(e == 0.0 and got.dtype == dt, f"K8 {shape} {dt} wire {wire}: max |err| {e}")
        err8 = max(err8, e)
        del xk, xt, yt, left, right, got, want
    torch.cuda.empty_cache()
    xk, xh, yt = randn(IN_PROJ, bf16), randn(IN_PROJ, bf16), randn(IN_PROJ, bf16)
    left, right = randn(IN_PROJ, f32), randn(IN_PROJ, f32)
    lb, rb = left.to(bf16), right.to(bf16)
    path = lambda: ops.mix_combine_half(xk, xh, left, right, eta_c=1.0, w_self=0.5,  # noqa: E731
                                        w_left=0.25, w_right=0.25)
    jax_form = lambda: ops.fused_mix_combine(  # noqa: E731
        xk, xh, yt, lb, rb, eta_c=1.0, eta_l=0.01, w_self=0.5, w_left=0.25, w_right=0.25)
    # path: x_k, x_half and the output in bf16, both neighbours in f32
    b_ms, b_by = bound_ms((3 * 2 + 2 * 4) * n, 7 * n)
    j_ms, j_by = bound_ms(6 * 2 * n, 9 * n)
    rows["fused_mix_combine"] = dict(
        shape=list(IN_PROJ), dtype="bfloat16 state, float32 wire", max_abs_err=err8,
        ms=time_ms(torch, path), bound_ms=b_ms, bound_by=b_by,
        plain_ms=time_ms(torch, lambda: ref.fused_mix_combine_ref(
            xk, xh, None, left, right, 1.0, 0.0, 0.5, 0.25, 0.25), iters=3),
        library_ms=None, jax_form_ms=time_ms(torch, jax_form), jax_form_bound_ms=j_ms,
    )
    del xk, xh, yt, left, right, lb, rb
    torch.cuda.empty_cache()

    # K9 and K2: (rows, columns, dtype, bits, residual, noise)
    err9 = err2 = 0.0
    for r_, d, dt, bits, with_res, with_noise in ((1, n, bf16, 8, True, False),
                                                  (1, n, f32, 8, True, True),
                                                  (1, n, bf16, 8, False, False),
                                                  (3, 100_003, bf16, 4, True, True),
                                                  (5, 7, f32, 8, False, False)):
        x = randn((r_, d), dt)
        res = randn((r_, d), dt, 0.01) if with_res else None
        noise = torch.rand((r_, d), generator=gen, device=dev) if with_noise else None
        am = ops.row_absmax(x, res)
        e2 = max_err(am, ref.row_absmax_ref(x, res))
        check(e2 == 0.0, f"K2 one-row ({r_}, {d}) {dt}: max |err| {e2} (must be exact)")
        q, r_new = ops.rowwise_quant_dequant(x, am, bits=bits, residual=res, noise=noise)
        q2, r2 = ref.rowwise_quant_dequant_ref(x, am, bits, res, noise)
        e9 = max(max_err(q, q2), max_err(r_new, r2) if with_res else 0.0)
        check(e9 == 0.0 and q.dtype == dt, f"K9 ({r_}, {d}) {dt} q{bits}: max |err| {e9}")
        err2, err9 = max(err2, e2), max(err9, e9)
        del x, res, noise, am, q, r_new, q2, r2
    torch.cuda.empty_cache()
    x, res = randn((1, n), bf16), randn((1, n), bf16, 0.01)
    am = ops.row_absmax(x, res)
    m = (x.float() + res.float()).to(bf16)
    b9_ms, b9_by = bound_ms(4 * 2 * n, 6 * n)  # read x, r; write q, r'
    p9_ms, _ = bound_ms(2 * 2 * n, 5 * n)  # the Pallas kernel's form: read x, write q
    rows["rowwise_quant_dequant"] = dict(
        shape=[1, n], dtype="bfloat16", max_abs_err=err9,
        ms=time_ms(torch, lambda: ops.rowwise_quant_dequant(x, am, bits=8, residual=res)),
        bound_ms=b9_ms, bound_by=b9_by,
        plain_ms=time_ms(torch, lambda: ref.rowwise_quant_dequant_ref(x, am, 8, res), iters=3),
        library_ms=None,
        no_residual_ms=time_ms(torch, lambda: ops.rowwise_quant_dequant(x, am, bits=8)),
        no_residual_bound_ms=p9_ms,
    )
    # the library yardstick: fake_quantize over one channel (the row) is the
    # per-row symmetric round trip clamp(rint(x / s)) * s of the reference's
    # form (no residual), timed on the float32 row beside K9's same form; it
    # multiplies by 1 / s, so at a tie it may land one step from K9
    xf = x.float()
    amf = ops.row_absmax(xf)
    scale = amf / torch.full_like(amf, 127.0)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    library = lambda: torch.fake_quantize_per_channel_affine(  # noqa: E731
        xf, scale, zero, 0, -127, 127)
    lib_steps = float((library() - ops.rowwise_quant_dequant(xf, amf, bits=8)[0]).abs().max()
                      / scale)
    check(lib_steps <= 1.0 + 1e-3, f"K9's library yardstick is {lib_steps} steps off")
    rows["rowwise_quant_dequant"].update(
        library_ms=time_ms(torch, library), library_max_steps=lib_steps,
        library_form="torch.fake_quantize_per_channel_affine, float32 row, no residual",
        f32_no_residual_ms=time_ms(torch, lambda: ops.rowwise_quant_dequant(xf, amf, bits=8)),
        f32_no_residual_bound_ms=bound_ms(2 * 4 * n, 5 * n)[0],
    )
    del xf, amf, scale, zero
    b2_ms, _ = bound_ms(2 * 2 * n + 4, 2 * n)
    b20_ms, _ = bound_ms(2 * n + 4, n)
    rows["row_absmax"].update(
        one_row_shape=[1, n], one_row_dtype="bfloat16", one_row_max_abs_err=err2,
        one_row_ms=time_ms(torch, lambda: ops.row_absmax(x, res), iters=20),
        one_row_bound_ms=b2_ms,
        one_row_plain_ms=time_ms(torch, lambda: ref.row_absmax_ref(x, res), iters=3),
        # the fair pair over one m: K2 without the residual, vector_norm
        one_row_no_residual_ms=time_ms(torch, lambda: ops.row_absmax(m), iters=20),
        one_row_no_residual_bound_ms=b20_ms,
        one_row_library_ms=time_ms(
            torch, lambda: torch.linalg.vector_norm(m, ord=float("inf"), dim=1), iters=20),
        one_row_no_residual_device_ms=device_ms(torch, lambda: ops.row_absmax(m)),
        one_row_library_device_ms=device_ms(
            torch, lambda: torch.linalg.vector_norm(m, ord=float("inf"), dim=1)),
    )
    del x, res, am, m
    torch.cuda.empty_cache()
    for name in ("fused_mix_combine", "rowwise_quant_dequant", "row_absmax"):
        log(f"kernel {name}: {json.dumps(rows[name])}")


# ---------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------

# (arch, agents, delta fraction, slots, requests, prompt length, new tokens)
SERVE = {"serve-qwen3-8b": ("qwen3-8b", 4, 0.001, 2, 6, 500, 16),
         "serve-mamba2-370m": ("mamba2-370m", 8, 0.02, 4, 12, 1000, 32)}
SERVE_ARRIVAL = "poisson:rate=4"


def serve_run(torch, dev, label, bundle, fleet, mode="admit", count=True):
    """One served trace (measured engine time): token streams, the report,
    and, when ``count``, the launch counts of this run alone."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (ArrivalProcess, ContinuousBatcher, DecodeEngine,
                                   make_requests, run_load)

    _, _, _, slots, n_req, prompt_len, gen = SERVE[label]
    engine = DecodeEngine(bundle, fleet, n_slots=slots, max_seq=prompt_len + gen + 8,
                          materialize=mode)
    reqs = make_requests(ArrivalProcess.parse(SERVE_ARRIVAL), n_req, n_agents=fleet.n_agents,
                         vocab_size=bundle.cfg.vocab_size, prompt_len=prompt_len,
                         max_new_tokens=gen, seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = run_load(ContinuousBatcher(engine), reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(len(rep.requests) == n_req and all(len(r.tokens) == gen for r in rep.requests),
          f"{label} ({mode}): {len(rep.requests)} requests served")
    return engine, rep, {r.rid: list(r.tokens) for r in rep.requests}, (counts if count else None)


def serve_report(torch, dev, label, engine, rep, card, kernel=None):
    """The path's end-to-end numbers, with decode ms per step measured over
    steps of the full slot batch after the run, then one traced prefill
    and four traced decode steps (device busy share, heaviest device ops).
    ``kernel`` = (name, substring of its device symbol): its share of the
    traced prefill's device time is logged too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = [0] * engine.n_slots
    engine.step(toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step(toks)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 8
    req = min(rep.requests, key=lambda r: r.rid)
    for what, fn, n in (("prefill", lambda: engine.admit(0, req.agent_id, req.prompt), 1),
                        ("decode", lambda: [engine.step(toks) for _ in range(4)], 4)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        window, busy, top = device_share(prof, f"{label} {what}")
        log(f"profile {label} {what}: window {window / 1e3 / n:.3f} ms per call, device busy "
            f"{100.0 * busy / window:.1f}% (idle {100.0 - 100.0 * busy / window:.1f}%), "
            f"device time {busy / 1e3 / n:.3f} ms per call")
        for name, us in top[:10]:
            log(f"profile {label} {what}:   {us / 1e3 / n:8.3f} ms  {name[:100]}")
        if kernel is not None and what == "prefill":
            k_us = sum(us for name, us in top if kernel[1] in name)
            k_n = sum(1 for e in prof.events() if kernel[1] in e.name and e.device_type
                      == DeviceType.CUDA)
            log(f"profile {label} prefill: {kernel[0]} {k_us / 1e3:.3f} ms in {k_n} kernel "
                f"launches, {100.0 * k_us / busy:.1f}% of the prefill's {busy / 1e3:.3f} ms "
                "device time")
    log(f"path {label}: {rep.total_tokens} tokens from {len(rep.requests)} requests, "
        f"{rep.tokens_per_s:.3f} tokens/s, p50 {1e3 * rep.p50_s:.3f} ms, "
        f"p99 {1e3 * rep.p99_s:.3f} ms, prefill {1e3 * rep.mean('prefill_s'):.3f} ms/request, "
        f"decode {step_ms:.3f} ms/step ({engine.n_slots} slots), "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, on {card}")


def serve_paths(torch, dev, card):
    import numpy as np

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import (ArrivalProcess, ContinuousBatcher, DecodeEngine, FleetDelta,
                                   StepCosts, make_requests, materialize_fleet, run_load)
    from repro_torch.utils.pytree import nest_leaves, nest_map

    launches = {}

    # -- serve-qwen3-8b: full width, bf16, flash attention on every layer -----
    label = "serve-qwen3-8b"
    arch, n_agents, frac = SERVE[label][:3]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    bundle = get_bundle(get_config(arch), dev)
    base = bundle.init(seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fleet = FleetDelta.synthetic(base, n_agents, fraction=frac, seed=0)
    torch.cuda.synchronize()
    log(f"{label}: {bundle.cfg.param_count() / 1e9:.3f} B parameters drawn in {t1 - t0:.1f} s, "
        f"fleet of {n_agents} ({fleet.spec.name}) in {time.perf_counter() - t1:.1f} s: "
        f"{fleet.nbytes() / 1e9:.3f} GB vs {fleet.naive_nbytes() / 1e9:.3f} GB naive")
    engine, rep, tokens, counts = serve_run(torch, dev, label, bundle, fleet)
    n_attn = bundle.cfg.layer_kinds().count("attn")
    for name in ("flash_attention", "flash_attention_tc"):  # bf16: every K6 on the tensor cores
        check(counts[name] == n_attn * len(rep.requests),
              f"{label}: {counts[name]} {name} launches for {len(rep.requests)} admissions")
    launches["flash_attention"] = counts["flash_attention"]
    log(f"{label}: launches {counts} ({n_attn} K6 per admitted request, "
        f"{counts['flash_attention_tc']} of {counts['flash_attention']} on the tensor cores)")
    serve_report(torch, dev, label, engine, rep, card, kernel=("K6", "flash_fwd"))
    first = min(rep.requests, key=lambda r: r.rid)
    kern = engine.admit(0, first.agent_id, first.prompt)
    plain = engine.admit(0, first.agent_id, first.prompt, use_kernels=False)
    check(bool(np.isfinite(kern).all()) and kern.shape == (bundle.cfg.vocab_size,),
          f"{label}: prefill logits")
    e = float(np.abs(kern - plain).max()) / (1.0 + float(np.abs(plain).max()))
    top2 = np.sort(plain)[-2:]
    log(f"{label}: request {first.rid} prefill logits, K6 vs plain on the card: "
        f"max |err| / (1 + max |logit|) {e:.3e} (limit {PREFILL_LOGIT_TOL}); greedy token "
        f"{int(np.argmax(kern))} vs {int(np.argmax(plain))} (served {first.tokens[0]}), "
        f"top-2 margin {float(top2[1] - top2[0]):.4f}")
    check(e <= PREFILL_LOGIT_TOL, f"{label}: prefill logits differ by {e}")
    check(int(np.argmax(kern)) == int(np.argmax(plain)) == first.tokens[0],
          f"{label}: greedy first tokens differ")
    del engine, fleet, base, bundle
    torch.cuda.empty_cache()

    # -- serve-mamba2-370m: SSD scan on every layer; admit / step / dense ----
    label = "serve-mamba2-370m"
    arch, n_agents, frac = SERVE[label][:3]
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = get_bundle(get_config(arch), dev)
    base = bundle.init(seed=0)
    t1 = time.perf_counter()
    fleet = FleetDelta.synthetic(base, n_agents, fraction=frac, seed=0)
    torch.cuda.synchronize()
    log(f"{label}: {bundle.cfg.param_count() / 1e9:.3f} B parameters, fleet of {n_agents} "
        f"({fleet.spec.name}) in {time.perf_counter() - t1:.1f} s: "
        f"{fleet.nbytes() / 1e9:.3f} GB vs {fleet.naive_nbytes() / 1e9:.3f} GB naive")
    engine, rep, tokens, counts = serve_run(torch, dev, label, bundle, fleet)
    n_ssm = bundle.cfg.layer_kinds().count("mamba")
    check(counts["ssd_scan"] == n_ssm * len(rep.requests),
          f"{label}: {counts['ssd_scan']} K7 launches for {len(rep.requests)} admissions")
    launches["ssd_scan"] = counts["ssd_scan"]
    log(f"{label}: launches {counts} ({n_ssm} K7 per admitted request)")
    serve_report(torch, dev, label, engine, rep, card, kernel=("K7", "ssd_"))
    del engine
    _, rep_step, tokens_step, _ = serve_run(torch, dev, label, bundle, fleet, "step", False)
    dense = materialize_fleet(fleet)
    _, rep_dense, tokens_dense, _ = serve_run(torch, dev, label, bundle, dense, "admit", False)
    check(tokens == tokens_step == tokens_dense,
          f"{label}: admit, step and dense token streams differ")
    log(f"{label}: admit, step and dense ({dense.nbytes() / 1e9:.3f} GB) token streams "
        f"bit-identical over {rep.total_tokens} tokens; step mode {rep_step.tokens_per_s:.3f} "
        f"tokens/s, dense {rep_dense.tokens_per_s:.3f} tokens/s")
    del dense, fleet, base, bundle
    torch.cuda.empty_cache()

    # -- serve-reduced: both models at reduced width, f32, card against CPU --
    cpu = torch.device("cpu")
    for arch in ("qwen3-8b", "mamba2-370m"):
        cfg = get_reduced(arch)
        streams = []
        base_cpu = get_bundle(cfg, cpu).init(seed=0)
        for d in (dev, cpu):
            bundle = get_bundle(cfg, d)
            base = nest_map(lambda t: t.to(d), base_cpu)
            fleet = FleetDelta.synthetic(base, 4, seed=0)
            reqs = make_requests(ArrivalProcess.parse(SERVE_ARRIVAL), 6, n_agents=4,
                                 vocab_size=cfg.vocab_size, prompt_len=45, max_new_tokens=8,
                                 seed=0)
            eng = DecodeEngine(bundle, fleet, n_slots=2, max_seq=64)
            rep = run_load(ContinuousBatcher(eng), reqs, costs=StepCosts())
            streams.append({r.rid: r.tokens for r in rep.requests})
        check(streams[0] == streams[1], f"serve-reduced/{arch}: GPU and CPU tokens differ")
        check(len(nest_leaves(base_cpu)) > 0, "serve-reduced: empty parameters")
        log(f"compare serve-reduced/{arch}: greedy token streams equal on GPU and CPU "
            f"({sum(map(len, streams[0].values()))} tokens)")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: PISCO across ranks (spawned processes, one agent each)
# ---------------------------------------------------------------------------

# collective-mamba2-370m: TRAIN_4K's sequence, 4 agents (not 16) with 2
# sequences each (not 64: global batch 8, not 256), T_o = 2, eta_l = 1e-2,
# eta_c = 1, the f32 wire; "reduced" is collective-reduced's model and sizes.
COLLECTIVE = dict(world=4, arch="mamba2-370m", reduced=False, dtype="bfloat16", seq=4096,
                  batch=2, t_o=2, eta_l=1e-2, eta_c=1.0, wire="float32",
                  reduced_seq=64, reduced_batch=2, reduced_rounds=3)
# collective-reduced, card against CPU: f32 round losses within 1e-4 relative
# and the final x within 1e-4 of its largest magnitude (cuBLAS and the CPU
# sum in other orders over three rounds); with int8 gossip (q8d) a few
# elements may round to the neighbouring grid point at a tie: x within two
# int8 steps and losses within 1e-3 (PATH_LOSS_RTOL's q8d limit).  The
# stochastic q8 mixer draws its noise on each device, so the card and the CPU
# round apart: both are held to the invariants of _stochastic_invariants.
COLLECTIVE_TOL = {"exact": 1e-4, "q8": 1e-3}


def _stats_all_reduce(torch, t, op):
    """``t`` reduced over every rank with ``op``, through the host (gloo)."""
    import torch.distributed as dist

    host = t.detach().to("cpu", torch.float32)
    dist.all_reduce(host, op=op)
    return host


def _rank_invariants(torch, label, state, n_ranks, what):
    """Lemma 1 on this state: mean over ranks of y equals that of g, within
    2^-5 of the leaf's largest |y| (about fifteen bf16 roundings of 2^-9 over
    three rounds; exact up to f32 rounding in f32)."""
    import torch.distributed as dist

    worst = 0.0
    for k in sorted(state.y):
        sy = _stats_all_reduce(torch, state.y[k], dist.ReduceOp.SUM)
        sg = _stats_all_reduce(torch, state.g[k], dist.ReduceOp.SUM)
        ymax = float(_stats_all_reduce(torch, state.y[k].abs().amax(), dist.ReduceOp.MAX))
        dev = float((sy - sg).abs().max()) / n_ranks
        tol = (2.0 ** -5 if state.y[k].dtype == torch.bfloat16 else 1e-5) * ymax
        check(dev <= tol, f"{label} {what}: Lemma 1 off by {dev} on {k} (limit {tol})")
        worst = max(worst, dev / max(ymax, 1e-30))
        check(bool(torch.isfinite(state.x[k]).all() and torch.isfinite(state.y[k]).all()),
              f"{label} {what}: non-finite state in {k}")
    return worst


def _stochastic_invariants(torch, label, mixing, state, n_ranks):
    """One stochastic int8 gossip of x with this state's residual and noise
    generator, held to what holds for any draw of the noise: the sum over
    ranks is kept (to float32 rounding), each message q = m - r' lies on its
    leaf's int8 grid within one step of m = x + r, and some elements rounded
    away from the nearest grid point (noise was drawn).  Returns the largest
    sum deviation as a share of its limit and the share rounded away."""
    import torch.distributed as dist

    qmax = 2 ** (mixing.compression.compressor.bits - 1) - 1
    out, res = mixing.compression(state.x, state.ef["x"], state.ef["gen"])
    used, away, total = 0.0, 0, 0
    for k in sorted(state.x):
        m = state.x[k].float() + state.ef["x"][k].float()
        before = _stats_all_reduce(torch, state.x[k], dist.ReduceOp.SUM)
        after = _stats_all_reduce(torch, out[k], dist.ReduceOp.SUM)
        vmax = float(_stats_all_reduce(torch, torch.stack(
            [m.abs().amax(), out[k].abs().amax()]).amax(), dist.ReduceOp.MAX))
        tol = n_ranks * 2.0 ** -18 * vmax + 1e-30  # 64 float32 ulps a rank
        d = float((after - before).abs().max())
        check(d <= tol, f"{label}: stochastic q8 gossip moved the sum of x/{k} by {d} "
                        f"(limit {tol})")
        used = max(used, d / tol)
        s = float(m.abs().max()) / qmax
        steps = (m - res[k].float()) / s
        grid = torch.round(steps)
        off = float((steps - grid).abs().max())
        check(off <= 1e-3 and float(grid.abs().max()) <= qmax
              and float(res[k].abs().max()) <= s * (1 + 1e-3),
              f"{label}: stochastic q8 message of x/{k} is off its grid by {off} steps")
        away += int((grid != torch.round(m / s)).sum())
        total += m.numel()
    check(away > 0.01 * total, f"{label}: stochastic q8 rounded {away} of {total} elements "
                               "away from the nearest grid point")
    return used, away / total


def _collective_run(torch, spec, dev, label, full):
    """One collective path on this rank: build the model and the mesh, run
    the rounds, return what the parent reports and checks."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.core import mixing as M
    from repro_torch.core.compression import StochasticQuantizer, compress_mixing
    from repro_torch.core.pisco import (PiscoConfig, init_compression_state, init_rank_state,
                                        make_rank_round_fn)
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, rank_slice
    from repro_torch.launch.steps import build_train_steps, flat_value_and_grad
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths

    world = spec["world"]
    cfg = (get_reduced(spec["arch"]) if spec["reduced"] or not full
           else get_config(spec["arch"], spec["dtype"]))
    seq, batch = (spec["seq"], spec["batch"]) if full else (spec["reduced_seq"],
                                                           spec["reduced_batch"])
    bundle = get_bundle(cfg, dev)
    vg = flat_value_and_grad(bundle)
    mesh = make_mesh((world, 1), ("data", "model"), dev)
    agent = ("data",)
    shape = dataclasses.replace(TRAIN_4K, seq_len=seq, global_batch=world * batch)
    steps = build_train_steps(bundle, shape, mesh, t_o=spec["t_o"], eta_l=spec["eta_l"],
                              eta_c=spec["eta_c"], wire_dtype=spec["wire"])
    pcfg = PiscoConfig(world, spec["t_o"], spec["eta_l"], spec["eta_c"])
    sampler = make_lm_sampler(cfg, world, batch, seq, spec["t_o"], seed=0)
    rounds = 3 if full else spec["reduced_rounds"]
    batches = [tuple(rank_slice(b, mesh, agent, axis=1 - i, device=dev)
                     for i, b in enumerate(sampler(k))) for k in range(rounds + 1)]
    # the full-width weights are drawn on the card; the reduced ones on the
    # CPU, so that the card's and the CPU's runs start from the same point
    x0 = flatten_paths(bundle.init(seed=0) if full else
                       get_bundle(cfg, "cpu").init(seed=0))
    x0 = {k: v.to(dev) for k, v in x0.items()}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = {"losses": {}, "rounds": {}}

    if full:
        gossip, glob = steps["train_gossip"], steps["train_global"]
        cmix = M.compressed_mixing(gossip.mixing, bits=8)
        q8d = make_rank_round_fn(vg, pcfg, cmix, global_round=False)
        plan = [("gossip", gossip.fn), ("global", glob.fn), ("gossip-q8d", q8d)]
        out["n_leaves"] = len(x0)
        state = init_rank_state(vg, x0, batches[0][1])
        del x0
        mesh.clock.on = True
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        ops.reset_launch_counts()
        for k, (kind, fn) in enumerate(plan, start=1):
            if kind == "gossip-q8d":
                state = init_compression_state(state, cmix)
            mesh.clock.reset()
            sync()
            t0 = time.perf_counter()
            state, loss = fn(state, *batches[k])
            sync()
            wall = time.perf_counter() - t0
            secs = dict(mesh.clock.seconds)
            out["rounds"][kind] = dict(
                ms=1e3 * wall, local_ms=1e3 * secs.get("local", 0.0),
                exchange_ms=1e3 * secs.get("exchange", 0.0),
                combine_ms=1e3 * (secs.get("mix", 0.0) - secs.get("exchange", 0.0)),
                bytes_sent=mesh.clock.bytes_sent)
            out["losses"][kind] = float(loss)
            check(np.isfinite(float(loss)), f"{label}: {kind} loss {float(loss)}")
            if kind == "global":  # x bit-equal on every rank after the server round
                for name, v in state.x.items():
                    hi = _stats_all_reduce(torch, v, dist.ReduceOp.MAX)
                    lo = _stats_all_reduce(torch, v, dist.ReduceOp.MIN)
                    check(torch.equal(hi, lo), f"{label}: x/{name} differs across ranks "
                                               "after the server round")
            out["rounds"][kind]["lemma1"] = _rank_invariants(torch, label, state, world, kind)
        sync()
        out["launches"] = ops.launch_counts()
        mesh.clock.on = False
        if dev.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            free, total = torch.cuda.mem_get_info(dev)
            out["card_used_gib"] = (total - free) / 2**30
        # one traced gradient call of rank 0 at the round's shapes while the
        # others wait: where the local phase's time goes on the card
        dist.barrier()
        if mesh.rank == 0 and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                vg(state.x, batches[1][1])
                sync()
            window, busy, top = device_share(prof, label)
            out["profile"] = dict(window_ms=window / 1e3, busy_ms=busy / 1e3,
                                  top=[(name[:90], us / 1e3) for name, us in top[:10]])
        dist.barrier()
        # ring gossip preserves the mean over ranks (checks, not the main path):
        # x through the round's fused candidate combine, y through the mixer,
        # and the candidate 0.3 x + 0.7 y (eta_c = 0.7, y standing in for
        # x_half) through the fused combine, against its float32 value
        ring = gossip.mixing

        def cand(name):
            return 0.3 * state.x[name].float() + 0.7 * state.y[name].float()

        for stream, mix, before_of in (
                ("x", lambda: M.mix_candidate(ring, state.x, state.x, 1.0), state.x.get),
                ("y", lambda: ring.gossip(state.y), state.y.get),
                ("cand", lambda: M.mix_candidate(ring, state.x, state.y, 0.7), cand)):
            mixed, worst = mix(), 0.0
            for name in sorted(mixed):
                v = before_of(name)
                before = _stats_all_reduce(torch, v, dist.ReduceOp.SUM)
                after = _stats_all_reduce(torch, mixed[name], dist.ReduceOp.SUM)
                vmax = float(_stats_all_reduce(torch, v.abs().amax(), dist.ReduceOp.MAX))
                # each rank's output rounds once to bf16 (2^-9 relative at most)
                tol = world * 2.0 ** -8 * vmax + 1e-30
                d = float((after - before).abs().max())
                check(d <= tol, f"{label}: ring gossip moved the sum of {stream}/{name} by {d} "
                                f"(limit {tol})")
                worst = max(worst, d / tol)
                del v
            out[f"mean_{stream}_used_of_limit"] = worst
            del mixed
        return out

    # collective-reduced: six mixers, three rounds each (gossip, server, gossip)
    shifts = {"data": [(0, 0.5), (1, 0.25), (-1, 0.25)]}
    ring = steps["train_gossip"].mixing
    torus_mesh = make_mesh((2, 2), ("pod", "data"), dev)
    torus = M.collective_shift_mixing(torus_mesh, ("pod", "data"),
                                      {"pod": [(0, 0.5), (1, 0.25)], "data": [(1, 0.25)]})
    mixers = {
        "ring": ring,
        "ring-q8d": M.compressed_mixing(M.collective_shift_mixing(mesh, agent, shifts), bits=8),
        "ring-q8": compress_mixing(M.collective_shift_mixing(mesh, agent, shifts),
                                   StochasticQuantizer(bits=8), seed=0),
        "torus": torus,
        "hierarchical": M.hierarchical_mixing(torus_mesh),
        "dense-er": M.collective_dense_mixing(
            mesh, agent, make_topology("erdos_renyi", world, prob=0.6, seed=3)),
    }
    state0 = init_rank_state(vg, x0, batches[0][1])
    ops.reset_launch_counts()
    for name, mixing in mixers.items():
        fns = {g: make_rank_round_fn(vg, pcfg, mixing, global_round=g) for g in (False, True)}
        state = init_compression_state(state0, mixing)
        losses = []
        for k in range(1, rounds + 1):
            state, loss = fns[k == 2](state, *batches[k])
            losses.append(float(loss))
            check(np.isfinite(losses[-1]), f"{label}/{name}: round {k} loss {losses[-1]}")
        out["losses"][name] = losses
        if name == "ring-q8":
            noisy = (mixing, state)
        else:
            out["rounds"][name] = {k: v.detach().cpu() for k, v in state.x.items()}
    out["launches"] = ops.launch_counts()
    out["ring-q8"] = _stochastic_invariants(torch, f"{label}/ring-q8", *noisy, world)
    return out


def _card_vs_cpu(torch, card, cpu):
    """Per deterministic mixer of collective-reduced: this rank's final x on
    the card against the CPU, as the largest deviation over its limit (see
    COLLECTIVE_TOL), and the round losses of both."""
    out = {}
    for name, xs in card["rounds"].items():
        lim = COLLECTIVE_TOL["q8" if "q8" in name else "exact"]
        used = 0.0
        for leaf, v in xs.items():
            want = cpu["rounds"][name][leaf]
            scale = float(want.abs().max())
            bound = (2 * scale / 127) if "q8" in name else lim * scale
            used = max(used, float((v - want).abs().max()) / max(bound, 1e-30))
        out[name] = dict(x_used_of_limit=used, card_losses=card["losses"][name],
                         cpu_losses=cpu["losses"][name])
    return out


def collective_rank(rank, spec, port, out_dir):
    """Body of one spawned rank: the collective-reduced paths on the card
    and on the CPU, then collective-mamba2-370m on the card; results go to
    ``out_dir/rank<r>.json``.  An exception fails the spawn, and the script."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    dev = resolve_device(spec["device"])
    if dev.type == "cuda":  # every rank on the one card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=spec["world"])
    try:
        card = _collective_run(torch, spec, dev, "collective-reduced", False)
        cpu = _collective_run(torch, spec, torch.device("cpu"), "collective-reduced", False)
        res = {"reduced": _card_vs_cpu(torch, card, cpu), "reduced_launches": card["launches"],
               "ring_q8": {"card": card["ring-q8"], "cpu": cpu["ring-q8"],
                           "card_losses": card["losses"]["ring-q8"]}}
        del card, cpu
        res["full"] = _collective_run(torch, spec, dev, "collective-mamba2-370m", True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def collective_paths(torch, dev, card, spec=None):
    """Spawn the ranks, then check and report what they return."""
    import socket
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    spec = dict(COLLECTIVE if spec is None else spec, device=str(dev))
    world = spec["world"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # each rank caches its own allocations: expandable segments keep four
    # caching allocators from fragmenting the one card
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(collective_rank, args=(spec, port, out_dir), nprocs=world,
                           join=True, start_method="spawn")
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
    log(f"collective: {world} ranks spawned and joined in {time.perf_counter() - t0:.1f} s")

    def summed(runs):
        out = {}
        for run in runs:
            for k, v in run["launches"].items():
                out[k] = out.get(k, 0) + v
        return out

    # -- collective-reduced: card against CPU -------------------------------
    for name in res[0]["reduced"]:
        lim = COLLECTIVE_TOL["q8" if "q8" in name else "exact"]
        g = np.array([r["reduced"][name]["card_losses"] for r in res])
        c = np.array([r["reduced"][name]["cpu_losses"] for r in res])
        rel = float(np.max(np.abs(g - c) / np.abs(c)))
        used = max(r["reduced"][name]["x_used_of_limit"] for r in res)
        log(f"compare collective-reduced/{name}: card vs CPU over {g.shape[1]} rounds on "
            f"{world} ranks, max relative loss deviation {rel:.3e} (limit {lim}), final x at "
            f"{used:.3f} of its limit")
        check(rel <= lim, f"collective-reduced/{name}: losses deviate by {rel} (limit {lim})")
        check(used <= 1.0, f"collective-reduced/{name}: final x past its limit ({used})")
    for where in ("card", "cpu"):
        used = max(r["ring_q8"][where][0] for r in res)
        away = min(r["ring_q8"][where][1] for r in res)
        log(f"check collective-reduced/ring-q8 on the {where}: one more stochastic int8 gossip "
            f"kept the sum of x within {used:.3f} of its limit, every message on its grid, "
            f"at least {100.0 * away:.1f}% of the elements rounded away from the nearest point")
    log(f"collective-reduced/ring-q8: card losses {res[0]['ring_q8']['card_losses']} (rank 0)")
    reduced_counts = summed([{"launches": r["reduced_launches"]} for r in res])
    log(f"collective-reduced: launches on the card, summed over ranks {reduced_counts}")

    # -- collective-mamba2-370m: full width ---------------------------------
    full = [r["full"] for r in res]
    label = "collective-mamba2-370m"
    counts = summed(full)
    for kind in full[0]["rounds"]:
        per = {k: float(np.mean([f["rounds"][kind][k] for f in full]))
               for k in ("ms", "local_ms", "exchange_ms", "combine_ms")}
        log(f"path {label} {kind}: {per['ms']:.3f} ms/round (mean over ranks; local "
            f"{per['local_ms']:.3f}, exchange {per['exchange_ms']:.3f}, combine "
            f"{per['combine_ms']:.3f}), {full[0]['rounds'][kind]['bytes_sent'] / 1e9:.3f} GB sent "
            f"per rank, loss {np.mean([f['losses'][kind] for f in full]):.6f}, Lemma 1 within "
            f"{max(f['rounds'][kind]['lemma1'] for f in full):.3e} of max |y|")
    if "profile" in full[0]:
        pr = full[0]["profile"]
        log(f"profile {label}: one gradient call of rank 0 alone (b {spec['batch']} x "
            f"{spec['seq']} tokens): window {pr['window_ms']:.3f} ms, device busy "
            f"{100.0 * pr['busy_ms'] / pr['window_ms']:.1f}%, device time {pr['busy_ms']:.3f} ms")
        for name, ms in pr["top"]:
            log(f"profile {label}:   {ms:9.3f} ms  {name}")
    peaks = [f.get("peak_gib", 0.0) for f in full]
    log(f"path {label}: peak device memory per rank "
        f"{', '.join(format(p, '.3f') for p in peaks)} GiB (sum {sum(peaks):.3f} GiB); card in "
        f"use after the rounds {full[0].get('card_used_gib', 0.0):.3f} GiB, on {card}")
    log(f"path {label}: launches summed over ranks {counts}; ring gossip kept the sum of x "
        f"within {max(f['mean_x_used_of_limit'] for f in full):.3f}, of y within "
        f"{max(f['mean_y_used_of_limit'] for f in full):.3f} and of the eta_c = 0.7 "
        f"candidate within {max(f['mean_cand_used_of_limit'] for f in full):.3f} of its limit")
    # the launch checks last (on the CPU, in a rehearsal, nothing launches)
    for k in ("fused_local_step", "fused_mix_combine", "row_absmax", "rowwise_quant_dequant"):
        check(reduced_counts.get(k, 0) > 0, f"collective-reduced: {k} not launched")
    for f in full:  # per rank: K8 once per leaf (gossip), K2 and K9 twice (q8d's x and y)
        n = f["n_leaves"]
        lc = f["launches"]
        check(lc["fused_mix_combine"] == n and lc["row_absmax"] == lc["rowwise_quant_dequant"]
              == 2 * n and lc["fused_local_step"] > 0,
              f"{label}: launches per rank {lc} for {n} leaves")
    return {k: counts.get(k, 0) for k in ("fused_local_step", "fused_mix_combine", "row_absmax",
                                         "rowwise_quant_dequant")}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {card}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.SOURCES)} sources in {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "Used" in line or "Performance" in line or (
                    name == "flash_attention" and "Compiling entry" in line):
                log(f"ptxas {name}: {line.strip()}")

    rows = kernel_checks(torch, dev)
    rows.update(lm_kernel_checks(torch, dev))
    collective_kernel_checks(torch, dev, rows)
    launches = main_path(torch, dev)
    for k, v in figures_paths(torch, dev).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in dynamic_paths(torch, dev).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in async_paths(torch, dev).items():
        launches[k] = launches.get(k, 0) + v
    launches.update(serve_paths(torch, dev, card))
    for k, v in collective_paths(torch, dev, card).items():
        launches[k] = launches.get(k, 0) + v
    for name, _, _ in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")

    # each row: max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by and
    # shape, plus K5's stateless-form and noise times and K6's f32 window time
    kernels = [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **rows[name])
        for name, source, replaces in KERNELS
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
