#!/usr/bin/env python3
"""GPU check of the PyTorch port (``src/repro_torch``): run from the repo root,

    python3 chip_smoke.py

on a machine with one NVIDIA H100 and the CUDA toolkit.  It

1. builds the seven hand-written Hopper kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
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
4. serves the two decoder-only models that fit the card at full width, in
   bf16, through ``FleetDelta.synthetic`` -> ``DecodeEngine`` ->
   ``ContinuousBatcher`` -> ``run_load``: Qwen3-8B ("serve-qwen3-8b": flash
   attention, K6, 36 launches per admitted request; its prefill logits held
   against the plain versions on the card) and Mamba2-370m
   ("serve-mamba2-370m": the SSD scan, K7, 48 launches per request; admit,
   step and dense-fleet token streams bit-identical), then both models at
   their reduced widths on the card and on the CPU ("serve-reduced");
5. prints the card's name and power limit, one JSON line of per-kernel
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
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:117"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:106"),
)

# Tolerances of the on-card kernel checks.  K1 and K2 compute the same
# roundings as their plain versions and must match exactly, as must the
# quantizer grid of K3 and K5 (checked through the residual r' = m - q).
# K3's W^T q and the neighbour sums of K4 and K5 add in another order than
# cuBLAS / index_add_ (whose atomics have no fixed order):
# max |err| <= TOL * (1 + max |input|).
MIX_TOL = 2e-5
# K6 against its plain version (the ROADMAP's): f32 2e-6 absolute (online
# against one-pass softmax); bf16 2e-2 absolute (the output rounds to bf16).
# K7 (the ROADMAP's 5e-4, scaled by 1 + max |plain|): f32 y and the f32
# state within 5e-4; bf16 y within one bf16 ulp (2^-8) of the same scale.
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 2.0 ** -8}
# serve-qwen3-8b: last-position prefill logits through K6 against the plain
# versions, both on the card, in bf16 through 36 layers: within 5e-2 of
# 1 + max |logit| (a few bf16 ulps; attention outputs may round one ulp
# apart and that carries through the residual stream)
PREFILL_LOGIT_TOL = 5e-2

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
                  "sparse-1024-q8d": 1e-3, "baselines-paper": 1e-4}


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

    # K2 + K3 — dense-q8's w1 leaf (512 agents x 25,088) with residual and
    # noise (stochastic int8 + error feedback), plus ragged and int4/gamma cases
    w512 = torch.as_tensor(
        make_topology("erdos_renyi", 512, prob=0.3, seed=7).w, dtype=torch.float32, device=dev
    )
    err2 = err3 = 0.0
    cases = [(512, 25088, 8, 1.0, True, True), (512, 32, 8, 1.0, True, True),
             (512, 320, 4, 0.5, True, False), (512, 10, 8, 1.0, False, False),
             (37, 1000, 4, 0.5, True, True), (3, 5, 8, 1.0, False, True)]
    for n_rows, d, bits, gamma, with_res, with_noise in cases:
        x = randn(n_rows, d)
        r = 0.01 * randn(n_rows, d) if with_res else None
        noise = torch.rand(n_rows, d, generator=gen, device=dev) if with_noise else None
        w = w512 if n_rows == 512 else torch.softmax(randn(n_rows, n_rows), dim=0)
        am = ops.row_absmax(x, r)
        e2 = max_err(am, ref.row_absmax_ref(x, r))
        check(e2 == 0.0, f"K2 ({n_rows}, {d}): max |err| {e2} (must be exact)")
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
    nd = x.numel()
    b_ms, b_by = bound_ms(2 * 4 * nd + 4 * 512, 2 * nd)
    rows["row_absmax"] = dict(
        shape=[512, 25088], max_abs_err=err2,
        ms=timer(lambda: ops.row_absmax(x, r), iters=50),
        plain_ms=timer(lambda: ref.row_absmax_ref(x, r), iters=50),
        # one call over the precomputed m = x + r (the add is not timed)
        library_ms=timer(lambda: torch.linalg.vector_norm(m, ord=float("inf"), dim=1), iters=50),
        bound_ms=b_ms, bound_by=b_by,
    )
    b_ms, b_by = bound_ms(5 * 4 * nd + 4 * 512 * 512 + 4 * 512, 2 * 512 * nd + 12 * nd)
    rows["compressed_mix"] = dict(
        shape=[512, 25088], max_abs_err=err3,
        ms=timer(lambda: ops.compressed_mix(x, r, w512, am, bits=8, noise=noise), iters=20),
        plain_ms=timer(lambda: ref.compressed_mix_ref(x, r, w512, am, 8, 1.0, noise), iters=20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    del x, r, noise, m

    # K4 — sparse-10k's w1 leaf over the degree-4 expander, plus ragged cases
    def csr_on(topo):
        return (torch.as_tensor(topo.indptr, device=dev), torch.as_tensor(topo.indices, device=dev),
                torch.as_tensor(topo.data, dtype=torch.float32, device=dev),
                torch.as_tensor(topo.self_weight, dtype=torch.float32, device=dev))

    err4 = 0.0
    for n_ag, d, name in ((10000, 25088, "random_regular"), (10000, 10, "random_regular"),
                          (1024, 320, "random_regular"), (7, 3, "ring"), (1, 5, "ring")):
        topo = make_sparse_topology(name, n_ag)
        csr = csr_on(topo)
        x = randn(n_ag, d)
        e4 = max_err(ops.sparse_mix_csr(x, *csr), ref.sparse_mix_csr_ref(x, *csr))
        check(e4 <= MIX_TOL * (1.0 + float(x.abs().max())), f"K4 ({n_ag}, {d}): max |err| {e4}")
        err4 = max(err4, e4)
        if n_ag == 10000 and d == 25088:
            big, big_csr, big_topo = x, csr, topo
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
    rows["sparse_mix"] = dict(
        shape=[n_ag, x.shape[1]], max_abs_err=err4,
        ms=timer(lambda: ops.sparse_mix_csr(x, *csr)),
        plain_ms=timer(lambda: ref.sparse_mix_csr_ref(x, *csr), iters=5),
        library_ms=timer(lambda: torch.sparse.mm(w_csr, x)),
        bound_ms=b_ms, bound_by=b_by,
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
        err5 = max(err5, e5)
        del x, r, noise, out, r_new, out_p, r_new_p
    torch.cuda.empty_cache()
    x, r = randn(n_ag_big, d_big), 0.01 * randn(n_ag_big, d_big)
    noise = torch.rand(n_ag_big, d_big, generator=gen, device=dev)
    am, am0 = ops.row_absmax(x, r), ops.row_absmax(x)
    nd = x.numel()
    csr_bytes = 8 * (n_ag_big + 1) + 12 * nnz + 4 * n_ag_big
    # EF form: read x, r, noise and write out, r'; stateless: read x, write out
    b_ms, b_by = bound_ms(5 * 4 * nd + csr_bytes + 4 * n_ag_big,
                          2 * (nnz + n_ag_big) * d_big + 10 * nd)
    b0_ms, b0_by = bound_ms(2 * 4 * nd + csr_bytes + 4 * n_ag_big,
                            2 * (nnz + n_ag_big) * d_big + 7 * nd)
    rows["sparse_compressed_mix"] = dict(
        shape=[n_ag_big, d_big], max_abs_err=err5,
        ms=timer(lambda: ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, noise=noise)),
        plain_ms=timer(lambda: ref.sparse_compressed_mix_csr_ref(x, r, *csr, am, 8, 1.0, noise),
                       iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        stateless_ms=timer(lambda: ops.sparse_compressed_mix_csr(x, None, *csr, am0, bits=8)),
        stateless_plain_ms=timer(
            lambda: ref.sparse_compressed_mix_csr_ref(x, None, *csr, am0, 8), iters=3),
        stateless_bound_ms=b0_ms, stateless_bound_by=b0_by,
        noise_ms=timer(lambda: torch.rand(n_ag_big, d_big, generator=gen, device=dev)),
    )
    del x, r, noise, csr, big_csr
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"kernel {name}: {json.dumps(row)}")
    return rows


# ---------------------------------------------------------------------------
# Phases 2-4: the main path, on the card and against the CPU
# ---------------------------------------------------------------------------


def run_path(torch, dev, spec, loss_fn, params0, data, batch, eval_fn=None):
    from repro_torch.core import Experiment
    from repro_torch.data import RoundSampler

    resident = data.to(dev)
    return Experiment(
        spec, loss_fn=loss_fn, params0=params0, eval_fn=eval_fn, device=dev,
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
    for name, us in top:
        log(f"profile {label}:   {us / 1e3 / active:8.3f} ms/round  {name[:110]}")


def device_share(prof, label):
    """(window µs, device-busy µs, the ten heaviest device ops as (name, µs))
    of a finished ``torch.profiler`` trace.  Busy time is the union of the
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
    return window, busy, sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]


def check_run(torch, label, hist, rounds, n_agents, template):
    import numpy as np

    check(len(hist.loss) == rounds and np.all(np.isfinite(hist.loss)), f"{label}: losses")
    st = hist.final_state
    for k, v in template.items():
        check(tuple(st.x[k].shape) == (n_agents,) + tuple(v.shape), f"{label}: shape of {k}")
        check(bool(torch.isfinite(st.x[k]).all()), f"{label}: non-finite {k}")
        if not hasattr(st, "y"):  # no gradient tracking (DSGD family, SCAFFOLD)
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
    for k in ("fused_local_step", "row_absmax", "compressed_mix"):
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
    for k in ("fused_local_step", "row_absmax", "sparse_compressed_mix"):
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
    for k in ("row_absmax", "sparse_compressed_mix"):
        check(counts[k] > 0, f"dsgt-sparse-10k-q8d: {k} not launched")
    log(f"dsgt-sparse-10k-q8d: {1e3 * hist.wall_time_s / spec_dsgt.rounds:.3f} ms/round, "
        f"loss {hist.loss[0]:.6f} -> {hist.loss[-1]:.6f}")
    del data, hist

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
    causal), at the served prompt (S 500), and at a ragged S of 1000 with a
    256 window in f32; K7 at Mamba2-370m's (B 1, L 2048, H 32, P 64, G 1,
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

    err6 = 0.0
    for b, hq, hkv, s, d, window, dt in ((1, 32, 8, 2048, 128, None, torch.bfloat16),
                                         (1, 32, 8, 500, 128, None, torch.bfloat16),
                                         (1, 32, 8, 1000, 128, 256, torch.float32),
                                         (2, 4, 2, 77, 32, None, torch.float32)):
        q, k, v = attn_inputs(b, hq, hkv, s, d, dt)
        e = max_err(ops.flash_attention(q, k, v, causal=True, window=window),
                    ref.flash_attention_ref(q, k, v, causal=True, window=window))
        check(e <= FLASH_TOL[names[dt]], f"K6 {(b, hq, hkv, s, d, window, dt)}: max |err| {e}")
        log(f"K6 check {(b, hq, hkv, s, d, window, names[dt])}: max |err| {e:.3e}")
        err6 = max(err6, e)
        del q, k, v
    q, k, v = attn_inputs(1, 32, 8, 2048, 128, torch.bfloat16)
    nb, fl = flash_cost(1, 32, 8, 2048, 2048, 128, None, 2)
    b_ms, b_by = bound_ms(nb, fl, BF16_FLOP_PER_S)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    e_lib = max_err(lib(), ref.flash_attention_ref(q, k, v, causal=True))
    check(e_lib <= FLASH_TOL["bfloat16"], f"SDPA disagrees with the plain version: {e_lib}")
    rows["flash_attention"] = dict(
        shape=[1, 32, 8, 2048, 128], dtype="bfloat16", max_abs_err=err6,
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True), iters=3),
        library_ms=time_ms(torch, lib), bound_ms=b_ms, bound_by=b_by,
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

    err7 = 0.0
    for b, l, h, p, g, n, dt in ((1, 2048, 32, 64, 1, 128, torch.bfloat16),
                                 (1, 1000, 32, 64, 1, 128, torch.bfloat16),
                                 (1, 1000, 32, 64, 1, 128, torch.float32),
                                 (2, 77, 8, 32, 2, 16, torch.float32)):
        args = ssd_inputs(b, l, h, p, g, n, dt)
        y, hf = ops.ssd_scan(*args, chunk=256)
        y2, hf2 = ref.ssd_scan_ref(*args, chunk=256)
        ey = max_err(y, y2) / (1.0 + float(y2.float().abs().max()))
        eh = max_err(hf, hf2) / (1.0 + float(hf2.abs().max()))
        check(ey <= SSD_TOL[names[dt]] and eh <= SSD_TOL["float32"],
              f"K7 {(b, l, h, p, g, n, dt)}: scaled max |err| y {ey}, state {eh}")
        log(f"K7 check {(b, l, h, p, g, n, names[dt])}: max |err| / (1 + max |plain|) "
            f"y {ey:.3e}, state {eh:.3e}")
        err7 = max(err7, max_err(y, y2), max_err(hf, hf2))
        del args, y, hf, y2, hf2
    args = ssd_inputs(1, 2048, 32, 64, 1, 128, torch.bfloat16)
    nb, fl = ssd_cost(1, 2048, 32, 64, 1, 128, 256, 2)
    b_ms, b_by = bound_ms(nb, fl, BF16_FLOP_PER_S)
    rows["ssd_scan"] = dict(
        shape=[1, 2048, 32, 64, 1, 128], dtype="bfloat16", max_abs_err=err7,
        ms=time_ms(torch, lambda: ops.ssd_scan(*args, chunk=256)),
        plain_ms=time_ms(torch, lambda: ref.ssd_scan_ref(*args, chunk=256), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    del args
    torch.cuda.empty_cache()
    for name in ("flash_attention", "ssd_scan"):
        log(f"kernel {name}: {json.dumps(rows[name])}")
    return rows


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


def serve_report(torch, dev, label, engine, rep, card):
    """The path's end-to-end numbers, with decode ms per step measured over
    steps of the full slot batch after the run, then one traced prefill
    and four traced decode steps (device busy share, heaviest device ops)."""
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
        for name, us in top:
            log(f"profile {label} {what}:   {us / 1e3 / n:8.3f} ms  {name[:100]}")
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
    check(counts["flash_attention"] == n_attn * len(rep.requests),
          f"{label}: {counts['flash_attention']} K6 launches for {len(rep.requests)} admissions")
    launches["flash_attention"] = counts["flash_attention"]
    log(f"{label}: launches {counts} ({n_attn} K6 per admitted request)")
    serve_report(torch, dev, label, engine, rep, card)
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
    serve_report(torch, dev, label, engine, rep, card)
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
            if "Used" in line:
                log(f"ptxas {name}: {line.strip()}")

    rows = kernel_checks(torch, dev)
    rows.update(lm_kernel_checks(torch, dev))
    launches = main_path(torch, dev)
    launches.update(serve_paths(torch, dev, card))
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
