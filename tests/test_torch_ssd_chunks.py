"""K7's chunk-parallel decomposition, pass by pass, against the JAX package.

The CUDA kernel (``csrc/ssd_scan.cu``) runs the SSD in three passes: the
chunk-local states, a scan over the chunk states, and y.  Their plain
PyTorch twins (``ref.ssd_chunk_states_ref``, ``ref.ssd_state_scan_ref``,
``ref.ssd_chunk_output_ref``, composed by ``ref.ssd_scan_chunks_ref``) are
held here against the Pallas kernel in interpret mode
(``repro.kernels.ssd_scan.ssd_scan_kernel``) and the reference's chunked jnp
SSD (``repro.models.mamba2.ssd_reference``) on the same numpy inputs:

* a chunk-local state is the final state of that chunk run alone;
* the state entering chunk z is the final state of the first z chunks;
* y and the final state of the composition are those of the whole run;
* the kernel's 64-step chunk gives the model's 256-step chunk's results;
* ragged L, G > 1, bf16 inputs and strong decay (A = -16, dt = 0.1) hold;
* the kernel's bf16 rounding model (f32 operands split into bf16 terms)
  stays far inside the card's limit, where one bf16 rounding would not.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_kernel as j_ssd_kernel  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import KERNEL_CHUNK  # noqa: E402

# Float32 throughout (bf16 inputs are exact in f32), with sums taken in
# other orders than XLA's: the ROADMAP's 5e-4 for K7, scaled by the size of
# what is compared, max |err| <= SSD_TOL * (1 + max |want|).
SSD_TOL = 5e-4
# The card's limit on K7's bf16 y against the f32 plain version (y rounds
# to bf16): 2^-8 of 1 + max |y| (chip_smoke.SSD_TOL).
CARD_Y_TOL = 2.0 ** -8


def _inputs(seed, b, l, h, p, g, n, dtype="float32", strong=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    # softplus(dt) of the model lies in [0.001, 0.1]; A = -[1, 16]
    dt = rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    if strong:
        dt = np.full((b, l, h), 0.1, np.float32)
        a = np.full((h,), -16.0, np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    if dtype == "bfloat16":
        x, dt, bm, cm = (t.astype(ml_dtypes.bfloat16) for t in (x, dt, bm, cm))
    return x, dt, a, bm, cm


def _t(a):
    """numpy -> torch, bf16 through its bits (numpy has no bf16 of its own)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _j(args):
    return tuple(jnp.asarray(t) for t in args)


def _close(got, want, what, tol=SSD_TOL):
    got = np.asarray(got, np.float32) if not torch.is_tensor(got) else got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * (1.0 + float(np.abs(want).max())), f"{what}: max |err| {err}"


def _close_y(y, jy, ry, dtype):
    """y against the Pallas kernel's y (in the input dtype) and the f32
    ssd_reference: in bf16 both the Pallas kernel's y and (for a bf16 y)
    ours are rounded to bf16, so they may sit one bf16 ulp apart."""
    _close(y, jy, "y vs Pallas kernel", SSD_TOL if dtype == "float32" else CARD_Y_TOL)
    _close(y, ry, "y vs ssd_reference", SSD_TOL if y.dtype == torch.float32 else CARD_Y_TOL)


def _sliced(args, lo, hi):
    x, dt, a, bm, cm = args
    return x[:, lo:hi], dt[:, lo:hi], a, bm[:, lo:hi], cm[:, lo:hi]


def test_kernel_chunk_is_the_cuda_kernels():
    assert KERNEL_CHUNK == 64


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dtype", [
    (1, 128, 4, 16, 1, 8, 64, "float32"),
    (2, 96, 4, 8, 2, 16, 32, "float32"),
    (1, 128, 2, 16, 1, 32, 64, "bfloat16"),
])
def test_chunk_states_are_each_chunk_run_alone(b, l, h, p, g, n, chunk, dtype):
    """Pass (a): chunk z's local state is the final state of chunk z run
    alone from a zero state (Pallas kernel and ssd_reference), and its decay
    is exp of the chunk's sum of dt·a."""
    args = _inputs(0, b, l, h, p, g, n, dtype)
    x, dt, a, bm, _ = (_t(t) for t in args)
    states, decay = ref.ssd_chunk_states_ref(x, dt, a, bm, chunk)
    assert states.shape == (b, l // chunk, h, p, n) and decay.shape == (b, l // chunk, h)
    for z in range(l // chunk):
        part = _sliced(args, z * chunk, (z + 1) * chunk)
        _, jh = j_ssd_kernel(*_j(part), chunk=chunk, interpret=True)
        _, rh = JM.ssd_reference(*_j(part), chunk=chunk)
        _close(states[:, z], jh, f"chunk {z} state vs Pallas kernel")
        _close(states[:, z], rh, f"chunk {z} state vs ssd_reference")
        dsum = np.asarray(part[1], np.float32).sum(axis=1) * np.asarray(a, np.float32)
        np.testing.assert_allclose(decay[:, z].numpy(), np.exp(dsum), rtol=1e-5)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [(1, 256, 4, 16, 1, 8, 64),
                                               (2, 160, 4, 8, 2, 16, 32)])
def test_state_scan_gives_each_prefix_state(b, l, h, p, g, n, chunk):
    """Pass (b): the state entering chunk z is the final state of the first
    z chunks; the scan's last state is the whole run's."""
    args = _inputs(1, b, l, h, p, g, n)
    x, dt, a, bm, _ = (_t(t) for t in args)
    h_in, final = ref.ssd_state_scan_ref(*ref.ssd_chunk_states_ref(x, dt, a, bm, chunk))
    assert float(h_in[:, 0].abs().max()) == 0.0
    for z in range(1, l // chunk):
        _, rh = JM.ssd_reference(*_j(_sliced(args, 0, z * chunk)), chunk=chunk)
        _close(h_in[:, z], rh, f"state entering chunk {z}")
    _, jh = j_ssd_kernel(*_j(args), chunk=chunk, interpret=True)
    _, rh = JM.ssd_reference(*_j(args), chunk=chunk)
    _close(final, jh, "final state vs Pallas kernel")
    _close(final, rh, "final state vs ssd_reference")


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dtype", [
    (1, 256, 4, 16, 1, 8, 64, "float32"),
    (2, 96, 4, 8, 2, 16, 32, "float32"),
    (1, 192, 2, 16, 1, 32, 64, "bfloat16"),
])
def test_output_pass_and_composition_match_jax(b, l, h, p, g, n, chunk, dtype):
    """Pass (c) from the scanned states, and the three passes composed: y
    and the final state of the Pallas kernel and of ssd_reference (the
    latter in f32: it rounds x·dt to the input dtype where K7 does not)."""
    args = _inputs(2, b, l, h, p, g, n, dtype)
    x, dt, a, bm, cm = (_t(t) for t in args)
    h_in, _ = ref.ssd_state_scan_ref(*ref.ssd_chunk_states_ref(x, dt, a, bm, chunk))
    y_c = ref.ssd_chunk_output_ref(x, dt, a, bm, cm, h_in, chunk)
    y, final = ref.ssd_scan_chunks_ref(x, dt, a, bm, cm, chunk)
    assert y.dtype == x.dtype and final.dtype == torch.float32
    jy, jh = j_ssd_kernel(*_j(args), chunk=chunk, interpret=True)
    f32 = tuple(np.asarray(t, np.float32) for t in args)
    ry, rh = JM.ssd_reference(*_j(f32), chunk=chunk)
    _close_y(y_c, jy, ry, dtype)
    _close_y(y, jy, ry, dtype)
    _close(final, jh, "final state vs Pallas kernel")
    _close(final, rh, "final state vs ssd_reference")


@pytest.mark.parametrize("l,h,g", [(512, 4, 1), (300, 4, 2)])
def test_kernel_chunk_gives_the_model_chunk_result(l, h, g):
    """The kernel's 64-step chunk against the model's 256 (Mamba2-370m's):
    the recurrence is the same for every chunk length."""
    args = _inputs(3, 1, l, h, 16, g, 16)
    y, final = ref.ssd_scan_chunks_ref(*(_t(t) for t in args), chunk=KERNEL_CHUNK)
    ry, rh = JM.ssd_reference(*_j(args), chunk=256)
    _close(y, ry, "y, chunk 64 vs 256")
    _close(final, rh, "final state, chunk 64 vs 256")


@pytest.mark.parametrize("l", [1, KERNEL_CHUNK - 1, KERNEL_CHUNK + 1, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_lengths(l, dtype):
    """L % 64 != 0 with G = 2: the ragged tail is zero-padded with dt = 0
    (exact no-ops).  Against ssd_reference at the model's chunk (which pads
    too) and the Pallas kernel run with a chunk that divides L."""
    args = _inputs(4, 2, l, 4, 8, 2, 16, dtype)
    y, final = ref.ssd_scan_chunks_ref(*(_t(t) for t in args), chunk=KERNEL_CHUNK)
    assert y.shape == (2, l, 4, 8) and y.dtype == _t(args[0]).dtype
    f32 = tuple(np.asarray(t, np.float32) for t in args)
    ry, rh = JM.ssd_reference(*_j(f32), chunk=256)
    jchunk = {1: 1, KERNEL_CHUNK - 1: KERNEL_CHUNK - 1, KERNEL_CHUNK + 1: KERNEL_CHUNK + 1,
              1000: 200}[l]
    jy, jh = j_ssd_kernel(*_j(args), chunk=jchunk, interpret=True)
    _close(final, rh, "final state vs ssd_reference")
    _close(final, jh, "final state vs Pallas kernel")
    _close_y(y, jy, ry, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strong_decay_stays_finite_and_equal(dtype):
    """dt = 0.1 and A = -16: a 64-step chunk's decay reaches e^-102, so
    exp(-cum) overflows f32 and exp(cum_l - cum_s) must be formed from the
    difference.  The passes stay finite and equal to the JAX package."""
    args = _inputs(5, 1, 300, 4, 16, 1, 16, dtype, strong=True)
    x, dt, a, bm, cm = (_t(t) for t in args)
    cum = torch.cumsum(dt.float()[0, :KERNEL_CHUNK, 0] * a[0], 0)
    assert torch.isinf(torch.exp(-cum)).any()  # the factored form would overflow
    y, final = ref.ssd_scan_chunks_ref(x, dt, a, bm, cm, KERNEL_CHUNK)
    assert torch.isfinite(y.float()).all() and torch.isfinite(final).all()
    jy, jh = j_ssd_kernel(*_j(args), chunk=100, interpret=True)
    f32 = tuple(np.asarray(t, np.float32) for t in args)
    ry, rh = JM.ssd_reference(*_j(f32), chunk=256)
    _close(final, jh, "final state vs Pallas kernel")
    _close(final, rh, "final state vs ssd_reference")
    _close_y(y, jy, ry, dtype)


@pytest.mark.parametrize("seed", [6, 7])
def test_bf16_split_rounding_model(seed, monkeypatch):
    """The kernel's bf16 path splits its f32 operands (G, w∘X and h_in)
    into three bf16 terms, which hold an f32 value to ~2^-25, so y and the
    final state stay within 2^-20 of 1 + max |oracle| (the oracle being the
    same passes in f32; the f32 order of sums moves no more than that).  One
    bf16 rounding of the same operands (2^-9 per term) would move them by
    more than 2^-11, an eighth of the card's 2^-8 limit on y."""
    args = _inputs(seed, 1, 256, 2, 64, 1, 128, "bfloat16")
    t = tuple(_t(a) for a in args)

    def passes(split):  # f32 y (the composition would round it to bf16)
        states, decay = ref.ssd_chunk_states_ref(*t[:4], KERNEL_CHUNK, bf16_split=split)
        h_in, fin = ref.ssd_state_scan_ref(states, decay)
        return ref.ssd_chunk_output_ref(*t, h_in, KERNEL_CHUNK, bf16_split=split), fin

    def scaled(a, b):
        return float((a - b).abs().max()) / (1.0 + float(b.abs().max()))

    y0, h0 = passes(False)
    y_s, h_s = passes(True)
    e_split = max(scaled(y_s, y0), scaled(h_s, h0))
    assert e_split <= 2.0 ** -20
    monkeypatch.setattr(ref, "_bf16_split", lambda v: v.to(torch.bfloat16).float())
    y_1, h_1 = passes(True)
    e_single = max(scaled(y_1, y0), scaled(h_1, h0))
    assert math.isfinite(e_single) and e_single >= 2.0 ** -11
