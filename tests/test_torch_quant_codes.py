"""The codes pass of K3 and K5 (``quant_codes``) and their second passes
(``code_mix``, ``sparse_code_mix_csr``), held against the JAX package on the
same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels are
held against those versions in ``test_torch_cuda.py``.  The codes times each
row's scale are the reference quantiser's grid bit for bit; K5's two passes
compose to its one-pass plain version bit for bit; K3's contraction with W'
as three bf16 terms agrees with the Pallas kernel and the plain version to
``MIX_TOL``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.sparse_mix import sparse_compressed_mix as j_scm  # noqa: E402
from repro.kernels.sparse_mix import topology_edge_arrays as j_edge_arrays  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# Mixed outputs against the Pallas kernels and the one-pass plain versions:
# W'[j, i] = W[j, i] s_j rounds once per term where W^T q rounds c s, and
# the matmuls sum in other orders; max |err| <= MIX_TOL * (1 + max |x|).
MIX_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _scale(absmax, bits):
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.clamp_min(absmax, 1e-12)
    return (amax / torch.full_like(amax, qmax))[:, None]


def _csr(topo):
    return (_t(topo.indptr), _t(topo.indices), _t(topo.data.astype(np.float32)),
            _t(topo.self_weight.astype(np.float32)))


def _inputs(seed, n, d, residual, stochastic):
    x = _rand(seed, n, d) * 2.0
    r = 0.05 * _rand(seed + 1, n, d) if residual else None
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.uniform(key, (n, d))) if stochastic else None
    return x, r, key, noise


def _close(got, want, x):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    assert err <= MIX_TOL * (1.0 + float(np.abs(x).max())), err


# ---------------------------------------------------------------------------
# The codes pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("residual,stochastic", [(False, False), (True, False), (False, True),
                                                 (True, True)])
@pytest.mark.parametrize("shape", [(5, 130), (16, 7), (1, 1)])
def test_codes_times_scale_bit_equal_to_jax_grid(bits, residual, stochastic, shape):
    """c s is StochasticQuantizer's q of m = x + r, bit for bit, with the
    same uniform noise in the stochastic form; r' = m - q exactly, and the
    same as rowwise_quant_dequant_ref's."""
    x, r, key, noise = _inputs(bits + shape[0] + 2 * residual, *shape, residual, stochastic)
    m = x if r is None else x + r
    tx, tr, tn = _t(x), None if r is None else _t(r), None if noise is None else _t(noise)
    am = ops.row_absmax(tx, tr)
    codes, r_new = ops.quant_codes(tx, am, bits=bits, residual=tr, noise=tn)
    assert codes.dtype == torch.int8 and codes.shape == shape
    qmax = 2 ** (bits - 1) - 1
    assert int(codes.abs().max()) <= qmax
    q = codes.float() * _scale(am, bits)
    j_q = jcomp.StochasticQuantizer(bits=bits, stochastic=stochastic).compress(
        jnp.asarray(m), key if stochastic else None)
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(q.numpy(), ref.quantize_rows_ref(_t(m), am, bits, tn).numpy())
    if r is None:
        assert r_new is None
    else:
        np.testing.assert_array_equal(r_new.numpy(), m - np.asarray(j_q))
        _, r_k9 = ref.rowwise_quant_dequant_ref(tx, am, bits, tr, tn)
        np.testing.assert_array_equal(r_new.numpy(), r_k9.numpy())


def test_codes_round_half_to_even_and_saturate():
    """s = 1 exactly (absmax = qmax): halves round to even, the row's
    abs-max maps to +-qmax, and floor(u + noise) moves up only past 1."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -127.0, 3.25]])
    am = ref.row_absmax_ref(x)
    codes, _ = ops.quant_codes(x, am, bits=8)
    assert codes.tolist() == [[127, 0, 2, 2, 0, -2, -127, 3]]
    noise = torch.tensor([[0.9, 0.4, 0.6, 0.0, 0.5, 0.49, 0.99, 0.75]])
    codes, _ = ops.quant_codes(x, am, bits=8, noise=noise)
    assert codes.tolist() == [[127, 0, 2, 2, 0, -3, -127, 4]]


# ---------------------------------------------------------------------------
# K5: the codes pass, then the gather over the codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,gamma,ef,name,n,d", [
    (8, 1.0, True, "random_regular", 40, 23),
    (4, 0.5, True, "random_regular", 40, 64),
    (8, 1.0, False, "ring", 7, 130),
    (4, 0.5, False, "star", 6, 13),
    (8, 1.0, True, "ring", 1, 9),
])
def test_k5_two_passes_bit_equal_to_one_pass_plain(bits, gamma, ef, name, n, d):
    """quant_codes then sparse_code_mix_csr is sparse_compressed_mix_csr's
    plain version bit for bit (both sum in edge order on the CPU), residual
    included; EF and stateless forms, gamma = 0.5, ragged d, n = 1."""
    topo = jtopo.make_sparse_topology(name, n)
    x, r, _, noise = _inputs(bits + n + d, n, d, ef, ef)
    tx, tr, tn = _t(x), None if r is None else _t(r), None if noise is None else _t(noise)
    am = ops.row_absmax(tx, tr)
    codes, r_new = ops.quant_codes(tx, am, bits=bits, residual=tr, noise=tn)
    out = ops.sparse_code_mix_csr(tx, codes, *_csr(topo), am, bits=bits, gamma=gamma)
    want, r_want = ref.sparse_compressed_mix_csr_ref(tx, tr, *_csr(topo), am, bits, gamma, tn)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    np.testing.assert_array_equal(
        ref.sparse_code_mix_csr_ref(tx, codes, *_csr(topo), am, bits, gamma).numpy(), want.numpy())
    if ef:
        np.testing.assert_array_equal(r_new.numpy(), r_want.numpy())
    else:
        assert r_new is None and r_want is None


@pytest.mark.parametrize("bits,gamma", [(8, 1.0), (4, 0.5)])
@pytest.mark.parametrize("name,n,d", [("random_regular", 40, 23), ("ring", 7, 130),
                                      ("ring", 1, 9)])
def test_k5_two_passes_match_jax_kernel(bits, gamma, name, n, d):
    """The stateless form (round to nearest, no residual) against the Pallas
    kernel in interpret mode."""
    topo = jtopo.make_sparse_topology(name, n)
    s, rcv, ew = j_edge_arrays(topo)
    sw = topo.self_weight.astype(np.float32)
    x = _rand(bits + n + d, n, d) * 2.0
    jk = j_scm(jnp.asarray(x), s, rcv, ew, sw, bits=bits, gamma=gamma, interpret=True)
    am = ops.row_absmax(_t(x))
    codes, _ = ops.quant_codes(_t(x), am, bits=bits)
    out = ops.sparse_code_mix_csr(_t(x), codes, *_csr(topo), am, bits=bits, gamma=gamma)
    _close(out.numpy(), np.asarray(jk), x)


# ---------------------------------------------------------------------------
# K3: the codes pass, then the contraction with W' as three bf16 terms
# ---------------------------------------------------------------------------


def _w(name, n):
    kw = {"prob": 0.4, "seed": 1} if name == "erdos_renyi" else {}
    return jtopo.make_topology(name, n, **kw).w.astype(np.float32)


@pytest.mark.parametrize("name,n,d", [("ring", 10, 50), ("erdos_renyi", 37, 19),
                                      ("erdos_renyi", 16, 128)])
def test_k3_second_pass_matches_jax_kernel(name, n, d):
    """Round to nearest, no residual: the Pallas kernel's function (its W
    is symmetric, so its W q is W^T q)."""
    w = _w(name, n)
    x = _rand(n + d, n, d)
    jk = jops.fused_compressed_mix(jnp.asarray(x), jnp.asarray(w), bits=8, interpret=True)
    am = ops.row_absmax(_t(x))
    codes, _ = ops.quant_codes(_t(x), am, bits=8)
    out = ops.code_mix(_t(x), codes, _t(w), am, bits=8)
    _close(out.numpy(), np.asarray(jk), x)
    _close(ref.code_mix_ref(_t(x), codes, _t(w), am, 8, bf16_split=True).numpy(),
           np.asarray(jk), x)


@pytest.mark.parametrize("bits,gamma,ef,stochastic", [
    (8, 1.0, True, True), (4, 1.0, True, False), (8, 0.5, True, True), (4, 0.5, False, False),
    (8, 1.0, False, True),
])
def test_k3_two_passes_match_one_pass_plain(bits, gamma, ef, stochastic):
    """quant_codes then code_mix against compressed_mix_ref (W^T q by one
    f32 matmul): the mixed output within MIX_TOL, the residual bit-equal."""
    n, d = 24, 45
    w = _w("erdos_renyi", n)
    x, r, _, noise = _inputs(bits + 3 * ef, n, d, ef, stochastic)
    tx, tr, tn = _t(x), None if r is None else _t(r), None if noise is None else _t(noise)
    am = ops.row_absmax(tx, tr)
    codes, r_new = ops.quant_codes(tx, am, bits=bits, residual=tr, noise=tn)
    out = ops.code_mix(tx, codes, _t(w), am, bits=bits, gamma=gamma)
    want, r_want = ref.compressed_mix_ref(tx, tr, _t(w), am, bits, gamma, tn)
    _close(out.numpy(), want.numpy(), x)
    if ef:
        np.testing.assert_array_equal(r_new.numpy(), r_want.numpy())
    else:
        assert r_new is None
    # the one-pass entry point on the CPU stays the plain version itself
    got, got_r = ops.compressed_mix(tx, tr, _t(w), am, bits=bits, gamma=gamma, noise=tn)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k3_three_bf16_terms_hold_w_prime_exactly():
    """The rounding model: W' (f32) is the sum of its three bf16 terms, so
    bf16_split changes nothing for f32 operands of a normal range."""
    n, d = 32, 40
    w = _t(_w("erdos_renyi", n))
    x = _t(_rand(5, n, d))
    am = ops.row_absmax(x)
    wp = w * _scale(am, 8)
    np.testing.assert_array_equal(ref._bf16_split(wp).numpy(), wp.numpy())
    codes, _ = ops.quant_codes(x, am, bits=8)
    np.testing.assert_array_equal(
        ref.code_mix_ref(x, codes, w, am, 8, bf16_split=True).numpy(),
        ref.code_mix_ref(x, codes, w, am, 8).numpy())


def test_k3_preserves_the_agent_mean():
    n, d = 16, 30
    w = _t(_w("erdos_renyi", n))
    x, r = _t(_rand(0, n, d)), _t(0.1 * _rand(1, n, d))
    noise = torch.rand(n, d, generator=torch.Generator().manual_seed(1))
    am = ops.row_absmax(x, r)
    codes, _ = ops.quant_codes(x, am, bits=4, residual=r, noise=noise)
    out = ops.code_mix(x, codes, w, am, bits=4)
    np.testing.assert_allclose(out.mean(0).numpy(), x.mean(0).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, am = torch.zeros(4, 5), torch.ones(4)
    codes = torch.zeros(4, 5, dtype=torch.int8)
    topo = jtopo.make_sparse_topology("ring", 4)
    for bad in (dict(bits=6), dict(bits=8, residual=torch.zeros(4, 4)),
                dict(bits=8, noise=torch.zeros(4, 5, dtype=torch.float64))):
        with pytest.raises(ValueError):
            ops.quant_codes(x, am, **bad)
    with pytest.raises(ValueError):
        ops.quant_codes(x.to(torch.bfloat16), am, bits=8)
    with pytest.raises(ValueError):
        ops.quant_codes(x, torch.ones(3), bits=8)
    with pytest.raises(ValueError):
        ops.code_mix(x, codes.to(torch.int16), torch.eye(4), am, bits=8)
    with pytest.raises(ValueError):
        ops.code_mix(x, codes[:, :4], torch.eye(4), am, bits=8)
    with pytest.raises(ValueError):
        ops.code_mix(x, codes, torch.eye(3), am, bits=8)
    with pytest.raises(ValueError):
        ops.code_mix(x, codes, torch.eye(4), am, bits=3)
    with pytest.raises(ValueError):
        ops.sparse_code_mix_csr(x, codes.to(torch.uint8), *_csr(topo), am, bits=8)
    indptr, indices, data, sw = _csr(topo)
    with pytest.raises(ValueError):
        ops.sparse_code_mix_csr(x, codes, indptr.int(), indices, data, sw, am, bits=8)
    with pytest.raises(ValueError):
        ops.sparse_code_mix_csr(x, codes, indptr, indices, data, sw, torch.ones(4, 1), bits=8)
