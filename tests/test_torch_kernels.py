"""The four ported kernels, held against the JAX package on the same numpy
inputs.  On the CPU each wrapper runs its plain PyTorch version (the CUDA
kernels themselves are held against it in ``test_torch_cuda.py``)."""
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import pisco as jpisco  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sparse_mix import sparse_mix as j_sparse_mix  # noqa: E402
from repro.kernels.sparse_mix import topology_edge_arrays  # noqa: E402
from repro.models.simple import logreg_loss as j_logreg  # noqa: E402
from repro.utils.pytree import tree_agent_mix, tree_agent_mix_sparse  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import pisco as tpisco  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.simple import logreg_loss as t_logreg  # noqa: E402
from repro_torch.utils.pytree import tree_agent_mix_sparse as t_mix_sparse  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# K1 fused local step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 33), (3, 5, 11), (1000,)])
def test_k1_reference_form_matches_jax_kernel(shape):
    """y' exact; x' within one f32 ulp: XLA:CPU contracts ``x - eta*y`` of
    the interpreted kernel into an FMA, the port rounds the product first
    (as the CUDA kernel, built with -fmad=false, does)."""
    x, y, gn, go = (_rand(i, *shape) for i in range(4))
    jx, jy = jops.fused_local_step(x, y, gn, go, eta_l=0.1, interpret=True)
    tx, ty = ops.fused_local_step(_t(x), _t(y), _t(gn), _t(go), 0.1)
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), rtol=2.4e-7, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(tx.numpy(), x - np.float32(0.1) * y)


def test_k1_bf16_reference_form_matches_jax_ref():
    """bf16: f32 math, one rounding per output; within one bf16 ulp of the
    reference oracle (which rounds every intermediate to bf16)."""
    x, y, gn, go = (_rand(i, 64, 8) for i in range(4))
    jx, jy = jref.fused_local_step_ref(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, y, gn, go)), 0.1
    )
    tx, ty = ops.fused_local_step(
        *(_t(a).to(torch.bfloat16) for a in (x, y, gn, go)), 0.1
    )
    for j, t in ((jx, tx), (jy, ty)):
        np.testing.assert_allclose(
            np.asarray(j, np.float32), t.float().numpy(), rtol=2e-2, atol=2e-2
        )


def test_k1_track_step_matches_one_local_phase_step():
    """The track-step variant over one local step equals the reference's
    ``_local_phase`` (T_o = 1) followed by the (4a) term x_to - eta_l*y_to,
    and leaves y_to; exact on the same f32 inputs."""
    n, d, b, eta = 6, 9, 4, 0.3
    rng = np.random.default_rng(0)
    a = rng.normal(size=(1, n, b, d)).astype(np.float32)
    lab = np.where(rng.random((1, n, b)) > 0.5, 1.0, -1.0).astype(np.float32)
    x0 = {"w": _rand(1, n, d)}
    y0, g0 = {"w": _rand(2, n, d)}, {"w": _rand(3, n, d)}
    lf_j = functools.partial(j_logreg, rho=0.01)
    vg = jpisco.make_stacked_value_and_grad(lf_j)
    state = jpisco.PiscoState(
        x={"w": jnp.asarray(x0["w"])}, y={"w": jnp.asarray(y0["w"])},
        g={"w": jnp.asarray(g0["w"])}, step=jnp.zeros((), jnp.int32),
    )
    jx, jy, jg, _ = jpisco._local_phase(vg, state, (jnp.asarray(a), jnp.asarray(lab)), eta)
    j_half = jx["w"] - eta * jy["w"]

    tstate = tpisco.PiscoState(
        x=from_jax(x0, "cpu"), y=from_jax(y0, "cpu"), g=from_jax(g0, "cpu"),
        step=torch.zeros((), dtype=torch.int32),
    )
    tvg = tpisco.make_stacked_value_and_grad(functools.partial(t_logreg, rho=0.01))
    th, ty, tg, _ = tpisco._local_phase(tvg, tstate, (_t(a), _t(lab)), eta)
    np.testing.assert_allclose(np.asarray(jg["w"]), tg["w"].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jy["w"]), ty["w"].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(j_half), th["w"].numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# K2 row abs-max and the q grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(5, 130), (16, 7), (1, 1)])
def test_k2_and_q_grid_bit_equal_to_jax(bits, shape):
    x = _rand(bits + shape[0], *shape) * 3.0
    x[0, 0] = 0.0
    am = ops.row_absmax(_t(x))
    np.testing.assert_array_equal(am.numpy(), np.abs(x).max(axis=1))
    q = ref.quantize_rows_ref(_t(x), am, bits).numpy()
    j_quant = jcomp.StochasticQuantizer(bits=bits, stochastic=False).compress(jnp.asarray(x))
    np.testing.assert_array_equal(q, np.asarray(j_quant))
    # The jitted Pallas kernel lets XLA turn ``absmax / qmax`` into a multiply
    # by 1/qmax, which can move the scale by one ulp (seen for qmax = 7);
    # the port divides, as StochasticQuantizer (what PISCO runs) does.
    j_kernel = jops.rowwise_quant_dequant(jnp.asarray(x), bits=bits, interpret=True)
    np.testing.assert_allclose(q, np.asarray(j_kernel), rtol=2.4e-7, atol=0)
    t_quant = tcomp.StochasticQuantizer(bits=bits, stochastic=False).compress(_t(x))
    np.testing.assert_array_equal(q, t_quant.numpy())


def test_k2_with_residual():
    x, r = _rand(0, 9, 40), _rand(1, 9, 40)
    np.testing.assert_array_equal(
        ops.row_absmax(_t(x), _t(r)).numpy(), np.abs(x + r).max(axis=1)
    )


def test_stochastic_rounding_is_unbiased_on_the_grid():
    """floor(u + noise) lands on one of the two neighbouring grid points and
    averages to the input (the property JAX's PRNG stream cannot pin)."""
    x = torch.tensor([[0.3, -0.7, 1.0, 0.0]]).repeat(4000, 1)
    noise = torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
    q = ref.quantize_rows_ref(x, ref.row_absmax_ref(x), 4, noise)
    step = 1.0 / 7.0
    assert torch.all(torch.abs(q - x) < step + 1e-6)
    np.testing.assert_allclose(q.mean(0).numpy(), x[0].numpy(), atol=0.01)


# ---------------------------------------------------------------------------
# K3 compressed gossip with error feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,gamma,ef", [
    (8, 1.0, True), (4, 1.0, True), (8, 0.5, True), (4, 0.5, False), (8, 1.0, False),
])
def test_k3_matches_compressed_gossip(bits, gamma, ef):
    """q8d/q4d, with and without gamma and error feedback, against the
    reference's CompressedGossip.__call__: the residual is bit-equal (the q
    grid is); the mixed output agrees to 1e-6 (matmul summation order)."""
    n = 12
    topo = jtopo.make_topology("erdos_renyi", n, prob=0.4, seed=1)
    w = jnp.asarray(topo.w, jnp.float32)
    tree = {"a": _rand(5, n, 3, 7), "b": _rand(6, n, 11)}
    res = {"a": 0.01 * _rand(7, n, 3, 7), "b": 0.01 * _rand(8, n, 11)}
    quant = jcomp.StochasticQuantizer(bits=bits, stochastic=False)
    jcg = jcomp.CompressedGossip(
        base_gossip=lambda t: tree_agent_mix(t, w), compressor=quant,
        error_feedback=ef, gamma=gamma,
    )
    jres = {k: jnp.asarray(v) for k, v in res.items()} if ef else ()
    jout, jnew = jcg({k: jnp.asarray(v) for k, v in tree.items()}, jres, jax.random.PRNGKey(0))
    tcg = tcomp.CompressedGossip(
        w=torch.as_tensor(topo.w, dtype=torch.float32),
        compressor=tcomp.StochasticQuantizer(bits=bits, stochastic=False),
        error_feedback=ef, gamma=gamma,
    )
    tres = from_jax(res, "cpu") if ef else ()
    tout, tnew = tcg(from_jax(tree, "cpu"), tres, torch.Generator().manual_seed(0))
    for k in tree:
        np.testing.assert_allclose(np.asarray(jout[k]), tout[k].numpy(), rtol=1e-6, atol=1e-6)
        if ef:
            np.testing.assert_array_equal(np.asarray(jnew[k]), tnew[k].numpy())
    if not ef:
        assert tnew == ()


def test_k3_stateless_matches_reference_kernel():
    n, d = 10, 50
    w = jtopo.make_topology("ring", n).w.astype(np.float32)
    x = _rand(3, n, d)
    jk = jops.fused_compressed_mix(jnp.asarray(x), jnp.asarray(w), bits=8, interpret=True)
    out, r = ops.compressed_mix(_t(x), None, _t(w), ops.row_absmax(_t(x)), bits=8)
    assert r is None
    np.testing.assert_allclose(np.asarray(jk), out.numpy(), rtol=1e-6, atol=1e-6)


def test_k3_preserves_the_agent_mean():
    n, d = 16, 30
    w = torch.as_tensor(jtopo.make_topology("erdos_renyi", n, prob=0.3).w, dtype=torch.float32)
    x, r = _t(_rand(0, n, d)), _t(0.1 * _rand(1, n, d))
    noise = torch.rand(n, d, generator=torch.Generator().manual_seed(1))
    out, _ = ops.compressed_mix(x, r, w, ops.row_absmax(x, r), bits=4, noise=noise)
    np.testing.assert_allclose(out.mean(0).numpy(), x.mean(0).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# K4 sparse gossip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("random_regular", 40), ("ring", 7), ("star", 6)])
def test_k4_matches_jax_sparse_mix(name, n):
    topo = jtopo.make_sparse_topology(name, n)
    s, r, ew = topology_edge_arrays(topo)
    sw = topo.self_weight.astype(np.float32)
    x = _rand(n, n, 23)
    jk = j_sparse_mix(jnp.asarray(x), s, r, ew, sw, interpret=True)
    jr = jref.sparse_mix_ref(jnp.asarray(x), s, r, jnp.asarray(ew), jnp.asarray(sw))
    jt = tree_agent_mix_sparse(
        {"x": jnp.asarray(x)}, jnp.asarray(s), jnp.asarray(r), jnp.asarray(ew),
        jnp.asarray(sw), n,
    )["x"]
    out = ops.sparse_mix(_t(x), _t(s), _t(r), _t(ew), _t(sw)).numpy()
    csr = ops.sparse_mix_csr(
        _t(x), _t(topo.indptr), _t(topo.indices),
        _t(topo.data.astype(np.float32)), _t(sw),
    ).numpy()
    np.testing.assert_array_equal(out, csr)
    tt = t_mix_sparse({"x": _t(x).reshape(n, 23, 1)}, _t(s), _t(r), _t(ew), _t(sw))["x"]
    np.testing.assert_array_equal(tt.reshape(n, 23).numpy(), out)
    # the same per-receiver edge order and self-term-last grouping as
    # segment_sum: exact against the jnp forms, 1e-6 against the kernel's
    # block-wise accumulation
    np.testing.assert_array_equal(out, np.asarray(jt))
    np.testing.assert_array_equal(out, np.asarray(jr))
    np.testing.assert_allclose(out, np.asarray(jk), rtol=1e-6, atol=1e-6)


def test_k4_empty_edge_list_holds_iterates():
    x = _t(_rand(0, 3, 4))
    z = torch.zeros(0, dtype=torch.int64)
    out = ops.sparse_mix(x, z, z, torch.zeros(0), torch.ones(3))
    np.testing.assert_array_equal(out.numpy(), x.numpy())


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="endpoints"):
        ops.sparse_mix(x, torch.tensor([0, 4]), torch.tensor([1, 0]), torch.ones(2), torch.ones(4))
    with pytest.raises(ValueError):
        ops.row_absmax(x.double())
    with pytest.raises(ValueError):
        ops.compressed_mix(x, None, torch.zeros(3, 3), torch.ones(4), bits=8)
    with pytest.raises(ValueError):
        ops.compressed_mix(x, None, torch.eye(4), torch.ones(4), bits=6)
    with pytest.raises(TypeError):
        ops.fused_track_step(*(x.double() for _ in range(4)), 0.1)
