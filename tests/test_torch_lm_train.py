"""LM training in the port, held against the JAX package on the same numpy
inputs: ``lm_loss`` and its gradients for both reduced models (with
activation checkpointing, chunked cross-entropy and chunked causal
attention), the token streams and the round sampler, the mesh gossip
weights, the input shapes, the LM state crossing and one rank's split, and
the plain versions of the last two kernels (K8 ``fused_mix_combine``, K9
``rowwise_quant_dequant``, and K2 over bfloat16) against the Pallas kernels
in interpret mode.  On the CPU each kernel wrapper runs its plain version
(the CUDA kernels are held against it in ``test_torch_cuda.py``)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import pisco as jpisco  # noqa: E402
from repro.core.compression import StochasticQuantizer as JQuant  # noqa: E402
from repro.data.synthetic import synthetic_lm_tokens as j_tokens  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import input_specs as jinputs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.train import make_lm_sampler as j_sampler  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm_tokens  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import input_specs as tinputs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import make_lm_sampler  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import flatten_paths, nest_leaves  # noqa: E402
from repro_torch.weights import (  # noqa: E402
    join_states,
    lm_params_from_jax,
    lm_state_from_jax,
    split_state,
)

# float32 loss and gradients: the reference's tolerance for the round
# (1e-5), per leaf of the largest gradient magnitude (autograd and XLA sum
# the backward pass in other orders)
GRAD_TOL = 1e-5


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _pair(arch, **replace):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    if replace:
        jcfg, cfg = dataclasses.replace(jcfg, **replace), dataclasses.replace(cfg, **replace)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,replace", [
    ("mamba2-370m", {}),
    ("mamba2-370m", {"remat": True, "loss_chunk": 24}),  # checkpointed periods, chunked CE
    ("qwen3-8b", {}),
    ("qwen3-8b", {"remat": True, "attn_chunk": 16}),      # chunked causal attention
    ("qwen3-8b", {"sliding_window": 12, "attn_chunk": 16, "loss_chunk": 20}),
])
def test_lm_loss_and_grads_match_jax(arch, replace):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": toks}))(jparams)
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    assert len(jl) == len(tl) == len(nest_leaves(params))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        scale = float(np.abs(a).max())
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * scale
    assert not any(t.requires_grad for t in tl + nest_leaves(params))


def test_bf16_loss_runs_and_gradients_keep_leaf_dtypes():
    cfg = get_reduced("mamba2-370m", "bfloat16")
    params = TT.init_lm(cfg, seed=0, device="cpu")
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(
        params, {"tokens": torch.randint(0, cfg.vocab_size, (1, 40))})
    assert np.isfinite(float(loss))
    for p, g in zip(nest_leaves(params), nest_leaves(grads)):
        assert g.dtype == p.dtype and g.shape == p.shape and bool(torch.isfinite(g).all())


def test_flat_value_and_grad_is_the_bundle_s():
    _, cfg, _, params = _pair("mamba2-370m")
    bundle = get_bundle(cfg, "cpu")
    flat = flatten_paths(params)
    assert "layers/pos0/mixer/in_proj" in flat and len(flat) == 11
    assert flatten_paths(TT.params_from_paths(flat, cfg)) == flat
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 33))}
    loss, grads = tsteps.flat_value_and_grad(bundle)(flat, batch)
    loss2, grads2 = bundle.value_and_grad(params, batch)
    assert float(loss) == float(loss2)
    assert all(torch.equal(grads[k], v) for k, v in flatten_paths(grads2).items())


# ---------------------------------------------------------------------------
# Data: token streams and the round sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,vocab,seed", [(1000, 512, 0), (5000, 50280, 17), (77, 3, 4)])
def test_synthetic_lm_tokens_bit_equal(n, vocab, seed):
    a, b = synthetic_lm_tokens(n, vocab, seed=seed), j_tokens(n, vocab, seed=seed)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_lm_sampler_bit_equal():
    cfg, jcfg = get_reduced("mamba2-370m"), j_get_reduced("mamba2-370m")
    mine, theirs = make_lm_sampler(cfg, 3, 2, 40, 2, seed=5), j_sampler(jcfg, 3, 2, 40, 2, seed=5)
    for k in range(3):
        (tl, tc), (jl, jc) = mine(k), theirs(k)
        assert tuple(tl["tokens"].shape) == (2, 3, 2, 40) and tl["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tl["tokens"].numpy(), np.asarray(jl["tokens"]))
        np.testing.assert_array_equal(tc["tokens"].numpy(), np.asarray(jc["tokens"]))


# ---------------------------------------------------------------------------
# Launch: gossip weights on the mesh, shapes, input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((4,), ("data",)), ((8,), ("data",)),
                                        ((2, 2), ("pod", "data")), ((2,), ("data",)),
                                        ((4, 1), ("data", "model")), ((1,), ("data",))])
def test_mesh_gossip_weights_match_jax(shape, axes):
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    agent = tuple(a for a in axes if a != "model")
    shifts = tsteps.mesh_gossip_shifts(mesh, agent)
    assert shifts == jsteps.mesh_gossip_shifts(mesh, agent)
    w = tsteps.gossip_matrix(mesh, agent, shifts)
    np.testing.assert_array_equal(w, jsteps.gossip_matrix(mesh, agent, shifts))
    np.testing.assert_allclose(w.sum(0), 1.0)
    np.testing.assert_allclose(w.sum(1), 1.0)
    assert tsteps.lambda_w(mesh, agent, shifts) == jsteps._lambda_w(mesh, agent, shifts)


def test_shapes_and_train_inputs_match_jax():
    for name, s in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == dataclasses.asdict(s)
    shape = dataclasses.replace(tshapes.TRAIN_4K, global_batch=8)
    jl, jc = jinputs.train_inputs(j_get_reduced("mamba2-370m"),
                                  dataclasses.replace(jshapes.TRAIN_4K, global_batch=8), 4, 2)
    tl, tc = tinputs.train_inputs(get_reduced("mamba2-370m"), shape, 4, 2)
    assert tl["tokens"].shape == jl["tokens"].shape == (2, 4, 2, 4096)
    assert tc["tokens"].shape == jc["tokens"].shape == (4, 2, 4096)
    assert tl["tokens"].dtype == torch.int32
    with pytest.raises(ValueError):
        tinputs.train_inputs(get_reduced("mamba2-370m"), shape, 3, 2)


def test_lm_state_crosses_and_splits_per_rank():
    jcfg, cfg, jparams, _ = _pair("mamba2-370m")
    bundle = j_get_bundle(jcfg)
    toks = np.random.default_rng(1).integers(0, 512, size=(3, 2, 33)).astype(np.int32)
    jstate = jpisco.init_state(bundle.loss, jpisco.replicate_params(jparams, 3), {"tokens": toks})
    state = lm_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert set(state.x) == set(flatten_paths(lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")))
    ranks = split_state(state)
    assert len(ranks) == 3 and ranks[1].x["embed"].shape == jparams["embed"].shape
    back = join_states(ranks)
    for f in ("x", "y", "g"):
        for k, v in getattr(state, f).items():
            np.testing.assert_array_equal(back[f][k], v.numpy())


# ---------------------------------------------------------------------------
# K8 fused_mix_combine, K9 rowwise_quant_dequant, K2 over bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000, 37), (5,), (3, 129), (257,)])
@pytest.mark.parametrize("coef", [(1.0, 0.05, 0.5, 0.25, 0.25), (0.7, 0.1, 0.4, 0.35, 0.25)])
def test_k8_plain_matches_pallas_kernel(shape, coef):
    eta_c, eta_l, ws, wl, wr = coef
    rng = np.random.default_rng(sum(shape))
    xk, xt, yt, left, right = (rng.normal(size=shape).astype(np.float32) for _ in range(5))
    want = np.asarray(jops.fused_mix_combine(
        *(jnp.asarray(a) for a in (xk, xt, yt, left, right)), eta_c=eta_c, eta_l=eta_l,
        w_self=ws, w_left=wl, w_right=wr, interpret=True))
    oracle = np.asarray(jref.neighbor_combine_ref(
        jref.mix_combine_ref(xk, xt, yt, eta_c, eta_l), left, right, ws, wl, wr))
    got = ops.fused_mix_combine(*(_t(a) for a in (xk, xt, yt, left, right)), eta_c=eta_c,
                                eta_l=eta_l, w_self=ws, w_left=wl, w_right=wr)
    # f32 math in one grouping on both sides; XLA may contract a multiply-add
    for other in (want, oracle):
        np.testing.assert_allclose(_np(got), other, rtol=1e-6, atol=1e-6)
    half = ops.mix_combine_half(_t(xk), _t(xt - eta_l * yt), _t(left), _t(right), eta_c=eta_c,
                                w_self=ws, w_left=wl, w_right=wr)
    np.testing.assert_allclose(_np(half), want, rtol=1e-6, atol=1e-6)


def test_k8_mixed_dtypes_and_one_neighbour():
    rng = np.random.default_rng(0)
    xk, xh, left = (rng.normal(size=(4, 33)).astype(np.float32) for _ in range(3))
    out = ops.mix_combine_half(_t(xk).bfloat16(), _t(xh).bfloat16(), _t(left), eta_c=1.0,
                               w_self=0.5, w_left=0.5)
    assert out.dtype == torch.bfloat16
    want = 0.5 * _t(xh).bfloat16().float() + 0.5 * _t(left)
    assert torch.equal(out, want.bfloat16())  # f32 math, one rounding
    with pytest.raises(TypeError):
        ops.mix_combine_half(_t(xk), _t(xh).double(), _t(left), eta_c=1.0, w_self=1.0, w_left=0.0)
    with pytest.raises(ValueError):
        ops.mix_combine_half(_t(xk), _t(xh), _t(left)[:2], eta_c=1.0, w_self=1.0, w_left=0.0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(5, 130), (1, 1000), (3, 7), (1, 1)])
def test_k9_plain_matches_pallas_kernel(bits, shape):
    x = np.random.default_rng(bits + shape[1]).normal(size=shape).astype(np.float32) * 3.0
    am = ops.row_absmax(_t(x))
    q, r = ops.rowwise_quant_dequant(_t(x), am, bits=bits)
    assert r is None
    np.testing.assert_array_equal(_np(q), np.asarray(JQuant(bits=bits, stochastic=False)
                                                     .compress(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(q), np.asarray(jref.rowwise_quant_dequant_ref(x, bits)))
    # the jitted Pallas kernel may place the scale one ulp apart (absmax/qmax
    # as a multiply by 1/qmax; see test_torch_kernels)
    want = np.asarray(jops.rowwise_quant_dequant(jnp.asarray(x), bits=bits, interpret=True))
    np.testing.assert_allclose(_np(q), want, rtol=2.4e-7, atol=0)


def test_k9_residual_noise_and_bf16():
    rng = np.random.default_rng(7)
    x, r = rng.normal(size=(3, 200)).astype(np.float32), 0.01 * rng.normal(size=(3, 200))
    x_t, r_t = _t(x), _t(r.astype(np.float32))
    u = torch.from_numpy(rng.random((3, 200)).astype(np.float32))
    am = ops.row_absmax(x_t, r_t)
    q, r_new = ops.rowwise_quant_dequant(x_t, am, bits=8, residual=r_t, noise=u)
    m = x_t + r_t
    scale = (am / 127.0)[:, None]
    q_want = torch.clamp(torch.floor(m / scale + u), -127, 127) * scale
    torch.testing.assert_close(q, q_want, rtol=0, atol=float(scale.max()) * 1e-6)
    assert torch.equal(r_new, m - q)  # the residual keeps exactly what was not sent
    # bf16: scale from the f32 sum, q rounded once into bf16, r' = m - q(bf16)
    xb, rb = x_t.bfloat16(), r_t.bfloat16()
    amb = ops.row_absmax(xb, rb)
    assert torch.equal(amb, (xb.float() + rb.float()).abs().amax(1))
    qb, rb_new = ops.rowwise_quant_dequant(xb, amb, bits=8, residual=rb)
    mb = xb.float() + rb.float()
    assert qb.dtype == rb_new.dtype == torch.bfloat16
    assert torch.equal(qb, ref.quantize_rows_ref(mb, amb, 8).bfloat16())
    assert torch.equal(rb_new, (mb - qb.float()).bfloat16())
