"""The paper's models in the port: loss and gradients against
``jax.value_and_grad`` of the reference, with the reference's parameters
carried across by ``weights.from_jax``; and the per-agent vmapped
value-and-grad against the reference's."""
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.pisco import make_stacked_value_and_grad as j_vg  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch.core.pisco import make_stacked_value_and_grad as t_vg  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.weights import from_jax, to_numpy  # noqa: E402


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _problem(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "logreg":
        params = {"w": (0.3 * rng.normal(size=20)).astype(np.float32)}
        x = rng.normal(size=(16, 20)).astype(np.float32)
        y = np.where(rng.random(16) > 0.5, 1.0, -1.0).astype(np.float32)
        return (functools.partial(jm.logreg_loss, rho=0.01),
                functools.partial(tm.logreg_loss, rho=0.01), params, (x, y))
    if name == "mlp":
        params = _np_params(jm.mlp_init(jax.random.PRNGKey(seed), d_in=30, hidden=8))
        x = rng.random((12, 30)).astype(np.float32)
        y = rng.integers(0, 10, size=12).astype(np.int32)
        return jm.mlp_loss, tm.mlp_loss, params, (x, y)
    params = _np_params(jm.cnn_init(jax.random.PRNGKey(seed), hw=8))
    x = rng.random((4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=4).astype(np.int32)
    return jm.cnn_loss, tm.cnn_loss, params, (x, y)


# Tolerances: float32 with different summation orders (XLA:CPU vs ATen),
# relative 2e-5 on the loss and 1e-4 on gradients (the CNN's convolution
# gradients sum over the most terms).
@pytest.mark.parametrize("name", ["logreg", "mlp", "cnn"])
def test_loss_and_grads_match_jax(name):
    j_loss, t_loss, params, (x, y) = _problem(name)
    jl, jg = jax.jit(jax.value_and_grad(j_loss))(
        {k: jnp.asarray(v) for k, v in params.items()}, (jnp.asarray(x), jnp.asarray(y))
    )
    tp = {k: v.requires_grad_(True) for k, v in from_jax(params, "cpu").items()}
    tl = t_loss(tp, (torch.from_numpy(x), torch.from_numpy(y)))
    tg = dict(zip(sorted(tp), torch.autograd.grad(tl, [tp[k] for k in sorted(tp)])))
    np.testing.assert_allclose(float(jl), float(tl.detach()), rtol=2e-5)
    for k in params:
        np.testing.assert_allclose(np.asarray(jg[k]), tg[k].numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["logreg", "mlp", "cnn"])
def test_agent_stacked_value_and_grad_matches_jax(name):
    j_loss, t_loss, params, (x, y) = _problem(name, seed=1)
    n = 3
    rng = np.random.default_rng(2)
    stacked = {k: np.stack([v + 0.01 * rng.normal(size=v.shape).astype(np.float32)
                            for _ in range(n)]) for k, v in params.items()}
    xb, yb = np.stack([x] * n), np.stack([y] * n)
    jl, jg = jax.jit(j_vg(j_loss))({k: jnp.asarray(v) for k, v in stacked.items()},
                                   (jnp.asarray(xb), jnp.asarray(yb)))
    tl, tg = t_vg(t_loss)(from_jax(stacked, "cpu"), (torch.from_numpy(xb), torch.from_numpy(yb)))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=2e-5)
    for k in stacked:
        np.testing.assert_allclose(np.asarray(jg[k]), tg[k].numpy(), rtol=1e-4, atol=1e-6)


def test_accuracy_matches_jax():
    _, _, params, (x, y) = _problem("mlp")
    ja = jax.jit(jm.mlp_accuracy)({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(y))
    ta = tm.mlp_accuracy(from_jax(params, "cpu"), torch.from_numpy(x), torch.from_numpy(y))
    assert float(ja) == float(ta)


def test_weights_round_trip_keeps_layout_and_dtype():
    params = _np_params(jm.cnn_init(jax.random.PRNGKey(0), hw=8))
    back = to_numpy(from_jax(params, "cpu"))
    for k, v in params.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_port_init_shapes_match_reference():
    for j, t in ((jax.eval_shape(jm.mlp_init, jax.random.PRNGKey(0)), tm.mlp_init(0)),
                 (jax.eval_shape(jm.cnn_init, jax.random.PRNGKey(0)), tm.cnn_init(0))):
        assert {k: tuple(v.shape) for k, v in j.items()} == {k: tuple(v.shape) for k, v in t.items()}
