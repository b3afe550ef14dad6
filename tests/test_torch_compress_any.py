"""``compress_mixing`` over any base mixer, as the reference wraps one
(``base_gossip=base.gossip``): over ``identity_mixing`` the names are the
reference's, and one deterministic int8 (``q8d``) gossip with error feedback
— its output and its residual — and the stateless form are bit-equal to the
reference's on the same numpy inputs (the quantiser's arithmetic is the
reference's; the identity's gossip adds nothing)."""
import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402


def _inputs(n):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32)}
    res = {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in tree.items()}
    return tree, res


def test_names_are_the_reference():
    for stochastic in (True, False):
        for ef in (True, False):
            j = jcomp.compress_mixing(jmixing.identity_mixing(4),
                                      jcomp.StochasticQuantizer(bits=8, stochastic=stochastic),
                                      error_feedback=ef)
            t = tcomp.compress_mixing(tmixing.identity_mixing(4),
                                      tcomp.StochasticQuantizer(bits=8, stochastic=stochastic),
                                      error_feedback=ef)
            assert t.name == j.name
    assert t.name == "identity/q8"
    assert tcomp.compress_mixing(tmixing.identity_mixing(4),
                                 tcomp.StochasticQuantizer(bits=8)).name == "identity/q8s+ef"


@pytest.mark.parametrize("bits,gamma", [(8, None), (4, 0.5)])
def test_q8d_gossip_and_residual_bit_equal(bits, gamma):
    n = 4
    tree, res = _inputs(n)
    jm = jcomp.compress_mixing(jmixing.identity_mixing(n),
                               jcomp.StochasticQuantizer(bits=bits, stochastic=False),
                               gamma=gamma)
    tm = tcomp.compress_mixing(tmixing.identity_mixing(n),
                               tcomp.StochasticQuantizer(bits=bits, stochastic=False),
                               gamma=gamma)
    jout, jres = jm.compression({k: jnp.asarray(v) for k, v in tree.items()},
                                {k: jnp.asarray(v) for k, v in res.items()},
                                jax.random.PRNGKey(0))
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    tout, tres = tm.compression(tt, {k: torch.from_numpy(v) for k, v in res.items()},
                                tm.compression.init_ef(tt)["gen"])
    jstate = jm.gossip({k: jnp.asarray(v) for k, v in tree.items()})
    tstate = tm.gossip(tt)
    for k in tree:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))
    # each agent row was quantised on its own grid: the residual is below
    # half a step of its own row's scale
    for k, v in tree.items():
        m = (v + res[k]).reshape(n, -1)
        step = np.abs(m).max(axis=1) / (2 ** (bits - 1) - 1)
        assert np.all(np.abs(tres[k].numpy().reshape(n, -1)) <= step[:, None] / 2 * (1 + 1e-6))
