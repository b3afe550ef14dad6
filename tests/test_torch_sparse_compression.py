"""Compressed gossip over the sparse CSR mixer (K5, port of the Pallas
``sparse_compressed_mix``) against the JAX package on the same numpy inputs:
the stateless form against the Pallas kernel, its jnp oracle and
``CompressedGossip.stateless`` over ``sparse_mixing``; the error-feedback
form's residual and mean; stochastic rounding; and whole PISCO runs over the
sparse mixer with int8 compression through both ``Experiment.run`` calls.

On the CPU the K5 wrapper runs its plain PyTorch version; the CUDA kernel is
held against that version in ``test_torch_cuda.py``."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sparse_mix import sparse_compressed_mix as j_scm  # noqa: E402
from repro.kernels.sparse_mix import topology_edge_arrays as j_edge_arrays  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)

# Mixed outputs: the Pallas kernel groups x + g(sw - 1)q + g*sum and may
# scale by 1/qmax (one ulp of a scale), the jnp forms sum as the port does;
# max |err| <= MIX_TOL * (1 + max |x|).  Whole runs: as test_torch_pisco.
MIX_TOL = 1e-6
LOSS_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _csr(topo):
    return (_t(topo.indptr), _t(topo.indices), _t(topo.data.astype(np.float32)),
            _t(topo.self_weight.astype(np.float32)))


def _close(got, want, x):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    assert err <= MIX_TOL * (1.0 + float(np.abs(x).max())), err


# ---------------------------------------------------------------------------
# K5 stateless form: the Pallas kernel's function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,gamma", [(8, 1.0), (4, 1.0), (8, 0.5), (4, 0.5)])
@pytest.mark.parametrize("name,n,d", [("random_regular", 40, 23), ("ring", 7, 130),
                                      ("star", 6, 5), ("ring", 1, 9)])
def test_k5_stateless_matches_jax_kernel_and_oracle(bits, gamma, name, n, d):
    topo = jtopo.make_sparse_topology(name, n)
    s, r, ew = j_edge_arrays(topo)
    sw = topo.self_weight.astype(np.float32)
    x = _rand(bits + n + d, n, d) * 2.0
    jk = j_scm(jnp.asarray(x), s, r, ew, sw, bits=bits, gamma=gamma, interpret=True)
    jr = jref.sparse_compressed_mix_ref(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                                        jnp.asarray(ew), jnp.asarray(sw), bits, gamma)
    edge = ops.sparse_compressed_mix(_t(x), _t(s), _t(r), _t(ew), _t(sw), bits=bits, gamma=gamma)
    out, res = ops.sparse_compressed_mix_csr(_t(x), None, *_csr(topo), ops.row_absmax(_t(x)),
                                             bits=bits, gamma=gamma)
    assert res is None
    # the edge-list entry sorts into the same CSR: the same numbers
    np.testing.assert_array_equal(edge.numpy(), out.numpy())
    _close(out.numpy(), np.asarray(jk), x)
    _close(out.numpy(), np.asarray(jr), x)


@pytest.mark.parametrize("spec", ["q8d", "q4d", "q8"])
@pytest.mark.parametrize("name,n", [("random_regular", 16), ("ring", 9)])
def test_k5_stateless_matches_compressed_gossip_over_sparse_mixing(spec, name, n):
    """``MixingOps.gossip`` of the compressed sparse mixer in both packages:
    deterministic rounding, no error feedback (q8 too: without a key or a
    generator the reference rounds to nearest)."""
    topo = jtopo.make_sparse_topology(name, n)
    jmix = jcomp.compress_mixing(jmixing.sparse_mixing(topo), jcomp.make_compressor(spec))
    tmix = tcomp.compress_mixing(tmixing.sparse_mixing(ttopo.make_sparse_topology(name, n), CPU),
                                 tcomp.make_compressor(spec))
    assert tmix.name == jmix.name
    tree = {"a": _rand(1, n, 3, 7), "b": _rand(2, n, 11) * 5.0}
    jout = jmix.gossip({k: jnp.asarray(v) for k, v in tree.items()})
    tout = tmix.gossip(from_jax(tree, CPU))
    for k in tree:
        _close(tout[k].numpy(), np.asarray(jout[k]), tree[k])


def test_topology_edge_arrays_bit_equal():
    for name, n in (("random_regular", 30), ("ring", 8), ("star", 5), ("ring", 1)):
        topo = jtopo.make_sparse_topology(name, n)
        for j, t in zip(j_edge_arrays(topo), ops.topology_edge_arrays(topo)):
            assert j.dtype == t.dtype
            np.testing.assert_array_equal(j, t)


# ---------------------------------------------------------------------------
# K5 error-feedback form: what PISCO runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,gamma", [(8, 1.0), (4, 0.5)])
def test_k5_ef_form_matches_compressed_gossip_call(bits, gamma):
    """Deterministic rounding with a residual, against the reference's
    ``CompressedGossip.__call__`` over the sparse mixer: the residual is
    bit-equal, the output agrees to MIX_TOL."""
    n = 20
    topo = jtopo.make_sparse_topology("random_regular", n)
    quant = jcomp.StochasticQuantizer(bits=bits, stochastic=False)
    jcg = jcomp.CompressedGossip(base_gossip=jmixing.sparse_mixing(topo).gossip,
                                 compressor=quant, gamma=gamma)
    tree = {"a": _rand(3, n, 2, 9), "b": _rand(4, n, 13)}
    res = {"a": 0.05 * _rand(5, n, 2, 9), "b": 0.05 * _rand(6, n, 13)}
    jout, jres = jcg({k: jnp.asarray(v) for k, v in tree.items()},
                     {k: jnp.asarray(v) for k, v in res.items()}, jax.random.PRNGKey(0))
    tcg = tcomp.CompressedGossip(
        compressor=tcomp.StochasticQuantizer(bits=bits, stochastic=False),
        csr=_csr(ttopo.make_sparse_topology("random_regular", n)), gamma=gamma,
    )
    tout, tres = tcg(from_jax(tree, CPU), from_jax(res, CPU), torch.Generator().manual_seed(0))
    for k in tree:
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
        _close(tout[k].numpy(), np.asarray(jout[k]), tree[k])


@pytest.mark.parametrize("bits", [8, 4])
def test_k5_ef_residual_is_m_minus_q_and_mean_is_kept(bits):
    n, d = 24, 37
    topo = ttopo.make_sparse_topology("random_regular", n)
    x, r = _t(_rand(0, n, d)), _t(0.1 * _rand(1, n, d))
    noise = torch.rand(n, d, generator=torch.Generator().manual_seed(2))
    am = ops.row_absmax(x, r)
    out, r_new = ops.sparse_compressed_mix_csr(x, r, *_csr(topo), am, bits=bits, noise=noise)
    m = x + r
    assert torch.equal(r_new, m - ref.quantize_rows_ref(m, am, bits, noise))
    np.testing.assert_allclose(out.mean(0).numpy(), x.mean(0).numpy(), atol=1e-6)
    out_d, _ = ops.sparse_compressed_mix_csr(x, r, *_csr(topo), am, bits=bits, gamma=0.5)
    np.testing.assert_allclose(out_d.mean(0).numpy(), x.mean(0).numpy(), atol=1e-6)


def test_k5_stochastic_rounding_on_the_grid_and_unbiased():
    """floor(m/s + noise): q = m - r' lies on the row's grid, within one step
    of m, and averages to m over independent noise draws."""
    n, d, bits, draws = 6, 4, 4, 3000
    topo = ttopo.make_sparse_topology("ring", n)
    x = _t(_rand(7, n, d))
    r = torch.zeros(n, d)
    am = ops.row_absmax(x, r)
    step = (am / 7.0)[:, None]
    gen = torch.Generator().manual_seed(3)
    qs = []
    for _ in range(draws):
        noise = torch.rand(n, d, generator=gen)
        _, r_new = ops.sparse_compressed_mix_csr(x, r, *_csr(topo), am, bits=bits, noise=noise)
        qs.append(x - r_new)
    q = torch.stack(qs)
    k = q / step
    assert torch.all(torch.abs(k - torch.round(k)) < 1e-4)
    assert torch.all(torch.abs(q - x) < step + 1e-6)
    np.testing.assert_allclose(q.mean(0).numpy(), x.numpy(), atol=0.02)


def test_k5_wrapper_rejects_what_the_kernel_does_not_take():
    topo = ttopo.make_sparse_topology("ring", 4)
    x, am = torch.zeros(4, 5), torch.ones(4)
    with pytest.raises(ValueError):
        ops.sparse_compressed_mix_csr(x, None, *_csr(topo), am, bits=6)
    with pytest.raises(ValueError):
        ops.sparse_compressed_mix_csr(x, None, *_csr(topo), torch.ones(3), bits=8)
    with pytest.raises(ValueError):
        ops.sparse_compressed_mix_csr(x, torch.zeros(4, 4), *_csr(topo), am, bits=8)
    indptr, indices, data, sw = _csr(topo)
    with pytest.raises(ValueError):
        ops.sparse_compressed_mix_csr(x, None, indptr.int(), indices, data, sw, am, bits=8)


# ---------------------------------------------------------------------------
# PISCO over the compressed sparse mixer: whole runs through both packages
# ---------------------------------------------------------------------------


def _run_both(js, ts, n_agents):
    x, y = synthetic_a9a(1600, d=24, seed=0)
    jd, td = JData.from_arrays(x, y, n_agents), FederatedDataset.from_arrays(x, y, n_agents)
    jh = JExperiment(
        js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)},
        sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed),
    ).run()
    tdev = td.to(CPU)
    th = Experiment(
        ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
        sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    return jh, th


@pytest.mark.parametrize("compression", ["q8d", "q4d"])
def test_pisco_sparse_compressed_whole_run_parity(compression):
    js = JSpec.create(algo="pisco", n_agents=16, topology="random_regular", sparse=True,
                      compression=compression, t_o=3, eta_l=0.3, p=0.3, seed=1, rounds=9,
                      eval_every=4)
    ts = ExperimentSpec.from_json(js.to_json())
    assert ts.to_json() == js.to_json()
    jh, th = _run_both(js, ts, 16)
    assert th.is_global == jh.is_global and any(th.is_global) and not all(th.is_global)
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.consensus_err, jh.consensus_err, rtol=1e-3, atol=1e-9)


def test_pisco_sparse_q8_runs_with_error_feedback():
    """Stochastic int8 with error feedback over the sparse mixer (the
    sparse-10k-q8 path at a small size): residuals carried, Lemma 1 kept,
    losses finite, and the averaged model's loss on all the data falling."""
    n = 16
    ts = ExperimentSpec.create(algo="pisco", n_agents=n, topology="random_regular", sparse=True,
                               compression="q8", t_o=2, eta_l=0.3, p=0.2, seed=0, rounds=12,
                               eval_every=4)
    x, y = synthetic_a9a(1600, d=24, seed=0)
    xa, ya = torch.as_tensor(x), torch.as_tensor(y)
    tdev = FederatedDataset.from_arrays(x, y, n).to(CPU)
    h = Experiment(
        ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
        eval_fn=lambda p: {"loss": float(T_LOSS(p, (xa, ya)))},
        sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    st = h.final_state
    assert set(st.ef) == {"x", "y", "gen"} and float(st.ef["x"]["w"].abs().max()) > 0
    np.testing.assert_allclose(st.y["w"].mean(0).numpy(), st.g["w"].mean(0).numpy(), atol=1e-6)
    assert np.all(np.isfinite(h.loss))
    ev = [m["loss"] for m in h.eval_metrics]
    assert ev[-1] < ev[0] < np.log(2.0) + 1e-6
