"""The paper's figures on the port against the JAX package: ``History``'s
readouts, top-k compressed gossip, seed and grid sweeps, and the figure
harness (``repro_torch.figures``) against ``benchmarks/`` on the same numpy
inputs.  The reference's figure ``run()`` functions write into
``artifacts/bench/``, so only its helpers are called here; the port's
``run()`` writes under pytest's ``tmp_path``."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jbench  # noqa: E402
from benchmarks import fig6_topology as jfig6  # noqa: E402
from benchmarks import fig7_cnn as jfig7  # noqa: E402
from benchmarks import fig_compression as jfigc  # noqa: E402
from benchmarks import fig_sparse as jfigs  # noqa: E402
from benchmarks import table2_complexity as jtab2  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.trainer import History as JHistory  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec, History, run_experiment  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.figures import common as tbench  # noqa: E402
from repro_torch.figures import fig6_topology as tfig6  # noqa: E402
from repro_torch.figures import fig7_cnn as tfig7  # noqa: E402
from repro_torch.figures import fig_compression as tfigc  # noqa: E402
from repro_torch.figures import fig_sparse as tfigs  # noqa: E402
from repro_torch.figures import run as trun  # noqa: E402
from repro_torch.figures import table2_complexity as ttab2  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)

# Whole runs: float32 trajectories through different summation orders
# (XLA:CPU against ATen) agree to 1e-5 relative in their per-round losses.
LOSS_RTOL = 1e-5
# One compressed-gossip call: W q summed in another order (1e-6).
MIX_TOL = 1e-6
# Eval series of the figure workloads: the full-data gradient norm and the
# losses at x̄ to 1e-4 relative after 150 rounds; accuracies are counts over
# the test set, equal up to one sample where a margin sits at float error.
SERIES_RTOL = 1e-4


def _metrics(seed=0, n=40):
    rng = np.random.default_rng(seed)
    gsq = np.exp(rng.normal(-5.0, 1.0, size=n)) * np.linspace(2.0, 0.2, n)
    acc = np.clip(np.linspace(0.5, 0.9, n) + 0.02 * rng.normal(size=n), 0, 1)
    return [{"grad_sq": float(g), "test_acc": float(a), "round": i}
            for i, (g, a) in enumerate(zip(gsq, acc))]


# ---------------------------------------------------------------------------
# History readouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,threshold,mode", [
    ("grad_sq", 0.004, "running_le"), ("grad_sq", 1e-9, "running_le"),
    ("test_acc", 0.8, "ge"), ("test_acc", 1.5, "ge"), ("grad_sq", 1.0, "running_le"),
])
def test_history_readouts_bit_equal(key, threshold, mode):
    ev = _metrics()
    th, jh = History(eval_metrics=ev), JHistory(eval_metrics=ev)
    np.testing.assert_array_equal(th.running_mean_eval(key), jh.running_mean_eval(key))
    assert th.running_mean_eval(key).dtype == np.float64
    got = th.rounds_to_threshold(key, threshold, mode=mode)
    assert got == jh.rounds_to_threshold(key, threshold, mode=mode)
    if threshold in (1e-9, 1.5):
        assert got is None


def test_history_readouts_edge_cases():
    assert History().rounds_to_threshold("grad_sq", 1.0) is None
    th, jh = History(eval_metrics=_metrics()), JHistory(eval_metrics=_metrics())
    for h in (th, jh):
        with pytest.raises(ValueError):
            h.rounds_to_threshold("grad_sq", 1.0, mode="le")


def test_agent_params():
    x, y = synthetic_a9a(400, d=8, seed=0)
    data = FederatedDataset.from_arrays(x, y, 4).to(CPU)
    hist = run_experiment(
        ExperimentSpec.create(n_agents=4, t_o=1, p=0.5, rounds=3), loss_fn=T_LOSS,
        params0={"w": np.zeros(8, np.float32)}, device=CPU,
        sampler_factory=lambda s: RoundSampler(data, 8, s.config.t_o, s.config.seed, device=CPU),
    )
    assert hist.agent_params() is hist.final_state.x
    assert tuple(hist.agent_params()["w"].shape) == (4, 8)
    assert History(final_state=(hist.final_state.x, None)).agent_params() is hist.final_state.x
    with pytest.raises(ValueError, match="final_state"):
        History().agent_params()


@pytest.mark.parametrize("grad_target,acc_target", [(0.004, 0.8), (1e-9, 0.7), (0.01, 1.5)])
def test_comm_rounds_to_targets_equal(grad_target, acc_target):
    rng = np.random.default_rng(1)
    payload = History(eval_metrics=_metrics(2),
                      is_global=[bool(v) for v in rng.random(40) < 0.2]).to_dict()
    payload = json.loads(json.dumps(payload))
    got = tbench.comm_rounds_to_targets(History.from_dict(payload), grad_target, acc_target)
    assert got == jbench.comm_rounds_to_targets(JHistory.from_dict(payload), grad_target,
                                                acc_target)


# ---------------------------------------------------------------------------
# Top-k compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(10, 124), (6, 3, 4, 5)])
@pytest.mark.parametrize("fraction", [0.1, "1/d", 1.0])
def test_topk_compress_bit_equal(shape, fraction):
    d = int(np.prod(shape[1:]))
    fraction = 1.0 / d if fraction == "1/d" else fraction
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    jc, tc = jcomp.TopKCompressor(fraction), tcomp.TopKCompressor(fraction)
    got = tc.compress(torch.from_numpy(x)).numpy()
    want = np.asarray(jc.compress(jnp.asarray(x)))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (np.count_nonzero(got.reshape(shape[0], -1), axis=1) == tc.k_for(d)).all()
    assert (tc.name, tc.k_for(d), tc.wire_bits(d), tc.wire_bits(d, 16)) == (
        jc.name, jc.k_for(d), jc.wire_bits(d), jc.wire_bits(d, 16))


def test_topk_ties_keep_the_lower_index():
    """The tie case.  ``jax.lax.top_k`` keeps the lower index where entries
    of equal magnitude straddle the k-th place; ``torch.topk`` promises no
    order among them (on CUDA neither).  The port takes only the k-th
    magnitude from ``torch.topk`` and fills the places left among the tied
    entries by index, so it keeps the reference's set on every input: here
    rows drawn from seven values, ties everywhere, signs mixed, and the
    all-zero rows of an error-feedback residual at init."""
    rng = np.random.default_rng(4)
    vals = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32)
    x = rng.choice(vals, size=(20, 37))
    x[0] = 0.0
    for fraction in (0.1, 0.3, 0.5, 1 / 37, 1.0):
        got = tcomp.TopKCompressor(fraction).compress(torch.from_numpy(x)).numpy()
        want = np.asarray(jcomp.TopKCompressor(fraction).compress(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        assert not got[0].any()


def test_make_compressor_topk():
    for spec in ("top0.1", "top0.25", "top1"):
        tc, jc = tcomp.make_compressor(spec), jcomp.make_compressor(spec)
        assert isinstance(tc, tcomp.TopKCompressor) and tc.fraction == jc.fraction
        assert tc.name == jc.name
    for bad in ("topx", "top", "top0.1.2"):
        for make in (tcomp.make_compressor, jcomp.make_compressor):
            with pytest.raises(ValueError, match="top-k needs a fraction"):
                make(bad)
    with pytest.raises(ValueError):
        tcomp.make_compressor("top0")
    assert not hasattr(tcomp, "TOPK_NOT_PORTED")


def _tree(seed, n):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 7)).astype(np.float32),
            "b": rng.normal(size=(n, 11)).astype(np.float32)}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("ef", [False, True])
def test_topk_gossip_call_matches_reference(sparse, ef):
    n = 16
    if sparse:
        jops = jmix.sparse_mixing(jtopo.make_sparse_topology("random_regular", n))
        tops = tmix.sparse_mixing(ttopo.make_sparse_topology("random_regular", n), CPU)
    else:
        jops = jmix.dense_mixing(jtopo.make_topology("erdos_renyi", n, prob=0.4, seed=1))
        tops = tmix.dense_mixing(ttopo.make_topology("erdos_renyi", n, prob=0.4, seed=1), CPU)
    jops = jcomp.compress_mixing(jops, jcomp.make_compressor("top0.2"), error_feedback=ef)
    tops = tcomp.compress_mixing(tops, tcomp.make_compressor("top0.2"), error_feedback=ef)
    assert tops.compression.gamma == jops.compression.gamma == 0.5
    assert tops.name == jops.name
    tree, res = _tree(5, n), {k: 0.1 * v for k, v in _tree(6, n).items()}
    if ef:
        jout, jres = jops.compression({k: jnp.asarray(v) for k, v in tree.items()},
                                      {k: jnp.asarray(v) for k, v in res.items()},
                                      jax.random.PRNGKey(0))
        tout, tres = tops.compression(from_jax(tree, CPU), from_jax(res, CPU), None)
        for k in tree:
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
    else:
        jout = jops.gossip({k: jnp.asarray(v) for k, v in tree.items()})
        tout = tops.gossip(from_jax(tree, CPU))
    for k in tree:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=MIX_TOL,
                                   atol=MIX_TOL)
        # W is doubly stochastic: the agent mean is kept
        np.testing.assert_allclose(tout[k].numpy().mean(0), tree[k].mean(0), atol=MIX_TOL)


@pytest.mark.parametrize("gamma", [None, 0.5, 1.0])
def test_compress_mixing_gamma(gamma):
    base = tmix.dense_mixing(ttopo.make_topology("ring", 6), CPU)
    for spec, auto in (("top0.1", 0.5), ("q8", 1.0), ("q4d", 1.0)):
        ops = tcomp.compress_mixing(base, tcomp.make_compressor(spec), gamma=gamma)
        assert ops.compression.gamma == (auto if gamma is None else gamma)


def _a9a(n_agents, n_samples=1600, d=24):
    x, y = synthetic_a9a(n_samples, d=d, seed=0)
    return JData.from_arrays(x, y, n_agents), FederatedDataset.from_arrays(x, y, n_agents)


def _experiments(js, n, d=24, eval_every=True):
    """The same spec as a reference and a port ``Experiment`` on the CPU."""
    jd, td = _a9a(n, d=d)
    tdev = td.to(CPU)
    xt, yt = torch.as_tensor(td.x_test), torch.as_tensor(td.y_test)
    jexp = JExperiment(
        js, loss_fn=J_LOSS, params0={"w": jnp.zeros(d)},
        eval_fn=(lambda p: {"acc": float(jm.logreg_accuracy(
            p, jnp.asarray(jd.x_test), jnp.asarray(jd.y_test)))}) if eval_every else None,
        sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed),
    )
    texp = Experiment(
        ExperimentSpec.from_json(js.to_json()), loss_fn=T_LOSS,
        params0={"w": np.zeros(d, np.float32)},
        eval_fn=(lambda p: {"acc": float(tm.logreg_accuracy(p, xt, yt))}) if eval_every else None,
        sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    )
    return jexp, texp


def _same_run(th, jh):
    assert th.is_global == jh.is_global
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    assert [m["round"] for m in th.eval_metrics] == [m["round"] for m in jh.eval_metrics]


@pytest.mark.parametrize("kw,n", [({"topology": "ring"}, 10),
                                  ({"topology": "ring", "sparse": True}, 64)])
def test_topk_whole_run_matches_reference(kw, n):
    js = JSpec.create(algo="pisco", n_agents=n, t_o=2, eta_l=0.3, p=0.3, seed=1, rounds=12,
                      eval_every=4, compression="top0.1", **kw)
    jexp, texp = _experiments(js, n, d=24 if n <= 10 else 16)
    jh, th = jexp.run(), texp.run()
    _same_run(th, jh)
    assert any(th.is_global) and not all(th.is_global)
    assert th.byte_model.gossip_message_bytes == 8 * (3 if n <= 10 else 2)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "q8d"])
def test_seed_sweep_matches_reference_and_run(compression):
    js = JSpec.create(algo="pisco", n_agents=8, t_o=2, eta_l=0.3, p=0.3, seed=0, rounds=10,
                      eval_every=3, block_size=4, compression=compression)
    jexp, texp = _experiments(js, 8)
    jhs, ths = jexp.sweep(seeds=[0, 1]), texp.sweep(seeds=[0, 1])
    assert len(ths) == 2
    for th, jh in zip(ths, jhs):
        _same_run(th, jh)
        np.testing.assert_allclose([m["acc"] for m in th.eval_metrics],
                                   [m["acc"] for m in jh.eval_metrics], atol=1e-6)
    assert ths[0].loss != ths[1].loss and ths[0].is_global == ths[1].is_global
    # seed 0 is the spec's own: bit-equal to run()
    single = texp.run()
    assert ths[0].loss == single.loss and ths[0].eval_metrics == single.eval_metrics
    for k in single.final_state.x:
        assert torch.equal(ths[0].final_state.x[k], single.final_state.x[k])
    assert ths[0].grad_sq_norm == single.grad_sq_norm


def test_grid_sweep_and_errors():
    js = JSpec.create(algo="pisco", n_agents=6, t_o=1, eta_l=0.3, p=0.3, seed=2, rounds=5,
                      eval_every=2)
    jexp, texp = _experiments(js, 6)
    grid = {"p": [0.0, 0.5], "t_o": [1, 2]}
    jruns, truns = jexp.sweep(grid=grid), texp.sweep(grid=grid)
    assert [s.to_json() for s, _ in truns] == [s.to_json() for s, _ in jruns]
    for (_, th), (_, jh) in zip(truns, jruns):
        _same_run(th, jh)
    assert not any(truns[0][1].is_global)
    with pytest.raises(ValueError, match="exactly one"):
        texp.sweep()
    with pytest.raises(ValueError, match="exactly one"):
        texp.sweep(seeds=[0], grid=grid)
    _, td = _a9a(6)
    fixed = Experiment(texp.spec, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
                       sampler=RoundSampler(td.to(CPU), 16, 1, 0, device=CPU), device=CPU)
    with pytest.raises(ValueError, match="sampler_factory"):
        fixed.sweep(seeds=[0, 1])
    # run_experiment is Experiment(spec, **pieces).run()
    hist = run_experiment(texp.spec, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
                          sampler=RoundSampler(td.to(CPU), 16, 1, 0, device=CPU), device=CPU)
    assert hist.loss == fixed.run().loss


# ---------------------------------------------------------------------------
# The figure harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logreg_quick():
    """The Fig. 4 workload at its quick size (4,000 samples), both packages."""
    return jbench.make_logreg_workload(quick=True, seed=0), tbench.make_logreg_workload(
        quick=True, seed=0, device=CPU)


def test_logreg_workload_matches_reference(logreg_quick):
    (jdata, _, jeval, jp0), (tdata, _, teval, tp0) = logreg_quick
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(jdata, f), getattr(tdata, f).numpy())
    w = np.random.default_rng(0).normal(size=124).astype(np.float32) * 0.1
    je, te = jeval({"w": jnp.asarray(w)}), teval({"w": torch.from_numpy(w)})
    assert je["test_acc"] == te["test_acc"]
    np.testing.assert_allclose(te["grad_sq"], je["grad_sq"], rtol=1e-5)
    assert tp0["w"].shape == jp0["w"].shape and not tp0["w"].any()


def _readout_margin(th, jh, key, threshold):
    """How far each running mean sits from the threshold at the rounds the
    two readouts name (printed when they differ)."""
    t, j = th.running_mean_eval(key), jh.running_mean_eval(key)
    return {"port": (t - threshold).tolist(), "reference": (j - threshold).tolist()}


@pytest.mark.parametrize("p", [0.0, 0.1, 1.0])
def test_fig4_quick_readout_matches_reference(logreg_quick, p):
    """Fig. 4 at its quick size (150 rounds, ring of 10, T_o = 1, seed 0)
    through both packages' ``run_pisco_variant``: the eval series within
    SERIES_RTOL, the (rounds, a2a, a2s) readout equal."""
    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = logreg_quick
    kw = dict(p=p, t_o=1, eta_l=0.5, rounds=150, seed=0)
    jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval, params0=jp0, **kw)
    th, topo = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval, params0=tp0,
                                        device=CPU, **kw)
    assert topo.name == "ring" and th.is_global == jh.is_global
    np.testing.assert_allclose([m["grad_sq"] for m in th.eval_metrics],
                               [m["grad_sq"] for m in jh.eval_metrics], rtol=SERIES_RTOL)
    np.testing.assert_allclose([m["test_acc"] for m in th.eval_metrics],
                               [m["test_acc"] for m in jh.eval_metrics],
                               atol=1.0 / len(tdata.y_test))
    got = tbench.comm_rounds_to_targets(th, 0.002, 0.75)
    want = jbench.comm_rounds_to_targets(jh, 0.002, 0.75)
    assert got == want, _readout_margin(th, jh, "grad_sq", 0.002)


def test_fig_compression_cell_matches_reference(logreg_quick):
    """One ``top0.1`` and one ``q8d`` cell of the compression sweep (150
    rounds): bytes to the target equal (q8's stochastic rounding draws from
    JAX's PRNG, which the port cannot reproduce, so the deterministic grid
    stands in).  Both codecs are discontinuous: where two magnitudes sit
    within float error of each other at the k-th place, or m/s within float
    error of a half-integer, the two frameworks send another coordinate or
    another code, and the trajectories part by ~1e-3 (top0.1 first at round
    149, by 2.9e-3; q8d first at round 15, by up to 2.0e-3).  So every round
    holds 1e-2, and top0.1's median round LOSS_RTOL."""
    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = logreg_quick
    for comp in ("top0.1", "q8d"):
        kw = dict(p=0.1, t_o=1, eta_l=0.5, rounds=150, seed=0, compression=comp)
        jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval,
                                         params0=jp0, **kw)
        th, _ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval,
                                         params0=tp0, device=CPU, **kw)
        assert th.is_global == jh.is_global
        assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
        rel = np.abs(np.subtract(th.loss, jh.loss)) / np.abs(jh.loss)
        assert rel.max() <= 1e-2, (comp, rel.max())
        if comp == "top0.1":
            assert np.median(rel) <= LOSS_RTOL, np.median(rel)
        assert tfigc._bytes_to_target(th, 0.002) == jfigc._bytes_to_target(jh, 0.002)
    res = {"comp=none,p=0.1000": {"gossip_bytes": 800.0},
           "comp=q8,p=0.1000": {"gossip_bytes": 200.0}, "comp=q4,p=0.1000": None}
    assert tfigc.best_same_p_savings(res) == jfigc.best_same_p_savings(res) == 4.0


def test_fig6_mlp_cell_matches_reference():
    jdata, jloss, jeval, jp0 = jfig6.make_mnist_workload(quick=True, seed=0)
    tdata, tloss, teval, tp0 = tfig6.make_mnist_workload(
        quick=True, seed=0, device=CPU, params0={k: np.asarray(v) for k, v in jp0.items()})
    kw = dict(topology_name="erdos_renyi", topo_kwargs={"prob": 0.08, "seed": 23}, p=0.1,
              t_o=10, eta_l=0.2, rounds=6, batch=100, seed=0, eval_every=2)
    jh, jtopo_ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval,
                                          params0=jp0, **kw)
    th, ttopo_ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval,
                                          params0=tp0, device=CPU, **kw)
    assert (ttopo_.lambda_w, ttopo_.connected) == (jtopo_.lambda_w, jtopo_.connected)
    assert not ttopo_.connected
    _same_run(th, jh)
    for key in ("train_loss", "test_acc"):
        np.testing.assert_allclose([m[key] for m in th.eval_metrics],
                                   [m[key] for m in jh.eval_metrics], rtol=SERIES_RTOL,
                                   atol=1.0 / len(tdata.y_test) if key == "test_acc" else 0)


@pytest.fixture(scope="module")
def cifar_quick():
    jw = jfig7.make_cifar_workload(quick=True, seed=0)
    tw = tfig7.make_cifar_workload(quick=True, seed=0, device=CPU,
                                   params0={k: np.asarray(v) for k, v in jw[3].items()})
    return jw, tw


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_fig7_cnn_round_matches_reference(cifar_quick, p):
    """One gossip round (p = 0) and one server round (p = 1) of Fig. 7's
    CNN from the reference's init: the agents' parameters within 1e-5."""
    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = cifar_quick
    kw = dict(topology_name="ring", p=p, t_o=4, eta_l=0.05, rounds=1, batch=20, seed=0,
              eval_every=1)
    jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval, params0=jp0, **kw)
    th, _ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval, params0=tp0,
                                     device=CPU, **kw)
    _same_run(th, jh)
    for k, v in th.agent_params().items():
        want = np.asarray(jh.agent_params()[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(th.eval_metrics[0]["test_loss"], jh.eval_metrics[0]["test_loss"],
                               rtol=LOSS_RTOL)


def test_fig7_cnn_cell_matches_reference(cifar_quick):
    """Four rounds of the p = 1/sqrt(5) cell.  Under gossip the CNN's ReLU
    and max-pool kinks make its float32 trajectory chaotic: the reference
    itself moves by ~1e-4 relative in round 1 and ~1e-3 in round 2 when its
    init is perturbed by 1e-7 relative, so the losses are held to 1e-2 here
    (round 0 to LOSS_RTOL, before any kink can flip) and each single round
    to 1e-5 by ``test_fig7_cnn_round_matches_reference``."""
    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = cifar_quick
    kw = dict(topology_name="ring", p=1.0 / np.sqrt(5), t_o=4, eta_l=0.05, rounds=4, batch=20,
              seed=0, eval_every=2)
    jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval, params0=jp0, **kw)
    th, _ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval, params0=tp0,
                                     device=CPU, **kw)
    assert th.is_global == jh.is_global
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    np.testing.assert_allclose(th.loss[0], jh.loss[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-2)
    np.testing.assert_allclose([m["test_loss"] for m in th.eval_metrics],
                               [m["test_loss"] for m in jh.eval_metrics], rtol=1e-2)


def test_table2_payload_equal(tmp_path):
    payload = ttab2.run(out_dir=str(tmp_path))
    consts = payload["constants"]
    assert payload["network_dependency"] == jtab2.network_dependency_sweep()
    for key, row in payload["table"].items():
        lam_w, p = (float(v.split("=")[1]) for v in key.split(","))
        want = jtab2.bounds(lam_w=lam_w, p=p, **consts)
        assert row == {k: (float(v) if np.isfinite(v) else None) for k, v in want.items()}
    written = json.loads((tmp_path / "table2_complexity.json").read_text())
    assert written["table"] == payload["table"] and written["device"] is None
    assert written["source_digest"] == tbench.source_digest()


def test_source_digest_names_the_sources(tmp_path):
    # the stamp that ties a payload to the port's code where no .git is present
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "a.py").write_text("x = 1\n")
    (tmp_path / "k.cu").write_text("// kernel\n")
    first = tbench.source_digest(str(tmp_path))
    (tmp_path / "core" / "__pycache__").mkdir()
    (tmp_path / "core" / "__pycache__" / "a.cpython.pyc").write_bytes(b"\0")
    (tmp_path / "notes.txt").write_text("not a source")
    assert tbench.source_digest(str(tmp_path)) == first
    (tmp_path / "k.cu").write_text("// kernel, changed\n")
    assert tbench.source_digest(str(tmp_path)) != first
    assert len(tbench.source_digest()) == 64


def test_fig_sparse_quick_parity(tmp_path):
    payload = tfigs.run(quick=True, device=CPU, out_dir=str(tmp_path))
    assert payload["parity"]["ok"]
    assert set(payload["results"]) == {f"n={n}" for n in jfigs.FLEET_SIZES}
    assert tfigs.memory_ratio(payload["results"]) == jfigs.memory_ratio(payload["results"])
    # the port's fleet runs against the reference's, round for round
    for n in (64, 1024):
        mixing = tmix.sparse_mixing(ttopo.make_sparse_topology("ring", n), CPU)
        th = tfigs._run(n, 8, mixing, 4, CPU)
        jh = jfigs._run(n, 8, jmix.sparse_mixing(jtopo.make_sparse_topology("ring", n)), 4)
        assert th.is_global == jh.is_global
        np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
        assert payload["results"][f"n={n}"]["final_loss"] == th.loss[-1]
    written = json.loads((tmp_path / "BENCH_sparse.json").read_text())
    assert written["device"] == "cpu" and written["card"] is None


def test_fig_timecost_quick_run(tmp_path):
    """The fig_timecost twin at its quick size on the CPU: the reference's
    grids and readout, the free profile's time ranking equal to its rounds
    ranking, wan-gossip's best p above lan-gossip's, the payload written
    (its cells against the reference: tests/test_torch_sim.py)."""
    from benchmarks import fig_timecost as jfig
    from repro_torch.figures import fig_timecost as tfig

    payload = tfig.run(quick=True, device=CPU, out_dir=str(tmp_path))
    assert list(payload["profiles"]) == [label for label, _ in jfig.PROFILES_SWEPT[:3]]
    flip = tfig.tuner_flip(payload["profiles"])
    assert flip == jfig.tuner_flip(payload["profiles"]) and flip[1] > flip[0]
    free = payload["profiles"]["free"]["tuner"]
    by_rounds = sorted(free["points"], key=lambda pt: (
        pt["rounds_to_target"] is None, pt["rounds_to_target"] or 0, pt["final_loss"]))
    assert payload["consistency"]["free_time_ranking"] == [[pt["p"], pt["t_o"]]
                                                          for pt in by_rounds]
    for cell in payload["profiles"].values():
        assert set(cell["baselines"]) == {"fedavg", "dsgt"} and len(cell["curves"]) == 3
    written = json.loads((tmp_path / "BENCH_timecost.json").read_text())
    assert written["bench"] == "fig_timecost" and written["device"] == "cpu"
    assert written["rounds"] == 5 * 150 and len(written["source_digest"]) == 64


def test_fig_async_quick_run(tmp_path):
    """The fig_async twin at its quick size on the CPU: the free fleet
    bit-identical to the scan driver, async faster under stragglers, the
    wan-gossip trace repriced to its own ledger exactly."""
    from benchmarks import fig_async as jfig
    from repro_torch.figures import fig_async as tfig

    payload = tfig.run(quick=True, device=CPU, out_dir=str(tmp_path))
    profiles = payload["profiles"]
    assert list(profiles) == [label for label, _ in jfig.PROFILES_SWEPT]
    assert payload["async_config"] == "poly:alpha=0.5,bound=2,buffer=5"
    assert profiles["free"]["bit_identical_loss"]
    assert not profiles["lognormal-stragglers"]["bit_identical_loss"]
    assert profiles["lognormal-stragglers"]["async"]["peak_staleness"] > 0
    speed = tfig.async_flip(profiles)
    assert speed == jfig.async_flip(profiles) and speed["lognormal-stragglers"] > 1.0
    assert payload["reprice"]["self_exact"]
    written = json.loads((tmp_path / "BENCH_async.json").read_text())
    assert written["bench"] == "fig_async" and written["rounds"] == 6 * 200


def test_figures_run_cli(tmp_path, capsys):
    trun.main(["--only", "table2", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,seconds,derived"
    assert out[1].startswith("table2_complexity,") and out[1].endswith(
        "lam1e-4_sqrtp_dependency=9.8e+03")
    # the run re-indexes its payload directory for the regression gate
    manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert manifest["benches"] == {}  # table2 writes no BENCH_ payload
    # serve (A16) and driver (A13) are ported (tests/test_torch_fleet.py),
    # and roofline (A17) aggregates the committed dry-run records
    assert trun.NOT_PORTED == {}
    trun.main(["--only", "roofline", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("roofline,") and ";fail=0;" in out[1]
    got = json.loads((tmp_path / "BENCH_roofline.json").read_text())
    assert got["bench"] == "roofline" and got["summary"]["n_fail"] == 0
    assert got["summary"]["n_ok"] > 0 and got["device"] is None
    manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert manifest["benches"] == {"roofline": {"path": "BENCH_roofline.json"}}
    with pytest.raises(SystemExit):
        trun.main(["--only", "fig9", "--device", "cpu"])
    # robust (ROADMAP A12) is ported: fig_robust at its quick size against
    # the reference's committed quick payload
    trun.main(["--only", "robust", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("fig_robust,") and "flip=True" in out[1]
    got = json.loads((tmp_path / "BENCH_robust.json").read_text())
    with open(os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench",
                           "BENCH_robust.json")) as f:
        want = json.load(f)
    assert got["quick"] and want["quick"] and got["n_byzantine"] == want["n_byzantine"] == 4
    for flag in ("robustness_flip", "trimmed_within_10pct", "mean_within_10pct"):
        assert got[flag] == want[flag], flag
    rows = dict(got["rows"], origin_trap=got["origin_trap"])
    for label, row in rows.items():
        ref_row = want["origin_trap"] if label == "origin_trap" else want["rows"][label]
        assert row["adversary_mask"] == ref_row["adversary_mask"]
        assert row["total_bytes"] == ref_row["total_bytes"] and row["rounds"] == ref_row["rounds"]
        # Krum selects one agent's vector: a near-tie between two agents'
        # scores flips the selection across frameworks, so its row is held
        # to 1e-2 (the others to 1e-5, accuracy to one test sample)
        rtol = 1e-2 if label == "signflip+krum" else 1e-5
        np.testing.assert_allclose(row["final_loss"], ref_row["final_loss"], rtol=rtol)
        np.testing.assert_allclose(row["final_test_acc"], ref_row["final_test_acc"],
                                   atol=1.0 / 800 + 1e-7 if label == "signflip+krum" else 1e-7)


def test_figure_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("the card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.make_logreg_workload(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--only", "table2"])


def test_examples_run_on_the_cpu(capsys):
    from repro_torch.examples import quickstart, semi_decentralized_cnn

    hist, hists, fed_hist = quickstart.main(["--device", "cpu"])
    assert len(hists) == 3 and hists[0].loss == hist.loss
    assert hist.eval_metrics[-1]["global_loss"] < hist.eval_metrics[0]["global_loss"]
    assert fed_hist.eval_metrics[-1]["global_loss"] < fed_hist.eval_metrics[0]["global_loss"]
    runs = semi_decentralized_cnn.main(["--device", "cpu", "--rounds", "2", "--t-o", "1"])
    assert [s.config.p for s, _ in runs] == [0.0, 0.2, 1.0]
    assert not any(runs[0][1].is_global) and all(runs[2][1].is_global)
    out = capsys.readouterr().out
    assert "3-seed test acc" in out and "5-agent ring" in out
    assert "FedAdam-over-gossip" in out
