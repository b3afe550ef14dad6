"""The PISCO slice of the port against the JAX package: single rounds from
the same state, Lemma 1, and whole runs of one ExperimentSpec JSON through
both ``Experiment.run`` calls (dense, sparse, dense with q8d compression)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a, synthetic_mnist  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec, History  # noqa: E402
from repro_torch.core.algorithms import get_algorithm  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.weights import state_from_jax, state_to_numpy  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)

# Float32 trajectories through different summation orders (XLA:CPU vs ATen
# matmuls, FMA contraction): per-round losses agree to 1e-5 relative over
# nine rounds; single rounds to 1e-5 on the state.
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-6


def _data(n_agents, n_samples=1600):
    x, y = synthetic_a9a(n_samples, d=24, seed=0)
    return JData.from_arrays(x, y, n_agents), FederatedDataset.from_arrays(x, y, n_agents)


def _specs(**kw):
    base = dict(algo="pisco", t_o=3, eta_l=0.3, p=0.3, seed=1, rounds=9, eval_every=4)
    base.update(kw)
    js = JSpec.create(**base)
    return js, ExperimentSpec.from_json(js.to_json())


def _eval_fns(jd, td):
    def j_eval(params):
        return {"acc": float(jm.logreg_accuracy(params, jnp.asarray(jd.x_test), jnp.asarray(jd.y_test)))}

    xt, yt = torch.as_tensor(td.x_test), torch.as_tensor(td.y_test)

    def t_eval(params):
        return {"acc": float(tm.logreg_accuracy(params, xt, yt))}

    return j_eval, t_eval


def _run_both(js, ts, n_agents):
    jd, td = _data(n_agents)
    j_eval, t_eval = _eval_fns(jd, td)
    jh = JExperiment(
        js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)}, eval_fn=j_eval,
        sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed),
    ).run()
    tdev = td.to(CPU)
    th = Experiment(
        ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)}, eval_fn=t_eval,
        sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    return jh, th


@pytest.mark.parametrize("kw,n", [
    ({"topology": "ring"}, 10),
    ({"topology": "random_regular", "sparse": True}, 16),
    ({"topology": "erdos_renyi", "topology_kwargs": {"prob": 0.4, "seed": 7},
      "compression": "q8d"}, 12),
])
def test_whole_slice_parity(kw, n):
    js, ts = _specs(n_agents=n, **kw)
    assert ts.to_json() == js.to_json()
    jh, th = _run_both(js, ts, n)
    assert th.is_global == jh.is_global and any(th.is_global) and not all(th.is_global)
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.grad_sq_norm, jh.grad_sq_norm, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(th.consensus_err, jh.consensus_err, rtol=1e-3, atol=1e-9)
    assert [m["round"] for m in th.eval_metrics] == [m["round"] for m in jh.eval_metrics]
    assert sorted(th.to_dict()) == sorted(jh.to_dict())
    assert History.from_dict(jh.to_dict()).to_dict() == jh.to_dict()


def test_loop_and_block_drivers_agree_exactly():
    ts = ExperimentSpec.create(n_agents=10, t_o=2, eta_l=0.3, p=0.3, rounds=9,
                               eval_every=4, compression="q8")
    _, td = _data(10)
    tdev = td.to(CPU)
    runs = []
    for driver, block in (("loop", 32), ("scan", 32), ("scan", 2)):
        runs.append(Experiment(
            ts.replace(driver=driver, block_size=block), loss_fn=T_LOSS,
            params0={"w": np.zeros(24, np.float32)},
            sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
            device=CPU,
        ).run())
    for h in runs[1:]:
        assert h.loss == runs[0].loss and h.is_global == runs[0].is_global
        for k in h.final_state.x:
            assert torch.equal(h.final_state.x[k], runs[0].final_state.x[k])


def _round_inputs(n, t_o, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(t_o + 1, n, 8, 24)).astype(np.float32)
    lab = np.where(rng.random((t_o + 1, n, 8)) > 0.5, 1.0, -1.0).astype(np.float32)
    return (a[:t_o], lab[:t_o]), (a[-1], lab[-1])


@pytest.mark.parametrize("kw", [
    {"topology": "ring"},
    {"topology": "ring", "sparse": True},
    {"topology": "erdos_renyi", "topology_kwargs": {"prob": 0.5, "seed": 2}, "compression": "q4d"},
])
@pytest.mark.parametrize("global_round", [False, True])
def test_one_round_from_the_same_state(kw, global_round):
    n, t_o = 8, 2
    js, ts = _specs(n_agents=n, t_o=t_o, **kw)
    local, comm = _round_inputs(n, t_o)
    rng = np.random.default_rng(5)
    x0 = {"w": (0.1 * rng.normal(size=(n, 24))).astype(np.float32)}

    from repro.core.algorithms import get_algorithm as j_get

    jbound = j_get("pisco").bind(J_LOSS, js.config, js.make_mixing())
    jstate = jbound.init(J_LOSS, {"w": jnp.asarray(x0["w"])},
                         (jnp.asarray(comm[0]), jnp.asarray(comm[1])))
    if js.compression:  # non-zero residuals, so error feedback is exercised
        jstate = jstate._replace(ef=dict(jstate.ef, x={"w": 0.01 * jnp.asarray(x0["w"])}))
    jfn = jbound.global_round if global_round else jbound.gossip_round
    jnew, jmet = jax.jit(jfn)(jstate, tuple(map(jnp.asarray, local)), tuple(map(jnp.asarray, comm)))

    tbound = get_algorithm("pisco").bind(T_LOSS, ts.config, ts.make_mixing(CPU))
    tstate = state_from_jax(jstate, CPU)
    back = state_to_numpy(tstate)
    for f in ("x", "y", "g"):
        np.testing.assert_array_equal(back[f]["w"], np.asarray(getattr(jstate, f)["w"]))
    if js.compression:
        np.testing.assert_array_equal(back["ef"]["x"]["w"], np.asarray(jstate.ef["x"]["w"]))
    tfn = tbound.global_round if global_round else tbound.gossip_round
    tnew, tmet = tfn(tstate, tuple(map(torch.from_numpy, local)), tuple(map(torch.from_numpy, comm)))

    for f in ("x", "y", "g"):
        np.testing.assert_allclose(np.asarray(getattr(jnew, f)["w"]), getattr(tnew, f)["w"].numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=f)
    if js.compression and not global_round:
        for f in ("x", "y"):
            np.testing.assert_allclose(np.asarray(jnew.ef[f]["w"]), tnew.ef[f]["w"].numpy(),
                                       rtol=STATE_RTOL, atol=STATE_ATOL)
    assert int(tnew.step) == int(jnew.step) == 1
    np.testing.assert_allclose(float(tmet.loss), float(jmet.loss), rtol=1e-6)


@pytest.mark.parametrize("compression", [None, "q8", "q4d"])
def test_lemma1_mean_y_equals_mean_g(compression):
    """Lemma 1 (mean_i y_i == mean_i g_i) survives gossip, server rounds and
    error-feedback compressed gossip in the port."""
    n = 12
    ts = ExperimentSpec.create(n_agents=n, t_o=2, eta_l=0.2, p=0.3, seed=4,
                               topology="erdos_renyi", compression=compression, rounds=1)
    bound = get_algorithm("pisco").bind(T_LOSS, ts.config, ts.make_mixing(CPU))
    local, comm = _round_inputs(n, 2)
    to_t = lambda b: tuple(map(torch.from_numpy, b))  # noqa: E731
    state = bound.init(T_LOSS, {"w": torch.zeros(n, 24)}, to_t(comm))
    for k in range(6):
        local, comm = _round_inputs(n, 2, seed=10 + k)
        fn = bound.global_round if k % 3 == 2 else bound.gossip_round
        state, _ = fn(state, to_t(local), to_t(comm))
        np.testing.assert_allclose(state.y["w"].mean(0).numpy(), state.g["w"].mean(0).numpy(),
                                   atol=1e-6)


def test_mlp_run_smoke():
    """A short MLP run on synthetic MNIST (iid split) through the port:
    finite losses, falling over the run."""
    x, y = synthetic_mnist(600, d=40, seed=0)
    data = FederatedDataset.from_arrays(x, y, 6, heterogeneous=False).to(CPU)
    ts = ExperimentSpec.create(n_agents=6, t_o=2, eta_l=0.5, p=0.2, rounds=10, eval_every=5)
    h = Experiment(
        ts, loss_fn=tm.mlp_loss, params0=tm.mlp_init(0, d_in=40, hidden=8),
        sampler_factory=lambda s: RoundSampler(data, 16, 2, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    assert np.all(np.isfinite(h.loss)) and h.loss[-1] < h.loss[0]


def test_entry_point_without_a_device_means_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is its absence")
    ts = ExperimentSpec.create(n_agents=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Experiment(ts, loss_fn=T_LOSS, params0={"w": np.zeros(3, np.float32)},
                   sampler=lambda k: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundSampler(FederatedDataset.from_arrays(np.zeros((8, 3)), np.zeros(8), 2), 1, 1)
