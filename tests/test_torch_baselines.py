"""The paper's six baselines (DSGD, Gossip-PGA, DSGT, periodical GT, FedAvg,
SCAFFOLD) in the port against the JAX package: the registry entries, single
rounds from one state carried across with ``weights.state_from_jax``,
Lemma 1 for the gradient-tracking baselines, and whole runs of one
ExperimentSpec JSON through both ``Experiment.run`` calls over the dense and
the sparse mixer, with and without int8 compressed gossip."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core.algorithms import get_algorithm as j_get  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core.algorithms import get_algorithm, registered_algorithms  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.weights import state_from_jax, state_to_numpy  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)

BASELINES = ("dsgd", "gossip_pga", "dsgt", "periodical_gt", "fedavg", "scaffold")

# As tests/test_torch_pisco.py: float32 trajectories through different
# summation orders agree to 1e-5 relative per round; single rounds to 1e-5
# on the state.
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-6

NETS = {
    "dense-ring-10": ({"topology": "ring"}, 10),
    "sparse-16": ({"topology": "random_regular", "sparse": True}, 16),
    "dense-q8d-12": ({"topology": "erdos_renyi", "topology_kwargs": {"prob": 0.4, "seed": 7},
                      "compression": "q8d"}, 12),
    "sparse-q8d-16": ({"topology": "random_regular", "sparse": True, "compression": "q8d"}, 16),
}


def _specs(algo, **kw):
    base = dict(algo=algo, t_o=3, eta_l=0.3, p=0.3, seed=1, rounds=7, eval_every=3)
    base.update(kw)
    js = JSpec.create(**base)
    return js, ExperimentSpec.from_json(js.to_json())


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_matches_the_reference():
    assert set(BASELINES) | {"pisco"} == set(registered_algorithms())
    assert {k: dataclasses.asdict(v) for k, v in tbase.BASELINES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.BASELINES.items()}
    for name in BASELINES + ("pisco",):
        t, j = get_algorithm(name), j_get(name)
        assert dataclasses.asdict(t.comm) == dataclasses.asdict(j.comm), name
        assert (t.schedule, t.avg_period) == (j.schedule, j.avg_period), name
        assert t.comm.server_based == tbase.BASELINES[name].server_based
        for p in (0.0, 0.1, 0.3, 1.0):
            js, ts = _specs(name, n_agents=4, p=p)
            jdraw = j.make_default_schedule(js.config)
            tdraw = t.make_default_schedule(ts.config)
            assert [tdraw(k) for k in range(40)] == [bool(jdraw(k)) for k in range(40)], (name, p)


# ---------------------------------------------------------------------------
# Whole runs through both packages
# ---------------------------------------------------------------------------


def _run_both(js, ts, n_agents):
    x, y = synthetic_a9a(1600, d=24, seed=0)
    jd, td = JData.from_arrays(x, y, n_agents), FederatedDataset.from_arrays(x, y, n_agents)
    xa, ya = jnp.asarray(jd.x_test), jnp.asarray(jd.y_test)
    xt, yt = torch.as_tensor(td.x_test), torch.as_tensor(td.y_test)
    jh = JExperiment(
        js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)},
        eval_fn=lambda p: {"test_loss": float(J_LOSS(p, (xa, ya)))},
        sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed),
    ).run()
    tdev = td.to(CPU)
    th = Experiment(
        ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
        eval_fn=lambda p: {"test_loss": float(T_LOSS(p, (xt, yt)))},
        sampler_factory=lambda s: RoundSampler(tdev, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    return jh, th


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("algo", BASELINES)
def test_whole_run_parity(algo, net):
    kw, n = NETS[net]
    js, ts = _specs(algo, n_agents=n, **kw)
    assert ts.to_json() == js.to_json()
    jh, th = _run_both(js, ts, n)
    assert th.is_global == [bool(f) for f in jh.is_global]
    if algo in ("fedavg", "scaffold"):
        assert all(th.is_global)
    elif algo == "gossip_pga":
        assert th.is_global == [(k + 1) % 3 == 0 for k in range(ts.rounds)]
    elif algo == "dsgt":  # Bernoulli(p), as PISCO
        assert any(th.is_global) and not all(th.is_global)
    else:
        assert not any(th.is_global)
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.grad_sq_norm, jh.grad_sq_norm, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(th.consensus_err, jh.consensus_err, rtol=1e-3, atol=1e-9)
    assert [m["round"] for m in th.eval_metrics] == [m["round"] for m in jh.eval_metrics]
    np.testing.assert_allclose([m["test_loss"] for m in th.eval_metrics],
                               [m["test_loss"] for m in jh.eval_metrics], rtol=LOSS_RTOL)
    assert sorted(th.to_dict()) == sorted(jh.to_dict())


# ---------------------------------------------------------------------------
# Single rounds from one state
# ---------------------------------------------------------------------------


def _round_inputs(n, t_o, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(t_o + 1, n, 8, 24)).astype(np.float32)
    lab = np.where(rng.random((t_o + 1, n, 8)) > 0.5, 1.0, -1.0).astype(np.float32)
    return (a[:t_o], lab[:t_o]), (a[-1], lab[-1])


_FIELDS = {"SGDState": ("x",), "GTState": ("x", "y", "g"), "PiscoState": ("x", "y", "g"),
           "ScaffoldState": ("x", "c_i", "c")}


@pytest.mark.parametrize("net", ["dense-ring-10", "sparse-q8d-16"])
@pytest.mark.parametrize("global_round", [False, True])
@pytest.mark.parametrize("algo", BASELINES)
def test_one_round_from_the_same_state(algo, global_round, net):
    kw, n = NETS[net]
    t_o = 2
    js, ts = _specs(algo, n_agents=n, t_o=t_o, **kw)
    local, comm = _round_inputs(n, t_o)
    x0 = {"w": (0.1 * np.random.default_rng(5).normal(size=(n, 24))).astype(np.float32)}

    jbound = j_get(algo).bind(J_LOSS, js.config, js.make_mixing())
    jstate = jbound.init(J_LOSS, {"w": jnp.asarray(x0["w"])},
                         (jnp.asarray(comm[0]), jnp.asarray(comm[1])))
    jfn = jbound.global_round if global_round else jbound.gossip_round
    jnew, jmet = jax.jit(jfn)(jstate, tuple(map(jnp.asarray, local)),
                              tuple(map(jnp.asarray, comm)))

    tbound = get_algorithm(algo).bind(T_LOSS, ts.config, ts.make_mixing(CPU))
    tstate = state_from_jax(jstate, CPU)
    kind = type(tstate).__name__
    assert kind == type(jstate).__name__
    back = state_to_numpy(tstate)
    for f in _FIELDS[kind]:
        np.testing.assert_array_equal(back[f]["w"], np.asarray(getattr(jstate, f)["w"]))
    tfn = tbound.global_round if global_round else tbound.gossip_round
    tnew, tmet = tfn(tstate, tuple(map(torch.from_numpy, local)),
                     tuple(map(torch.from_numpy, comm)))
    assert type(tnew).__name__ == kind
    for f in _FIELDS[kind]:
        np.testing.assert_allclose(np.asarray(getattr(jnew, f)["w"]), getattr(tnew, f)["w"].numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=f)
    assert int(tnew.step) == int(jnew.step) == 1
    for f in ("loss", "grad_sq_norm", "consensus_err"):
        np.testing.assert_allclose(float(getattr(tmet, f)), float(getattr(jmet, f)),
                                   rtol=1e-5, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("compression", [None, "q8d", "q4"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("algo", ["dsgt", "periodical_gt"])
def test_lemma1_gradient_tracking_baselines(algo, sparse, compression):
    """mean_i y_i == mean_i g_i after every round of DSGT and periodical GT,
    over the dense and the sparse mixer, plain and compressed."""
    n = 12
    ts = ExperimentSpec.create(algo=algo, n_agents=n, t_o=2, eta_l=0.2, p=0.3, seed=4,
                               topology="random_regular", sparse=sparse,
                               compression=compression, rounds=1)
    bound = get_algorithm(algo).bind(T_LOSS, ts.config, ts.make_mixing(CPU))
    to_t = lambda b: tuple(map(torch.from_numpy, b))  # noqa: E731
    _, comm = _round_inputs(n, 2)
    state = bound.init(T_LOSS, {"w": torch.zeros(n, 24)}, to_t(comm))
    for k in range(6):
        local, comm = _round_inputs(n, 2, seed=10 + k)
        fn = bound.global_round if k % 3 == 2 else bound.gossip_round
        state, _ = fn(state, to_t(local), to_t(comm))
        np.testing.assert_allclose(state.y["w"].mean(0).numpy(), state.g["w"].mean(0).numpy(),
                                   atol=1e-6)


def test_bind_overrides_step_sizes_and_schedule():
    """``eta`` moves the SGD-family step, ``eta_g`` SCAFFOLD's server step,
    and ``schedule`` replaces the registry default."""
    n = 6
    ts = ExperimentSpec.create(algo="fedavg", n_agents=n, t_o=1, eta_l=0.3, rounds=1)
    mixing = ts.make_mixing(CPU)
    local, comm = _round_inputs(n, 1)
    to_t = lambda b: tuple(map(torch.from_numpy, b))  # noqa: E731
    x0 = {"w": torch.zeros(n, 24)}
    outs = []
    for eta in (None, 0.3, 0.1):
        b = get_algorithm("fedavg").bind(T_LOSS, ts.config, mixing, eta=eta)
        outs.append(b.gossip_round(b.init(T_LOSS, x0, to_t(comm)), to_t(local), to_t(comm))[0].x)
    assert torch.equal(outs[0]["w"], outs[1]["w"]) and not torch.equal(outs[1]["w"], outs[2]["w"])
    sc = [get_algorithm("scaffold").bind(T_LOSS, ts.config, mixing, eta_g=g) for g in (1.0, 0.5)]
    xs = [b.global_round(b.init(T_LOSS, x0, to_t(comm)), to_t(local), to_t(comm))[0].x["w"]
          for b in sc]
    torch.testing.assert_close(xs[1], 0.5 * xs[0])
    b = get_algorithm("dsgd").bind(T_LOSS, ts.config, mixing, schedule=lambda k: k == 2)
    assert [b.schedule(k) for k in range(4)] == [False, False, True, False]
