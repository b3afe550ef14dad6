"""Asynchronous execution on the port (``repro_torch.events``) against the JAX
package (``repro.events``) on the same numpy inputs, and the port's twins of
``tests/test_events.py``.

Tolerances: the event clock is float64 numpy in both packages, so the trace,
seconds, staleness, weights and realized counts of an engine, and the
``sim_time_s`` and ``staleness`` of a whole run, are held **equal**, bit for
bit.  Losses of whole runs within LOSS_RTOL = 1e-5 relative per round; runs
with deterministic int8 gossip (q8d) within Q8D_LOSS_RTOL = 1e-4 (a near-tie
of the int8 grid may round a step apart across frameworks, as in
tests/test_torch_network.py).  Staged mixes against the dense W: MIX_TOL
(1e-6 of 1 + max |x|, other summation orders)."""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402
from repro import events as J  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro.sim import SystemsModel as JSystemsModel, SystemsParams as JSystemsParams  # noqa: E402
from repro.sim import price_history as j_price_history  # noqa: E402
from repro_torch import events as T  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core.compression import make_byte_model  # noqa: E402
from repro_torch.core.driver import DRIVERS, get_driver  # noqa: E402
from repro_torch.core.topology import make_sparse_topology  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.events.driver import EventNetwork, make_async_mixing  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quantize import qmax_of  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.sim import FREE_NETWORK, SystemsModel, SystemsParams, price_history, tune  # noqa: E402
from repro_torch.utils.pytree import tree_agent_mix  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)
LOSS_RTOL = 1e-5
Q8D_LOSS_RTOL = 1e-4
MIX_TOL = 1e-6
N_AGENTS = 6
ROUNDS = 20

ENGINE_ARRAYS = ("seconds", "staleness", "weights", "messages", "n_participants")
TRACE_KEYS = ("flags", "base_edges", "active", "gate", "participants")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pieces(n=N_AGENTS):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=n)
    return dict(loss_fn=loss_fn, params0={"w": torch.zeros(d)}, device=CPU,
                sampler_factory=lambda s: sampler_factory(s.config.t_o))


def _spec(**kw):
    base = dict(algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.2, seed=0, rounds=ROUNDS)
    base.update(kw)
    return ExperimentSpec.create(**base)


def _same_engine(t, j):
    """Two engines (port, reference): every array and the trace equal."""
    assert t.trivial == j.trivial
    for f in ENGINE_ARRAYS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert set(t.trace) == set(j.trace)
    for k, v in j.trace.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(t.trace[k], v, err_msg=k)
        else:
            assert t.trace[k] == v, k


# ---------------------------------------------------------------------------
# Staleness rules: grammar and weights equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", ["constant", "poly", "poly:alpha=1.0", "poly:bound=2",
                               "buffer:buffer=4", "poly:alpha=0.25,bound=3,buffer=2",
                               "poly:bound=inf", "buffer:bound=none,buffer=1"])
def test_async_spec_grammar_matches_the_reference(s):
    tc, jc = T.parse_async_spec(s), J.parse_async_spec(s)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.spec() == jc.spec() and T.parse_async_spec(tc.spec()) == tc
    for bound in (None, 0, 3):
        assert T.with_staleness_bound(s, bound) == J.with_staleness_bound(s, bound)
    assert T.with_staleness_bound(None, 2) == J.with_staleness_bound(None, 2)
    assert T.RULES == J.RULES


@pytest.mark.parametrize("bad", ["warp", "poly:zzz=1", "poly:alpha=", "", "poly:bound=1.5",
                                 "poly:alpha=-1", "buffer:buffer=0"])
def test_async_spec_rejects_malformed_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        J.parse_async_spec(bad)
    with pytest.raises(ValueError) as got:
        T.parse_async_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule", ["constant", "poly", "buffer"])
def test_staleness_weights_bit_equal(rule):
    rng = np.random.default_rng(3)
    for _ in range(5):
        s = rng.integers(0, 5, size=9)
        ontime = rng.random(9) < 0.6
        part = rng.random(9) < 0.7
        for cfg_kw in (dict(alpha=0.5), dict(alpha=1.7)):
            tc, jc = T.AsyncConfig(rule=rule, **cfg_kw), J.AsyncConfig(rule=rule, **cfg_kw)
            for kw in (dict(ontime=ontime), dict(ontime=ontime, participants=part)):
                np.testing.assert_array_equal(T.staleness_weights(s, tc, **kw),
                                              J.staleness_weights(s, jc, **kw))
    w = T.staleness_weights(np.array([0, 1, 3]), T.AsyncConfig(rule="poly", alpha=1.0))
    np.testing.assert_allclose(w, np.array([4, 2, 1]) / 7)


# ---------------------------------------------------------------------------
# EventEngine on hand-built fleets: bit-equal to the reference's
# ---------------------------------------------------------------------------


def _fleet(pkg_model, pkg_params, compute, lat=None, up_bw=None, down_bw=None, rtt=0.0,
           bw=None):
    n = len(compute)
    return pkg_model(params=pkg_params(
        compute_s=np.asarray(compute, dtype=np.float64),
        link_latency_s=np.zeros((n, n)) if lat is None else np.asarray(lat, float),
        link_bw_Bps=np.full((n, n), np.inf) if bw is None else np.asarray(bw, float),
        up_bw_Bps=np.ones(n) if up_bw is None else np.asarray(up_bw, float),
        down_bw_Bps=np.ones(n) if down_bw is None else np.asarray(down_bw, float),
        server_rtt_s=float(rtt)))


def _path_lat():
    lat = np.zeros((3, 3))
    lat[0, 1] = lat[1, 0] = 0.5
    lat[1, 2] = lat[2, 1] = 1.5
    return lat


FLEETS = {
    # path 0-1-2: the 1-2 edge gates every round at 2.5 s
    "wait-chain": (dict(compute=[1.0, 1.0, 1.0], lat=_path_lat()), dict(),
                   np.zeros(2, bool), np.array([[0, 1], [1, 2]]), dict(gossip_bytes=8)),
    # agent 2 five times slower, bound 0 drops its edge
    "bounded-drop": (dict(compute=[1.0, 1.0, 5.0]), dict(rule="constant", bound=0),
                     np.zeros(3, bool), np.array([[0, 1], [1, 2]]), dict(gossip_bytes=8)),
    # buffer-of-2 fires at the second push
    "buffered-server": (dict(compute=[1.0, 2.0, 3.0], up_bw=[1, 1, 1], down_bw=[2, 2, 2],
                             rtt=0.5), dict(rule="buffer", buffer=2), np.ones(2, bool),
                        np.array([[0, 1]]), dict(server_bytes=4)),
    "mixed": (dict(compute=[1.0, 1.0, 5.0, 2.0], up_bw=[1, 1, 1, 3], down_bw=[2, 2, 2, 1],
                   rtt=0.5, lat=np.full((4, 4), 0.3) - 0.3 * np.eye(4)),
              dict(rule="poly", alpha=0.7, bound=1, buffer=3),
              np.array([False, True, False, False, True, False]),
              np.array([[0, 1], [1, 2], [2, 3], [0, 3]]), dict(gossip_bytes=8, server_bytes=4)),
}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("case", list(FLEETS))
def test_engine_on_hand_built_fleets_bit_equal(case, sparse):
    """The reference's hand-built fleets (and a mixed one): trace, seconds,
    staleness, weights and realized counts equal; the block draws equal;
    repricing on the same fleet reproduces the seconds exactly."""
    fleet, cfg, flags, edges, kw = FLEETS[case]
    t = T.EventEngine(model=_fleet(SystemsModel, SystemsParams, **fleet),
                      cfg=T.AsyncConfig(**cfg), flags=flags, base_edges=edges, sparse=sparse,
                      **kw)
    j = J.EventEngine(model=_fleet(JSystemsModel, JSystemsParams, **fleet),
                      cfg=J.AsyncConfig(**cfg), flags=flags, base_edges=edges, sparse=sparse,
                      **kw)
    _same_engine(t, j)
    assert np.array_equal(T.reprice_trace(t.trace, t.model), t.seconds)
    tb, jb = t.draw_block(0, len(flags)), j.draw_block(0, len(flags))
    if sparse:
        for key in ("edge_w", "self_w"):
            np.testing.assert_array_equal(tb[0][key], jb[0][key])
    else:
        np.testing.assert_array_equal(tb[0], jb[0])
    for key in ("w", "keep"):
        np.testing.assert_array_equal(tb[1][key], jb[1][key])
    for a, b in zip(tb[2:], jb[2:]):
        np.testing.assert_array_equal(a, b)


def test_engine_hand_computed_timelines():
    """The reference's hand-derived timelines, on the port."""
    fleet, cfg, flags, edges, kw = FLEETS["wait-chain"]
    eng = T.EventEngine(model=_fleet(SystemsModel, SystemsParams, **fleet),
                        cfg=T.AsyncConfig(**cfg), flags=flags, base_edges=edges, **kw)
    assert eng.trivial and eng.messages.tolist() == [4, 4]
    np.testing.assert_allclose(eng.seconds, [2.5, 2.5])
    fleet, cfg, flags, edges, kw = FLEETS["bounded-drop"]
    eng = T.EventEngine(model=_fleet(SystemsModel, SystemsParams, **fleet),
                        cfg=T.AsyncConfig(**cfg), flags=flags[:2], base_edges=edges, **kw)
    assert not eng.trivial and eng.messages.tolist() == [2, 2]
    assert eng.staleness.tolist() == [[0, 0, 1], [0, 0, 2]]
    np.testing.assert_allclose(eng.seconds, [1.0, 1.0])
    fleet, cfg, flags, edges, kw = FLEETS["buffered-server"]
    eng = T.EventEngine(model=_fleet(SystemsModel, SystemsParams, **fleet),
                        cfg=T.AsyncConfig(**cfg), flags=flags[:1], base_edges=edges, **kw)
    np.testing.assert_allclose(eng.seconds, [8.5])
    np.testing.assert_allclose(eng.weights[0], [0.5, 0.5, 0.0])
    fast = _fleet(SystemsModel, SystemsParams, [0.1, 0.2, 0.3], up_bw=[10, 10, 10],
                  down_bw=[20, 20, 20])
    assert T.reprice_trace(eng.trace, fast).sum() < eng.seconds.sum()


ENGINE_SPECS = {
    "dense-stragglers": dict(systems="lognormal-stragglers",
                             async_="poly:alpha=0.5,bound=1,buffer=3"),
    "dense-wan-bern-part": dict(systems="wan-gossip", network="bernoulli:0.3",
                                participation=0.5, async_="buffer:bound=2,buffer=2"),
    "sparse-edge-cohort": dict(systems="edge-vs-datacenter", cohort=0.5, sparse=True,
                               async_="constant:bound=0"),
    "sparse-stragglers-q8": dict(systems="lognormal-stragglers", sparse=True,
                                 compression="q8", async_="poly:alpha=1,bound=1,buffer=4"),
    "free": dict(systems=FREE_NETWORK),
    "uniform-matching": dict(systems="uniform", network="matching"),
}


@pytest.mark.parametrize("case", list(ENGINE_SPECS))
def test_make_event_engine_bit_equal(case):
    """``make_event_engine`` for the same spec JSON, with the spec mixing's
    network as ``Experiment`` passes it: the engines equal, and the fleet
    reprices under another profile to the same seconds."""
    from repro.core.compression import make_byte_model as j_byte_model
    from repro.core.driver import predraw_schedule as j_predraw
    from repro_torch.core.driver import predraw_schedule

    n = 16
    kw = dict(algo="pisco", n_agents=n, t_o=2, p=0.25, seed=3, rounds=24, driver="events",
              topology="erdos_renyi", topology_kwargs={"prob": 0.4, "seed": 1})
    kw.update(ENGINE_SPECS[case])
    if kw.get("sparse"):
        kw.update(topology="random_regular", topology_kwargs={"degree": 4, "seed": 2})
    js = JSpec.create(**kw)
    ts = ExperimentSpec.from_json(js.to_json())
    jmix, tmix = js.make_mixing(), ts.make_mixing(CPU)
    jb = j_byte_model(jmix, {"w": jnp.zeros((n, 10))}, n)
    tb = make_byte_model(tmix, {"w": torch.zeros(n, 10)}, n)
    from repro.core.algorithms import get_algorithm as j_get

    jflags = j_predraw(j_get("pisco").make_default_schedule(js.config), 0, 24)
    from repro_torch.core.algorithms import get_algorithm

    tflags = predraw_schedule(get_algorithm("pisco").make_default_schedule(ts.config), 0, 24)
    np.testing.assert_array_equal(tflags, jflags)
    t = T.make_event_engine(ts, tb, tflags, network=tmix.network)
    j = J.make_event_engine(js, jb, jflags, network=jmix.network)
    _same_engine(t, j)
    assert t.sparse == j.sparse == ts.use_sparse
    if case == "free":
        assert t.trivial
    else:
        assert not t.trivial or case == "uniform-matching"
    from repro.events.clock import reprice_trace as j_reprice
    from repro.sim import make_systems_model as j_model
    from repro_torch.sim import make_systems_model

    np.testing.assert_array_equal(
        T.reprice_trace(t.trace, make_systems_model("wan-gossip", n, seed=3)),
        j_reprice(j.trace, j_model("wan-gossip", n, seed=3)))


# ---------------------------------------------------------------------------
# Staging: an engine block through EventNetwork into K4's and K3's plain
# versions, against the engine's dense W
# ---------------------------------------------------------------------------


def _engine_for(spec, n):
    from repro_torch.core.driver import predraw_schedule
    from repro_torch.core.algorithms import get_algorithm

    mixing = spec.make_mixing(CPU)
    bm = make_byte_model(mixing, {"w": torch.zeros(n, 10)}, n)
    flags = predraw_schedule(get_algorithm(spec.algo).make_default_schedule(spec.config),
                             0, spec.rounds)
    return T.make_event_engine(spec, bm, flags, network=mixing.network)


@pytest.mark.parametrize("network", [None, "bernoulli:0.3"])
def test_staged_sparse_block_is_the_engines_dense_w(network):
    """A sparse engine's block staged through the async mixing's
    ``EventNetwork``: per gossip round, the staged CSR (weights permuted
    into the base CSR's order) rebuilt as a matrix is the dense engine's
    W_k, and K4's plain version over it equals ``tree_agent_mix`` over W_k;
    the staged server operand is the engine's weights and keep mask."""
    n = 24
    spec = _spec(n_agents=n, topology="random_regular", topology_kwargs={"degree": 4, "seed": 2},
                 sparse=True, systems="lognormal-stragglers", network=network, driver="events",
                 async_="poly:alpha=0.5,bound=1,buffer=8", rounds=12)
    engine = _engine_for(spec, n)
    assert not engine.trivial and (engine.trace["active"].sum(1) <
                                   len(engine.base_edges)).any()
    dense = dataclasses.replace(engine, sparse=False)  # same fleet, dense draws
    w_dense = dense.draw_block(0, spec.rounds)[0]
    mixing = make_async_mixing(spec, CPU)
    net = mixing.network
    assert isinstance(net, EventNetwork) and net.sparse
    np.testing.assert_array_equal(engine.base_edges,
                                  make_sparse_topology("random_regular", n, degree=4,
                                                       seed=2).edges)
    net.engine = engine
    operands, messages, participants = net.device_block(0, spec.rounds)
    np.testing.assert_array_equal(messages, engine.messages)
    x = np.random.default_rng(4).normal(size=(n, 7)).astype(np.float32)
    for k in range(spec.rounds):
        net.stage(operands, k)
        np.testing.assert_array_equal(net.server_w["w"].numpy(),
                                      engine.weights[k].astype(np.float32))
        np.testing.assert_array_equal(net.server_w["keep"].numpy(),
                                      1.0 - engine.trace["participants"][k].astype(np.float32))
        if engine.flags[k]:
            continue
        indptr, indices, data, self_w = (t.numpy() for t in net.gossip_w)
        rebuilt = np.zeros((n, n), np.float32)
        for i in range(n):
            rebuilt[i, indices[indptr[i]:indptr[i + 1]]] += data[indptr[i]:indptr[i + 1]]
        rebuilt[np.arange(n), np.arange(n)] += self_w
        np.testing.assert_allclose(rebuilt, w_dense[k], atol=1e-7)
        got = ops.sparse_mix_csr(_t(x), *net.gossip_w).numpy()
        want = tree_agent_mix({"x": _t(x)}, _t(w_dense[k]))["x"].numpy()
        assert np.max(np.abs(got - want)) <= MIX_TOL * (1 + np.abs(x).max())
        np.testing.assert_array_equal(mixing.gossip({"x": _t(x)})["x"].numpy(), got)


def test_staged_dense_block_drives_k3_over_the_engines_w():
    """A dense engine's block staged through ``EventNetwork`` under q8d:
    the compressed gossip reads the staged W_k, and K3's plain version over
    it equals the difference form ``x + (W_k q - q)`` over the same codes."""
    n = 12
    spec = _spec(n_agents=n, topology="erdos_renyi", topology_kwargs={"prob": 0.4, "seed": 1},
                 systems="wan-gossip", async_="poly:alpha=0.5,bound=1,buffer=4", driver="events",
                 compression="q8d", rounds=10)
    engine = _engine_for(spec, n)
    assert not engine.trivial
    mixing = make_async_mixing(spec, CPU)
    net = mixing.network
    net.engine = engine
    operands, _, _ = net.device_block(0, spec.rounds)
    w_block = engine.draw_block(0, spec.rounds)[0]
    x = np.random.default_rng(5).normal(size=(n, 33)).astype(np.float32)
    for k in np.nonzero(~engine.flags)[0]:
        net.stage(operands, k)
        np.testing.assert_array_equal(net.gossip_w.numpy(), w_block[k])
        w, _ = mixing.compression._operands()
        assert w is net.gossip_w
        out, res = ops.compressed_mix(_t(x), None, net.gossip_w, ops.row_absmax(_t(x)), bits=8)
        assert res is None
        absmax = ops.row_absmax(_t(x))
        codes, _ = ops.quant_codes(_t(x), absmax, bits=8)
        scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, qmax_of(8))
        q = codes.to(torch.float32) * scale[:, None]
        want = _t(x) + (torch.from_numpy(w_block[k]) @ q - q)
        assert float((out - want).abs().max()) <= MIX_TOL * (1 + np.abs(x).max())
        np.testing.assert_array_equal(mixing.gossip({"x": _t(x)})["x"].numpy(), out.numpy())


# ---------------------------------------------------------------------------
# Whole runs through both packages
# ---------------------------------------------------------------------------

RUNS = {
    "pisco-dense-stragglers": dict(systems="lognormal-stragglers",
                                   async_="poly:alpha=0.5,bound=1,buffer=5"),
    "pisco-sparse-stragglers": dict(systems="lognormal-stragglers", sparse=True,
                                    async_="poly:alpha=0.5,bound=1,buffer=5"),
    "pisco-dense-wan-q8d": dict(systems="wan-gossip", compression="q8d",
                                async_="buffer:bound=1,buffer=4"),
    "pisco-sparse-wan-q8d": dict(systems="wan-gossip", compression="q8d", sparse=True,
                                 async_="buffer:bound=1,buffer=4"),
    "pisco-dense-bern-part": dict(systems="lognormal-stragglers", network="bernoulli:0.3",
                                  participation=0.5, async_="constant:bound=2"),
    "dsgt-sparse-stragglers": dict(algo="dsgt", systems="lognormal-stragglers", sparse=True,
                                   async_="poly:bound=1"),
    "fedavg-dense-edge": dict(algo="fedavg", systems="edge-vs-datacenter",
                              async_="poly:alpha=1.0,buffer=5"),
    "pisco-free": dict(systems=FREE_NETWORK),
}


def _run_both(js):
    ts = ExperimentSpec.from_json(js.to_json())
    assert ts.to_json() == js.to_json()
    n = js.config.n_agents
    x, y = synthetic_a9a(1600, d=24, seed=0)
    jd, td = JData.from_arrays(x, y, n), FederatedDataset.from_arrays(x, y, n)
    jh = JExperiment(js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)},
                     sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed)).run()
    th = Experiment(ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
                    sampler_factory=lambda s: RoundSampler(td, 16, s.config.t_o, s.config.seed,
                                                           device=CPU),
                    device=CPU).run()
    return ts, jh, th


@pytest.mark.parametrize("case", list(RUNS))
def test_events_whole_run_parity(case):
    """An events run through both packages: flags, realized bytes,
    ``sim_time_s``, ``staleness`` and the event trace equal; losses within
    LOSS_RTOL (q8d: Q8D_LOSS_RTOL); ``price_history`` of each package on its
    own History equal, under the run's profile and under another."""
    kw = dict(algo="pisco", n_agents=10, t_o=2, eta_l=0.3, p=0.3, seed=1, rounds=12,
              block_size=5, driver="events")
    kw.update(RUNS[case])
    js = JSpec.create(**kw)
    ts, jh, th = _run_both(js)
    assert th.is_global == [bool(f) for f in jh.is_global]
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    assert th.sim_time_s == list(jh.sim_time_s)
    assert th.staleness == jh.staleness and len(th.staleness) == 12
    assert th.to_dict()["staleness"] == jh.to_dict()["staleness"]
    for k, v in jh.event_trace.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(th.event_trace[k], v)
        else:
            assert th.event_trace[k] == v
    for systems in (None, "wan-gossip"):
        np.testing.assert_array_equal(price_history(th, ts, systems=systems),
                                      j_price_history(jh, js, systems=systems))
    if case != "pisco-free":
        assert np.max(th.staleness) > 0
    rtol = Q8D_LOSS_RTOL if "q8d" in case else LOSS_RTOL
    assert np.isfinite(th.loss).all()
    np.testing.assert_allclose(th.loss, jh.loss, rtol=rtol)


# ---------------------------------------------------------------------------
# Degenerate fleets: the events driver is the scan driver, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["pisco", "dsgt", "fedavg"])
def test_events_free_network_bit_identical_to_scan(algo):
    kw = dict(algo=algo, rounds=12, systems=FREE_NETWORK)
    h_scan = Experiment(_spec(driver="scan", **kw), **_pieces()).run()
    h_ev = Experiment(_spec(driver="events", **kw), **_pieces()).run()
    assert h_scan.is_global == h_ev.is_global
    assert h_scan.loss == h_ev.loss
    for k in h_scan.final_state.x:
        assert torch.equal(h_scan.final_state.x[k], h_ev.final_state.x[k])
    assert np.max(h_ev.staleness) == 0


@pytest.mark.parametrize("kw", [dict(sparse=True, compression="q8d"),
                                dict(network="bernoulli:0.3", participation=0.5)],
                         ids=["sparse-q8d", "dense-bern-part"])
def test_events_free_network_bit_identical_on_other_mixers(kw):
    """The trivial case binds the spec's own mixing, dynamic or compressed
    ones included: the run is the scan driver's, bit for bit."""
    kw = dict(rounds=12, systems=FREE_NETWORK, **kw)
    h_scan = Experiment(_spec(driver="scan", **kw), **_pieces()).run()
    h_ev = Experiment(_spec(driver="events", **kw), **_pieces()).run()
    assert h_scan.loss == h_ev.loss and h_scan.is_global == h_ev.is_global
    assert h_scan.accountant.per_round_bytes == h_ev.accountant.per_round_bytes


def test_events_uniform_fleet_matches_sync_times_too():
    kw = dict(rounds=12, systems="uniform")
    h_scan = Experiment(_spec(driver="scan", **kw), **_pieces()).run()
    h_ev = Experiment(_spec(driver="events", **kw), **_pieces()).run()
    assert h_scan.loss == h_ev.loss
    np.testing.assert_allclose(h_ev.sim_time_s, h_scan.sim_time_s, rtol=1e-9)


# ---------------------------------------------------------------------------
# Twins of tests/test_events.py: a heterogeneous fleet on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def straggler_pair():
    sync_spec = _spec(driver="scan", systems="lognormal-stragglers")
    async_spec = sync_spec.replace(driver="events", async_="poly:alpha=0.5,bound=1,buffer=3")
    return (sync_spec, Experiment(sync_spec, **_pieces()).run(),
            async_spec, Experiment(async_spec, **_pieces()).run())


def test_async_beats_the_barrier_under_stragglers(straggler_pair):
    _, h_sync, _, h_async = straggler_pair
    assert h_sync.is_global == h_async.is_global
    assert np.max(h_async.staleness) > 0
    assert sum(h_async.sim_time_s) < sum(h_sync.sim_time_s)
    assert h_async.loss[-1] < h_async.loss[3]


def test_events_run_is_seed_deterministic(straggler_pair):
    _, _, async_spec, h_async = straggler_pair
    h2 = Experiment(async_spec, **_pieces()).run()
    assert h_async.loss == h2.loss and h_async.sim_time_s == h2.sim_time_s
    assert h_async.staleness == h2.staleness


def test_event_trace_reprices_online_seconds_exactly(straggler_pair):
    _, _, async_spec, h_async = straggler_pair
    same = price_history(h_async, async_spec)
    assert np.array_equal(same, np.asarray(h_async.sim_time_s))
    wan = price_history(h_async, async_spec, systems="wan-gossip")
    assert wan.shape == same.shape and not np.array_equal(wan, same)


def test_history_exports_trace_and_staleness(straggler_pair):
    _, _, _, h_async = straggler_pair
    for key in TRACE_KEYS + ("n_agents",):
        assert key in h_async.event_trace
    payload = h_async.to_dict()
    assert "event_trace" not in payload
    assert len(payload["staleness"]) == ROUNDS
    assert all(len(row) == N_AGENTS for row in payload["staleness"])


def test_events_driver_registered():
    assert "events" in DRIVERS
    assert get_driver("events") is T.drive_events
    with pytest.raises(ValueError, match="unknown driver"):
        get_driver("warp")


def test_spec_validation():
    with pytest.raises(ValueError, match="async_ only applies"):
        _spec(driver="scan", systems="uniform", async_="constant")
    with pytest.raises(ValueError, match="needs a systems profile"):
        _spec(driver="events")
    with pytest.raises(ValueError):
        _spec(driver="events", systems="uniform", async_="warp")
    # the robust rules and the adversary stay refused, naming their item
    for kw in (dict(robust_agg="median"), dict(adversary="signflip:f=0.2")):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            _spec(driver="events", systems="uniform", async_="constant", **kw)


def test_spec_async_json_round_trip_and_legacy_payload():
    spec = _spec(driver="events", systems="lognormal-stragglers",
                 async_="poly:alpha=1.0,bound=2,buffer=3")
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert JSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    legacy = json.loads(spec.to_json())
    del legacy["async_"]
    assert ExperimentSpec.from_dict(legacy).async_ is None


def test_seed_sweep_refuses_events_and_grid_sweep_runs():
    spec = _spec(driver="events", systems="lognormal-stragglers", rounds=6,
                 async_="poly:bound=1")
    exp = Experiment(spec, **_pieces())
    with pytest.raises(ValueError, match="driver='events'"):
        exp.sweep(seeds=[0, 1])
    runs = exp.sweep(grid={"p": [0.2, 0.5]})
    assert [s.config.p for s, _ in runs] == [0.2, 0.5]
    assert all(len(h.staleness) == 6 and h.event_trace is not None for _, h in runs)


def test_tuner_sweeps_staleness_bound_for_events_specs():
    spec = _spec(driver="events", systems="lognormal-stragglers", rounds=8,
                 async_="poly:alpha=0.5,bound=2,buffer=3")
    res = tune(spec, _pieces(), p_grid=[0.2], staleness_grid=[1, None])
    assert {pt.staleness_bound for pt in res.points} == {1, None}
    assert all(pt.to_dict()["staleness_bound"] == pt.staleness_bound for pt in res.points)
    with pytest.raises(ValueError):
        tune(_spec(driver="scan", systems="lognormal-stragglers"), _pieces(), p_grid=[0.2],
             staleness_grid=[1], rounds=4)


def test_adversary_over_the_async_mixers_is_refused():
    # the spec itself refuses an adversary; set one past it to reach the mixer
    spec = _spec(driver="events", systems="uniform")
    object.__setattr__(spec, "adversary", "signflip:f=0.2")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        make_async_mixing(spec, CPU)


# ---------------------------------------------------------------------------
# The fig_async twin against benchmarks/fig_async.py
# ---------------------------------------------------------------------------


def test_fig_async_quick_cell_matches_reference():
    """fig_async's lognormal-stragglers cell at its quick size (200 rounds of
    the quick §5.1 workload, sync and async) through both packages: flags,
    seconds and staleness equal, losses within LOSS_RTOL, the readout's
    seconds and rounds equal to the reference's ``_readout``."""
    from benchmarks import common as jbench
    from benchmarks import fig_async as jfig
    from repro.sim.tuner import _smoothed
    from repro_torch.figures import common as tbench
    from repro_torch.figures import fig_async as tfig

    assert tfig.PROFILES_SWEPT == jfig.PROFILES_SWEPT
    jdata, jloss, _, jp0 = jbench.make_logreg_workload(quick=True, seed=0)
    tdata, tloss, _, tp0 = tbench.make_logreg_workload(quick=True, seed=0, device=CPU)
    b = min(256, tdata.samples_per_agent)
    window = 20
    t_sync, t_async = tfig.cell_specs(10, "lognormal-stragglers", 200)
    assert t_async.async_ == "poly:alpha=0.5,bound=2,buffer=5"
    hists = {}
    for name, ts in (("sync", t_sync), ("async", t_async)):
        js = JSpec.from_json(ts.to_json())
        jh = JExperiment(js, loss_fn=jloss, params0=jp0, sampler_factory=lambda s: JSampler(
            jdata, b, s.config.t_o, s.config.seed)).run()
        th = Experiment(ts, loss_fn=tloss, params0=tp0, device=CPU,
                        sampler_factory=lambda s: RoundSampler(tdata, b, s.config.t_o,
                                                               s.config.seed, device=CPU)).run()
        assert th.is_global == [bool(f) for f in jh.is_global]
        assert th.sim_time_s == list(jh.sim_time_s) and th.staleness == jh.staleness
        np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
        hists[name] = (th, jh)
    cell = tfig.cell_readout(hists["sync"][0], hists["async"][0], "lognormal-stragglers", window)
    target = 1.05 * max(float(_smoothed(h.loss, window)[-1])
                        for h in (hists["sync"][1], hists["async"][1]))
    np.testing.assert_allclose(cell["target_loss"], target, rtol=LOSS_RTOL)
    for name in ("sync", "async"):
        got, want = cell[name], jfig._readout(hists[name][1], cell["target_loss"], window)
        np.testing.assert_allclose(got.pop("final_loss"), want.pop("final_loss"), rtol=LOSS_RTOL)
        assert got == want
    speed = tfig.async_flip({"lognormal-stragglers": cell})
    assert speed == jfig.async_flip({"lognormal-stragglers": cell})
    assert speed["lognormal-stragglers"] > 1.0
