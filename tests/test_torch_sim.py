"""Simulated systems costs on the port (``repro_torch.sim``) against the JAX
package (``repro.sim``) on the same numpy inputs, and the port's twins of
``tests/test_sim.py``.

Tolerances: the host arithmetic (profile draws, round times, the priced
``sim_time_s`` series, tuner readouts in seconds, rounds and bytes) is
float64 numpy in both packages and is held **equal**, bit for bit.  Losses
of whole runs: within LOSS_RTOL = 1e-5 relative per round (float32 in two
frameworks' summation orders, as tests/test_torch_network.py)."""
import dataclasses
import functools
import json
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402
from conftest import make_logreg_problem as j_make_logreg_problem  # noqa: E402
from repro import sim as J  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro_torch import sim as T  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core.compression import make_byte_model  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)
LOSS_RTOL = 1e-5
N_AGENTS = 5
COMPUTE = 0.01  # the profiles' base seconds-per-local-step

PARAM_FIELDS = ("compute_s", "link_latency_s", "link_bw_Bps", "up_bw_Bps", "down_bw_Bps")


def _pieces(n=N_AGENTS):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=n)
    return dict(loss_fn=loss_fn, params0={"w": torch.zeros(d)}, device=CPU,
                sampler_factory=lambda s: sampler_factory(s.config.t_o))


def _j_pieces(n=N_AGENTS):
    loss_fn, _, sampler_factory, d = j_make_logreg_problem(n_agents=n)
    return dict(loss_fn=loss_fn, params0={"w": jnp.zeros(d)},
                sampler_factory=lambda s: sampler_factory(s.config.t_o))


def _experiment(spec, n=N_AGENTS):
    return Experiment(spec, **_pieces(n))


# ---------------------------------------------------------------------------
# Profiles: the same draws, the same grammar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
@pytest.mark.parametrize("name", sorted(J.PROFILES))
def test_profile_realizations_bit_equal(name, n, seed):
    """Every named profile's fleet at several sizes and seeds: each array
    equal to the reference's, bit for bit (compute multipliers drawn first,
    then the (n, n) latency multipliers, from the same tagged generator)."""
    jp, tp = J.make_profile(name).realize(n, seed=seed), T.make_profile(name).realize(n, seed=seed)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.server_rtt_s == jp.server_rtt_s
    assert tp.to_dict() == jp.to_dict()


@pytest.mark.parametrize("spec", ["uniform", "wan-gossip:latency=0.2,bw=1e6", T.FREE_NETWORK,
                                  "edge-vs-datacenter:compute=0.02,latency_sigma=0.5",
                                  "lognormal-stragglers:compute_sigma=1.2"])
def test_profile_specs_and_overrides_match_the_reference(spec):
    assert T.parse_systems_spec(spec) == J.parse_systems_spec(spec)
    tp, jp = T.make_profile(spec), J.make_profile(spec)
    assert tp.spec() == jp.spec() and tp.to_json() == jp.to_json()
    assert tp.params() == jp.params()
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp.realize(9, seed=2), f),
                                      getattr(jp.realize(9, seed=2), f))


@pytest.mark.parametrize("bad", ["wan-gosip", "uniform:latency", "uniform:warp=9", "uniform:bw=0",
                                 "uniform:up_bw=-1", "uniform:latency=-0.1",
                                 "uniform:compute=inf"])
def test_bad_profile_specs_raise_the_reference_errors(bad):
    with pytest.raises(ValueError) as want:
        J.parse_systems_spec(bad)
    with pytest.raises(ValueError) as got:
        T.parse_systems_spec(bad)
    assert str(got.value) == str(want.value)


def test_systems_params_json_across_packages():
    tp = T.make_profile(T.FREE_NETWORK).realize(3, seed=0)
    jp = J.SystemsParams.from_dict(json.loads(json.dumps(tp.to_dict())))
    back = T.SystemsParams.from_dict(json.loads(json.dumps(jp.to_dict())))
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(tp, f))


# ---------------------------------------------------------------------------
# Round times: round_time / round_parts bit-equal to the reference's
# ---------------------------------------------------------------------------

TIME_SPECS = {
    "dense-static": dict(),
    "dense-bern-part": dict(network="bernoulli:0.4", participation=0.6),
    "dense-matching-q8": dict(network="matching", compression="q8"),
    "sparse-static": dict(sparse=True),
    "sparse-cohort-part": dict(cohort=0.5, participation=0.5, sparse=True),
    "dsgt-rr": dict(algo="dsgt", network="roundrobin:2"),
}


@pytest.mark.parametrize("systems", ["lognormal-stragglers", "wan-gossip", "edge-vs-datacenter"])
@pytest.mark.parametrize("case", list(TIME_SPECS))
def test_round_times_bit_equal(case, systems):
    """``make_time_model`` of both packages for the same spec JSON (with and
    without the live network context): ``round_time`` and ``round_parts``
    equal, round by round and kind by kind; the parts sum to the time."""
    kw = dict(algo="pisco", n_agents=12, t_o=3, p=0.3, seed=4, systems=systems,
              topology="erdos_renyi", topology_kwargs={"prob": 0.4, "seed": 3})
    kw.update(TIME_SPECS[case])
    if kw.get("sparse"):
        kw.update(topology="random_regular", topology_kwargs={"degree": 4, "seed": 2})
    js = JSpec.create(**kw)
    ts = ExperimentSpec.from_json(js.to_json())
    tmix = ts.make_mixing(CPU)
    x0 = {"w": torch.zeros(12, 16)}
    tb = make_byte_model(tmix, x0, 12, mixes_per_round=2, server_payloads=2)
    from repro.core.compression import make_byte_model as j_byte_model

    jmix = js.make_mixing()
    jb = j_byte_model(jmix, {"w": jnp.zeros((12, 16))}, 12, mixes_per_round=2,
                      server_payloads=2)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    jtm = J.make_time_model(js, jb)
    for ttm in (T.make_time_model(ts, tb), T.make_time_model(ts, tb, network=tmix.network)):
        assert ttm.local_steps == jtm.local_steps
        np.testing.assert_array_equal(ttm.base_edges, jtm.base_edges)
        for k in range(8):
            for g in (False, True):
                assert ttm.round_time(k, g) == jtm.round_time(k, g)
                tp, jp = ttm.round_parts(k, g), jtm.round_parts(k, g)
                assert tp == jp and sum(tp.values()) == ttm.round_time(k, g)
        flags = [bool(f) for f in np.random.default_rng(1).random(10) < 0.3]
        np.testing.assert_array_equal(ttm.price_rounds(flags, start=3),
                                      jtm.price_rounds(flags, start=3))


def _tiny_model(pkg):
    lat = np.array([[0.0, 0.05, 0.1], [0.05, 0.0, 0.2], [0.1, 0.2, 0.0]])
    return pkg.SystemsModel(params=pkg.SystemsParams(
        compute_s=np.array([0.1, 0.2, 0.4]), link_latency_s=lat,
        link_bw_Bps=np.full((3, 3), 100.0), up_bw_Bps=np.array([10.0, 5.0, 2.0]),
        down_bw_Bps=np.array([20.0, 10.0, 4.0]), server_rtt_s=1.0))


def test_hand_computed_round_times_equal_the_reference():
    """The reference's hand-computed fleet (tests/test_sim.py): the gossip
    round gated by the slowest realized edge, the server round by the
    sample's straggler tail — equal in both packages and to the hand sums."""
    t, j = _tiny_model(T), _tiny_model(J)
    edges = np.array([[0, 1], [1, 2]])
    for e in (edges, edges[:1], np.zeros((0, 2), int)):
        assert t.gossip_round_time(e, 10, mixes=2, local_steps=3) == \
            j.gossip_round_time(e, 10, mixes=2, local_steps=3)
    assert t.gossip_round_time(edges, 10, mixes=2, local_steps=3) == pytest.approx(
        3 * 0.4 + 2 * 0.3)
    for parts in (np.array([0, 1, 2]), np.array([0, 1]), np.array([], int)):
        assert t.server_round_time(parts, 10, payloads=2) == \
            j.server_round_time(parts, 10, payloads=2)
    assert t.server_round_time(np.array([0, 1]), 10, payloads=2) == pytest.approx(
        0.2 + 1.0 + 20.0 / 5.0 + 20.0 / 10.0)


# ---------------------------------------------------------------------------
# Whole runs: sim_time_s equal, losses within LOSS_RTOL
# ---------------------------------------------------------------------------

RUNS = {
    "pisco-stragglers": dict(systems="lognormal-stragglers"),
    "pisco-wan-bern-part-loop": dict(systems="wan-gossip", network="bernoulli:0.4",
                                     participation=0.6, driver="loop"),
    "pisco-edge-sparse-cohort": dict(systems="edge-vs-datacenter", cohort=0.5, sparse=True),
    "pisco-lan-q8d": dict(systems="lan-gossip", compression="q8d"),
    "pisco-lan-sparse-q8d": dict(systems="lan-gossip", compression="q8d", sparse=True),
    "dsgt-wan-matching": dict(algo="dsgt", systems="wan-gossip", network="matching"),
    "fedavg-stragglers-part": dict(algo="fedavg", systems="lognormal-stragglers",
                                   participation=0.5),
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
def test_whole_run_sim_time_equal(case):
    """A timed run through both packages: flags, bytes and ``sim_time_s``
    equal round by round (and so the a2a/a2s split of ``to_dict``), losses
    within LOSS_RTOL; the reference's ``price_history`` on its History equals
    the port's on the port's."""
    kw = dict(algo="pisco", n_agents=10, t_o=2, eta_l=0.3, p=0.3, seed=1, rounds=12,
              block_size=5)
    kw.update(RUNS[case])
    js = JSpec.create(**kw)
    ts, jh, th = _run_both(js)
    assert th.is_global == [bool(f) for f in jh.is_global]
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    assert th.sim_time_s == list(jh.sim_time_s) and len(th.sim_time_s) == 12
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    td, jd = th.to_dict(), jh.to_dict()
    for key in ("sim_time_s", "sim_time_total_s", "sim_time_a2a_total_s", "sim_time_a2s_total_s",
                "sim_time_a2a_s", "sim_time_a2s_s", "staleness"):
        assert td[key] == jd[key], key
    np.testing.assert_array_equal(T.price_history(th, ts), J.price_history(jh, js))
    np.testing.assert_array_equal(T.price_history(th, ts, systems="lan-gossip"),
                                  J.price_history(jh, js, systems="lan-gossip"))
    assert np.isfinite(th.loss).all()
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# Tuner: grid, halving and retime against the reference
# ---------------------------------------------------------------------------


def _tuner_spec(rounds=60, pkg=ExperimentSpec):
    return pkg.create(algo="pisco", n_agents=N_AGENTS, t_o=1, eta_l=0.3, p=0.1, seed=0,
                      rounds=rounds, eval_every=rounds, driver="scan")


def _same_points(got, want):
    """Two TunerResults: the same order and readouts (seconds, rounds and
    bytes equal; the smoothed final loss within LOSS_RTOL)."""
    assert got.ranking() == want.ranking()
    assert (got.target_loss, got.window, got.systems, got.strategy) == pytest.approx(
        (want.target_loss, want.window, want.systems, want.strategy), rel=LOSS_RTOL)
    for a, b in zip(got.points, want.points):
        da, db = a.to_dict(), b.to_dict()
        np.testing.assert_allclose(da.pop("final_loss"), db.pop("final_loss"), rtol=LOSS_RTOL)
        assert da == db


@pytest.mark.parametrize("strategy", ["grid", "halving"])
def test_tuner_matches_the_reference(strategy):
    """``tune`` over p × τ through both packages (grid, and successive
    halving from 8 rounds): the same ranking, every point's time, rounds and
    bytes to the target equal; ``retime`` under two other profiles equal."""
    kw = dict(p_grid=[0.0, 0.3, 1.0], tau_grid=(1, 2), systems="lan-gossip",
              strategy=strategy, min_rounds=8)
    got = T.tune(_tuner_spec(40), _pieces(), **kw)
    want = J.tune(_tuner_spec(40, JSpec), _j_pieces(), **kw)
    _same_points(got, want)
    assert sorted(pt.rounds_run for pt in got.points) == sorted(pt.rounds_run for pt in want.points)
    for systems in ("wan-gossip", T.FREE_NETWORK):
        _same_points(T.retime(got, systems), J.retime(want, systems))
    target = 1.02 * max(pt.final_loss for pt in got.points)
    _same_points(T.retime(got, "wan-gossip", target_loss=target),
                 J.retime(want, "wan-gossip", target_loss=target))


def test_smoothing_and_window_match_the_reference():
    from repro.sim import tuner as jt
    from repro_torch.sim import tuner as tt

    v = np.random.default_rng(0).normal(size=37)
    for w in (1, 3, 20, 50):
        np.testing.assert_array_equal(tt._smoothed(v, w), jt._smoothed(v, w))
    assert [tt._auto_window(b) for b in (1, 9, 60, 150, 600)] == \
        [jt._auto_window(b) for b in (1, 9, 60, 150, 600)]


# ---------------------------------------------------------------------------
# Twins of tests/test_sim.py (the port alone)
# ---------------------------------------------------------------------------


def test_profile_spec_and_json_round_trips():
    for name in T.PROFILE_NAMES:
        p = T.make_profile(name)
        assert T.make_profile(p.spec()) == p
        assert T.Profile.from_json(p.to_json()) == p
    p = T.make_profile("wan-gossip:latency=0.2,bw=1e6")
    assert dict(p.overrides) == {"latency": 0.2, "bw": 1e6}
    assert T.make_profile(p.spec()) == p and T.Profile.from_dict(p.to_dict()) == p


def test_free_network_profile_is_actually_free():
    params = T.make_profile(T.FREE_NETWORK).realize(4, seed=0)
    assert np.all(params.link_latency_s == 0.0) and np.all(np.isinf(params.link_bw_Bps))
    assert np.all(np.isinf(params.up_bw_Bps)) and np.all(np.isinf(params.down_bw_Bps))
    assert params.server_rtt_s == 0.0


def test_profile_draws_pure_in_seed_and_classes():
    for name in ("lognormal-stragglers", "wan-gossip", "edge-vs-datacenter"):
        a = T.make_profile(name).realize(8, seed=5)
        b = T.make_profile(name).realize(8, seed=5)
        for f in PARAM_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.link_latency_s, a.link_latency_s.T)
        assert np.all(np.diag(a.link_latency_s) == 0.0)
    prof = T.make_profile("lognormal-stragglers")
    assert not np.array_equal(prof.realize(8, seed=0).compute_s, prof.realize(8, seed=1).compute_s)
    params = T.make_profile("edge-vs-datacenter").realize(6, seed=0)
    assert params.compute_s[:3].max() < params.compute_s[3:].min()
    assert params.up_bw_Bps[:3].min() > params.up_bw_Bps[3:].max()


def test_free_network_reduces_to_compute_only():
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=3, eta_l=0.1, p=0.5, seed=1,
        systems=T.FREE_NETWORK, rounds=6, driver="scan", block_size=2,
    )
    assert _experiment(spec).run().sim_time_s == [3 * COMPUTE] * 6
    hist = _experiment(spec.replace(algo="dsgt")).run()
    assert hist.sim_time_s == [COMPUTE] * 6
    assert hist.accountant.total_seconds == pytest.approx(6 * COMPUTE)


def test_sim_series_identical_across_drivers_and_posthoc():
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.3, seed=4,
        network="bernoulli:0.4", participation=0.6,
        systems="lognormal-stragglers", rounds=8, driver="scan", block_size=3,
    )
    h_scan = _experiment(spec).run()
    h_loop = _experiment(spec.replace(driver="loop")).run()
    assert len(h_scan.sim_time_s) == 8 and h_scan.sim_time_s == h_loop.sim_time_s
    np.testing.assert_array_equal(T.price_history(h_scan, spec), np.asarray(h_scan.sim_time_s))
    assert h_scan.accountant.agent_to_server_seconds > 0
    assert h_scan.accountant.agent_to_agent_seconds > 0
    assert h_scan.time_model is not None and "time_model" not in h_scan.to_dict()


def test_runs_without_systems_record_no_sim_time():
    spec = ExperimentSpec.create(algo="pisco", n_agents=N_AGENTS, t_o=1, eta_l=0.1, p=0.3,
                                 seed=0, rounds=4, driver="scan")
    hist = _experiment(spec).run()
    assert hist.sim_time_s == [] and hist.time_model is None
    d = hist.to_dict()
    assert d["sim_time_s"] == [] and d["sim_time_total_s"] == 0.0


def test_compression_shortens_simulated_transfers():
    kw = dict(algo="pisco", n_agents=N_AGENTS, t_o=1, eta_l=0.1, p=0.0, seed=0,
              systems="uniform:latency=0,bw=1e3,rtt=0", rounds=3, driver="scan")
    full = _experiment(ExperimentSpec.create(**kw)).run()
    q8 = _experiment(ExperimentSpec.create(compression="q8", **kw)).run()
    assert q8.byte_model.gossip_message_bytes < full.byte_model.gossip_message_bytes
    assert sum(q8.sim_time_s) < sum(full.sim_time_s)


def test_systems_spec_round_trips_in_both_packages():
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.15, p=0.3, seed=5,
        network="bernoulli:0.35", participation=0.6, systems="wan-gossip:latency=0.1", rounds=6,
    )
    for c in (ExperimentSpec.from_dict(spec.to_dict()), ExperimentSpec.from_json(spec.to_json()),
              pickle.loads(pickle.dumps(spec))):
        assert c == spec
    assert json.loads(spec.to_json())["systems"] == "wan-gossip:latency=0.1"
    assert JSpec.from_json(spec.to_json()).to_json() == spec.to_json()


def test_legacy_payloads_without_systems_load_bit_exact():
    spec = ExperimentSpec.create(algo="dsgt", n_agents=N_AGENTS, t_o=1, eta_l=0.1, p=0.3, seed=1,
                                 rounds=5, driver="scan")
    payload = spec.to_dict()
    payload.pop("systems")
    old = ExperimentSpec.from_dict(payload)
    assert old.systems is None and old == spec
    h_old, h_new = _experiment(old).run(), _experiment(spec).run()
    assert h_old.loss == h_new.loss
    assert h_old.accountant.per_round_bytes == h_new.accountant.per_round_bytes
    assert h_old.sim_time_s == [] == h_new.sim_time_s


def test_bad_systems_spec_fails_at_construction():
    with pytest.raises(ValueError, match="unknown systems profile"):
        ExperimentSpec.create(algo="pisco", n_agents=4, systems="wann-gossip")
    with pytest.raises(ValueError, match="bad systems override"):
        ExperimentSpec.create(algo="pisco", n_agents=4, systems="uniform:x=1")


def test_tuner_free_ranking_matches_rounds_ranking():
    res = T.tune(_tuner_spec(), _pieces(), p_grid=[0.0, 0.3, 1.0], systems=T.FREE_NETWORK)
    by_rounds = sorted(res.points, key=lambda pt: (
        0 if pt.rounds_to_target is not None else 1,
        pt.rounds_to_target if pt.rounds_to_target is not None else 0, pt.final_loss))
    assert res.ranking() == [(pt.p, pt.t_o) for pt in by_rounds]
    for pt in res.points:
        assert pt.total_sim_time_s == pytest.approx(pt.rounds_run * COMPUTE)


def test_tuner_flips_to_higher_p_when_gossip_crosses_the_wan():
    res = T.tune(_tuner_spec(), _pieces(), p_grid=[0.0, 1.0], systems="lan-gossip")
    target = 1.02 * max(pt.final_loss for pt in res.points)
    lan = T.retime(res, "lan-gossip", target_loss=target)
    wan = T.retime(res, "wan-gossip", target_loss=target)
    assert all(pt.time_to_target_s is not None for pt in lan.points + wan.points)
    assert lan.best.p == 0.0 and wan.best.p == 1.0
    for a, b in zip(sorted(lan.points, key=lambda pt: pt.p),
                    sorted(wan.points, key=lambda pt: pt.p)):
        assert (a.rounds_to_target, a.bytes_to_target, a.final_loss) == \
            (b.rounds_to_target, b.bytes_to_target, b.final_loss)


def test_tuner_halving_spends_less_and_reports_every_config():
    kw = dict(p_grid=[0.0, 0.3, 1.0], systems="lan-gossip")
    grid = T.tune(_tuner_spec(40), _pieces(), strategy="grid", **kw)
    halved = T.tune(_tuner_spec(40), _pieces(), strategy="halving", min_rounds=8, **kw)
    assert halved.best.rounds_run == 40
    assert sum(pt.rounds_run for pt in halved.points) < sum(pt.rounds_run for pt in grid.points)
    assert sorted(pt.p for pt in halved.points) == [0.0, 0.3, 1.0]
    assert halved.best.time_to_target_s is not None


def test_tuner_sweeps_tau_and_requires_systems():
    res = T.tune(_tuner_spec(16), _pieces(), p_grid=[0.1], tau_grid=(1, 3), systems=T.FREE_NETWORK)
    assert sorted(pt.t_o for pt in res.points) == [1, 3]
    for pt in res.points:
        assert pt.total_sim_time_s == pytest.approx(16 * pt.t_o * COMPUTE)
    with pytest.raises(ValueError, match="systems profile"):
        T.tune(_tuner_spec(8), _pieces(), p_grid=[0.1])
    with pytest.raises(ValueError, match="strategy"):
        T.tune(_tuner_spec(8), _pieces(), p_grid=[0.1], systems=T.FREE_NETWORK, strategy="bogus")


# ---------------------------------------------------------------------------
# The fig_timecost twin against benchmarks/fig_timecost.py
# ---------------------------------------------------------------------------


def test_fig_timecost_quick_tuner_matches_reference():
    """fig_timecost's quick PISCO tuner (p ∈ {0, 0.1, 1}, τ = 1, 150 rounds on
    the quick §5.1 workload, free profile) through both packages, then
    ``retime`` under lan- and wan-gossip: the same points, bests and curves
    (seconds equal, smoothed losses within LOSS_RTOL)."""
    from benchmarks import common as jbench
    from benchmarks import fig_timecost as jfig
    from repro_torch.figures import common as tbench
    from repro_torch.figures import fig_timecost as tfig

    assert (tfig.P_GRID, tfig.TAU_GRID, tfig.PROFILES_SWEPT) == \
        (jfig.P_GRID, jfig.TAU_GRID, jfig.PROFILES_SWEPT)
    jdata, jloss, _, jp0 = jbench.make_logreg_workload(quick=True, seed=0)
    tdata, tloss, _, tp0 = tbench.make_logreg_workload(quick=True, seed=0, device=CPU)
    b = min(256, tdata.samples_per_agent)
    kw = dict(algo="pisco", n_agents=10, t_o=1, eta_l=0.5, p=0.1, seed=0, rounds=150,
              eval_every=150, driver="scan")
    grid = dict(p_grid=[0.0, 0.1, 1.0], tau_grid=(1,), systems=T.FREE_NETWORK)
    want = J.tune(JSpec.create(**kw), dict(
        loss_fn=jloss, params0=jp0,
        sampler_factory=lambda s: JSampler(jdata, b, s.config.t_o, s.config.seed)), **grid)
    got = T.tune(ExperimentSpec.create(**kw), dict(
        loss_fn=tloss, params0=tp0, device=CPU,
        sampler_factory=lambda s: RoundSampler(tdata, b, s.config.t_o, s.config.seed,
                                               device=CPU)), **grid)
    _same_points(got, want)
    for prof in ("lan-gossip", "wan-gossip"):
        g, w = T.retime(got, prof), J.retime(want, prof)
        _same_points(g, w)
        tc, jc = tfig._curve(g.best, g.window, prof), jfig._curve(w.best, w.window, prof)
        assert tc["sim_time_s"] == jc["sim_time_s"]
        np.testing.assert_allclose(tc["loss"], jc["loss"], rtol=LOSS_RTOL, atol=1e-6)
    assert tfig._bytes_ranking(got) == jfig._bytes_ranking(want)
    profiles = {"lan-gossip": {"best_p": T.retime(got, "lan-gossip").best.p},
                "wan-gossip": {"best_p": T.retime(got, "wan-gossip").best.p}}
    assert tfig.tuner_flip(profiles) == jfig.tuner_flip(profiles)
