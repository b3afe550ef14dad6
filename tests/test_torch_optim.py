"""Update rules on the port (``repro_torch.optim``) against the JAX package
(``repro.optim``) on the same numpy inputs: every rule and chain, the
schedules, the string layer's precedence and errors, the opt-state policies
and FedOpt server steps, the rule paths of PISCO and the six baselines
(``sgd`` bit-identical to the inline path, Lemma 1 under momentum and Adam,
the priced extra payloads), whole runs through both ``Experiment.run``
calls, ``state_from_jax`` with rule state, and the port's twins of the 24
tests of ``tests/test_update_rules.py``."""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402
import repro.optim as JO  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
import repro_torch.optim as O  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec, registered_algorithms  # noqa: E402
from repro_torch.core.algorithms import (  # noqa: E402
    _build_pisco,
    get_algorithm,
    register_algorithm,
    unregister_algorithm,
)
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.optim.update_rules import (  # noqa: E402
    comm_opt_state,
    make_lr_schedule,
    map_state,
    parse_update_rule,
    resolve_update_rules,
)
from repro_torch.weights import state_from_jax, state_to_numpy  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)
N_AGENTS = 5
# rules on the same inputs: float32 arithmetic in the same order, but
# torch.pow / sqrt / cos may round an ulp apart from XLA's
RULE_TOL = 1e-6
LOSS_RTOL = 1e-5
# Whole runs' final rule state (momentum, Adam moments, server state): the
# largest deviation over the cases is 3.6e-7 absolute
# (tools/parity_readings.py); atol about three times that, rtol as the losses.
RULE_STATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(seed, n=4):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 2, 5)).astype(np.float32)}


def _flat(state):
    """Every array of a rule state (either package), in traversal order."""
    out = []

    def walk(s):
        if isinstance(s, dict):
            for k in sorted(s):
                walk(s[k])
        elif isinstance(s, (tuple, list)):
            for v in s:
                walk(v)
        else:
            out.append(np.asarray(s.numpy() if isinstance(s, torch.Tensor) else s))

    walk(state)
    return out


# ---------------------------------------------------------------------------
# Rules, chains and schedules against the reference
# ---------------------------------------------------------------------------

RULES = ["sgd", "sgd:lr=0.5", "momentum", "momentum:beta=0.8,lr=0.2", "nesterov", "adam",
         "adam:lr=0.05,b2=0.99", "adamw:lr=0.1,weight_decay=0.05", "clip:1.0|momentum",
         "clip:0.5|adam", "fedavgm", "fedadam", "fedadam:lr=0.05,eps=0.01"]


@pytest.mark.parametrize("spec", RULES)
def test_rules_match_the_reference(spec):
    jr, tr = JO.parse_update_rule(spec, lr=0.3), parse_update_rule(spec, lr=0.3)
    assert (tr.name, tr.n_buffers) == (jr.name, jr.n_buffers)
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jr.init(jp), tr.init(tp)
    for step in range(5):
        g = _tree(10 + step)
        ju, js = jr.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = tr.update({k: _t(v) for k, v in g.items()}, ts, tp)
        jp, tp = JO.apply_updates(jp, ju), O.apply_updates(tp, tu)
        for k in params:
            for got, want in ((tu[k], ju[k]), (tp[k], jp[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RULE_TOL,
                                           rtol=RULE_TOL)
        for a, b in zip(_flat(ts), _flat(js)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=RULE_TOL, rtol=RULE_TOL)


def test_sgd_rule_step_is_the_inline_step_bit_for_bit():
    x, y = _tree(1), _tree(2)
    rule = O.sgd(0.3)
    upd, _ = rule.update({k: _t(v) for k, v in y.items()}, rule.init({"a": _t(x["a"])}), None)
    for k in x:
        got = O.apply_updates({k: _t(x[k])}, {k: upd[k]})[k]
        assert torch.equal(got, _t(x[k]) - 0.3 * _t(y[k]))


@pytest.mark.parametrize("spec", ["linear", "linear:final=0.1", "cosine", "cosine:final=0.01",
                                  "warmup_cosine", "warmup_cosine:warmup=0.2,final=0.05"])
def test_schedules_match_the_reference(spec):
    js, ts = JO.make_lr_schedule(spec, 0.5, 40), make_lr_schedule(spec, 0.5, 40)
    for c in (0, 1, 3, 4, 7, 20, 39, 40, 55):
        got = ts(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(js(jnp.asarray(c, jnp.int32))), rtol=1e-6,
                                   atol=1e-7)
    rule_j = JO.parse_update_rule("momentum", lr=js, force_lr=True)
    rule_t = parse_update_rule("momentum", lr=ts, force_lr=True)
    g = _tree(3)
    jst, tst = rule_j.init({k: jnp.asarray(v) for k, v in g.items()}), rule_t.init(
        {k: _t(v) for k, v in g.items()})
    for _ in range(6):
        ju, jst = rule_j.update({k: jnp.asarray(v) for k, v in g.items()}, jst, None)
        tu, tst = rule_t.update({k: _t(v) for k, v in g.items()}, tst, None)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=RULE_TOL,
                                       atol=RULE_TOL)


@pytest.mark.parametrize("spec", ["adamax", "clip:1.0", "adam|clip:1.0", "momentum:0.9,0.1",
                                  "", "sgd:lr=x"])
def test_parse_update_rule_errors_match_the_reference(spec):
    with pytest.raises(ValueError) as want:
        JO.parse_update_rule(spec)
    with pytest.raises(ValueError) as got:
        parse_update_rule(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [
    ("momentum", None, None, None), ("sgd:lr=0.1", None, "linear:final=0.0", None),
    (None, "fedadam", None, "keep"), ("adam:0.02", "sgd:lr=0.5", "cosine", "reset"),
    (None, None, "warmup_cosine", None),
])
def test_resolve_update_rules_matches_the_reference(args):
    jk = JO.resolve_update_rules(*args, eta_l=0.2, rounds=10, t_o=2)
    tk = resolve_update_rules(*args, eta_l=0.2, rounds=10, t_o=2)
    assert sorted(tk) == sorted(jk)
    assert tk.get("opt_policy") == jk.get("opt_policy")
    g = _tree(4)
    for key in ("local_opt", "server_opt"):
        if key not in jk:
            continue
        jr, tr = jk[key], tk[key]
        assert (tr.name, tr.n_buffers) == (jr.name, jr.n_buffers)
        jst, tst = jr.init({k: jnp.asarray(v) for k, v in g.items()}), tr.init(
            {k: _t(v) for k, v in g.items()})
        for _ in range(4):
            ju, jst = jr.update({k: jnp.asarray(v) for k, v in g.items()}, jst, None)
            tu, tst = tr.update({k: _t(v) for k, v in g.items()}, tst, None)
            for k in g:
                np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=RULE_TOL,
                                           atol=RULE_TOL)


def test_server_step_matches_the_reference():
    old, new = _tree(5), _tree(6)
    for spec in ("sgd:lr=1.0", "fedavgm", "fedadam"):
        jr, tr = JO.parse_update_rule(spec, lr=1.0), parse_update_rule(spec, lr=1.0)
        jst = jr.init({k: jnp.asarray(v) for k, v in old.items()})
        tst = tr.init({k: _t(v) for k, v in old.items()})
        for _ in range(3):
            jx, jst = JO.server_step(jr, jst, {k: jnp.asarray(v) for k, v in old.items()},
                                     {k: jnp.asarray(v) for k, v in new.items()})
            tx, tst = O.server_step(tr, tst, {k: _t(v) for k, v in old.items()},
                                    {k: _t(v) for k, v in new.items()})
            for k in old:
                np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]), rtol=RULE_TOL,
                                           atol=RULE_TOL)
        if spec == "sgd:lr=1.0":
            for k in old:  # plain averaging up to float association
                np.testing.assert_allclose(tx[k].numpy(), new[k], atol=1e-6)


def test_step_count_stays_on_the_device_tensor():
    """The count is a 0-dim int32 tensor beside the params, and a schedule
    reads it with torch ops (no host value): its step is a tensor too."""
    rule = parse_update_rule("adam", lr=make_lr_schedule("cosine", 0.1, 10), force_lr=True)
    params = {"a": torch.zeros(3, 2)}
    state = rule.init(params)
    counts = [s for s in _flat(state) if s.ndim == 0]
    assert len(counts) == 2 and all(c.dtype == np.int32 for c in counts)
    _, state = rule.update({"a": torch.ones(3, 2)}, state, params)
    assert all(isinstance(c, torch.Tensor) for c in (state[0]["count"], state[1]["count"]))
    assert int(state[1]["count"]) == 1


# ---------------------------------------------------------------------------
# Whole runs through both packages, and state carried across
# ---------------------------------------------------------------------------

RUNS = {
    "pisco-adam-fedadam": dict(optimizer="adam:lr=0.05", server_optimizer="fedadam"),
    "pisco-momentum-keep-sched": dict(optimizer="momentum:lr=0.1", opt_policy="keep",
                                      lr_schedule="cosine"),
    "pisco-momentum-dyn-q8d": dict(optimizer="momentum:lr=0.1", network="bernoulli:0.35",
                                   participation=0.6, compression="q8d"),
    # Adam's second moment stays local: moved through quantised gossip it
    # can turn negative (an agent's v_i - (1 - W_ii) q_i < 0 where q_i rounds
    # v_i up by more than half), and both packages then run into NaN
    "pisco-adam-sparse-cohort-q8d": dict(optimizer="adam:lr=0.05", opt_policy="keep",
                                         cohort=0.5, compression="q8d", sparse=True),
    "pisco-momentum-sparse-cohort-q8d": dict(optimizer="momentum:lr=0.1", cohort=0.5,
                                             compression="q8d", sparse=True),
    "dsgt-nesterov-fedavgm": dict(algo="dsgt", optimizer="nesterov:lr=0.1",
                                  server_optimizer="fedavgm"),
    "dsgd-clip-adam": dict(algo="dsgd", optimizer="clip:1.0|adam:lr=0.05"),
    "gossip_pga-momentum-reset": dict(algo="gossip_pga", optimizer="momentum:lr=0.1",
                                      opt_policy="reset"),
    "periodical_gt-adamw": dict(algo="periodical_gt", optimizer="adamw:lr=0.05"),
    "fedavg-fedadam": dict(algo="fedavg", server_optimizer="fedadam"),
    "scaffold-momentum-fedavgm": dict(algo="scaffold", optimizer="momentum:lr=0.1",
                                      server_optimizer="fedavgm"),
}


def _specs(**kw):
    base = dict(algo="pisco", n_agents=8, t_o=2, eta_l=0.3, p=0.3, seed=1, rounds=7,
                eval_every=3, block_size=3)
    base.update(kw)
    js = JSpec.create(**base)
    return js, ExperimentSpec.from_json(js.to_json())


def _run_both(js, ts):
    n = js.config.n_agents
    x, y = synthetic_a9a(1600, d=24, seed=0)
    jd, td = JData.from_arrays(x, y, n), FederatedDataset.from_arrays(x, y, n)
    jh = JExperiment(js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)},
                     sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed)).run()
    th = Experiment(ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)}, device=CPU,
                    sampler_factory=lambda s: RoundSampler(td, 16, s.config.t_o, s.config.seed,
                                                           device=CPU)).run()
    return jh, th


@pytest.mark.parametrize("case", list(RUNS))
def test_whole_run_parity(case):
    """Losses per round to 1e-5, flags and bytes equal round by round, the
    rule state at the end within RULE_STATE_TOL."""
    js, ts = _specs(**RUNS[case])
    jh, th = _run_both(js, ts)
    assert th.is_global == [bool(f) for f in jh.is_global]
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    assert np.isfinite(th.loss).all() and np.isfinite(jh.loss).all()
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.grad_sq_norm, jh.grad_sq_norm, rtol=1e-3, atol=1e-9)
    for a, b in zip(_flat(th.final_state.opt), _flat(jh.final_state.opt)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **RULE_STATE_TOL)


@pytest.mark.parametrize("algo", ["pisco", "dsgt", "scaffold", "dsgd"])
def test_state_from_jax_carries_rule_state(algo):
    """A reference state with non-empty rule state crosses over, and one
    round from it in both packages agrees (the rules read what crossed)."""
    js, ts = _specs(algo=algo, optimizer="adam:lr=0.05", server_optimizer="fedavgm",
                    rounds=3)
    jh, _ = _run_both(js, ts)
    jstate = jax.tree.map(np.asarray, jh.final_state)
    tstate = state_from_jax(jstate, CPU)
    assert type(tstate).__name__ == type(jh.final_state).__name__
    back = state_to_numpy(tstate)
    for a, b in zip(_flat(back["opt"]), _flat(jstate.opt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jb = get_algorithm(algo)
    from repro.core.algorithms import get_algorithm as j_get

    n = js.config.n_agents
    rng = np.random.default_rng(0)
    a = rng.normal(size=(js.config.t_o + 1, n, 16, 24)).astype(np.float32)
    lab = np.where(rng.random((js.config.t_o + 1, n, 16)) > 0.5, 1.0, -1.0).astype(np.float32)
    kw = resolve_update_rules(js.optimizer, js.server_optimizer, eta_l=js.config.eta_l,
                              rounds=js.rounds, t_o=js.config.t_o)
    jkw = JO.resolve_update_rules(js.optimizer, js.server_optimizer, eta_l=js.config.eta_l,
                                  rounds=js.rounds, t_o=js.config.t_o)
    for glob in (False, True):
        tb = jb.bind(T_LOSS, ts.config, ts.make_mixing(CPU), **kw)
        jbound = j_get(algo).bind(J_LOSS, js.config, js.make_mixing(), **jkw)
        tfn = tb.global_round if glob else tb.gossip_round
        jfn = jbound.global_round if glob else jbound.gossip_round
        tout, _ = tfn(tstate, (_t(a[:-1]), _t(lab[:-1])), (_t(a[-1]), _t(lab[-1])))
        jout, _ = jfn(jh.final_state, (jnp.asarray(a[:-1]), jnp.asarray(lab[:-1])),
                      (jnp.asarray(a[-1]), jnp.asarray(lab[-1])))
        np.testing.assert_allclose(tout.x["w"].numpy(), np.asarray(jout.x["w"]), rtol=1e-5,
                                   atol=1e-6)
        for x_, y_ in zip(_flat(tout.opt), _flat(jout.opt)):
            np.testing.assert_allclose(x_, np.asarray(y_), rtol=1e-5, atol=1e-6)


def test_lm_state_from_jax_flattens_rule_buffers():
    from repro_torch.weights import lm_state_from_jax

    class S:  # a reference PiscoState over a nested tree, as numpy
        pass

    st = S()
    tree = {"emb": np.ones((2, 3), np.float32), "layers": {"w": np.zeros((2, 4), np.float32)}}
    st.x = st.y = st.g = tree
    st.step, st.ef = np.int32(4), ()
    st.opt = {"local": ({"mu": tree}, {"count": np.int32(7)}), "server": ()}
    out = lm_state_from_jax(st, CPU)
    mu = out.opt["local"][0]["mu"]
    assert sorted(mu) == sorted(out.x) == ["emb", "layers/w"]
    assert int(out.opt["local"][1]["count"]) == 7 and out.opt["server"] == ()


# ---------------------------------------------------------------------------
# Twins of tests/test_update_rules.py
# ---------------------------------------------------------------------------


def _spec(algo="pisco", **kw):
    base = dict(algo=algo, n_agents=N_AGENTS, t_o=2, eta_l=0.15, eta_c=0.7, p=0.3,
                seed=0, rounds=7, eval_every=3, driver="scan", block_size=3)
    base.update(kw)
    return ExperimentSpec.create(**base)


def _run(spec):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=N_AGENTS)
    return Experiment(
        spec, loss_fn=loss_fn, params0={"w": torch.zeros(d)}, device=CPU,
        sampler_factory=lambda s: sampler_factory(s.config.t_o, seed=s.config.seed),
    ).run()


def _assert_histories_bit_identical(h0, h1):
    assert h0.loss == h1.loss
    assert h0.grad_sq_norm == h1.grad_sq_norm
    assert h0.consensus_err == h1.consensus_err
    assert h0.is_global == h1.is_global
    assert h0.accountant.per_round_bytes == h1.accountant.per_round_bytes
    assert h0.accountant.total_bytes == h1.accountant.total_bytes


def _gt_gap(hist):
    s = hist.final_state
    return max(float((s.y[k].mean(0) - s.g[k].mean(0)).abs().max()) for k in s.y)


@pytest.mark.parametrize("driver", ["loop", "scan"])
@pytest.mark.parametrize("algo", registered_algorithms())
def test_sgd_rule_is_bit_identical_to_legacy(algo, driver):
    h_legacy = _run(_spec(algo=algo, driver=driver))
    h_rule = _run(_spec(algo=algo, driver=driver, optimizer="sgd"))
    _assert_histories_bit_identical(h_legacy, h_rule)
    assert torch.equal(h_legacy.final_state.x["w"], h_rule.final_state.x["w"])


def test_sgd_rule_bit_identical_under_dynamic_network_and_compression():
    for kw in (dict(network="bernoulli:0.35", participation=0.6),
               dict(compression="q8"),
               dict(network="matching", participation=0.6, compression="q8d", sparse=True)):
        _assert_histories_bit_identical(_run(_spec(**kw)), _run(_spec(optimizer="sgd", **kw)))


@pytest.mark.parametrize("driver", ["loop", "scan"])
@pytest.mark.parametrize("policy", ["mix", "keep", "reset"])
@pytest.mark.parametrize("opt", ["momentum", "adam:lr=0.05"])
def test_lemma1_invariant_under_rules(opt, policy, driver):
    h = _run(_spec(optimizer=opt, opt_policy=policy, driver=driver))
    assert np.isfinite(h.loss).all()
    assert _gt_gap(h) < 1e-5


@pytest.mark.parametrize("algo", ["periodical_gt", "dsgt"])
def test_lemma1_invariant_for_tracking_baselines_under_momentum(algo):
    assert _gt_gap(_run(_spec(algo=algo, optimizer="momentum:lr=0.05"))) < 1e-5


@pytest.mark.parametrize("policy", ["mix", "keep", "reset"])
def test_lemma1_under_rules_dynamic_compressed(policy):
    """Rule buffers under the "mix" policy move through the round's W_k (or
    S_k on a server round) and compressed gossip: Lemma 1 holds."""
    h = _run(_spec(optimizer="adam:lr=0.05", opt_policy=policy, network="matching",
                   participation=0.6, compression="q8", rounds=9))
    assert np.isfinite(h.loss).all() and _gt_gap(h) < 2e-5


def test_rule_path_scan_matches_loop():
    kw = dict(optimizer="momentum:lr=0.1", server_optimizer="fedavgm")
    _assert_histories_bit_identical(_run(_spec(driver="loop", **kw)),
                                    _run(_spec(driver="scan", **kw)))


def test_spec_round_trips_optimizer_fields():
    spec = _spec(optimizer="clip:1.0|momentum:beta=0.8", server_optimizer="fedadam:lr=0.05",
                 lr_schedule="cosine:final=0.01", opt_policy="keep")
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert JSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    payload = json.loads(spec.to_json())
    assert payload["optimizer"] == "clip:1.0|momentum:beta=0.8"
    assert payload["server_optimizer"] == "fedadam:lr=0.05"
    assert payload["lr_schedule"] == "cosine:final=0.01"
    assert payload["opt_policy"] == "keep"


def test_legacy_payload_resolves_to_bit_exact_sgd_default():
    spec = _spec()
    payload = spec.to_dict()
    for key in ("optimizer", "server_optimizer", "lr_schedule", "opt_policy"):
        assert payload.pop(key) is None
    legacy = ExperimentSpec.from_dict(payload)
    assert legacy == spec
    _assert_histories_bit_identical(_run(legacy), _run(spec))


def test_spec_rejects_malformed_optimizer_strings():
    with pytest.raises(ValueError, match="unknown update rule"):
        _spec(optimizer="adamax")
    with pytest.raises(ValueError, match="cannot terminate"):
        _spec(optimizer="clip:1.0")
    with pytest.raises(ValueError, match="unknown lr schedule"):
        _spec(lr_schedule="step")
    with pytest.raises(ValueError, match="opt_policy"):
        _spec(opt_policy="teleport")


def test_optimizer_is_update_rule():
    assert O.Optimizer is O.UpdateRule
    from repro_torch.optim.optimizers import apply_updates as legacy_apply

    assert legacy_apply is O.apply_updates


def test_chain_trace_adam_compose_and_descend():
    params = {"w": torch.tensor([3.0, -2.0])}

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for rule in (
        O.chain(O.trace(0.9), O.scale_by_learning_rate(0.02)),
        O.chain(O.clip_by_global_norm(1.0), O.scale_by_adam(), O.scale(-0.1)),
        parse_update_rule("clip:0.5|adamw:lr=0.1,weight_decay=0.0"),
    ):
        p, state = params, rule.init(params)
        for _ in range(300):
            g = torch.func.grad(loss)(p)
            updates, state = rule.update(g, state, p)
            p = O.apply_updates(p, updates)
        assert float(loss(p)) < 1e-2, rule.name


def test_clip_by_global_norm_caps_update():
    rule = O.clip_by_global_norm(1.0)
    g = {"a": torch.tensor([30.0, 40.0])}
    out, _ = rule.update(g, rule.init(g), None)
    np.testing.assert_allclose(out["a"].numpy(), [0.6, 0.8], rtol=1e-6)
    out, _ = rule.update({"a": torch.tensor([0.3, 0.4])}, (), None)
    np.testing.assert_allclose(out["a"].numpy(), [0.3, 0.4], rtol=1e-6)


def test_n_buffers_metadata():
    assert O.sgd(0.1).n_buffers == 0
    assert O.momentum(0.1).n_buffers == 1
    assert O.adam(0.1).n_buffers == 2
    assert parse_update_rule("clip:1.0|adam").n_buffers == 2


def test_parse_update_rule_lr_precedence():
    g = {"w": torch.ones(2)}

    def first_step(rule):
        u, _ = rule.update(g, rule.init(g), g)
        return float(u["w"][0])

    assert first_step(parse_update_rule("sgd", lr=0.25)) == pytest.approx(-0.25)
    assert first_step(parse_update_rule("sgd:lr=0.5", lr=0.25)) == pytest.approx(-0.5)
    assert first_step(parse_update_rule("sgd:0.5", lr=0.25)) == pytest.approx(-0.5)
    assert first_step(parse_update_rule("fedadam", lr=0.25)) == pytest.approx(-0.1, rel=1e-3)
    assert first_step(parse_update_rule("sgd:lr=0.5", lr=0.25, force_lr=True)) == \
        pytest.approx(-0.25)


def test_make_lr_schedule_wires_optim_schedules():
    sched = make_lr_schedule("cosine:final=0.1", 1.0, 100)
    assert callable(sched)
    assert float(sched(torch.tensor(0))) == pytest.approx(1.0)
    assert float(sched(torch.tensor(100))) == pytest.approx(0.1)
    assert make_lr_schedule(None, 0.3, 100) == 0.3
    assert make_lr_schedule("constant", 0.3, 100) == 0.3


def test_lr_schedule_composes_with_explicit_lr():
    g = {"w": torch.ones(3)}

    def step_mags(optimizer, n=10):
        rule = resolve_update_rules(optimizer, None, "linear:final=0.0", eta_l=0.5, rounds=n,
                                    t_o=0)["local_opt"]
        state, mags = rule.init(g), []
        for _ in range(n):
            u, state = rule.update(g, state, g)
            mags.append(float(u["w"][0].abs()))
        return mags

    mags = step_mags("sgd:lr=0.1")
    assert mags[0] == pytest.approx(0.1, rel=1e-5)
    assert mags[-1] == pytest.approx(0.01, rel=1e-4)
    assert step_mags("momentum:lr=0.1")[0] == pytest.approx(0.1, rel=1e-5)


def test_lr_schedule_decays_local_lr_per_round():
    h_const = _run(_spec(rounds=12))
    h_sched = _run(_spec(rounds=12, lr_schedule="linear:final=0.0"))
    assert np.isfinite(h_sched.loss).all()
    assert h_const.loss != h_sched.loss


def test_server_sgd_unit_lr_recovers_plain_averaging():
    h_avg = _run(_spec(algo="fedavg"))
    h_srv = _run(_spec(algo="fedavg", server_optimizer="sgd:lr=1.0"))
    np.testing.assert_allclose(h_avg.loss, h_srv.loss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_avg.final_state.x["w"].numpy(),
                               h_srv.final_state.x["w"].numpy(), rtol=1e-5, atol=1e-6)


def test_server_rule_prices_extra_payload():
    h0 = _run(_spec(algo="pisco"))
    h1 = _run(_spec(algo="pisco", server_optimizer="fedadam", opt_policy="keep"))
    assert h0.is_global == h1.is_global
    bm0, bm1 = h0.byte_model, h1.byte_model
    assert bm1.server_payloads == bm0.server_payloads + 1
    assert bm1.gossip_round_bytes == bm0.gossip_round_bytes
    assert bm1.server_round_bytes > bm0.server_round_bytes
    # realized pricing composes: participation prices m participants' payloads
    h2 = _run(_spec(algo="pisco", server_optimizer="fedadam", participation=0.6))
    srv = [b for b, g in zip(h2.accountant.per_round_bytes, h2.is_global) if g]
    assert srv and all(b == 3 * 2 * 3 * 64 for b in srv)  # 3 payloads, m = 3 of 5


def test_mix_policy_prices_buffer_streams():
    base = _run(_spec())
    mom = _run(_spec(optimizer="momentum", opt_policy="mix"))
    adam = _run(_spec(optimizer="adam", opt_policy="mix"))
    kept = _run(_spec(optimizer="momentum", opt_policy="keep"))
    assert mom.byte_model.mixes_per_round == base.byte_model.mixes_per_round + 1
    assert adam.byte_model.mixes_per_round == base.byte_model.mixes_per_round + 2
    assert kept.byte_model.mixes_per_round == base.byte_model.mixes_per_round
    assert mom.byte_model.gossip_round_bytes > base.byte_model.gossip_round_bytes


def test_fedopt_scenarios_converge_end_to_end():
    for kw in (dict(optimizer="momentum:lr=0.1"), dict(server_optimizer="fedadam"),
               dict(optimizer="momentum:lr=0.1", server_optimizer="fedavgm")):
        h = _run(_spec(rounds=20, **kw))
        assert np.isfinite(h.loss).all() and h.loss[-1] < h.loss[0]


def test_comm_opt_state_policies():
    n = 4
    opt = {"count": torch.tensor(3, dtype=torch.int32),
           "mu": {"w": torch.arange(8.0).reshape(n, 2)}}

    def mean(t):
        return {k: v.mean(0, keepdim=True).expand(v.shape).contiguous() for k, v in t.items()}

    assert comm_opt_state(opt, mean, n, "keep", is_global=True) is opt
    mixed = comm_opt_state(opt, mean, n, "mix", is_global=True)
    np.testing.assert_allclose(mixed["mu"]["w"].numpy(), np.tile([[3.0, 4.0]], (n, 1)))
    assert int(mixed["count"]) == 3
    same = comm_opt_state(opt, mean, n, "reset", is_global=False)
    assert torch.equal(same["mu"]["w"], opt["mu"]["w"])
    zeroed = comm_opt_state(opt, mean, n, "reset", is_global=True)
    assert float(zeroed["mu"]["w"].abs().sum()) == 0.0 and int(zeroed["count"]) == 3
    with pytest.raises(ValueError, match="opt policy"):
        comm_opt_state(opt, mean, n, "nope")
    assert map_state(lambda v: v + 1, ({"a": torch.zeros(1)},))[0]["a"].item() == 1.0


def test_resolve_update_rules_empty_when_unset():
    assert resolve_update_rules(eta_l=0.1, rounds=10, t_o=2) == {}
    kw = resolve_update_rules("momentum", "fedadam", "cosine", "keep", eta_l=0.1, rounds=10,
                              t_o=2)
    assert set(kw) == {"local_opt", "server_opt", "opt_policy"}


def test_registry_entry_optimizer_defaults():
    name = "pisco_m_test"
    register_algorithm(name, mixes_per_round=2, local_opt="momentum:beta=0.9", opt_policy="mix",
                       description="PISCO-M: momentum local steps")(_build_pisco)
    try:
        h = _run(_spec(algo=name))
        assert np.isfinite(h.loss).all()
        assert h.byte_model.mixes_per_round == 3
        assert _gt_gap(h) < 1e-5
    finally:
        unregister_algorithm(name)
    with pytest.raises(ValueError, match="opt_policy"):
        register_algorithm("bad_policy_test", opt_policy="nope")(_build_pisco)
    unregister_algorithm("bad_policy_test")


def test_multi_seed_sweep_with_rules():
    """Each seed runs through run()'s own driver: the seed equal to the
    spec's reproduces run() bit for bit, rule state included."""
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=N_AGENTS)
    spec = _spec(optimizer="momentum:lr=0.1", server_optimizer="fedavgm", rounds=6)
    exp = Experiment(spec, loss_fn=loss_fn, params0={"w": torch.zeros(d)}, device=CPU,
                     sampler_factory=lambda s: sampler_factory(s.config.t_o, seed=s.config.seed))
    hists = exp.sweep(seeds=[0, 1])
    single = exp.run()
    assert hists[0].loss == single.loss
    for a, b in zip(_flat(hists[0].final_state.opt), _flat(single.final_state.opt)):
        np.testing.assert_array_equal(a, b)
    for h in hists:
        assert len(h.loss) == 6 and np.isfinite(h.loss).all() and h.final_state is not None


# ---------------------------------------------------------------------------
# The fig_optimizers twin against benchmarks/fig_optimizers.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logreg_quick():
    from benchmarks import common as jbench
    from repro_torch.figures import common as tbench

    return jbench.make_logreg_workload(quick=True, seed=0), tbench.make_logreg_workload(
        quick=True, seed=0, device=CPU)


@pytest.mark.parametrize("local,server", [("momentum:lr=0.1", "fedavgm"),
                                          ("adam:lr=0.05", "fedadam"), (None, None)])
def test_fig_optimizers_quick_cell_matches_reference(logreg_quick, local, server):
    """One cell of the quick sweep (p = 0.2, T_o = 2, 120 rounds) through
    both packages' ``run_pisco_variant``: flags and bytes equal round by
    round, the eval series within 1e-4 relative (1e-7 absolute near the
    optimum), the readout equal but for the final
    gradient norm and loss (1e-5)."""
    from benchmarks import common as jbench
    from benchmarks import fig_optimizers as jfig
    from repro_torch.figures import common as tbench
    from repro_torch.figures import fig_optimizers as tfig

    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = logreg_quick
    kw = dict(p=0.2, t_o=2, eta_l=0.3, rounds=120, seed=0, optimizer=local,
              server_optimizer=server)
    jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval, params0=jp0, **kw)
    th, _ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval, params0=tp0,
                                     device=CPU, **kw)
    assert th.is_global == jh.is_global
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    # near the optimum the full-data gradient is small and its relative
    # error grows as it shrinks: a floor of 1e-7 (the series starts at ~2e-2)
    np.testing.assert_allclose([m["grad_sq"] for m in th.eval_metrics],
                               [m["grad_sq"] for m in jh.eval_metrics], rtol=1e-4, atol=1e-7)
    got, want = tfig.cell_readout(th, 0.01), jfig._cell_readout(jh, 0.01)
    for key in ("final_grad_sq", "final_loss"):
        np.testing.assert_allclose(got.pop(key), want.pop(key), rtol=1e-5)
    assert got == want
    assert tfig.cell_key(local, server, 0.2) == \
        f"local={jfig._label(local)},server={server or 'none'},p=0.20"


def test_fig_optimizers_derived_readout_matches_reference():
    from benchmarks import fig_optimizers as jfig
    from repro_torch.figures import fig_optimizers as tfig

    cells = {"local=sgd,server=none,p=0.05": {"rounds_to_target": 120},
             "local=adam,server=fedadam,p=0.05": {"rounds_to_target": 80},
             "local=momentum,server=none,p=0.05": {"rounds_to_target": None},
             "local=sgd,server=none,p=0.20": {"rounds_to_target": None},
             "local=adam,server=none,p=0.20": {"rounds_to_target": 50}}
    assert tfig.best_adaptive_speedup(cells) == jfig.best_adaptive_speedup(cells) == 1.5
    assert (tfig.LOCAL_RULES, tfig.SERVER_RULES, tfig.P_GRID) == \
        (jfig.LOCAL_RULES, jfig.SERVER_RULES, jfig.P_GRID)
