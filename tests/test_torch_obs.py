"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the same calls, and the port's twins of
``tests/test_obs.py``.

Tolerances: the recorder, the exporter, the registry and the gate are plain
host data in both packages and are held **equal** (spans, Chrome-trace
JSON, snapshots, JSONL lines, findings, exit codes).  Round tables of whole
runs: rounds, kinds and bytes equal, durations equal to ``sim_time_s`` (the
host float64 clock, equal across packages; the events engine's to 1e-9
relative, as the reference's own driver-parity test).  Telemetry of whole
runs: counts exact, floats within 1e-6 relative, the final loss within the
whole-run loss tolerance of 1e-5 and the wall time not compared (host
clocks)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402
from benchmarks.check_regress import main as j_gate_main  # noqa: E402
from conftest import make_logreg_problem as j_make_logreg_problem  # noqa: E402
from repro import obs as J  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core.trainer import History as JHistory  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.serve.load import ServeReport as JReport  # noqa: E402
from repro_torch import obs as T  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core.trainer import History  # noqa: E402
from repro_torch.figures.check_regress import BASELINES  # noqa: E402
from repro_torch.figures.check_regress import main as gate_main  # noqa: E402
from repro_torch.serve.batcher import Request  # noqa: E402
from repro_torch.serve.load import ServeReport  # noqa: E402

CPU = torch.device("cpu")
N_AGENTS = 5
ROUNDS = 10
LOSS_RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _spans(rec):
    return [dataclasses.asdict(s) for s in rec.spans], [dataclasses.asdict(i)
                                                        for i in rec.instants]


# ---------------------------------------------------------------------------
# The recorder: the same calls give the reference's spans
# ---------------------------------------------------------------------------


def _rounds(rec, _req):
    rec.record_round(0, True, 100, parts={"local_steps": 0.25, "server_sync": 0.75})
    rec.record_round(1, False, 200, seconds=0.5)
    rec.record_round(2, False, 300)  # no time model: a DEFAULT_ROUND_S slot
    rec.record_round(3, True, 400, seconds=0.125, parts={"local_steps": 0.1, "gossip_mix": 0.025},
                     extra="x")
    rec.add_instant("rounds", "eval", rec.clock_s, round=3, grad_sq=0.5)


def _clamp(rec, _req):
    rec.add_span("host", "oops", 1.0, -0.5)
    rec.add_span("host", "fine", 2.0, 0.25, cat="host", detail=1)


def _agents(rec, _req):
    rec.record_round(0, False, 64, seconds=0.25)
    rec.record_agent_round(0, 1, 0.0, 0.25, False, staleness=0, participant=True, gated=False)
    rec.record_agent_round(0, 0, 0.0, 0.25, False, staleness=2, participant=False, gated=True)
    rec.record_agent_round(1, 10, 0.25, 0.5, True, staleness=1)


def _serve(rec, req):
    full = dict(prompt=np.zeros(4, np.int32), max_new_tokens=4, tokens=[1, 2, 3, 4])
    rec.record_request(req(rid=7, agent_id=3, arrival_s=1.0, admit_s=1.5, first_token_s=2.0,
                           done_s=3.0, prefill_s=0.5, decode_s=1.0, slot=2, **full))
    # admitted on arrival: no queue span, no slot
    rec.record_request(req(rid=8, agent_id=1, arrival_s=2.0, admit_s=2.0, first_token_s=2.5,
                           done_s=2.5, **full))
    rec.record_request(req(rid=9, agent_id=1, arrival_s=2.0, **full))  # never admitted


@pytest.mark.parametrize("scenario", [_rounds, _clamp, _agents, _serve],
                         ids=lambda f: f.__name__.strip("_"))
def test_recorder_gives_the_reference_spans(scenario):
    jrec, trec = J.TraceRecorder(meta={"kind": "unit"}), T.TraceRecorder(meta={"kind": "unit"})
    scenario(jrec, JRequest)
    scenario(trec, Request)
    assert _spans(trec) == _spans(jrec)
    assert trec.clock_s == jrec.clock_s and trec.meta == jrec.meta
    assert trec.round_table() == jrec.round_table()
    assert trec.tracks() == jrec.tracks()


def test_recorder_round_spans_clamps_and_host_spans():
    """The port's twin of the reference's span-model tests."""
    rec = T.TraceRecorder()
    _rounds(rec, Request)
    assert rec.clock_s == pytest.approx(1.0 + 0.5 + T.DEFAULT_ROUND_S + 0.125)
    phases = [s for s in rec.spans if s.cat == "phase"]
    assert [p.name for p in phases] == ["local_steps", "server_sync", "local_steps", "gossip_mix"]
    assert phases[1].t0 == pytest.approx(0.25)
    rec.add_span("host", "oops", 1.0, -0.5)
    assert rec.spans[-1].dur == 0.0
    with rec.host_span("work", detail=1):
        pass
    (span,) = [s for s in rec.spans if s.cat == "host"]
    assert span.name == "work" and span.dur >= 0.0 and span.args["detail"] == 1
    assert span.track == "host"


# ---------------------------------------------------------------------------
# Chrome traces and their validation
# ---------------------------------------------------------------------------


def test_chrome_traces_equal_as_json(tmp_path):
    jrec, trec = J.TraceRecorder(meta={"kind": "unit"}), T.TraceRecorder(meta={"kind": "unit"})
    for rec, req in ((jrec, JRequest), (trec, Request)):
        for scenario in (_rounds, _clamp, _agents, _serve):
            scenario(rec, req)
    jobj = J.write_trace(str(tmp_path / "j.json"), jrec)
    tobj = T.write_trace(str(tmp_path / "t.json"), trec)
    assert tobj == jobj
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    T.validate_chrome_trace(tobj)
    meta = [e for e in tobj["traceEvents"] if e["ph"] == "M" and e["name"] == "thread_name"]
    order = [e["args"]["name"] for e in sorted(meta, key=lambda e: e["tid"])]
    assert order[:2] == ["rounds", "host"] and order[2:5] == ["agent 0", "agent 1", "agent 3"]


def _malformed(good):
    neg = json.loads(json.dumps(good))
    for e in neg["traceEvents"]:
        if e["ph"] == "X":
            e["dur"] = -1.0
    unnamed = json.loads(json.dumps(good))
    unnamed["traceEvents"] = [e for e in unnamed["traceEvents"] if e["ph"] != "M"]
    phase = json.loads(json.dumps(good))
    phase["traceEvents"][0]["ph"] = "Q"
    no_ts = json.loads(json.dumps(good))
    for e in no_ts["traceEvents"]:
        e.pop("ts", None)
    no_tid = json.loads(json.dumps(good))
    no_tid["traceEvents"][-1].pop("tid")
    return [[], {}, {"traceEvents": []}, {"traceEvents": [1]}, neg, unnamed, phase, no_ts,
            no_tid]


def test_validate_rejects_the_same_malformed_traces():
    rec = T.TraceRecorder()
    rec.record_round(0, True, 1)
    rec.add_instant("rounds", "eval", 0.0, grad_sq=1.0)
    good = T.to_chrome_trace(rec)
    T.validate_chrome_trace(good)
    J.validate_chrome_trace(good)
    for bad in _malformed(good):
        with pytest.raises(AssertionError) as tinfo:
            T.validate_chrome_trace(bad)
        with pytest.raises(AssertionError) as jinfo:
            J.validate_chrome_trace(bad)
        assert str(tinfo.value) == str(jinfo.value)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def _fill(mod):
    reg = mod.MetricsRegistry(meta={"kind": "unit"})
    reg.counter("c").inc()
    reg.counter("c").inc(2.5)
    reg.gauge("g").set(1.0)
    reg.gauge("g").set(-2.0)
    reg.gauge("unset")
    reg.histogram("h").observe_many([3.0, 1.0, 2.0, 10.0, -4.5])
    reg.histogram("h").observe(0.25)
    reg.histogram("empty")
    return reg


def test_registries_and_jsonl_equal(tmp_path):
    jreg, treg = _fill(J), _fill(T)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.names() == jreg.names() == ["c", "empty", "g", "h", "unset"]
    for mod, reg in ((J, jreg), (T, treg)):
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        with pytest.raises(TypeError):  # a name bound to another instrument
            reg.gauge("c")
        for i in range(2):
            reg.write_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"), run=i)
    jtext = (tmp_path / "repro.obs.jsonl").read_text()
    assert (tmp_path / "repro_torch.obs.jsonl").read_text() == jtext
    lines = T.read_jsonl(str(tmp_path / "repro_torch.obs.jsonl"))
    assert lines == J.read_jsonl(str(tmp_path / "repro.obs.jsonl"))
    assert lines[1]["meta"]["run"] == 1 and lines[1]["metrics"]["h"]["count"] == 6


# ---------------------------------------------------------------------------
# Whole runs: round tables, phases, eval instants, per-agent tracks
# ---------------------------------------------------------------------------


def _pieces(n=N_AGENTS):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=n)
    return dict(loss_fn=loss_fn, params0={"w": torch.zeros(d)}, device=CPU,
                eval_fn=lambda p: {"w_sq": float(torch.sum(p["w"] ** 2))},
                sampler_factory=lambda s: sampler_factory(s.config.t_o))


def _j_pieces(n=N_AGENTS):
    loss_fn, _, sampler_factory, d = j_make_logreg_problem(n_agents=n)
    return dict(loss_fn=loss_fn, params0={"w": jnp.zeros(d)},
                eval_fn=lambda p: {"w_sq": float(jnp.sum(p["w"] ** 2))},
                sampler_factory=lambda s: sampler_factory(s.config.t_o))


# (driver, systems profile): the events driver needs a profile and a rule
CASES = [("loop", None), ("scan", None), ("loop", "uniform"), ("scan", "uniform"),
         ("events", "uniform"), ("events", "lognormal-stragglers")]


def _spec_kw(driver, systems):
    kw = dict(algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.2, seed=0, rounds=ROUNDS,
              driver=driver, systems=systems, eval_every=4)
    if driver == "events":
        kw["async_"] = "constant:buffer=3"
    return kw


@pytest.fixture(scope="module")
def traced():
    """(case) -> (port History, port recorder, JAX History, JAX recorder),
    plus the port's runs without a recorder."""
    out, plain = {}, {}
    for driver, systems in CASES:
        kw = _spec_kw(driver, systems)
        trec, jrec = T.TraceRecorder(), J.TraceRecorder()
        th = Experiment(ExperimentSpec.create(**kw), recorder=trec, **_pieces()).run()
        jh = JExperiment(JSpec.create(**kw), recorder=jrec, **_j_pieces()).run()
        out[(driver, systems)] = (th, trec, jh, jrec)
        plain[(driver, systems)] = Experiment(ExperimentSpec.create(**kw), **_pieces()).run()
    return out, plain


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_round_tables_equal_the_reference(traced, case):
    th, trec, jh, jrec = traced[0][case]
    table, want = trec.round_table(), jrec.round_table()
    assert len(table) == ROUNDS
    assert [t[:3] for t in table] == [w[:3] for w in want]
    durs = [t[3] for t in table]
    np.testing.assert_allclose(durs, [w[3] for w in want], rtol=1e-9)
    if case[1] is None:
        assert durs == [T.DEFAULT_ROUND_S] * ROUNDS and th.sim_time_s == []
    else:  # the span of round k is its simulated seconds
        np.testing.assert_allclose(durs, th.sim_time_s, rtol=1e-12)
        assert th.sim_time_s == pytest.approx(jh.sim_time_s, rel=1e-9)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_recording_off_and_on_losses_bit_identical(traced, case):
    th, trec, _, _ = traced[0][case]
    plain = traced[1][case]
    np.testing.assert_array_equal(plain.loss, th.loss)
    assert plain.is_global == th.is_global
    assert plain.to_dict()["sim_time_s"] == th.to_dict()["sim_time_s"]
    assert th.recorder is trec and plain.recorder is None
    assert "recorder" not in th.to_dict()
    assert History.from_dict(th.to_dict()).recorder is None


def test_phase_children_and_eval_instants(traced):
    th, trec, jh, jrec = traced[0][("scan", "uniform")]
    rounds = [s for s in trec.spans if s.cat == "round"]
    phases = [s for s in trec.spans if s.cat == "phase"]
    assert len(phases) == 2 * ROUNDS
    for rs in rounds:
        kids = [p for p in phases if p.args["round"] == rs.args["round"]]
        assert [p.name for p in kids] == ["local_steps", "server_sync" if rs.name ==
                                          "server_round" else "gossip_mix"]
        assert sum(p.dur for p in kids) == pytest.approx(rs.dur, abs=1e-12)
        assert kids[0].t0 == rs.t0
    jphases = [s for s in jrec.spans if s.cat == "phase"]
    assert [(p.name, p.args, p.t0, p.dur) for p in phases] == [
        (p.name, p.args, p.t0, p.dur) for p in jphases]
    evals, jevals = trec.instants, jrec.instants
    assert [(i.name, i.track, i.t, i.args["round"]) for i in evals] == [
        (i.name, i.track, i.t, i.args["round"]) for i in jevals]
    assert [i.args["round"] for i in evals] == [0, 4, 8, 9]
    np.testing.assert_allclose([i.args["w_sq"] for i in evals],
                               [i.args["w_sq"] for i in jevals], rtol=LOSS_RTOL)
    # no time model: phase-free round slots, eval instants on the same clock
    _, trec0, _, _ = traced[0][("loop", None)]
    assert not [s for s in trec0.spans if s.cat == "phase"]
    assert [i.t for i in trec0.instants] == pytest.approx(
        [(k + 1) * T.DEFAULT_ROUND_S for k in (0, 4, 8, 9)])


@pytest.mark.parametrize("systems", ["uniform", "lognormal-stragglers"])
def test_events_per_agent_tracks(traced, systems):
    _, trec, _, jrec = traced[0][("events", systems)]
    agent = [s for s in trec.spans if s.cat == "agent"]
    jagent = [s for s in jrec.spans if s.cat == "agent"]
    assert len(agent) == ROUNDS * N_AGENTS
    assert [t for t in trec.tracks() if t.startswith("agent ")] == [
        f"agent {i}" for i in range(N_AGENTS)]
    assert [(s.track, s.name, s.args) for s in agent] == [(s.track, s.name, s.args)
                                                          for s in jagent]
    np.testing.assert_allclose([(s.t0, s.dur) for s in agent], [(s.t0, s.dur) for s in jagent],
                               rtol=1e-9, atol=1e-15)
    if systems == "lognormal-stragglers":
        assert any(s.args["staleness"] > 0 for s in agent)


def test_real_run_traces_validate(traced, tmp_path):
    for (driver, systems), (_, trec, _, _) in traced[0].items():
        obj = T.write_trace(str(tmp_path / f"{driver}-{systems}.json"), trec)
        T.validate_chrome_trace(obj)
        J.validate_chrome_trace(obj)


def test_sweeps_record_every_history():
    """The port runs a sweep's seeds and grid points one after another, so
    the recorder takes each one's rounds in turn on one timeline."""
    rec = T.TraceRecorder()
    kw = _spec_kw("scan", "uniform")
    exp = Experiment(ExperimentSpec.create(**kw), recorder=rec, **_pieces())
    hists = exp.sweep(seeds=[0, 1])
    assert all(h.recorder is rec for h in hists)
    table = rec.round_table()
    assert [t[0] for t in table] == list(range(ROUNDS)) * 2
    np.testing.assert_allclose([t[3] for t in table], hists[0].sim_time_s + hists[1].sim_time_s)
    grid = exp.sweep(grid={"p": [0.0, 1.0]})
    assert all(h.recorder is rec for _, h in grid)
    assert [t[1] for t in rec.round_table()[2 * ROUNDS:]] == (
        ["gossip_round"] * ROUNDS + ["server_round"] * ROUNDS)


# ---------------------------------------------------------------------------
# Telemetry: History and ServeReport
# ---------------------------------------------------------------------------


def _assert_snapshots_close(got, want, skip=(), loose=()):
    assert got["meta"] == want["meta"] and got["schema_version"] == want["schema_version"]
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for name, w in want["metrics"].items():
        g = got["metrics"][name]
        assert sorted(g) == sorted(w) and g["type"] == w["type"], name
        if name in skip:
            continue
        for key, wv in w.items():
            if key == "count" or w["type"] == "counter":
                assert g[key] == wv, (name, key)
            elif isinstance(wv, float):
                rtol = LOSS_RTOL if name in loose else 1e-6
                assert g[key] == pytest.approx(wv, rel=rtol), (name, key)
            else:
                assert g[key] == wv, (name, key)


@pytest.mark.parametrize("case", [("scan", "uniform"), ("events", "lognormal-stragglers")],
                         ids=lambda c: c[0])
def test_history_telemetry_equals_the_reference(traced, case):
    th, _, jh, _ = traced[0][case]
    got = th.telemetry(meta={"algo": "pisco"}).snapshot()
    want = jh.telemetry(meta={"algo": "pisco"}).snapshot()
    _assert_snapshots_close(got, want, skip=("train.wall_time_s",), loose=("train.final_loss",))
    m = got["metrics"]
    assert m["train.rounds_gossip"]["value"] + m["train.rounds_server"]["value"] == ROUNDS
    assert m["train.round_bytes"]["count"] == ROUNDS
    # the same recorded run (one JSON) gives the same registry, bit for bit
    d = json.loads(json.dumps(jh.to_dict()))
    assert (History.from_dict(d).telemetry().snapshot()
            == JHistory.from_dict(d).telemetry().snapshot())


def _requests(req):
    return [req(rid=i, agent_id=i % 2, prompt=np.zeros(2, np.int32), max_new_tokens=2,
                arrival_s=float(i), admit_s=i + 0.5, first_token_s=i + 0.7, done_s=i + 1.0,
                prefill_s=0.2, decode_s=0.3, tokens=[1, 2], slot=None if i == 5 else i % 3)
            for i in range(6)]


def test_serve_report_telemetry_equals_the_reference():
    got = ServeReport(requests=_requests(Request), clock_s=7.0).telemetry(
        meta={"kind": "serve"}).snapshot()
    want = JReport(requests=_requests(JRequest), clock_s=7.0).telemetry(
        meta={"kind": "serve"}).snapshot()
    _assert_snapshots_close(got, want)
    m = got["metrics"]
    assert m["serve.requests"]["value"] == 6 and m["serve.tokens"]["value"] == 12
    assert m["serve.slot.0.requests"]["value"] == 2 and "serve.slot.None.requests" not in m


# ---------------------------------------------------------------------------
# The regression gate
# ---------------------------------------------------------------------------


def _findings(fs):
    return [dataclasses.asdict(f) for f in fs]


def test_gates_are_the_reference_gates_but_roofline():
    """The same gates, roofline's (A17) among them since the dry run is
    ported; serve's rate gates read the full-size payload's highest rate
    (16) where the reference's quick payload has 8."""
    assert set(J.GATES) == set(T.GATES)
    for bench, gates in T.GATES.items():
        want = [dataclasses.astuple(g) for g in J.GATES[bench]]
        if bench == "serve":
            want = [(path.replace("rate=8.", "rate=16."), kind, tol) for path, kind, tol in want]
        assert [dataclasses.astuple(g) for g in gates] == want


def test_gate_kinds_and_missing_metrics_give_the_reference_findings():
    base = {"t": 1.0, "h": 10.0, "m": 5.0, "f": True, "c": 2, "a": {"b": 1.0}}
    kinds = [("t", "time", 2.0), ("h", "higher", 2.0), ("m", "match", 0.1), ("f", "flag", 0.0),
             ("c", "count", 1), ("a.b", "time", 2.0), ("x.y", "match", 0.0)]
    fresh_cases = [
        dict(base), {"t": 1.9, "h": 5.5, "m": 5.4, "f": True, "c": 3, "a": {"b": 2.0}},
        {**base, "t": 2.5}, {**base, "h": 4.0}, {**base, "m": 6.0}, {**base, "f": False},
        {**base, "c": 4}, {k: v for k, v in base.items() if k != "a"}, {**base, "x": {"y": 1}},
    ]
    tg = [T.MetricGate(*k) for k in kinds]
    jg = [J.MetricGate(*k) for k in kinds]
    for fresh in fresh_cases:
        got = T.compare_payloads("x", base, fresh, gates=tg)
        want = J.compare_payloads("x", base, fresh, gates=jg)
        assert _findings(got) == _findings(want)
        assert T.format_findings(got) == J.format_findings(want)
    assert any(f.failed for f in T.compare_payloads("x", base, fresh_cases[2], gates=tg))
    with pytest.raises(ValueError):
        T.MetricGate("a", "faster")


def _write_fixture_dirs(tmp_path, slowdown=1.0):
    base, fresh = tmp_path / "base", tmp_path / "fresh"
    base.mkdir(parents=True, exist_ok=True)
    fresh.mkdir(exist_ok=True)
    payload = {
        "profiles": {
            "lognormal-stragglers": {"sync": {"total_sim_time_s": 10.0},
                                     "async": {"total_sim_time_s": 4.0}},
            "wan-gossip": {"async": {"total_sim_time_s": 20.0}},
            "free": {"bit_identical_loss": True},
        },
        "reprice": {"self_exact": True},
    }
    (base / "BENCH_async.json").write_text(json.dumps(payload))
    fresh_payload = json.loads(json.dumps(payload))
    for prof in fresh_payload["profiles"].values():
        for mode in ("sync", "async"):
            if mode in prof:
                prof[mode]["total_sim_time_s"] *= slowdown
    (fresh / "BENCH_async.json").write_text(json.dumps(fresh_payload))
    return base, fresh


@pytest.mark.parametrize("slowdown", [1.0, 2.0])
def test_compare_dirs_gives_the_reference_findings(tmp_path, slowdown):
    base, fresh = _write_fixture_dirs(tmp_path, slowdown)
    got = T.compare_dirs(str(base), str(fresh))
    assert _findings(got) == _findings(J.compare_dirs(str(base), str(fresh)))
    assert len([f for f in got if f.failed]) == (3 if slowdown == 2.0 else 0)
    # paired through the manifest, not the file name
    (fresh / "BENCH_async.json").rename(fresh / "async.v2.json")
    (fresh / "MANIFEST.json").write_text(json.dumps(
        {"schema_version": 1, "benches": {"async": {"path": "async.v2.json"}}}))
    got = T.compare_dirs(str(base), str(fresh))
    assert _findings(got) == _findings(J.compare_dirs(str(base), str(fresh)))


def test_check_regress_cli_exit_codes_equal_the_reference(tmp_path, capsys):
    assert BASELINES == os.path.normpath(os.path.join(ROOT, "artifacts", "torch"))
    for slowdown, want in ((1.0, 0), (2.0, 1)):
        base, fresh = _write_fixture_dirs(tmp_path / str(slowdown), slowdown)
        args = ["--baseline", str(base), "--fresh", str(fresh)]
        assert gate_main(args) == j_gate_main(args) == want
        out = capsys.readouterr().out.split("\n")
        half = len(out) // 2
        assert out[:half] == out[half:2 * half]  # the same table, line for line
    # --update-baselines copies fresh over base; then the gate passes
    base, fresh = _write_fixture_dirs(tmp_path / "up", 2.0)
    assert gate_main(["--baseline", str(base), "--fresh", str(fresh), "--update-baselines"]) == 0
    assert gate_main(["--baseline", str(base), "--fresh", str(fresh)]) == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert gate_main(["--baseline", str(base), "--fresh", str(empty)]) == 1
    assert j_gate_main(["--baseline", str(base), "--fresh", str(empty)]) == 1
    assert gate_main(["--baseline", str(base), "--fresh", str(empty),
                      "--update-baselines"]) == 1


def test_gate_paths_resolve_in_the_port_baselines():
    """Every gate path exists in the port's committed card payloads
    (``artifacts/torch``), which the manifest indexes."""
    from repro_torch.obs.regress import load_artifacts, lookup

    art = os.path.join(ROOT, "artifacts", "torch")
    with open(os.path.join(art, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert set(T.GATES) <= set(manifest["benches"])
    payloads = load_artifacts(art)
    for bench, gates in T.GATES.items():
        # the roofline summary aggregates the dry run's meta-device counts
        assert payloads[bench]["device"] == (None if bench == "roofline" else "cuda"), bench
        for gate in gates:
            found, _ = lookup(payloads[bench], gate.path)
            assert found, f"{bench}: gate path {gate.path} absent from the baseline"
    # the fresh side of the gate passes against itself
    findings = T.compare_dirs(art, art)
    assert findings and not any(f.failed for f in findings)


def test_write_manifest_indexes_bench_payloads(tmp_path):
    from benchmarks.common import write_manifest as j_write_manifest
    from repro_torch.figures.common import write_manifest

    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        for name in ("BENCH_driver.json", "BENCH_async.json", "notes.json"):
            (tmp_path / d / name).write_text("{}")
    got = json.load(open(write_manifest(str(tmp_path / "t"))))
    want = json.load(open(j_write_manifest(str(tmp_path / "j"))))
    assert got["benches"] == want["benches"] == {"async": {"path": "BENCH_async.json"},
                                                 "driver": {"path": "BENCH_driver.json"}}
    assert got["schema_version"] == want["schema_version"] == 1


# ---------------------------------------------------------------------------
# Profiler hooks
# ---------------------------------------------------------------------------


def test_profile_capture_none_is_a_noop_and_a_dir_gets_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with T.profile_capture(None):
        pass
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "prof"
    with T.profile_capture(str(out)):
        torch.arange(4.0).sum()
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]


def test_track_compile_time_without_a_load():
    """On the CPU no kernel library is loaded: zero seconds, no events; the
    block's listener is gone afterwards, and nested blocks stack."""
    from repro_torch.kernels import build

    with T.track_compile_time() as outer:
        with T.track_compile_time() as inner:
            assert len(build.LOAD_LISTENERS) >= 2
            build.LOAD_LISTENERS[-1]("flash_attention", 0.5)  # a load as library() reports it
        build.LOAD_LISTENERS[-1]("quantize", 0.25)
    assert inner.events == {"flash_attention": 0.5} and inner.seconds == 0.5
    assert outer.events == {"quantize": 0.25} and outer.seconds == 0.25
    assert build.LOAD_LISTENERS == []
