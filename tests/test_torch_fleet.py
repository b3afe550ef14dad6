"""The train → checkpoint → serve loop on the port against the JAX package:
low-rank deltas, the exporters (``from_history``, ``from_checkpoint``,
``export_fleet``) across the two packages' files, the serving launcher
(``repro_torch.launch.serve``), the example twin
(``repro_torch.examples.train_federated_lm``), and the twins of
``benchmarks/fig_serve.py`` and ``benchmarks/bench_driver.py``.

Tolerances: host-side payloads (top-k indices and values, the q8 codes and
scales, dense values, bases) are numpy in both packages and held **equal**.
Low-rank factors are not unique (signs, order at equal singular values), so
their products ``u @ v`` and the materialised parameters are compared,
within LOWRANK_ATOL = 1e-5 of 1 + max |residual| (float32 SVDs of two
LAPACK builds and a float32 product).  Training losses within 1e-5 relative
(float32 in two frameworks' summation orders).  Greedy tokens and the
launcher's printed report under fixed costs: equal."""
import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import fig_serve as jfig  # noqa: E402
from repro import serve as J  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import PiscoConfig as JPiscoConfig, dense_mixing as j_dense_mixing  # noqa: E402
from repro.core import make_topology as j_make_topology  # noqa: E402
from repro.core import replicate_params as j_replicate  # noqa: E402
from repro.core.algorithms import get_algorithm as j_get_algorithm  # noqa: E402
from repro.core.driver import make_block_fn, predraw_schedule, sample_block  # noqa: E402
from repro.core.pisco import PiscoState as JPiscoState  # noqa: E402
from repro.data.synthetic import synthetic_lm_tokens  # noqa: E402
from repro.launch.serve import main as j_serve_main  # noqa: E402
from repro.models import config_from_dict as j_config_from_dict  # noqa: E402
from repro.models import config_to_dict as j_config_to_dict, get_bundle as j_get_bundle  # noqa: E402
from conftest import make_logreg_problem as j_make_logreg_problem  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.checkpoint import read_manifest, save_checkpoint  # noqa: E402
from repro_torch.core import PiscoState  # noqa: E402
from repro_torch.core.trainer import History  # noqa: E402
from repro_torch.examples import train_federated_lm as ex  # noqa: E402
from repro_torch.figures import bench_driver, fig_serve  # noqa: E402
from repro_torch.figures import run as trun  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import config_from_dict, config_to_dict  # noqa: E402
from repro_torch.utils.pytree import nest_leaves, nest_map  # noqa: E402
from repro_torch.weights import lm_params_from_jax, tree_from_jax  # noqa: E402

CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(__file__), "..")
LOWRANK_ATOL = 1e-5
LOSS_RTOL = 1e-5
# the example's model at test size: 2 layers, d_model 64 (its dtype, SwiGLU,
# GQA 2:1, remat off; head dim 16 as fig_serve's TINY)
SMALL = dataclasses.replace(ex.LM_100M, name="pisco-lm-small", n_layers=2, d_model=64,
                            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
J_SMALL = j_config_from_dict(config_to_dict(SMALL))  # the reference's twin


def _np(t):
    return t.detach().cpu().numpy()


def _tree(seed=0, n=4):
    """An agent-stacked tree with 1-D, 2-D and 3-D leaves (numpy)."""
    rng = np.random.default_rng(seed)
    base = {"norm": rng.normal(size=(6,)), "w": rng.normal(size=(5, 7)),
            "stack": {"a": rng.normal(size=(3, 4, 5))}}
    return jax.tree.map(lambda b: (b[None] + 0.1 * rng.normal(size=(n,) + b.shape)).astype(
        np.float32), base)


def _payloads_equal(jf, tf, lowrank=False):
    """Bases equal; dense / top-k payloads equal leaf for leaf; low-rank
    payloads through their products."""
    for a, b in zip(jax.tree.leaves(jf.base), nest_leaves(tf.base)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    jd = jax.tree.leaves(jf.deltas, is_leaf=J.delta._is_delta)
    td = [d for d in _delta_leaves(tf.deltas)]
    assert [type(d).__name__ for d in jd] == [type(d).__name__ for d in td]
    for a, b in zip(jd, td):
        if type(b).__name__ == "LowRankDelta":
            assert lowrank
            want = np.einsum("nir,nrj->nij", np.asarray(a.u), np.asarray(a.v))
            got = _np(torch.bmm(b.u, b.v))
            scale = 1.0 + float(np.abs(want).max())
            np.testing.assert_allclose(got, want, atol=LOWRANK_ATOL * scale, rtol=0)
            assert b.u.shape == a.u.shape and b.v.shape == a.v.shape
        else:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), _np(y))
                assert np.asarray(x).dtype == _np(y).dtype


def _delta_leaves(tree):
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _delta_leaves(tree[k])]
    if isinstance(tree, list):
        return [d for x in tree for d in _delta_leaves(x)]
    return [tree]


def _materialized_close(jf, tf, atol):
    for a, b in zip(jax.tree.leaves(J.materialize(jf.base, jf.deltas)),
                    nest_leaves(S.materialize(tf.base, tf.deltas))):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# Low-rank deltas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [1, 2, 4, 9])
def test_lowrank_encode_and_gather_match_the_reference(rank):
    stacked = _tree(rank)
    spec = f"lowrank:r={rank}"
    jf = J.FleetDelta.from_stacked(stacked, J.DeltaSpec.parse(spec))
    tf = S.FleetDelta.from_stacked(tree_from_jax(stacked, CPU), S.DeltaSpec.parse(spec))
    assert tf.spec.name == jf.spec.name == spec and tf.spec.rank == rank
    _payloads_equal(jf, tf, lowrank=True)
    # the 1-D leaf stays dense; a factor's rank is capped by the leaf's shape
    assert isinstance(tf.deltas["norm"], S.delta.DenseDelta)
    assert tf.deltas["stack"]["a"].u.shape == (4, 3, min(rank, 3))
    assert tf.nbytes() == jf.nbytes() and tf.naive_nbytes() == jf.naive_nbytes()
    _materialized_close(jf, tf, 1e-5)
    # gather (step mode) and gather_into (admit mode) build the same rows
    ids = [3, 0, 3]
    got = tf.gather(ids)
    buf = nest_map(torch.zeros_like, got)
    for slot, agent in enumerate(ids):
        tf.gather_into(buf, slot, agent)
    for a, b in zip(nest_leaves(got), nest_leaves(buf)):
        assert torch.equal(a, b)
    want = J.FleetDelta.gather(jf.arrays, jnp.asarray(ids))
    for a, b in zip(jax.tree.leaves(want), nest_leaves(got)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-5, rtol=0)


def test_lowrank_at_full_rank_reconstructs_the_agents():
    stacked = _tree(5)
    tf = S.FleetDelta.from_stacked(tree_from_jax(stacked, CPU), S.DeltaSpec.parse("lowrank:r=8"))
    for a, b in zip(jax.tree.leaves(stacked), nest_leaves(S.materialize(tf.base, tf.deltas))):
        np.testing.assert_allclose(_np(b), a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("spec", ["lowrank", "lowrank:r=3", "lowrank:r=12", "dense",
                                  "topk:f=0.5,q8", "lowrank:r=0", "lowrank:r=2,q8",
                                  "lowrank:g=1", "lowrank:f=0.5", "topk:r=2", "lowrank:r",
                                  "lowrank:r=1.5"])
def test_delta_grammar_and_refusals_match_the_reference(spec):
    try:
        want = J.DeltaSpec.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            S.DeltaSpec.parse(spec)
        assert str(got.value) == str(e)
        return
    got = S.DeltaSpec.parse(spec)
    assert (got.kind, got.fraction, got.rank, got.quantize, got.name) == (
        want.kind, want.fraction, want.rank, want.quantize, want.name)


# ---------------------------------------------------------------------------
# The exporters, across the two packages' files
# ---------------------------------------------------------------------------

SPECS = ["dense", "topk:f=0.2", "topk:f=0.3,q8", "topk:f=1", "lowrank:r=2"]


@pytest.fixture(scope="module")
def j_history():
    """A finished JAX run (logreg, 5 agents) and its x crossed to the port."""
    loss_fn, _, sampler_factory, d = j_make_logreg_problem(n_agents=5)
    spec = JSpec.create(algo="pisco", n_agents=5, t_o=2, eta_l=0.1, p=0.3, seed=0, rounds=6)
    jh = JExperiment(spec, loss_fn=loss_fn, params0={"w": jnp.zeros(d)},
                     sampler_factory=lambda s: sampler_factory(s.config.t_o)).run()
    x = jax.tree.map(np.asarray, jh.agent_params())
    th = History()
    th.final_state = PiscoState(x=tree_from_jax(x, CPU), y={}, g={},
                                step=torch.zeros((), dtype=torch.int32))
    return jh, th, x


@pytest.mark.parametrize("spec", SPECS)
def test_from_history_payloads_equal_the_reference(j_history, spec):
    jh, th, _ = j_history
    jf = J.FleetDelta.from_history(jh, J.DeltaSpec.parse(spec))
    tf = S.FleetDelta.from_history(th, S.DeltaSpec.parse(spec))
    _payloads_equal(jf, tf, lowrank=spec.startswith("lowrank"))
    assert tf.n_agents == jf.n_agents == 5


def _state_trees(x):
    """The three tree shapes a fleet checkpoint may hold, in both packages."""
    tx = tree_from_jax(x, CPU)
    step = np.int32(6)
    jstate = JPiscoState(x=x, y=x, g=x, step=step)
    tstate = PiscoState(x=tx, y=tx, g=tx, step=torch.tensor(6, dtype=torch.int32))
    return {"state": (jstate, tstate), "x": ({"x": x}, {"x": tx}), "bare": (x, tx)}


@pytest.mark.parametrize("shape", ["state", "x", "bare"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_checkpoint_reads_either_package_file(j_history, tmp_path, shape, writer):
    _, _, x = j_history
    jtree, ttree = _state_trees(x)[shape]
    if writer == "jax":
        path = j_save(str(tmp_path), 6, jtree, metadata={"kind": "fleet"})
    else:
        path = save_checkpoint(str(tmp_path), 6, ttree, metadata={"kind": "fleet"})
    for spec in ("topk:f=0.3,q8", "lowrank:r=2"):
        jf = J.FleetDelta.from_checkpoint(path, J.DeltaSpec.parse(spec))
        tf = S.FleetDelta.from_checkpoint(path, S.DeltaSpec.parse(spec), device="cpu")
        _payloads_equal(jf, tf, lowrank=spec.startswith("lowrank"))
        assert tf.device == CPU


def test_restore_subtree_reads_one_part_of_either_package_file(j_history, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint

    _, _, x = j_history
    jtree, ttree = _state_trees(x)["state"]
    for writer, path in (("jax", j_save(str(tmp_path / "j"), 6, {"s": jtree, "n": np.int32(1)})),
                         ("port", save_checkpoint(str(tmp_path / "t"), 6, {"s": ttree}))):
        _, whole = restore_checkpoint(path)
        for sub in (("s",), ("s", 0), ("s", 2), ("s", 3)):
            step, part = restore_checkpoint(path, subtree=sub)
            want = whole
            for k in sub:
                want = want[k]
            assert step == 6
            assert all(torch.equal(a, b) for a, b in zip(nest_leaves(part), nest_leaves(want)))
            assert len(nest_leaves(part)) == len(nest_leaves(want)), (writer, sub)
        with pytest.raises(KeyError):
            restore_checkpoint(path, subtree=("x",))


def test_export_fleet_round_trips_through_both_packages(j_history, tmp_path):
    jh, th, _ = j_history
    spec = "topk:f=0.2"
    tpath = S.export_fleet(str(tmp_path / "t"), th, step=6)
    jpath = J.export_fleet(str(tmp_path / "j"), jh, step=6)
    assert read_manifest(tpath)["metadata"] == {"kind": "fleet"}
    for path in (tpath, jpath):
        jf = J.FleetDelta.from_checkpoint(path, J.DeltaSpec.parse(spec))
        tf = S.FleetDelta.from_checkpoint(path, S.DeltaSpec.parse(spec), device="cpu")
        _payloads_equal(jf, tf)
        _payloads_equal(jf, S.FleetDelta.from_history(th, S.DeltaSpec.parse(spec)))
    with pytest.raises(ValueError, match="final_state"):
        S.export_fleet(str(tmp_path / "none"), History())


# ---------------------------------------------------------------------------
# The serving launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A 4-agent TINY fleet checkpoint written by the JAX package: a PISCO
    state tuple with the model config in its manifest (what the example
    writes)."""
    jb = j_get_bundle(jfig.TINY)
    base = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    x = jax.tree.map(lambda b: (b[None] + 0.02 * rng.normal(size=(4,) + b.shape)).astype(b.dtype),
                     base)
    d = tmp_path_factory.mktemp("ckpt")
    j_save(str(d), 7, JPiscoState(x=x, y=x, g=x, step=np.int32(7)),
           metadata={"model": j_config_to_dict(jfig.TINY)})
    return str(d)


@pytest.mark.parametrize("delta,extra", [
    ("dense", ["--dense-baseline"]), ("topk:f=0.05,q8", []), ("lowrank:r=2", []),
    ("topk:f=1", ["--materialize", "step"])])
def test_launcher_prints_the_reference_report(tiny_ckpt, tmp_path, capsys, delta, extra):
    args = ["--ckpt-dir", tiny_ckpt, "--delta", delta, "--fixed-costs", "0.05,0.01",
            "--requests", "5", "--gen", "5", "--prompt-len", "9", "--slots", "2",
            "--arrival", "poisson:rate=4", *extra]
    outs = {}
    for name, fn, more in (("jax", j_serve_main, []), ("port", launcher.main, ["--device", "cpu"])):
        trace, metrics = tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl"
        assert fn([*args, "--trace-out", str(trace), "--metrics-out", str(metrics), *more]) == 0
        lines = capsys.readouterr().out.splitlines()
        outs[name] = ([ln.replace(str(tmp_path), "") for ln in lines],
                      json.loads(trace.read_text()), metrics.read_text())
    got, want = outs["port"], outs["jax"]
    assert got[0][-1] == "device: cpu"
    # every printed line: the fleet, its bytes, the report and the tokens
    assert [ln.replace("port.", "X.") for ln in got[0][:-1]] == [
        ln.replace("jax.", "X.") for ln in want[0]]
    assert got[1] == want[1]  # the Chrome trace, span for span
    assert got[2] == want[2]  # the metrics line
    line = json.loads(got[2])
    assert line["metrics"]["serve.requests"]["value"] == 5
    assert line["metrics"]["serve.tokens"]["value"] == 25


def test_launcher_rebuilds_the_bundle_from_the_manifest(tiny_ckpt):
    path = os.path.join(tiny_ckpt, "ckpt_7.npz")
    cfg = config_from_dict(read_manifest(path)["metadata"]["model"])
    assert cfg == fig_serve.TINY
    report, fleet = launcher.run(["--ckpt", path, "--delta", "topk:f=1", "--device", "cpu",
                                  "--requests", "2", "--gen", "2", "--prompt-len", "4",
                                  "--fixed-costs", "0.05,0.01"])
    assert fleet.n_agents == 4 and report.total_tokens == 4
    with pytest.raises(SystemExit, match="pass --arch"):
        launcher.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        launcher.main(["--ckpt-dir", os.path.join(tiny_ckpt, "empty"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# The example twin
# ---------------------------------------------------------------------------

ROUNDS = 3


def _reference_example(cfg, params, args):
    """The reference example's loop (examples/train_federated_lm.py:77-136)
    on ``cfg``: ``get_algorithm("pisco").bind`` + ``make_block_fn``, its
    token streams and round sampler; returns (losses, final state)."""
    bundle = j_get_bundle(cfg)
    n = args.n_agents
    streams = [synthetic_lm_tokens(500_000, cfg.vocab_size, seed=31 * a + 1) for a in range(n)]
    rng = np.random.default_rng(0)

    def sample_round(_k):
        def one_set():
            out = []
            for a in range(n):
                s = streams[a]
                starts = rng.integers(0, len(s) - args.seq - 1, size=args.batch)
                out.append(np.stack([s[i: i + args.seq] for i in starts]))
            return np.stack(out)

        sets = np.stack([one_set() for _ in range(args.t_o + 1)])
        return {"tokens": jnp.asarray(sets[: args.t_o])}, {"tokens": jnp.asarray(sets[-1])}

    pcfg = JPiscoConfig(n_agents=n, t_o=args.t_o, eta_l=args.eta_l, eta_c=1.0, p=args.p)
    bound = j_get_algorithm("pisco").bind(bundle.loss, pcfg,
                                          j_dense_mixing(j_make_topology("ring", n)))
    block_fn = make_block_fn(bound)
    _, comm0 = sample_round(-1)
    state = bound.init(bundle.loss, j_replicate(params, n), comm0)
    losses, k = [], 0
    while k < args.rounds:
        stop = min(k + args.log_every, args.rounds)
        flags = predraw_schedule(bound.schedule, k, stop)
        local, comm = sample_block(sample_round, k, stop)
        state, metrics = block_fn(state, jnp.asarray(flags), local, comm)
        losses.extend(np.asarray(metrics.loss, dtype=np.float64).tolist())
        k = stop
    return losses, state


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    params = jax.tree.map(np.asarray, j_get_bundle(J_SMALL).init(jax.random.PRNGKey(0)))
    d = tmp_path_factory.mktemp("ex")
    args = argparse.Namespace(rounds=ROUNDS, log_every=2, p=0.5, ckpt_dir=str(d))
    hist = ex.train(SMALL, args, device="cpu", params0=lm_params_from_jax(params, CPU))
    full = ex.build_parser().parse_args([])
    for k, v in vars(args).items():
        setattr(full, k, v)
    losses, jstate = _reference_example(J_SMALL, params, full)
    return hist, losses, jstate, str(d)


def test_example_losses_match_the_reference(example_runs):
    hist, losses, _, _ = example_runs
    assert len(hist.loss) == ROUNDS
    np.testing.assert_allclose(hist.loss, losses, rtol=LOSS_RTOL)
    assert hist.accountant.agent_to_agent + hist.accountant.agent_to_server == ROUNDS


def test_example_checkpoint_is_the_reference_state(example_runs, tmp_path):
    """The final checkpoint holds the reference's state layout (x, y, g
    nested as the model's parameters) and the model config; x within the
    run's tolerance of the reference's final x."""
    hist, _, jstate, d = example_runs
    path = os.path.join(d, f"ckpt_{ROUNDS}.npz")
    got = read_manifest(path)
    jpath = j_save(str(tmp_path), ROUNDS, jax.tree.map(np.asarray, jstate),
                   metadata={"model": j_config_to_dict(J_SMALL)})
    want = read_manifest(jpath)
    for key in ("keys", "dtypes", "structure", "metadata", "step"):
        assert got[key] == want[key], key
    fleet = S.FleetDelta.from_checkpoint(path, S.DeltaSpec.parse("dense"), device="cpu")
    ref = J.FleetDelta.from_checkpoint(jpath, J.DeltaSpec.parse("dense"))
    for a, b in zip(jax.tree.leaves(J.materialize(ref.base, ref.deltas)),
                    nest_leaves(S.materialize(fleet.base, fleet.deltas))):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-4, atol=1e-5)
    # from_history on the run gives the checkpoint's payloads
    h = S.FleetDelta.from_history(hist, S.DeltaSpec.parse("topk:f=0.05,q8"))
    c = S.FleetDelta.from_checkpoint(path, S.DeltaSpec.parse("topk:f=0.05,q8"), device="cpu")
    for a, b in zip(nest_leaves(h.deltas) + nest_leaves(h.base),
                    nest_leaves(c.deltas) + nest_leaves(c.base)):
        assert torch.equal(a, b)


def test_example_main_checks_the_loss_and_serves(tmp_path, capsys):
    hist = ex.main(["--rounds", "4", "--log-every", "2", "--ckpt-dir", str(tmp_path),
                    "--device", "cpu", "--p", "0.5"], cfg=SMALL)
    out = capsys.readouterr().out
    assert "saved final checkpoint" in out and hist.loss[-1] < hist.loss[0]
    report, fleet = launcher.run(["--ckpt-dir", str(tmp_path), "--delta", "topk:f=0.05,q8",
                                  "--device", "cpu", "--requests", "3", "--gen", "3",
                                  "--prompt-len", "8", "--fixed-costs", "0.05,0.01"])
    assert fleet.n_agents == 4 and report.total_tokens == 9


# ---------------------------------------------------------------------------
# fig_serve and bench_driver twins
# ---------------------------------------------------------------------------


def _reference_payload(name):
    with open(os.path.join(ROOT, "artifacts", "bench", f"BENCH_{name}.json")) as f:
        return json.load(f)


def test_fig_serve_quick_memory_table_and_flags(tmp_path, capsys):
    trun.main(["--only", "serve", "--device", "cpu", "--out", str(tmp_path)])
    row = capsys.readouterr().out.splitlines()[1]
    assert row.startswith("fig_serve,") and row.endswith("bit_identical=True;best_tok_s=" +
                                                         row.rsplit("=", 1)[1])
    got = json.loads((tmp_path / "BENCH_serve.json").read_text())
    want = _reference_payload("serve")
    assert want["quick"] and got["quick"]
    assert got["memory"] == want["memory"]  # shapes only: bit-equal
    assert got["bit_identity"] == want["bit_identity"]
    assert sorted(got["rates"]) == sorted(want["rates"])
    for row in got["rates"].values():
        assert row["total_tokens"] == 80 and row["p99_s"] >= row["p50_s"] > 0
    assert got["device"] == "cpu" and got["card"] is None
    # the reference's own memory table, recomputed from its synthetic fleets
    jbase = j_get_bundle(jfig.TINY).init(jax.random.PRNGKey(0))
    for n, entry in got["memory"].items():
        f = J.FleetDelta.synthetic(jbase, int(n), seed=1)
        assert (entry["delta_bytes"], entry["naive_bytes"]) == (f.nbytes(), f.naive_nbytes())
    manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert manifest["benches"] == {"serve": {"path": "BENCH_serve.json"}}


def test_bench_driver_quick_matches_the_reference(tmp_path):
    got = bench_driver.run(quick=True, device="cpu", out_dir=str(tmp_path))
    want = _reference_payload("driver")
    assert got["quick"] and want["quick"] and sorted(got) == sorted(want)
    for driver in ("loop", "scan", "events"):
        g, w = got["results"][driver], want["results"][driver]
        assert (g["rounds"], g["eval_every"], g["a2a_rounds"], g["a2s_rounds"]) == (
            w["rounds"], w["eval_every"], w["a2a_rounds"], w["a2s_rounds"])
        np.testing.assert_allclose(g["final_loss"], w["final_loss"], rtol=LOSS_RTOL)
        assert g["per_round_s"] > 0 and g["compile_s"] >= 0
        assert g["compile_events_s"] == 0.0  # the CPU loads no kernel library
    # the three drivers run the same rounds: one final loss
    assert len({got["results"][d]["final_loss"] for d in ("loop", "scan", "events")}) == 1
    written = json.loads((tmp_path / "BENCH_driver.json").read_text())
    assert written == dict(got, device="cpu", card=None, git_rev=written["git_rev"],
                           source_digest=written["source_digest"])
