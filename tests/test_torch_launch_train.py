"""The LM training launcher, ``python -m repro_torch.launch.train``, held
against the reference's ``python -m repro.launch.train`` on the CPU: every
option with its default and choices; runs restored from one checkpoint of
the reference's (per-round losses within 1e-4, J/W flags and byte counts
equal) under both block drivers, a dynamic network, an adversary with a
robust rule and update rules; the simulated seconds of ``--systems`` and of
the events driver bit-equal; checkpoints that cross both ways; and the
reference's argument errors (the states' leaf order is in
``test_torch_launch_state.py``).  The two packages draw their initial weights
differently, so their runs are compared from a shared checkpoint."""
import argparse
import json
import re
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# JAX (on the CPU) is imported before the reference
import jax  # noqa: E402, F401

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ARCH = "qwen3-8b"
COMMON = ["--arch", ARCH, "--reduced", "--batch", "1", "--seq", "16", "--log-every", "1"]
RULES = ["--local-opt", "momentum", "--server-opt", "fedadam", "--lr-schedule", "cosine"]
VARIANTS = {
    "scan": [],
    "loop": ["--driver", "loop"],
    "network": ["--network", "bernoulli:0.3", "--participation", "0.5"],
    "adversary": ["--adversary", "signflip:f=0.25", "--robust-agg", "trimmed"],
    "rules": RULES,
}
LOSS_TOL = 1e-4
ROUND_RE = re.compile(r"^round +(\d+) \[([JW])\] loss=([-\d.naninf]+)")


def _reference_parser() -> argparse.ArgumentParser:
    """The parser ``repro.launch.train.main`` builds (caught at its
    ``parse_args``)."""
    seen = {}

    class Caught(Exception):
        pass

    def grab(self, *a, **k):
        seen["parser"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jtrain.main([])
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"]


def _options(ap: argparse.ArgumentParser) -> dict:
    return {a.option_strings[-1]: (a.dest, a.default, a.choices, a.type, a.nargs, a.required,
                                   type(a).__name__)
            for a in ap._actions if a.option_strings and a.dest != "help"}


def test_every_option_of_the_reference_with_its_default():
    want = _options(_reference_parser())
    got = _options(ttrain.build_parser())
    assert set(got) == set(want) | {"--device"}
    for opt, spec in want.items():
        assert got[opt] == spec, opt
    assert got["--device"][1] is None  # the GPU


def _run(main, argv, capsys) -> list:
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _rounds(lines) -> list:
    return [(int(m[1]), m[2], float(m[3])) for m in map(ROUND_RE.match, lines) if m]


@pytest.fixture(scope="module")
def ref_ckpts(tmp_path_factory):
    """The reference's checkpoints at round 2: one without update rules,
    one with (their states differ in structure)."""
    root = tmp_path_factory.mktemp("ref_ckpt")
    out = {}
    for name, extra in (("plain", []), ("rules", RULES)):
        d = root / name
        assert jtrain.main(COMMON + extra + ["--rounds", "2", "--ckpt-dir", str(d),
                                             "--ckpt-every", "2"]) == 0
        out[name] = d
    return out


def _metrics(path, prefixes=("train.",)) -> dict:
    """The last metrics snapshot, wall-clock time aside."""
    snap = json.loads(open(path).read().splitlines()[-1])["metrics"]
    return {k: v for k, v in snap.items() if k.startswith(prefixes) and k != "train.wall_time_s"}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_restored_runs_agree_with_the_reference(variant, ref_ckpts, tmp_path, capsys):
    """Both launchers restore the reference's round-2 checkpoint and run to
    round 6, logging every round."""
    capsys.readouterr()
    src = ref_ckpts["rules" if variant == "rules" else "plain"]
    runs = {}
    for pkg, main, extra in (("ref", jtrain.main, []), ("port", ttrain.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        shutil.copytree(src, d)
        lines = _run(main, COMMON + VARIANTS[variant] + extra + [
            "--rounds", "6", "--ckpt-dir", str(d), "--metrics-out", str(tmp_path / f"{pkg}.jsonl")],
            capsys)
        assert any(line.startswith("restored ") and line.endswith(" at round 2") for line in lines)
        runs[pkg] = (lines, _metrics(tmp_path / f"{pkg}.jsonl"))
    ref, port = _rounds(runs["ref"][0]), _rounds(runs["port"][0])
    assert [r[:2] for r in port] == [r[:2] for r in ref] and [r[0] for r in ref] == [2, 3, 4, 5]
    np.testing.assert_allclose([r[2] for r in port], [r[2] for r in ref], atol=LOSS_TOL, rtol=0)
    assert runs["port"][1] == runs["ref"][1]
    done = [line for line in runs["port"][0] if line.startswith("done: ")]
    want = [line for line in runs["ref"][0] if line.startswith("done: ")]
    assert re.sub(r"in [\d.]+s", "", done[0]) == re.sub(r"in [\d.]+s", "", want[0])


@pytest.mark.parametrize("extra", [
    ["--systems", "wan-gossip", "--rounds", "8"],
    ["--driver", "events", "--systems", "lognormal-stragglers", "--async", "poly:alpha=0.5",
     "--rounds", "8"],
], ids=["systems", "events"])
def test_simulated_seconds_bit_equal(extra, tmp_path, capsys):
    """Host-side pricing: the simulated seconds and their gossip/server
    split (and the events run's staleness) equal the reference's, whatever
    the weights."""
    capsys.readouterr()
    out = {}
    for pkg, main, dev in (("ref", jtrain.main, []), ("port", ttrain.main, ["--device", "cpu"])):
        path = tmp_path / f"{pkg}.jsonl"
        lines = _run(main, COMMON + extra + dev + ["--metrics-out", str(path)], capsys)
        out[pkg] = ([line for line in lines if line.startswith(("simulated", "done (events"))],
                    _metrics(path, ("train.sim_time", "train.round_sim_s", "train.staleness",
                                    "train.rounds", "train.bytes")))
    assert out["port"][0] and out["port"][1]["train.sim_time_a2a_s"]["value"] > 0
    assert out["port"] == out["ref"]


def test_port_checkpoint_restores_in_the_reference(tmp_path, capsys):
    """The port's round-2 checkpoint (with update rules) loads in the
    reference's ``restore_checkpoint`` with the reference state's leaf
    shapes, and both launchers continue it alike."""
    capsys.readouterr()
    d = tmp_path / "port"
    _run(ttrain.main, COMMON + RULES + ["--device", "cpu", "--rounds", "2", "--ckpt-dir", str(d),
                                        "--ckpt-every", "2"], capsys)
    step, tree = j_restore(str(d / "ckpt_2.npz"))
    assert step == 2
    shutil.copytree(d, tmp_path / "ref")
    runs = {}
    for pkg, main, extra in (("ref", jtrain.main, []), ("port", ttrain.main, ["--device", "cpu"])):
        lines = _run(main, COMMON + RULES + extra + ["--rounds", "4", "--ckpt-dir",
                                                      str(tmp_path / pkg)], capsys)
        runs[pkg] = _rounds(lines)
    assert [r[:2] for r in runs["port"]] == [r[:2] for r in runs["ref"]]
    np.testing.assert_allclose([r[2] for r in runs["port"]], [r[2] for r in runs["ref"]],
                               atol=LOSS_TOL, rtol=0)


def test_restore_refuses_a_state_of_another_shape(ref_ckpts, tmp_path):
    shutil.copytree(ref_ckpts["plain"], tmp_path / "c")
    with pytest.raises(ValueError, match="checkpoint has .* leaves but the bound"):
        ttrain.main(COMMON + RULES + ["--device", "cpu", "--rounds", "3", "--ckpt-dir",
                                      str(tmp_path / "c")])


@pytest.mark.parametrize("argv", [
    ["--cohort", "0.5", "--network", "bernoulli:0.3"],
    ["--async", "poly:alpha=0.5"],
    ["--driver", "events"],
    ["--driver", "events", "--systems", "uniform", "--ckpt-dir", "x"],
], ids=["cohort-and-network", "async-without-events", "events-without-systems",
        "events-with-ckpt"])
def test_argument_errors_are_the_reference(argv, capsys):
    for main, extra in ((jtrain.main, []), (ttrain.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(COMMON + argv + extra + ["--rounds", "1"])
        assert e.value.code == 2
    errs = capsys.readouterr().err.splitlines()
    assert errs[-1].split("error: ")[1] == [ln for ln in errs if "error: " in ln][0].split(
        "error: ")[1]


def test_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    """No ``--device``: the GPU, and an error where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(COMMON + ["--rounds", "1"])
