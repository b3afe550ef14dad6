"""The dry run, ``python -m repro_torch.launch.dryrun``, held against the
reference's on the CPU: the arithmetic (``_model_flops``, ``Roofline``), the
input shapes, the full-width parameter and cache shapes on the meta device
against ``jax.eval_shape`` of the reference's inits, the counted matmul
FLOPs against a closed form, the two-point cost correction against the
direct count, the committed payload (an ``ok`` record for every pair the
reference's ``applicable`` admits) and the tables against the reference's
scripts."""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402

# the reference's dryrun forces 512 host devices through XLA_FLAGS when
# imported; the backend is initialised first, so this process keeps its one
# device, and the variable is put back for any subprocess
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from benchmarks import experiments_md as jmd  # noqa: E402
from benchmarks import roofline as jroof  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import input_specs as jinputs  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro.utils import hlo as jhlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.figures import experiments_md as tmd  # noqa: E402
from repro_torch.figures import roofline as troof  # noqa: E402
from repro_torch.launch import cost_correction as tcc  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import input_specs as tinputs  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, make_production_mesh  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils import roofline as troofline  # noqa: E402
from repro_torch.utils.pytree import flatten_paths  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
PAYLOAD = os.path.join(ROOT, "artifacts", "torch", "dryrun")
STEPS = {"train": ("train_gossip", "train_global"), "prefill": ("prefill",),
         "decode": ("decode",)}


def _spec(s):
    return tuple(s.shape), str(s.dtype).removeprefix("torch.")


def _jax_tree(tree) -> dict:
    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))

    return {"/".join(name(k) for k in path): _spec(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def test_model_flops_bit_equal():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for name, shape in tshapes.SHAPES.items():
            for step in STEPS[shape.kind]:
                for t_o in (1, 3):
                    assert tdry._model_flops(cfg, shape, step, t_o) == jdry._model_flops(
                        jcfg, jshapes.SHAPES[name], step, t_o), (arch, name, step)


def test_applicable_is_the_reference():
    for arch in ARCH_IDS:
        for name in tshapes.SHAPES:
            assert tdry.applicable(arch, name) == jdry.applicable(arch, name)
    assert tdry.SKIP_LONG_DECODE_NOTE == jdry.SKIP_LONG_DECODE_NOTE


def test_roofline_from_counts_is_the_reference_at_its_constants():
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c, mf = (float(v) for v in rng.uniform(1e9, 1e16, size=4))
        chips = int(rng.integers(1, 512))
        got = troofline.Roofline.from_counts(
            f, b, c, model_flops=mf, n_chips=chips, peak_flops=jhlo.PEAK_FLOPS_BF16,
            hbm_bw=jhlo.HBM_BW, link_bw=jhlo.ICI_BW).to_dict()
        assert got == jhlo.Roofline.from_counts(f, b, c, model_flops=mf, n_chips=chips).to_dict()
    # the port's defaults are the H100's
    r = troofline.Roofline.from_counts(989e12, 3.35e12, 450e9)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in tshapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        if shape.kind == "train":
            for n, t_o in ((16, 1), (32, 2)):
                got = tinputs.train_inputs(cfg, shape, n, t_o)
                want = jinputs.train_inputs(jcfg, jshape, n, t_o)
                for g, w in zip(got, want):
                    assert {k: _spec(v) for k, v in g.items()} == _jax_tree(w)
        elif shape.kind == "prefill":
            got = tinputs.prefill_inputs(cfg, shape)
            assert {k: _spec(v) for k, v in got.items()} == _jax_tree(
                jinputs.prefill_inputs(jcfg, jshape))
        else:
            assert _spec(tinputs.decode_token_input(shape)) == _spec(
                jinputs.decode_token_input(jshape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_meta_params_and_caches_are_eval_shape(arch):
    """The meta init and the DECODE_32K cache at full width equal
    ``jax.eval_shape`` of the reference's in path, shape and dtype; nothing
    is allocated."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    bundle, jbundle = get_bundle(cfg, "meta"), j_get_bundle(jcfg)
    params = bundle.init(0)
    assert all(t.device.type == "meta" for t in flatten_paths(params).values())
    got = {k: _spec(v) for k, v in flatten_paths(params).items()}
    assert got == _jax_tree(jax.eval_shape(jbundle.init, jax.random.PRNGKey(0)))
    shape = tshapes.DECODE_32K
    kw = {"mem_len": shape.seq_len // 4} if cfg.is_enc_dec else {}
    cache = bundle.init_cache(shape.global_batch, shape.seq_len, **kw)
    want = jax.eval_shape(lambda: jbundle.init_cache(shape.global_batch, shape.seq_len, **kw))
    assert {k: _spec(v) for k, v in flatten_paths(cache).items()} == _jax_tree(want)


def test_steps_run_on_meta_arguments():
    cfg = get_reduced("deepseek-v2-lite-16b")
    mesh = make_production_mesh(multi_pod=True)
    for shape in (InputShape("t", 16, 32, "train"), InputShape("p", 16, 2, "prefill"),
                  InputShape("d", 16, 2, "decode")):
        for spec in tdry.build_steps(cfg, shape, mesh).values():
            leaves = jax.tree_util.tree_leaves(spec.args, is_leaf=lambda x: isinstance(
                x, torch.Tensor))
            assert leaves and all(t.device.type == "meta" for t in leaves
                                  if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(2, 64), (3, 128)])
def test_decode_matmul_flops_closed_form(b, s):
    """A dense GQA decode step: every layer's q/k/v/o projections, the
    scores and values over the whole cache (masked, as the reference's
    decode attends), the SwiGLU FFN, then the vocabulary head."""
    cfg = get_reduced("qwen3-8b")
    d, h, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                           cfg.d_ff, cfg.vocab_size)
    per_layer = 2 * b * (d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f) \
        + 2 * 2 * b * h * s * hd
    want = cfg.n_layers * per_layer + 2 * b * d * v
    spec = tdry.build_steps(cfg, InputShape("d", s, b, "decode"),
                            CountingMesh({"data": 16, "model": 1}, torch.device("meta")))["decode"]
    counts = spec.lower()
    assert counts["flops_int"] == want
    assert counts["memory"]["alias_bytes"] > 0  # the cache is written in place


def test_train_round_collectives_closed_form():
    """A gossip round moves x and y once along each ring shift (float32
    on the wire); a server round sums them once."""
    cfg = get_reduced("mamba2-370m")
    leaves = flatten_paths(get_bundle(cfg, "meta").init(0))
    n_params = sum(t.numel() for t in leaves.values())
    for multi, shifts in ((False, 2), (True, 3)):
        # one card per agent (a model axis of 1): the agent axes' traffic alone
        shape = {"pod": 2, "data": 16, "model": 1} if multi else {"data": 16, "model": 1}
        steps = tdry.build_steps(cfg, InputShape("t", 16, 64, "train"),
                                 CountingMesh(shape, torch.device("meta")))
        gossip = steps["train_gossip"].lower()["collectives"]
        assert gossip["collective-permute"] == 2 * shifts * 4 * n_params
        assert gossip["n_collective-permute"] == 2 * shifts * len(leaves)
        server = steps["train_global"].lower()["collectives"]
        assert server["all-reduce"] == server["total"] == 2 * 4 * n_params


@pytest.mark.parametrize("kind,batch,multi,cards", [
    ("prefill", 32, False, 16), ("prefill", 32, True, 32), ("decode", 64, False, 16),
    ("decode", 8, False, 1), ("decode", 1, True, 1)])
def test_serve_step_useful_ratio_is_model_flops_over_flops(kind, batch, multi, cards):
    """A serving batch splits over the agents when it divides across them:
    the cards' counts add up to the whole batch's on one card, so the
    record's useful ratio is model FLOPs over the step's FLOPs."""
    cfg = get_reduced("qwen3-8b")
    shape = InputShape("s", 32, batch, kind)
    # one card per agent (a model axis of 1): the batch split alone
    mesh = CountingMesh({"pod": 2, "data": 16, "model": 1} if multi else
                        {"data": 16, "model": 1}, torch.device("meta"))
    spec = tdry.build_steps(cfg, shape, mesh)[kind]
    assert spec.notes["n_chips"] == cards and spec.notes["rows_per_chip"] == batch // cards
    per_card = spec.lower()["flops_int"]
    whole = tdry.build_steps(cfg, shape, CountingMesh({"data": 1, "model": 1}, torch.device("meta")))[kind]
    assert whole.notes["n_chips"] == 1
    flops = whole.lower()["flops_int"]
    assert per_card * cards == flops
    model = tdry._model_flops(cfg, shape, kind, 1)
    ratio = troofline.Roofline.from_counts(float(per_card), 1.0, 0.0, model_flops=model,
                                           n_chips=cards).useful_ratio
    assert ratio == pytest.approx(model / flops, rel=1e-12)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_cost_correction_equals_the_direct_count(arch):
    """Four layer periods counted directly against the extrapolation from
    one and two: equal FLOPs, bytes and collective bytes."""
    cfg = tcc._variant_cfg(get_reduced(arch), 4)
    for shape in (InputShape("t", 16, 32, "train"), InputShape("p", 32, 2, "prefill"),
                  InputShape("d", 32, 2, "decode")):
        for step in STEPS[shape.kind][:1]:
            direct = tcc.measure(cfg, shape, step, "multi", {})
            corrected = tcc.corrected_counts(cfg, shape, step, "multi", {})
            assert corrected["n_periods"] == 4
            for key in ("flops", "bytes_accessed", "collective_total"):
                assert corrected[key] == direct[key], (step, key)


# ---------------------------------------------------------------------------
# The command line, the payload and the tables
# ---------------------------------------------------------------------------


def test_dryrun_cli_records(tmp_path, capsys, monkeypatch):
    out = str(tmp_path)
    assert tdry.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--out", out]) == 0
    rec = troof.load_records(out)[0]
    # a batch of one does not split: one agent of the 16, its 16 model cards, serves it
    assert rec["status"] == "ok" and rec["n_chips"] == 16 and rec["compile_s"] == 0.0
    assert rec["notes"]["batch_axes"] is None and rec["notes"]["rows_per_chip"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                                  "alias_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "transcendentals"}
    assert set(rec["roofline"]) == set(jhlo.Roofline.from_counts(1, 1, 1).to_dict())
    assert {"collective-permute", "all-reduce", "all-gather", "total"} <= set(rec["collectives"])
    assert os.path.basename(troof.glob.glob(os.path.join(out, "*.json"))[0]) == (
        "mamba2-370m__long_500k__single__decode.json")
    # pod-as-agent and the dots remat policy, once refused, write ok records
    # (at the reduced width, with remat on, to keep the test short)
    monkeypatch.setattr(tdry, "get_config", lambda arch: dataclasses.replace(
        get_reduced(arch), remat=True))
    assert tdry.main(["--arch", "mamba2-370m", "--shape", "train_4k", "--mesh", "multi",
                      "--agent-mode", "hierarchical", "--out", out]) == 0
    for policy in ("full", "dots"):
        assert tdry.main(["--arch", "mamba2-370m", "--shape", "train_4k", "--mesh", "multi",
                          "--remat-policy", policy, "--steps", "train_gossip",
                          "--tag", policy, "--out", out]) == 0
    recs = {os.path.basename(r["_file"]): r for r in jmd.load(out)}
    assert all(r["status"] == "ok" for r in recs.values())
    for step in ("train_gossip", "train_global"):
        rec = recs[f"mamba2-370m__train_4k__multi__{step}__hierarchical.json"]
        assert rec["agent_mode"] == "hierarchical" and rec["notes"]["agent_axes"] == ["pod"]
        assert rec["notes"]["n_agents"] == 2 and "dropped_shardings" in rec["notes"]
    assert "OK   mamba2-370m__train_4k__multi__train_gossip__hierarchical" in (
        capsys.readouterr().out)
    full, dots = (recs[f"mamba2-370m__train_4k__multi__train_gossip__{p}.json"]
                  for p in ("full", "dots"))
    assert dots["variant"]["remat_policy"] == "dots"
    none = tdry.build_steps(dataclasses.replace(get_reduced("mamba2-370m"), remat=False),
                            tshapes.TRAIN_4K, make_production_mesh(multi_pod=True))
    none = none["train_gossip"].lower()
    assert (full["memory"]["peak_bytes"] < dots["memory"]["peak_bytes"]
            < none["memory"]["peak_bytes"])
    assert none["cost"]["flops"] < dots["cost"]["flops"] < full["cost"]["flops"]


def test_payload_has_an_ok_record_for_every_pair():
    """The committed ``--all --mesh both`` payload, and beside it the
    ``--all --mesh multi --agent-mode hierarchical`` train records, each
    holding less state a card than the flat multi record of its arch, and
    the long_500k decodes with ``--opt-idle-batch --tag opt_idle_batch``,
    each holding no more than its flat record."""
    recs = {os.path.basename(r["_file"]): r for r in jmd.load(PAYLOAD)}
    want = {f"{a}__{s}__{m}__{step}.json"
            for a in ARCH_IDS for s, shape in tshapes.SHAPES.items() if jdry.applicable(a, s)
            for m in ("single", "multi") for step in STEPS[shape.kind]}
    hier = {f"{a}__train_4k__multi__{step}__hierarchical.json"
            for a in ARCH_IDS for step in STEPS["train"]}
    idle = {f"{a}__long_500k__{m}__decode__opt_idle_batch.json"
            for a in ARCH_IDS if jdry.applicable(a, "long_500k") for m in ("single", "multi")}
    assert set(recs) == want | hier | idle
    for name in idle:
        flat = recs[name.replace("__opt_idle_batch", "")]
        assert recs[name]["memory"]["argument_bytes"] <= flat["memory"]["argument_bytes"]
    for name in hier:
        flat = recs[name.replace("__hierarchical", "")]
        assert recs[name]["agent_mode"] == "hierarchical"
        assert recs[name]["memory"]["argument_bytes"] < flat["memory"]["argument_bytes"]
    assert all(r["status"] == "ok" for r in recs.values())
    assert troof.summarize(list(recs.values()))["n_fail"] == 0


def _titles(text: str) -> str:
    return re.sub(r"^### (T\d) .*$", r"\1", text, flags=re.M)


def test_tables_are_the_reference_scripts():
    recs = troof.load_records(PAYLOAD)
    assert recs == jroof.load_records(PAYLOAD)
    for mesh in ("single", "multi", None):
        assert troof.fmt_table(recs, mesh) == jroof.fmt_table(recs, mesh)
    assert troof.summarize(recs) == jroof.summarize(recs)
    md = tmd.load(PAYLOAD)
    assert md == jmd.load(PAYLOAD)
    for mesh in ("single", "multi"):
        assert tmd.dryrun_table(md, mesh) == jmd.dryrun_table(md, mesh)
        # the rows; the footnote names each package's correction tool
        assert tmd.roofline_table(md, mesh).split("\n\n")[0] == jmd.roofline_table(
            md, mesh).split("\n\n")[0]
    assert tmd.perf_table(md) == jmd.perf_table(md)


def test_run_one_records_variants(tmp_path):
    """``opt_idle_batch`` and the levers are recorded in the record."""
    rec = tdry.run_one("mamba2-370m", "long_500k", "multi", opt_idle_batch=True, ssm_chunk=128)[0]
    assert rec["status"] == "ok" and rec["n_chips"] == 512
    assert rec["variant"]["opt_idle_batch"] and rec["notes"]["opt_idle_batch"]
    assert rec["notes"]["idle_axes"] == ["pod", "data"]
    assert "opt_idle_batch_note" not in rec["notes"]
    assert rec["variant"]["ssm_chunk"] == 128
    assert dataclasses.asdict(get_config("mamba2-370m").ssm)["chunk"] != 128
