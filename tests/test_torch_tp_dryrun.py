"""The dry run on the reference's meshes (``make_production_mesh``: data 16 x
model 16, pod 2 x data 16 x model 16): records on 256 and 512 cards, counts
per card, the model axis's collectives counted (``collectives["model_axis"]``),
and the per-card FLOPs of a tensor-parallel decode against a closed form.
Reduced widths, and the shapes' full batches at 64 positions (meta tensors,
nothing allocated)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import GATHER_NOTE


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(tdry, "get_config", lambda arch: get_reduced(arch))
    monkeypatch.setattr(tdry, "SHAPES", {k: dataclasses.replace(v, seq_len=64)
                                         for k, v in tdry.SHAPES.items()})


@pytest.mark.parametrize("mesh_kind,cards", [("single", 256), ("multi", 512)])
def test_records_are_on_256_and_512_cards(reduced, mesh_kind, cards):
    for shape, steps in (("train_4k", ("train_gossip", "train_global")),
                         ("prefill_32k", ("prefill",)), ("decode_32k", ("decode",))):
        recs = tdry.run_one("qwen3-8b", shape, mesh_kind)
        assert [r["step"] for r in recs] == list(steps)
        for rec in recs:
            assert rec["status"] == "ok", rec.get("error")
            assert rec["n_chips"] == cards, (shape, rec["step"])
            assert rec["notes"].get("model_axis") == 16
    # a batch of one does not split over the agents: one agent's 16 cards
    rec = tdry.run_one("mamba2-370m", "long_500k", mesh_kind)[0]
    assert rec["status"] == "ok" and rec["n_chips"] == 16


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b", "mamba2-370m",
                                  "seamless-m4t-medium"])
def test_model_axis_all_reduce_bytes_are_counted(reduced, arch):
    """A prefill moves nothing over the agent axes: every byte it counts is
    the model axis's (the layers' all-reduces and the logits' all-gather);
    a train step adds the agent axes' gossip to its model-axis traffic."""
    rec = tdry.run_one(arch, "prefill_32k", "single")[0]
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0
    assert coll["model_axis"] == coll["total"] == coll["all-reduce"] + coll["all-gather"]
    for rec in tdry.run_one(arch, "train_4k", "multi"):
        coll = rec["collectives"]
        assert 0 < coll["model_axis"] < coll["total"]
        assert coll["model_axis"] <= coll["all-reduce"] + coll["all-gather"]


@pytest.mark.parametrize("b,s", [(2, 64), (3, 128)])
def test_tp_decode_flops_closed_form(b, s):
    """The reduced Qwen3-8B decode on 16 model ranks: its 4 heads do not
    divide 16, so each card computes the whole attention; the FFN's hidden
    dim and the vocabulary split, 1/16 each a card."""
    cfg = get_reduced("qwen3-8b")
    d, h, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                           cfg.d_ff, cfg.vocab_size)
    per_layer = 2 * b * (d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f // 16) \
        + 2 * 2 * b * h * s * hd
    want = cfg.n_layers * per_layer + 2 * b * d * v // 16
    spec = tdry.build_steps(cfg, InputShape("d", s, b, "decode"),
                            make_production_mesh())["decode"]
    counts = spec.lower()
    assert counts["flops_int"] == want
    # the embedding's and each layer's FFN's all-reduce of (b, 1, d); the
    # logits' all-gather
    coll = counts["collectives"]
    assert coll["n_all-reduce"] == cfg.n_layers + 1 and coll["n_all-gather"] == 1
    assert coll["all-reduce"] == (cfg.n_layers + 1) * b * d * 4
    assert coll["all-gather"] == b * v * 4


def test_opt_idle_batch_is_recorded_as_not_ported(reduced):
    """``--opt-idle-batch`` is ported (the name is kept from when it was
    not): a batch that splits over the agent axes leaves no axis idle, so
    the flag changes nothing there; a batch of one runs on all 256 cards,
    its KV cache's sequence split over the data axis and counted on the
    ``idle_axis`` collectives."""
    rec = tdry.run_one("qwen3-8b", "decode_32k", "single", opt_idle_batch=True)[0]
    assert rec["status"] == "ok" and rec["notes"]["opt_idle_batch"]
    assert "opt_idle_batch_note" not in rec["notes"] and "idle_axes" not in rec["notes"]
    plain = tdry.run_one("qwen3-8b", "decode_32k", "single")[0]
    assert rec["cost"] == plain["cost"] and rec["collectives"] == plain["collectives"]
    one = tdry.run_one("qwen3-8b", "long_500k", "single", opt_idle_batch=True)[0]
    flat = tdry.run_one("qwen3-8b", "long_500k", "single")[0]
    assert one["status"] == "ok" and one["n_chips"] == 256 and flat["n_chips"] == 16
    assert one["notes"]["idle_axes"] == ["data"]
    assert {k.rsplit("/", 1)[-1] for k, d in one["notes"]["cache_idle_layout"].items()
            if d is not None} == {"k", "v"}
    assert one["collectives"]["idle_axis"] > 0 and flat["collectives"]["idle_axis"] == 0
    assert one["memory"]["argument_bytes"] < flat["memory"]["argument_bytes"]


def test_hierarchical_records_gather_the_model_shard(reduced):
    cfg = dataclasses.replace(get_reduced("qwen3-8b"), d_model=1024)
    mesh = make_production_mesh(multi_pod=True)
    spec = tdry.build_steps(cfg, InputShape("t", 64, 64, "train"), mesh,
                            agent_mode="hierarchical")["train_gossip"]
    assert spec.notes["model_axis"] == 16
    assert spec.notes["gather"] == GATHER_NOTE and "one period" in GATHER_NOTE
    assert any(d is not None for d in spec.notes["data_dims"].values())
    counts = spec.lower()
    assert counts["collectives"]["model_axis"] > 0 and counts["collectives"]["all-gather"] > 0
    assert torch.device(mesh.device).type == "meta"
