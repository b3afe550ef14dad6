"""A batch-1 decode's placements over the idle axes
(``repro_torch.launch.steps.idle_layouts``) against the reference's
``_optimize_idle_batch_specs`` after ``sanitize_specs``, on every arch's
full-width shapes and the reference's meshes (data 16, model 16) and (pod 2,
data 16, model 16), on meta tensors (no process is spawned); and the six
committed ``__opt_idle_batch`` dry-run records.  Exact: integers and names.

The port's layout departs from the reference's where its bytes on a card
differ, and lists those leaves (``differs``, with the bytes each adds):
the Mamba-2 leaves of the model axis (B and C held whole), the SSM state
where the model rank's heads do not divide over the idle axes (the
reference holds all heads over the idle axes alone), and stacked dense FFN
leaves, whose layer axis the reference's key-based rewrite reads as experts
(the port keeps them whole over the idle axes).
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import get_bundle as j_get_bundle
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import CountingMesh
from repro_torch.models.registry import get_bundle
from repro_torch.utils.pytree import flatten_paths

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PAYLOAD = os.path.join(ROOT, "artifacts", "torch", "dryrun")
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
SEQ = 32768
LONG = ("mixtral-8x7b", "jamba-v0.1-52b", "mamba2-370m")


def _mesh(shape):
    return CountingMesh(dict(shape), torch.device("meta"))


def _path(keystr: str) -> str:
    return "/".join(a or b for a, b in re.findall(r"\[(?:'([^']*)'|(\d+))\]", keystr))


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {_path(jax.tree_util.keystr(p)): (tuple(s) if isinstance(s, jax.sharding.PartitionSpec)
                                             else s) for p, s in leaves}


def _cache(jb, cfg):
    if cfg.is_enc_dec:
        return jax.eval_shape(lambda: jb.init_cache(1, SEQ, mem_len=SEQ // 4))
    return jax.eval_shape(lambda: jb.init_cache(1, SEQ))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_idle_layouts_against_the_reference_rewrite(arch, mesh_kind):
    mesh = _mesh(MESHES[mesh_kind])
    jcfg = j_get_config(arch)
    jb = j_get_bundle(jcfg)
    p_sds = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    c_sds = _cache(jb, jcfg)
    jc, jp = jsteps._optimize_idle_batch_specs(jb.cache_specs(None, "model"),
                                                jb.param_specs("model"), mesh)
    jp, jp_drop = jspecs.sanitize_specs(jp, p_sds, mesh)
    jc, jc_drop = jspecs.sanitize_specs(jc, c_sds, mesh)
    ref = {**_flat(jp), **_flat(jc)}
    sds = {**_flat(p_sds), **_flat(c_sds)}

    mb = get_bundle(get_config(arch), "meta")
    cache = (mb.init_cache(1, SEQ, mem_len=SEQ // 4) if mb.cfg.is_enc_dec
             else mb.init_cache(1, SEQ))
    lay = S.idle_layouts(mb, cache, mesh)
    # the twin of the rewrite and its sanitizer: the same placements and report
    assert lay.reference == ref
    want = sorted(re.sub(r"^(\S+):", lambda m: _path(m.group(1)) + ":", d)
                  for d in jp_drop + jc_drop)
    assert sorted(lay.dropped) == want
    # each leaf's bytes on a card: the reference's shard_bytes, but where listed
    for k, shaped in sds.items():
        jbytes = jspecs.shard_bytes({"x": shaped}, {"x": jax.sharding.PartitionSpec(*ref[k])},
                                    mesh)
        assert lay.reference_bytes[k] == jbytes, k
        if k in lay.differs:
            assert lay.port_bytes[k] == jbytes + lay.added[k], k
        else:
            assert lay.port_bytes[k] == jbytes, k
    total = sum(lay.port_bytes.values())
    assert total == sum(lay.reference_bytes.values()) + sum(lay.added.values())
    # every leaf the port splits over the idle axes divides, and is a KV
    # cache's sequence, an SSM state's heads or an expert-stacked leaf
    for k, d in {**lay.params, **lay.cache}.items():
        if d is None:
            continue
        name = k.rsplit("/", 1)[-1]
        assert name in tspecs.CACHE_SEQ + ("ssm",) + tspecs.EXPERT_LEAVES, k
        assert "shared" not in k
    # what the port leaves whole that the reference split is listed
    entry = tspecs.idle_entry(mesh)
    for k, spec in ref.items():
        split_ref = entry in spec
        split_port = (lay.params.get(k, lay.cache.get(k)) is not None)
        if split_ref and not split_port:
            assert k in lay.differs or lay.port_bytes[k] == lay.reference_bytes[k], k


def test_dense_stacked_ffn_is_read_as_experts_by_the_reference_only():
    """The reference's rewrite puts the idle axes on the first of the last
    three dims of every FFN leaf under ``ffn``: a stacked dense leaf's layer
    axis.  Qwen3-8B's 36 layers do not divide 16, Granite-20B's 52 do not
    either; Nemotron-4's 96 do: the reference splits its layers, the port
    keeps them whole and lists the bytes."""
    mesh = _mesh(MESHES["single"])
    mb = get_bundle(get_config("nemotron-4-340b"), "meta")
    lay = S.idle_layouts(mb, mb.init_cache(1, SEQ), mesh)
    k = "layers/pos0/ffn/w_up"
    assert lay.reference[k][0] == "data" and lay.params[k] is None
    assert k in lay.differs and lay.added[k] == lay.reference_bytes[k] * 15


def test_rewrite_is_key_based_as_the_reference():
    mesh = _mesh(MESHES["multi"])
    cache = {"layers/pos0/k": (None, None, None, "model", None), "layers/pos0/c_kv":
             (None, None, None, None), "layers/pos0/ssm": (None, None, None, None, None),
             "layers/pos0/conv": (None, None, None, "model"), "pos": ()}
    params = {"layers/pos0/ffn/w_up": (None, None, None, "model"),
              "head_layers/0/ffn/w_up": (None, "model"), "layers/pos0/mixer/wq": (None, None,
                                                                                "model", None)}
    c, p = tspecs.optimize_idle_batch_specs(cache, params, mesh)
    e = ("pod", "data")
    assert c["layers/pos0/k"] == (None, None, e, "model", None)
    assert c["layers/pos0/c_kv"] == (None, None, e, None)
    assert c["layers/pos0/ssm"] == (None, None, e, None, None)
    assert c["layers/pos0/conv"] == (None, None, None, "model") and c["pos"] == ()
    assert p["layers/pos0/ffn/w_up"] == (None, e, None, "model")
    assert p["head_layers/0/ffn/w_up"] == (None, "model")
    assert p["layers/pos0/mixer/wq"] == params["layers/pos0/mixer/wq"]


def _records():
    out = {}
    for arch in LONG:
        for mesh in MESHES:
            name = f"{arch}__long_500k__{mesh}__decode__opt_idle_batch.json"
            with open(os.path.join(PAYLOAD, name)) as f:
                out[(arch, mesh)] = json.load(f)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LONG)
def test_committed_idle_batch_records(arch, mesh):
    recs = _records()
    rec = recs[(arch, mesh)]
    with open(os.path.join(PAYLOAD, f"{arch}__long_500k__{mesh}__decode.json")) as f:
        flat = json.load(f)
    cards = 256 if mesh == "single" else 512
    assert rec["status"] == "ok" and rec["n_chips"] == cards and flat["n_chips"] == 16
    assert rec["variant"]["opt_idle_batch"] and rec["notes"]["opt_idle_batch"]
    assert "opt_idle_batch_note" not in rec["notes"]
    assert rec["notes"]["idle_axes"] == (["data"] if mesh == "single" else ["pod", "data"])
    assert "idle_axis" in rec["collectives"]
    n = cards // 16
    # each cache leaf the idle axes split holds at most the flat record's
    # block over the data-axis size
    mb = get_bundle(get_config(arch), "meta")
    cache = mb.init_cache(1, 524288)
    lay = S.idle_layouts(mb, cache, make_mesh_of(mesh))
    shapes = flatten_paths(cache)
    split = [k for k, d in lay.cache.items() if d is not None]
    for k in split:
        flat_bytes = int(np.prod(shapes[k].shape)) * shapes[k].element_size()
        m = 16 if lay.model_cache.get(k) is not None else 1
        assert lay.port_bytes[k] <= flat_bytes // m // n, k
    assert rec["notes"]["cache_idle_layout"] == lay.cache
    assert rec["memory"]["argument_bytes"] <= flat["memory"]["argument_bytes"]
    if arch != "mamba2-370m":  # its SSM heads (2 a model rank) stay whole over the idle axes
        assert split and rec["collectives"]["idle_axis"] > 0
        assert rec["memory"]["argument_bytes"] < flat["memory"]["argument_bytes"]


def make_mesh_of(kind):
    return _mesh(MESHES[kind])


def test_cost_correction_of_an_idle_record_equals_the_direct_count(tmp_path):
    """The two-point correction over layer periods, run on a committed
    ``__opt_idle_batch`` record (its variant rebuilds the idle decode),
    equals the record's direct count to the flop."""
    import shutil

    from repro_torch.launch import cost_correction as cc

    name = "jamba-v0.1-52b__long_500k__single__decode__opt_idle_batch.json"
    path = str(tmp_path / name)
    shutil.copy(os.path.join(PAYLOAD, name), path)
    assert cc.correct_record(path, force=True)
    with open(path) as f:
        rec = json.load(f)
    assert rec["cost_corrected"]["flops"] == rec["cost"]["flops"]
    assert rec["cost_corrected"]["collective_total"] == rec["collectives"]["total"]


@pytest.mark.parametrize("arch,n", [("mixtral-8x7b", 2), ("deepseek-v2-lite-16b", 4),
                                    ("jamba-v0.1-52b", 4)])
def test_batched_dispatch_over_held_experts_sums_to_the_whole(arch, n):
    """The batched form (the dry run's, and any routing group of more than
    one token) on ranks that each hold a block of the experts: the entries
    routed elsewhere are dropped, each held expert keeps the whole layer's
    capacity, and the ranks' outputs sum to the whole dispatch's, drops at
    capacity included."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as TMoE

    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(3)
    p = TMoE.init_moe(gen, cfg, torch.float32)
    experts = {k: p[k] for k in ("w_gate", "w_up", "w_down") if k in p}
    xf = torch.randn(24, cfg.d_model, generator=gen)
    top_idx, top_w, _ = TMoE.route(xf @ p["router"], cfg.moe)
    whole = TMoE.dispatch_batched(experts, cfg, xf, top_idx, top_w)
    e = cfg.moe.n_experts // n
    parts = [TMoE.dispatch_batched({k: v[r * e:(r + 1) * e] for k, v in experts.items()}, cfg,
                                   xf, top_idx, top_w, lo=r * e) for r in range(n)]
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    for r, part in enumerate(parts):  # nothing of another rank's experts
        elsewhere = (top_idx < r * e) | (top_idx >= (r + 1) * e)
        assert float(part[elsewhere].abs().max()) == 0.0
