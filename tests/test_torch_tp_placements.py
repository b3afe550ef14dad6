"""Where the model axis splits each leaf (``repro_torch.launch.steps.param_layout``
/ ``cache_layout``, the bundles' ``cache_specs``) against the reference's
placements on every arch's full-width shapes, on meta tensors (nothing is
allocated, no process is spawned).  The reference's functions read only
``mesh.shape``, so one stand-in serves both packages.  Exact: these are
integers and names.

The port departs from the reference's placement on the Mamba-2 leaves that
pack several tensors along one dim (``in_proj``: z, x, B, C, dt; ``conv_w``
/ ``conv_b``: x, B, C): the reference cuts contiguous chunks across those
boundaries, the port cuts each rank's heads of z, x and dt and holds B and C
whole.  Per Mamba-2 layer and rank that is ``(d_model + d_conv + 1) x 2
n_groups d_state x (1 - 1/m)`` more elements than the reference's shard, on
m model ranks; the conv window of the cache likewise, and the SSM state,
which the reference holds whole, is split by head.
"""
import re

import pytest
import torch

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import CountingMesh  # noqa: E402
from repro_torch.launch.specs import Segments, shard_model, shard_tree  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import flatten_paths  # noqa: E402
from repro_torch.weights import init_model_shard  # noqa: E402

MAMBA_PACKED = ("mixer/in_proj", "mixer/conv_w", "mixer/conv_b")


def _mesh(**shape):
    """Rank 0's view of a mesh with no process group."""
    return CountingMesh(dict(shape), torch.device("meta"))


def _path(keystr: str) -> str:
    return "/".join(a or b for a, b in re.findall(r"\[(?:'([^']*)'|(\d+))\]", keystr))


def _flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {_path(jax.tree_util.keystr(p)): tuple(s) for p, s in leaves}


def _want_shape(shape, spec, m):
    """A leaf's shard shape under the reference's sanitized placement."""
    return tuple(d // m if i < len(spec) and spec[i] == "model" else d
                 for i, d in enumerate(shape))


def _mamba_layers(cfg) -> int:
    return sum(k == "mamba" for k in cfg.layer_kinds())


def _mamba_extra(cfg, m) -> int:
    """Elements a rank holds beyond the reference's shard: B and C whole in
    ``in_proj`` (d_model rows), ``conv_w`` (d_conv rows) and ``conv_b``."""
    if cfg.ssm is None:
        return 0
    gn2 = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return _mamba_layers(cfg) * (cfg.d_model + cfg.ssm.d_conv + 1) * (gn2 - gn2 // m)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    mb, jb = get_bundle(cfg, "meta"), j_get_bundle(j_get_config(arch))
    for baxes in (None, "data", ("pod", "data")):
        assert mb.cache_specs(baxes, "model") == _flat_specs(jb.cache_specs(baxes, "model"))


@pytest.mark.parametrize("m", [16, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shards_follow_the_reference_placement(arch, m):
    """Every parameter's and cache leaf's shard shape on m model ranks is
    the reference's sanitized placement's, but for the packed Mamba-2
    leaves (and the SSM state), whose port layout is stated above."""
    cfg = get_config(arch)
    mb, jb = get_bundle(cfg, "meta"), j_get_bundle(j_get_config(arch))
    mesh = _mesh(data=16, model=m)
    params = flatten_paths(mb.init(0))
    jspec, _ = jspecs.sanitize_specs(jb.param_specs("model"),
                                     jax.eval_shape(jb.init, jax.random.PRNGKey(0)), mesh)
    jspec = _flat_specs(jspec)
    layout, differs, _ = S.param_layout(mb, mesh)
    shards = shard_model(params, layout, mesh)
    heads_split = (cfg.ssm is not None
                   and (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) % m == 0)
    want_differs = sorted(p for p in params if p.endswith(MAMBA_PACKED)) if heads_split else []
    assert differs == want_differs
    for path, leaf in params.items():
        got = tuple(shards[path].shape)
        if path in differs:
            seg = layout[path]
            assert isinstance(seg, Segments) and seg.split.count(False) == 1
            assert got[-1] == leaf.shape[-1] // m + (seg.sizes[seg.split.index(False)]
                                                     * (m - 1)) // m
        else:
            assert got == _want_shape(tuple(leaf.shape), jspec[path], m), path
    # the cache of a decode_32k card (batch 8 rows)
    kw = {"mem_len": 1024} if cfg.is_enc_dec else {}
    cache = mb.init_cache(8, 4096, **kw)
    c_layout, c_differs = S.cache_layout(mb, cache, mesh)
    jcache = jax.eval_shape(lambda: jb.init_cache(8, 4096, **kw))
    cspec = _flat_specs(jspecs.sanitize_specs(jb.cache_specs(None, "model"), jcache, mesh)[0])
    c_shards = shard_model(flatten_paths(cache), c_layout, mesh)
    assert c_differs == (sorted(p for p in c_shards if p.endswith(("/conv", "/ssm")))
                         if heads_split else [])
    for path, leaf in flatten_paths(cache).items():
        if path.endswith("/ssm") and heads_split:
            assert c_shards[path].shape[-3] == leaf.shape[-3] // m
        elif path not in c_differs:
            assert tuple(c_shards[path].shape) == _want_shape(tuple(leaf.shape), cspec[path], m)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_card_bytes_equal_the_reference_shard_bytes(arch):
    """On (data 16, model 16), one card's parameter bytes are the
    reference's ``shard_bytes`` of the flat mode's stacked placements, plus
    the Mamba-2 leaves' stated difference."""
    cfg = get_config(arch)
    mb, jb = get_bundle(cfg, "meta"), j_get_bundle(j_get_config(arch))
    mesh = _mesh(data=16, model=16)
    jsds = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    stacked = jax.tree.map(lambda s: jax.ShapeDtypeStruct((16,) + s.shape, s.dtype), jsds)
    jsp, _ = jspecs.sanitize_specs(jspecs.stack_spec_tree(jb.param_specs("model"), ("data",)),
                                   stacked, mesh)
    want = jspecs.shard_bytes(stacked, jsp, mesh)
    layout, _, _ = S.param_layout(mb, mesh)
    shards = shard_model(flatten_paths(mb.init(0)), layout, mesh)
    got = sum(v.numel() * v.element_size() for v in shards.values())
    itemsize = torch.finfo(torch.bfloat16).bits // 8
    assert got - want == _mamba_extra(cfg, 16) * itemsize
    if cfg.ssm is not None:
        assert got > want


def test_leaves_that_stay_whole():
    """At 16 ranks the 8 KV heads of Qwen3-8B, Mixtral, Jamba and Nemotron-4
    stay whole, and so do the vocabularies of Mamba2-370m and Seamless;
    Qwen2.5-14B's 40 heads and Qwen2-VL's 12 do not divide either."""
    mesh = _mesh(data=16, model=16)

    def layout_of(arch):
        return S.param_layout(get_bundle(get_config(arch), "meta"), mesh)[0]

    for arch in ("qwen3-8b", "mixtral-8x7b", "jamba-v0.1-52b", "nemotron-4-340b"):
        lay = layout_of(arch)
        wk = [p for p in lay if p.endswith("mixer/wk")]
        assert wk and all(lay[p] is None for p in wk)
        assert all(lay[p] is not None for p in lay if p.endswith("mixer/wq"))
    assert layout_of("mamba2-370m")["embed"] is None
    assert layout_of("seamless-m4t-medium")["embed"] is None
    assert layout_of("qwen3-8b")["embed"] == 0
    for arch in ("qwen2.5-14b", "qwen2-vl-2b"):
        lay = layout_of(arch)
        assert all(lay[p] is None for p in lay if p.endswith(("mixer/wq", "mixer/wo")))
    lay = layout_of("granite-20b")  # MQA: the one KV head whole
    assert all(lay[p] is None for p in lay if p.endswith(("mixer/wk", "mixer/wv")))


@pytest.mark.parametrize("m,i", [(2, 1), (4, 2)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_model_shard_is_the_init_cut(arch, m, i):
    """``init_model_shard`` (each random leaf cut as it is drawn) gives rank
    i's model shard of ``bundle.init``, bit for bit."""
    bundle = get_bundle(get_reduced(arch), "cpu")
    mesh = CountingMesh({"data": 1, "model": m}, torch.device("cpu"), rank=i)
    layout = S.param_layout(bundle, mesh)[0]
    got = flatten_paths(init_model_shard(bundle, layout, mesh, seed=3))
    want = flatten_paths(shard_tree(bundle.init(seed=3), layout, mesh))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sum(v.numel() for v in got.values()) < sum(
        v.numel() for v in flatten_paths(bundle.init(seed=3)).values())
