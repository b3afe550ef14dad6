"""The placements of pod-as-agent (``repro_torch.launch.specs`` and the
bundles' ``param_specs``) against the reference's ``repro.launch.specs`` and
``bundle.param_specs`` on every arch's full-width shapes: the model's
placements path for path, the stacked, FSDP'd and sanitized placements of
``build_train_steps(agent_mode="hierarchical")`` and of the flat mode, the
report of dropped entries and ``shard_bytes``, on meshes (pod 2, data 16,
model 16) — the reference's and the port's — and (2, 16, 1), one card per
agent.  The
reference's functions read only ``mesh.shape``, so one stand-in serves both
packages without JAX devices.  Exact: these are integers and names."""
import re
import types

import numpy as np
import pytest
import torch

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import fsdp_placement, param_layout, shard_leaves  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import flatten_paths  # noqa: E402

MESHES = {"port": {"pod": 2, "data": 16, "model": 16},
          "one card per agent": {"pod": 2, "data": 16, "model": 1}}


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _path(keystr: str) -> str:
    """``['layers']['pos0']['mixer'][0]`` -> ``layers/pos0/mixer/0``."""
    return "/".join(a or b for a, b in re.findall(r"\[(?:'([^']*)'|(\d+))\]", keystr))


def _flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {_path(jax.tree_util.keystr(p)): tuple(s) for p, s in leaves}


def _stacked_sds(jbundle, n):
    params = jax.eval_shape(jbundle.init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape, s.dtype), params)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_and_shard_bytes_equal_the_reference(arch):
    jbundle = j_get_bundle(j_get_config(arch))
    mb = get_bundle(get_config(arch), "meta")
    j_inner = jbundle.param_specs("model")
    inner = mb.param_specs("model")
    assert inner == _flat_specs(j_inner)
    leaves = flatten_paths(mb.init(0))
    for mesh_shape in MESHES.values():
        mesh = _mesh(mesh_shape)
        for mode, axes in (("hierarchical", ("pod",)), ("flat", ("pod", "data"))):
            n = int(np.prod([mesh.shape[a] for a in axes]))
            jsds = _stacked_sds(jbundle, n)
            stacked = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device="meta")
                       for k, v in leaves.items()}
            jsp = jspecs.stack_spec_tree(j_inner, axes)
            sp = tspecs.stack_spec_tree(inner, axes)
            assert sp == _flat_specs(jsp)
            if mode == "hierarchical":
                jsp = jspecs.add_fsdp_axis(jsp, jsds, mesh, "data", skip_leading=1)
                sp = tspecs.add_fsdp_axis(sp, stacked, mesh, "data", skip_leading=1)
                assert sp == _flat_specs(jsp)
            jsp, jdropped = jspecs.sanitize_specs(jsp, jsds, mesh)
            sp, dropped = tspecs.sanitize_specs(sp, stacked, mesh)
            assert sp == _flat_specs(jsp), (mode, mesh_shape)
            want = sorted(re.sub(r"^(\S+):", lambda m: _path(m.group(1)) + ":", d)
                          for d in jdropped)
            assert sorted(dropped) == want
            assert tspecs.shard_bytes(stacked, sp, mesh) == jspecs.shard_bytes(jsds, jsp, mesh)
            if mode == "hierarchical" and mesh_shape["model"] == 1:
                got, got_dropped, dims = fsdp_placement(mb, mesh, n)
                assert got == sp and got_dropped == dropped
                assert dims == {k: (v.index("data") - 1 if "data" in v else None)
                                for k, v in sp.items()}


def test_hierarchical_state_is_smaller_per_card_than_flat():
    """On the port's multi mesh a pod-as-agent card holds its agent's
    shard: of Mamba2-370m's model shard (what a flat card holds of its
    agent) the data ranks split all but the few leaves no dim of which is
    >= 1024 and divides by 16, so a card holds 1/16 of the flat card's
    share and a little more."""
    mesh = make_production_mesh(multi_pod=True)
    mb = get_bundle(get_config("mamba2-370m"), "meta")
    layout = param_layout(mb, mesh)[0]
    leaves = tspecs.shard_model(flatten_paths(mb.init(0)), layout, mesh)
    sp, _, dims = fsdp_placement(mb, mesh, 2, layout=layout)
    flat_card = sum(v.numel() * v.element_size() for v in leaves.values())
    per_card = sum(v.numel() * v.element_size()
                   for v in shard_leaves(leaves, dims, mesh).values())
    assert flat_card / 16 <= per_card < flat_card / 8
    assert {k for k, d in dims.items() if d is None} == {
        "layers/pos0/mixer/a_log", "layers/pos0/mixer/conv_b", "layers/pos0/mixer/conv_w",
        "layers/pos0/mixer/d_skip", "layers/pos0/mixer/dt_bias", "layers/pos0/mixer/norm"}
