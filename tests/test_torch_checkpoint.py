"""Checkpoints on the port (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): files written by either package load in
the other, leaf for leaf and bit for bit (bf16 included), with manifests
equal key for key; a compressed PISCO state continues bit for bit after a
round trip, generator included; and ``config_to_dict`` gives the
reference's JSON."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.core.pisco import PiscoState as JPiscoState  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.configs import get_config as j_get_config, get_reduced as j_get_reduced  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import ExperimentSpec, PiscoState  # noqa: E402
from repro_torch.models import config_from_dict, config_to_dict  # noqa: E402

CPU = torch.device("cpu")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        f32=rng.normal(size=(3, 4)).astype(np.float32),
        bf16=rng.normal(size=(5,)).astype(np.float32),
        i32=rng.integers(-5, 5, size=(2, 3)).astype(np.int32),
        ints=np.arange(4, dtype=np.int32),
        scalar=np.float32(2.5),
    )


def _port_tree(a):
    bf16 = torch.from_numpy(a["bf16"]).to(torch.bfloat16)
    return {
        "state": PiscoState(x={"w": torch.from_numpy(a["f32"])}, y={"w": bf16},
                            g={"w": torch.from_numpy(a["i32"])},
                            step=torch.tensor(a["scalar"]), ef=(), opt=()),
        "nested": [torch.from_numpy(a["ints"]), (torch.from_numpy(a["f32"]) * 2,
                                                {"b": bf16, "a": torch.ones(1)})],
    }


def _ref_tree(a):
    bf16 = jnp.asarray(a["bf16"]).astype(jnp.bfloat16)
    return {
        "state": JPiscoState(x={"w": jnp.asarray(a["f32"])}, y={"w": bf16},
                             g={"w": jnp.asarray(a["i32"])},
                             step=jnp.asarray(a["scalar"]), ef=(), opt=()),
        "nested": [jnp.asarray(a["ints"]), (jnp.asarray(a["f32"]) * 2,
                                           {"b": bf16, "a": jnp.ones(1)})],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _bits(leaf) -> np.ndarray:
    """A leaf's raw bytes, whichever package it came from."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        return t.numpy().reshape(-1).view(np.uint8)
    return np.asarray(leaf).reshape(-1).view(np.uint8)


def test_manifests_equal_key_for_key(tmp_path):
    a = _arrays()
    tp = tckpt.save_checkpoint(str(tmp_path / "t"), 7, _port_tree(a), metadata={"kind": "x"})
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), 7, _ref_tree(a), metadata={"kind": "x"})
    tm, jm = tckpt.read_manifest(tp), jckpt.read_manifest(jp)
    assert tm == jm
    assert tm["keys"][:4] == ["d:nested/s:0", "d:nested/s:1/s:0", "d:nested/s:1/s:1/d:a",
                              "d:nested/s:1/s:1/d:b"]
    assert "d:state/a:x/d:w" in tm["keys"] and tm["dtypes"][tm["keys"].index(
        "d:state/a:y/d:w")] == "bfloat16"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    a = _arrays(1)
    if writer == "port":
        path = tckpt.save_checkpoint(str(tmp_path), 3, _port_tree(a), metadata={"n": 1})
    else:
        path = jckpt.save_checkpoint(str(tmp_path), 3, _ref_tree(a), metadata={"n": 1})
    t_step, t_tree = tckpt.restore_checkpoint(path)
    j_step, j_tree = jckpt.restore_checkpoint(path)
    assert t_step == j_step == 3
    tl, jl = _leaves(t_tree), _leaves(j_tree)
    assert len(tl) == len(jl) == 8
    for t, j in zip(tl, jl):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == np.asarray(j).shape
        np.testing.assert_array_equal(_bits(t), _bits(j))
    assert t_tree["state"][1]["w"].dtype == torch.bfloat16
    assert t_tree["state"][2]["w"].dtype == torch.int32
    assert isinstance(t_tree["nested"], list) and isinstance(t_tree["nested"][1], tuple)
    assert tckpt.read_manifest(path)["metadata"] == {"n": 1}
    assert os.listdir(tmp_path) == ["ckpt_3.npz"]  # no .tmp left behind


def test_latest_checkpoint_and_overwrite(tmp_path):
    d = str(tmp_path / "run")
    assert tckpt.latest_checkpoint(d) is None
    for step in (2, 10, 9):
        tckpt.save_checkpoint(d, step, {"v": torch.full((2,), float(step))})
    jckpt.save_checkpoint(d, 11, {"v": jnp.full((2,), 11.0)})
    latest = tckpt.latest_checkpoint(d)
    assert latest == jckpt.latest_checkpoint(d) and latest.endswith("ckpt_11.npz")
    tckpt.save_checkpoint(d, 10, {"v": torch.zeros(2)})  # atomic overwrite
    assert torch.equal(tckpt.restore_checkpoint(os.path.join(d, "ckpt_10.npz"))[1]["v"],
                       torch.zeros(2))
    assert sorted(os.listdir(d)) == ["ckpt_10.npz", "ckpt_11.npz", "ckpt_2.npz", "ckpt_9.npz"]


def test_deflated_members_restore_like_stored_ones(tmp_path):
    """Stored members are read at their offsets, deflated ones through
    np.load: the same leaves, bit for bit, and the same subtree."""
    import zipfile

    a = _arrays(3)
    stored = tckpt.save_checkpoint(str(tmp_path / "s"), 4, _port_tree(a))
    deflated = str(tmp_path / "ckpt_4.npz")
    with zipfile.ZipFile(stored) as src, zipfile.ZipFile(deflated, "w",
                                                          zipfile.ZIP_DEFLATED) as dst:
        for info in src.infolist():
            dst.writestr(info.filename, src.read(info))
    with zipfile.ZipFile(deflated) as z:
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
    (s_step, s_tree), (d_step, d_tree) = (tckpt.restore_checkpoint(p)
                                          for p in (stored, deflated))
    assert s_step == d_step == 4
    s_leaves, d_leaves = _leaves(s_tree), _leaves(d_tree)
    assert [t.dtype for t in s_leaves] == [t.dtype for t in d_leaves]
    assert [t.shape for t in s_leaves] == [t.shape for t in d_leaves]
    assert all(np.array_equal(_bits(x), _bits(y)) for x, y in zip(s_leaves, d_leaves))
    assert s_leaves[-1].shape == () and s_leaves[-1].dtype == torch.float32  # the 0-d step
    sub = [tckpt.restore_checkpoint(p, subtree=("nested", 1))[1] for p in (stored, deflated)]
    assert all(np.array_equal(_bits(x), _bits(y)) for x, y in zip(*map(_leaves, sub)))
    assert tckpt.read_manifest(stored) == tckpt.read_manifest(deflated)


def test_reference_prng_key_comes_back_as_uint32(tmp_path):
    import jax

    path = jckpt.save_checkpoint(str(tmp_path), 0, {"ef": {"key": jax.random.PRNGKey(3)}})
    _, tree = tckpt.restore_checkpoint(path)
    assert tree["ef"]["key"].dtype == torch.uint32 and tree["ef"]["key"].shape == (2,)
    assert "generators" not in tckpt.read_manifest(path)


def test_checkpoint_module_needs_neither_jax_nor_ml_dtypes():
    """The card's machine has neither: bf16 goes through a uint16 view."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = ("import sys, repro_torch.checkpoint\n"
            "sys.exit(int(any(m.split('.')[0] in ('jax', 'ml_dtypes', 'repro') "
            "for m in sys.modules)))")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    assert subprocess.run([sys.executable, "-c", code], env=env, timeout=120).returncode == 0


def test_none_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError):
        tckpt.save_checkpoint(str(tmp_path), 0, {"a": None})


def test_compressed_state_continues_bit_for_bit(tmp_path):
    """A port-written compressed PISCO state (residuals and the
    stochastic-rounding generator) restored and run on gives the rounds of
    the run continued from memory; the reference reads the file too."""
    from repro_torch.core.algorithms import get_algorithm

    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=6)
    spec = ExperimentSpec.create(algo="pisco", n_agents=6, t_o=2, eta_l=0.1, p=0.3, seed=2,
                                 compression="q8")
    bound = get_algorithm("pisco").bind(loss_fn, spec.config, spec.make_mixing(CPU))
    sampler = sampler_factory(2)
    state = bound.init(loss_fn, {"w": torch.zeros(6, d)}, sampler(-1)[1])
    for k in range(3):
        state, _ = bound.gossip_round(state, *sampler(k))
    path = tckpt.save_checkpoint(str(tmp_path), 3, state)
    manifest = tckpt.read_manifest(path)
    assert manifest["generators"] == {"a:ef/d:gen": "cpu"}
    _, restored = tckpt.restore_checkpoint(path)
    restored = PiscoState(*restored)
    batches = [sampler(k) for k in (3, 4)]
    for local, comm in batches:
        state, m1 = bound.gossip_round(state, local, comm)
        restored, m2 = bound.gossip_round(restored, local, comm)
        assert torch.equal(m1.loss, m2.loss)
    for k in state.x:
        assert torch.equal(state.x[k], restored.x[k]) and torch.equal(state.y[k], restored.y[k])
        assert torch.equal(state.ef["x"][k], restored.ef["x"][k])
    assert torch.equal(state.ef["gen"].get_state(), restored.ef["gen"].get_state())
    j_step, j_tree = jckpt.restore_checkpoint(path)
    assert j_step == 3 and np.asarray(j_tree[4]["gen"]).dtype == np.uint8


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "qwen3-8b-swa"])
def test_config_json_equals_the_reference(arch):
    for t_cfg, j_cfg in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        text = json.dumps(config_to_dict(t_cfg))
        assert text == json.dumps(jconfig.config_to_dict(j_cfg))
        assert config_from_dict(json.loads(text)) == t_cfg
        assert jconfig.config_from_dict(json.loads(text)) == j_cfg


def test_config_from_dict_refuses_moe_and_mla():
    """MoE and MLA sub-configs are ported: a well-formed one is rebuilt (the
    reduced Mixtral and DeepSeek-V2-Lite round-trip), a malformed one is
    refused; the ``dots`` remat policy round-trips."""
    for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b"):
        cfg = get_reduced(arch)
        assert config_from_dict(json.loads(json.dumps(config_to_dict(cfg)))) == cfg
    d = config_to_dict(get_reduced("qwen3-8b"))
    for key in ("moe", "mla"):
        with pytest.raises(TypeError):
            config_from_dict(dict(d, **{key: {"n_experts": 8, "no_such_field": 1}}))
    dots = config_from_dict(dict(d, remat_policy="dots"))
    assert dots.remat_policy == "dots" and config_to_dict(dots) == dict(d, remat_policy="dots")
