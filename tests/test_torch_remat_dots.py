"""The ``dots`` remat policy (the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``): gradients
bit-equal to full remat's and to no remat's for the decoder-only families
and the encoder-decoder, the same loss as the reference's under ``dots``,
the config's JSON round trip against the reference's, and the dry run's
counts: under ``dots`` a train step keeps more than under full remat and
less than without remat, and recomputes fewer FLOPs than full remat."""
import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
from test_torch_lm_train import GRAD_TOL, _np  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.layers import remat_call  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402


def _batch(cfg, seed=3, b=2, s=40):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32))}
    if cfg.is_enc_dec:
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(b, s // 4, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b", "seamless-m4t-medium"])
def test_dots_gradients_equal_full_remat_and_no_remat(arch):
    """The same loss and bit-equal gradients under no remat, full remat and
    ``dots``: the kept matmul outputs are the values a recomputation gives."""
    base = get_reduced(arch)
    bundle = get_bundle(base, "cpu")
    params, batch = bundle.init(0), _batch(base)
    runs = {}
    for name, kw in (("none", {"remat": False}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        cfg = dataclasses.replace(base, **kw)
        runs[name] = get_bundle(cfg, "cpu").value_and_grad(params, batch)
    for name in ("full", "dots"):
        assert torch.equal(runs[name][0], runs["none"][0]), name
        for a, b in zip(nest_leaves(runs[name][1]), nest_leaves(runs["none"][1])):
            assert torch.equal(a, b), name


def test_dots_saves_the_unbatched_matmuls_only():
    """Under ``dots`` the backward pass recomputes no ``mm`` and every
    ``bmm`` whose output it needs; under ``full`` it recomputes both."""
    from torch.utils.flop_counter import FlopCounterMode

    w1, w2 = torch.randn(8, 16, requires_grad=True), torch.randn(4, 8, 8, requires_grad=True)
    x = torch.randn(4, 8)

    def fn(x):
        h = torch.tanh(x @ w1)                       # mm
        return torch.tanh(torch.bmm(h.reshape(4, 4, 4).repeat(1, 1, 2), w2)).sum()  # bmm

    counts = {}
    for policy in ("full", "dots"):
        loss = remat_call(policy, fn, x)
        with FlopCounterMode(display=False) as fc:
            loss.backward()
        counts[policy] = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    # the backward of the mm is one product (x needs no gradient); full
    # recomputes the forward's too
    assert counts["dots"]["aten.mm"] == 2 * 4 * 8 * 16
    assert counts["full"]["aten.mm"] == 2 * 2 * 4 * 8 * 16
    assert counts["dots"]["aten.bmm"] == counts["full"]["aten.bmm"] == 3 * 2 * 4 * 4 * 8 * 8


@pytest.mark.parametrize("arch", ["qwen3-8b", "seamless-m4t-medium"])
def test_dots_loss_and_grads_match_the_reference_under_dots(arch):
    jcfg = dataclasses.replace(j_get_reduced(arch), remat=True, remat_policy="dots")
    cfg = dataclasses.replace(get_reduced(arch), remat=True, remat_policy="dots")
    init = JE.init_encdec if cfg.is_enc_dec else JT.init_lm
    loss_fn = JE.encdec_loss if cfg.is_enc_dec else JT.lm_loss
    jparams = init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = _batch(cfg, s=32)
    jbatch = {k: v.numpy() for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: loss_fn(p, jcfg, jbatch))(jparams)
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    for a, b in zip(jl, tl):
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * float(np.abs(a).max())


def test_remat_policy_round_trips_through_the_reference_json():
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(get_reduced("qwen3-8b"), remat_policy=policy)
        jcfg = dataclasses.replace(j_get_reduced("qwen3-8b"), remat_policy=policy)
        d = tconfig.config_to_dict(cfg)
        assert d == jconfig.config_to_dict(jcfg)
        assert list(d) == list(jconfig.config_to_dict(jcfg))
        assert tconfig.config_from_dict(json.loads(json.dumps(d))) == cfg
        assert jconfig.config_from_dict(json.loads(json.dumps(d))) == jcfg
    with pytest.raises(ValueError, match="remat_policy"):
        get_bundle(dataclasses.replace(get_reduced("qwen3-8b"), remat_policy="offload"), "cpu")


def test_dryrun_dots_peak_between_full_and_none_with_fewer_flops():
    """One train step counted on meta under no remat, full remat and
    ``dots``: the peak under ``dots`` lies between the other two, and its
    FLOPs below full remat's (the unbatched matmuls are not recomputed)."""
    shape = InputShape("t", 512, 32, "train")  # 2 rows of 512 tokens an agent
    mesh = make_production_mesh()
    rec = {}
    for name, kw in (("none", {"remat": False}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        cfg = dataclasses.replace(get_reduced("qwen3-8b"), n_layers=4, **kw)
        rec[name] = tdry.build_steps(cfg, shape, mesh)["train_gossip"].lower()
    peak = {k: v["memory"]["peak_bytes"] for k, v in rec.items()}
    flops = {k: v["flops_int"] for k, v in rec.items()}
    assert peak["full"] < peak["dots"] < peak["none"], peak
    assert flops["none"] < flops["dots"] < flops["full"], flops
