"""The VLM decoder (Qwen2-VL-2B at ``reduced()`` size) and the audio / VLM
training inputs in the port, held against the JAX package on the same numpy
inputs: M-RoPE's tables on a patch grid and on degenerate text ids, the
prefill over patch embeddings with their grid ids and the decode steps after
it (logits and caches), ``lm_loss`` and its gradients against
``jax.value_and_grad``, and the audio and VLM batches of
``make_lm_sampler`` (bit-equal) and ``train_inputs`` (shapes)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm import LM_ATOL, _assert_tree_close, _np, _pair  # noqa: E402
from test_torch_lm_train import GRAD_TOL  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import input_specs as jinputs  # noqa: E402
from repro.launch.train import make_lm_sampler as j_sampler  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.rope import mrope_text_positions as j_mrope_text_positions  # noqa: E402
from repro.models.rope import rope_cos_sin as j_rope_cos_sin  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import input_specs as tinputs  # noqa: E402
from repro_torch.launch.train import make_lm_sampler  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.models.rope import mrope_text_positions, rope_cos_sin  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402

ARCH = "qwen2-vl-2b"


def grid_positions(b: int, grid: int, n_text: int) -> np.ndarray:
    """M-RoPE ids (3, b, grid² + n_text) of one image of grid x grid merged
    patches (t = 0, h = row, w = column) followed by text at t = h = w =
    grid + i."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.zeros_like(rows), rows, cols])
    txt = np.broadcast_to(grid + np.arange(n_text), (3, n_text))
    ids = np.concatenate([img, txt], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(ids[:, None], (3, b, ids.shape[1])))


def _vlm_inputs(cfg, b=2, grid=4, n_text=20, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, n_text)).astype(np.int32)
    prefix = rng.normal(size=(b, grid * grid, cfg.d_model)).astype(np.float32)
    return toks, prefix, grid_positions(b, grid, n_text)


@pytest.mark.parametrize("kind", ["grid", "text", "text_offset"])
def test_mrope_tables_match_reference(kind):
    cfg = get_reduced(ARCH)
    hd, theta, sec = cfg.resolved_head_dim, 1_000_000.0, cfg.mrope_sections
    if kind == "grid":
        pos = grid_positions(2, 4, 9)
    else:
        pos = np.array(j_mrope_text_positions(2, 11, 7 if kind == "text_offset" else 0))
        tpos = mrope_text_positions(2, 11, 7 if kind == "text_offset" else 0)
        np.testing.assert_array_equal(tpos.numpy(), pos)
        # text ids: M-RoPE is 1-D RoPE
        one_d = rope_cos_sin(tpos[0], hd, theta)
        got = rope_cos_sin(tpos, hd, theta, sec)
        for a, b in zip(got, one_d):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = j_rope_cos_sin(jnp.asarray(pos), hd, theta, sec)
    got = rope_cos_sin(torch.from_numpy(pos), hd, theta, sec)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (2, pos.shape[-1], hd // 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="3, B, S"):
        rope_cos_sin(torch.from_numpy(pos[0]), hd, theta, sec)


@pytest.mark.parametrize("grid,n_text", [(4, 20), (3, 30)])
def test_prefill_with_patches_and_decode_match_jax(grid, n_text):
    """The prefill over patch embeddings at their grid ids, then greedy
    decode steps at the reference's degenerate ids ``pos``: logits and the
    caches."""
    jcfg, cfg, jparams, params = _pair(ARCH)
    toks, prefix, pos = _vlm_inputs(cfg, grid=grid, n_text=n_text)
    s = grid * grid + n_text
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, s + 8),
                                 prefix_embeds=jnp.asarray(prefix), positions=jnp.asarray(pos))
    bundle = get_bundle(cfg, "cpu")
    log, cache = bundle.prefill(params, {"tokens": torch.from_numpy(toks),
                                         "prefix_embeds": torch.from_numpy(prefix),
                                         "positions": torch.from_numpy(pos)},
                                bundle.init_cache(2, s + 8))
    assert log.shape == (2, s, cfg.vocab_size) and int(cache["pos"]) == s
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    for step in range(4):
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
        log, cache = bundle.decode(params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    _assert_tree_close(jcache, cache, LM_ATOL)


def test_prefill_without_positions_takes_text_ids():
    """No ``positions``: the stream's ids are the degenerate text ids, and
    the prefix still goes first."""
    jcfg, cfg, jparams, params = _pair(ARCH)
    toks, prefix, _ = _vlm_inputs(cfg, seed=6)
    jlog, _ = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 40),
                            prefix_embeds=jnp.asarray(prefix))
    log, _ = TT.lm_prefill(params, cfg, torch.from_numpy(toks), TT.init_cache(cfg, 2, 40, "cpu"),
                           prefix_embeds=torch.from_numpy(prefix))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)


@pytest.mark.parametrize("replace", [{}, {"remat": True, "loss_chunk": 7},
                                     {"attn_chunk": 12}])
def test_lm_loss_and_grads_match_jax(replace):
    """The loss over the text tail of a stream with a patch prefix and its
    grid ids (chunked cross-entropy and chunked causal attention among the
    cases)."""
    jcfg, cfg, jparams, params = _pair(ARCH, **replace)
    toks, prefix, pos = _vlm_inputs(cfg, grid=4, n_text=20, seed=3)
    jbatch = {"tokens": toks, "prefix_embeds": jnp.asarray(prefix), "positions": pos}
    jloss, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, jbatch))(jparams)
    batch = {"tokens": torch.from_numpy(toks), "prefix_embeds": torch.from_numpy(prefix),
             "positions": torch.from_numpy(pos)}
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    assert len(jl) == len(tl) == len(nest_leaves(params))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * float(np.abs(a).max())


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_serving_engine_refuses_both_families(arch):
    """DecodeEngine serves decoder-only text models, as the reference's
    does; these two run through bundle.prefill and bundle.decode."""
    from repro_torch.serve import DecodeEngine, FleetDelta

    bundle = get_bundle(get_reduced(arch), "cpu")
    fleet = FleetDelta.synthetic(bundle.init(seed=0), 2, seed=0)
    with pytest.raises(ValueError, match="decoder-only text"):
        DecodeEngine(bundle, fleet, n_slots=1, max_seq=16)


def test_config_and_param_count():
    assert get_config(ARCH).param_count() == 1_776_943_104
    cfg = get_reduced(ARCH)
    assert cfg.arch_type == "vlm" and cfg.mrope_sections == (4, 6, 6) and cfg.qkv_bias


# ---------------------------------------------------------------------------
# Training inputs of the stub frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [("qwen2-vl-2b", "float32"),
                                        ("seamless-m4t-medium", "float32"),
                                        ("seamless-m4t-medium", "bfloat16")])
def test_lm_sampler_audio_and_vlm_bit_equal(arch, dtype):
    """Tokens, then the frontends' draws from the same generator: patch
    embeddings and M-RoPE ids, or frames, in the config's dtype, bit for
    bit; every agent's batch feeds the bundle's loss."""
    cfg, jcfg = get_reduced(arch, dtype), j_get_reduced(arch, dtype)
    mine, theirs = make_lm_sampler(cfg, 3, 2, 24, 2, seed=5), j_sampler(jcfg, 3, 2, 24, 2, seed=5)
    extra = ("prefix_embeds", "positions") if cfg.modality == "vlm" else ("frames",)
    for k in range(2):
        (tl, tc), (jl, jc) = mine(k), theirs(k)
        assert set(tl) == set(jl) == set(tc) == set(jc) == {"tokens", *extra}
        for name in tl:
            for t, j in ((tl[name], jl[name]), (tc[name], jc[name])):
                j = np.asarray(j)
                assert tuple(t.shape) == j.shape and str(t.dtype).removeprefix("torch.") == \
                    str(j.dtype), name
                if t.dtype == torch.bfloat16:
                    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                                  j.view(np.int16))
                else:
                    np.testing.assert_array_equal(t.numpy(), j)
    bundle = get_bundle(get_reduced(arch), "cpu")
    params = bundle.init(seed=0)
    for a in range(3):
        batch = {name: t[0, a].float() if t.is_floating_point() else t[0, a]
                 for name, t in tl.items()}
        assert np.isfinite(float(bundle.loss(params, batch)))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium", "qwen3-8b"])
def test_train_inputs_match_jax(arch):
    shape = dataclasses.replace(tshapes.TRAIN_4K, global_batch=8)
    jl, jc = jinputs.train_inputs(j_get_reduced(arch, "bfloat16"),
                                  dataclasses.replace(jshapes.TRAIN_4K, global_batch=8), 4, 2)
    tl, tc = tinputs.train_inputs(get_reduced(arch, "bfloat16"), shape, 4, 2)
    for mine, theirs in ((tl, jl), (tc, jc)):
        assert set(mine) == set(theirs)
        for name, spec in mine.items():
            assert spec.shape == theirs[name].shape, name
            assert str(spec.dtype).removeprefix("torch.") == str(theirs[name].dtype), name
