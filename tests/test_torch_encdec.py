"""The encoder-decoder (SeamlessM4T-medium at ``reduced()`` size) in the
port, held against the JAX package's ``repro.models.encdec`` on the same
numpy frames and tokens, with the reference's weights carried across by
``repro_torch.weights``: the encoder (the training form and the prefill's,
K6 without the causal mask), the teacher-forced decoder, the bundle's
prefill (encoder + one step) and decode steps with their caches, the prefill
-> decode consistency of ``tests/test_models_smoke.py``'s
``test_encdec_decode_consistency``, and ``encdec_loss`` with its gradients
against ``jax.value_and_grad``.  Also K6's plain version without the causal
mask (Sq = Sk and Sq != Sk, f32 and the bf16-P model) against the Pallas
kernel in interpret mode, and the attention cores' non-causal and cross
forms against the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm import BF16_ATOL, F32_ATOL, LM_ATOL, _assert_tree_close, _np, _qkv, _t  # noqa: E402
from test_torch_lm_train import GRAD_TOL  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models.registry import get_bundle as j_get_bundle  # noqa: E402
from repro.models.rope import rope_cos_sin as j_rope_cos_sin  # noqa: E402
from repro.models.rope import text_positions as j_text_positions  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models.registry import EncDecBundle, get_bundle  # noqa: E402
from repro_torch.models.rope import rope_cos_sin, text_positions  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import lm_cache_from_jax, lm_params_from_jax  # noqa: E402

ARCH = "seamless-m4t-medium"


def _pair(**replace):
    jcfg, cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    if replace:
        jcfg, cfg = dataclasses.replace(jcfg, **replace), dataclasses.replace(cfg, **replace)
    jparams = JE.init_encdec(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _inputs(cfg, b=2, t=12, s=20, seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return frames, toks


# ---------------------------------------------------------------------------
# K6 without the causal mask, and the attention cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dtype", [
    (2, 4, 4, 64, 64, 32, "float32"),     # the encoder's MHA, Sq = Sk
    (1, 8, 2, 32, 96, 64, "float32"),     # GQA, Sq < Sk (a cross-attention)
    (1, 4, 1, 96, 32, 32, "float32"),     # MQA, Sq > Sk
    (2, 4, 4, 64, 64, 64, "bfloat16"),
    (1, 8, 2, 32, 96, 64, "bfloat16"),
    (1, 4, 4, 96, 32, 32, "bfloat16"),
])
def test_k6_plain_non_causal_matches_pallas_kernel_and_oracle(b, hq, hkv, sq, sk, d, dtype):
    q, k, v = _qkv(20, b, hq, hkv, sq, sk, d, dtype)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                              block_q=32, block_k=32, interpret=True), np.float32)
    oracle = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=False), np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == (b, hq, sq, d) and got.dtype == _t(q).dtype
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), oracle, atol=tol, rtol=0)
    if dtype == "bfloat16":  # the tensor-core kernel's rounding model (P in bf16)
        model = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=False,
                                        p_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(model), want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("sq,sk,hkv", [(37, 37, 4), (21, 50, 2), (50, 21, 1)])
def test_attention_core_non_causal_matches_reference(sq, sk, hkv):
    """Ragged lengths, Sq and Sk apart, in the (B, S, H, D) layout: the
    prefill core (K6's plain version on the CPU) and the training core
    against the reference's unmasked attention_core; a window is ignored
    without the causal mask, as in the reference."""
    q, k, v = _qkv(21, 2, 4, hkv, sq, sk, 32, "float32")
    q, k, v = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    want = np.asarray(JA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=False, window=8, chunk=16))
    got = TA.attention_core(_t(q), _t(k), _t(v), causal=False, window=8)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    got = TA.attention_train(_t(q), _t(k), _t(v), causal=False, window=8, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_cross_attention_forward_matches_reference():
    """``gqa_forward`` with a memory: K and V from ``x_kv``, rotated with
    the memory's own position tables."""
    jcfg, cfg, jparams, params = _pair()
    frames, _ = _inputs(cfg, t=14)
    x = np.random.default_rng(6).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda t: t[0], jparams["dec_layers"]["cross_attn"])
    tlp = {k: v[0] for k, v in params["dec_layers"]["cross_attn"].items()}
    hd = cfg.resolved_head_dim
    jcs = j_rope_cos_sin(j_text_positions(2, 9), hd, jcfg.rope_theta)
    jmcs = j_rope_cos_sin(j_text_positions(2, 14), hd, jcfg.rope_theta)
    want = JA.gqa_forward(jlp, jcfg, jnp.asarray(x), jcs, causal=False,
                          x_kv=jnp.asarray(frames), cos_sin_kv=jmcs)
    tcs = rope_cos_sin(text_positions(2, 9), hd, cfg.rope_theta)
    tmcs = rope_cos_sin(text_positions(2, 14), hd, cfg.rope_theta)
    got = TA.gqa_forward(tlp, cfg, torch.from_numpy(x), tcs, causal=False,
                         x_kv=torch.from_numpy(frames), cos_sin_kv=tmcs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replace,t,s", [
    ({}, 12, 20),
    ({"remat": True, "attn_chunk": 16}, 20, 32),  # remat, the decoder's chunked causal path
])
def test_encode_and_decode_train_match_jax(replace, t, s):
    jcfg, cfg, jparams, params = _pair(**replace)
    frames, toks = _inputs(cfg, t=t, s=s)
    jmem = JE.encode(jparams, jcfg, jnp.asarray(frames))
    mem = TE.encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=LM_ATOL, rtol=0)
    pre = TE.encode_prefill(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jmem), atol=LM_ATOL, rtol=0)
    jlog = JE.decode_train(jparams, jcfg, jnp.asarray(toks), jmem)
    log = TE.decode_train(params, cfg, torch.from_numpy(toks), mem)
    assert log.shape == (2, s, cfg.vocab_size)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)


@pytest.mark.parametrize("mem_len", [None, 3])
def test_prefill_and_decode_match_jax(mem_len):
    """The bundle's prefill (the encoder, then one step on the first token)
    and greedy decode steps against the reference bundle's: logits and the
    whole cache (the memory takes the encoder's length whatever mem_len
    made it)."""
    jcfg, cfg, jparams, params = _pair()
    frames, toks = _inputs(cfg)
    jb, tb = j_get_bundle(jcfg), get_bundle(cfg, "cpu")
    assert isinstance(tb, EncDecBundle)
    jcache = jb.init_cache(2, 24, mem_len=mem_len)
    cache = tb.init_cache(2, 24, mem_len=mem_len)
    _assert_tree_close(jcache, cache, 0.0)
    jlog, jcache = jb.prefill(jparams, {"frames": jnp.asarray(frames), "tokens": toks}, jcache)
    log, cache = tb.prefill(params, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks)}, cache)
    assert log.shape == (2, 1, cfg.vocab_size) and int(cache["pos"]) == 1
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    for step in range(4):
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = jb.decode(jparams, jnp.asarray(tok), jcache)
        log, cache = tb.decode(params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    _assert_tree_close(jcache, cache, LM_ATOL)
    assert int(cache["pos"]) == 5


def test_decode_from_a_reference_cache():
    """A cache filled by the reference's prefill, carried across, decodes to
    the reference's next logits."""
    jcfg, cfg, jparams, params = _pair()
    frames, toks = _inputs(cfg, seed=7)
    jb = j_get_bundle(jcfg)
    _, jcache = jb.prefill(jparams, {"frames": jnp.asarray(frames), "tokens": toks},
                           jb.init_cache(2, 16))
    cache = lm_cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    jlog, _ = jb.decode(jparams, jnp.asarray(toks[:, 1:2]), jcache)
    log, cache = get_bundle(cfg, "cpu").decode(params, torch.from_numpy(toks[:, 1:2]), cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)


def test_prefill_then_decode_equals_teacher_forcing():
    """The twin of the reference's test_encdec_decode_consistency: the
    prefill's logits and each decode step's equal decode_train's at every
    position over the prefill's memory."""
    cfg = get_reduced(ARCH)
    bundle = get_bundle(cfg, "cpu")
    params = bundle.init(seed=0)
    s = 16
    frames, toks = _inputs(cfg, t=s // 4, s=s, seed=8)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    memory = TE.encode(params, cfg, frames)
    full = TE.decode_train(params, cfg, toks, memory)
    cache = bundle.init_cache(2, s, mem_len=s // 4)
    logits, cache = bundle.prefill(params, {"frames": frames, "tokens": toks}, cache)
    np.testing.assert_allclose(cache["memory"].numpy(), memory.numpy(), atol=LM_ATOL, rtol=0)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 0].numpy(), atol=LM_ATOL, rtol=0)
    for t in range(1, s):
        lg, cache = bundle.decode(params, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=LM_ATOL, rtol=0,
                                   err_msg=f"position {t}")


@pytest.mark.parametrize("replace", [{}, {"remat": True, "attn_chunk": 16}])
def test_encdec_loss_and_grads_match_jax(replace):
    jcfg, cfg, jparams, params = _pair(**replace)
    frames, toks = _inputs(cfg, t=20, s=32, seed=3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JE.encdec_loss(p, jcfg, {"frames": jnp.asarray(frames), "tokens": toks}))(
        jparams)
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(
        params, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    assert len(jl) == len(tl) == len(nest_leaves(params))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * float(np.abs(a).max())
    assert not any(t.requires_grad for t in tl + nest_leaves(params))


def test_port_init_has_the_reference_tree_and_param_count():
    """``init_encdec`` draws the reference's tree, leaf for leaf in shape and
    dtype; the full config's count is the reference's 0.927 B."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = j_get_reduced(ARCH, dtype), get_reduced(ARCH, dtype)
        jparams = JE.init_encdec(jax.random.PRNGKey(0), jcfg)
        params = get_bundle(cfg, "cpu").init(seed=1)
        jl = jax.tree_util.tree_leaves_with_path(jparams)
        tl = nest_leaves(params)
        assert len(jl) == len(tl)
        for (path, a), b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
        cache = get_bundle(cfg, "cpu").init_cache(3, 10, mem_len=4)
        jcache = JE.init_encdec_cache(jcfg, 3, 10, 4)
        _assert_tree_close(jcache, cache, 0.0)
    assert get_config(ARCH).param_count() == 927_363_072
