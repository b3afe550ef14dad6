"""The attention logit softcap (Gemma-2's ``cap * tanh(s / cap)``), held
against the reference on the same numpy inputs: K6's plain version
``flash_attention_ref(softcap=...)`` against the reference's jnp attention
core, and whole reduced models with ``attn_logit_softcap`` set — GQA
(Qwen3-8B), MLA (DeepSeek-V2-Lite) and the encoder-decoder
(SeamlessM4T-medium) — through prefill, greedy decode and ``lm_loss`` /
``encdec_loss`` gradients.  No reference config sets the cap, so each case
picks one below its model's largest scaled score (the cap bites: the
logits move by far more than the tolerance)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm import F32_ATOL, LM_ATOL, _assert_tree_close, _qkv  # noqa: E402
from test_torch_lm_train import GRAD_TOL, _np  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_bundle as j_get_bundle  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

# a cap under each reduced model's largest scaled score (3.8 for Qwen3's
# QK-normed heads, 0.19 and 0.23 for the other two at init scale 0.02)
CAPS = {"qwen3-8b": 2.0, "deepseek-v2-lite-16b": 0.1, "seamless-m4t-medium": 0.1}


def _pair(arch, **replace):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    replace = dict(attn_logit_softcap=CAPS[arch], **replace)
    jcfg, cfg = dataclasses.replace(jcfg, **replace), dataclasses.replace(cfg, **replace)
    init = JE.init_encdec if cfg.is_enc_dec else JT.init_lm
    jparams = init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# K6's plain version against the reference's attention core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap", [
    (2, 4, 2, 40, 40, 16, True, None, 1.5),
    (1, 4, 1, 33, 33, 32, True, 8, 0.5),      # MQA, a window
    (2, 2, 2, 24, 24, 48, False, None, 2.0),  # an encoder's self-attention
    (1, 6, 2, 20, 20, 64, True, None, 50.0),  # Gemma-2's cap: close to no cap
])
def test_flash_ref_softcap_matches_the_reference_core(b, hq, hkv, sq, sk, d, causal, window, cap):
    """``flash_attention_ref(softcap=cap)`` (and the wrapper on CPU tensors)
    against ``repro.models.attention.attention_core(softcap=cap)`` on the
    same f32 inputs (unchunked: ``chunk`` above S), within K6's f32
    tolerance; scores are drawn large enough that the cap bites."""
    q, k, v = _qkv(0, b, hq, hkv, sq, sk, d, np.float32)
    q, k = 2.0 * q, 2.0 * k
    want = JA.attention_core(jnp.asarray(q.transpose(0, 2, 1, 3)),
                             jnp.asarray(k.transpose(0, 2, 1, 3)),
                             jnp.asarray(v.transpose(0, 2, 1, 3)), causal=causal,
                             window=window, chunk=4096, softcap=cap)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    assert torch.equal(flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap), got)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    if cap < 10:
        assert float((plain - got).abs().max()) > 1e3 * F32_ATOL
    # the bf16 rounding model takes the cap too
    bf = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window, softcap=cap,
                                 p_dtype=torch.bfloat16)
    assert float((bf - got).abs().max()) < 2e-2


def test_softcap_must_be_positive():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, q, q, softcap=0.0)
    cfg = dataclasses.replace(get_reduced("qwen3-8b"), attn_logit_softcap=-1.0)
    with pytest.raises(ValueError, match="attn_logit_softcap"):
        get_bundle(cfg, "cpu")


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,replace,prompt", [
    ("qwen3-8b", {}, 45),
    ("qwen3-8b", {"sliding_window": 16}, 40),
    ("deepseek-v2-lite-16b", {}, 45),   # MLA: K6 at q/k 48, v 32; the absorbed decode
])
def test_prefill_and_decode_match_jax(arch, replace, prompt):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, prompt)).astype(np.int32)
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 64))
    log, cache = TT.lm_prefill(params, cfg, torch.from_numpy(toks),
                               TT.init_cache(cfg, 2, 64, "cpu"))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    capless = dataclasses.replace(cfg, attn_logit_softcap=None)
    plain, _ = TT.lm_prefill(params, capless, torch.from_numpy(toks),
                             TT.init_cache(capless, 2, 64, "cpu"))
    assert float((plain - log).abs().max()) > 1e2 * LM_ATOL
    for step in range(3):
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
        log, cache = TT.lm_decode(params, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    _assert_tree_close(jcache, cache, LM_ATOL)


def _assert_grads(jgrads, grads, params):
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    assert len(jl) == len(tl) == len(nest_leaves(params))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * float(np.abs(a).max())


@pytest.mark.parametrize("arch,replace", [
    ("qwen3-8b", {}),
    ("qwen3-8b", {"remat": True, "attn_chunk": 16}),  # chunked causal attention
    ("deepseek-v2-lite-16b", {}),
])
def test_lm_loss_and_grads_match_jax(arch, replace):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": toks}))(jparams)
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    _assert_grads(jgrads, grads, params)


def test_encdec_prefill_decode_and_grads_match_jax():
    """The encoder (K6's plain version without the causal mask, capped), the
    decoder's self- and cross-attention, capped, against the reference
    bundle; then ``encdec_loss`` gradients."""
    arch = "seamless-m4t-medium"
    jcfg, cfg, jparams, params = _pair(arch)
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    jb, tb = j_get_bundle(jcfg), get_bundle(cfg, "cpu")
    jlog, jcache = jb.prefill(jparams, {"frames": jnp.asarray(frames), "tokens": toks},
                              jb.init_cache(2, 24))
    log, cache = tb.prefill(params, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks)}, tb.init_cache(2, 24))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    for step in range(3):
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = jb.decode(jparams, jnp.asarray(tok), jcache)
        log, cache = tb.decode(params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    batch = {"frames": frames, "tokens": toks}
    jloss, jgrads = jax.value_and_grad(lambda p: JE.encdec_loss(
        p, jcfg, {"frames": jnp.asarray(frames), "tokens": toks}))(jparams)
    loss, grads = tb.value_and_grad(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    _assert_grads(jgrads, grads, params)
