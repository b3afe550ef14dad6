"""The LM zoo's served path in the port, held against the JAX package on the
same numpy inputs: the two kernels' plain versions (K6 flash attention, K7
SSD scan) against the Pallas kernels in interpret mode and the reference's
jnp code, and ``lm_prefill`` / ``lm_decode`` of both served models at their
reduced widths.  On the CPU each kernel wrapper runs its plain version (the
CUDA kernels are held against it in ``test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_kernel as j_ssd_kernel  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import (  # noqa: E402
    lm_cache_from_jax,
    lm_cache_to_numpy,
    lm_params_from_jax,
    lm_params_to_numpy,
)

MODELS = ("qwen3-8b", "mamba2-370m")

# K6: the ROADMAP's tolerances.  float32: online softmax against a one-pass
# softmax, rounding only.  bfloat16: the output is rounded to bf16 (and the
# reference's _sdpa also rounds the scores and the probabilities to bf16).
F32_ATOL = 2e-6
BF16_ATOL = 2e-2
# against the reference's attention_core in bf16, which rounds the scores
# and the probabilities to bf16 before P·V (attention.py:129-132) where K6
# keeps them in f32: two more roundings, up to two bf16 ulps at |out| <= 2
BF16_CORE_ATOL = 4e-2
# K7: 5e-4 (the ROADMAP's), chunked sums in different orders
SSD_ATOL = 5e-4
# lm logits/caches in float32: a handful of f32 ulps through two layers
LM_ATOL = 1e-5


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _qkv(seed, b, hq, hkv, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    return q, k, v


# ---------------------------------------------------------------------------
# K6 flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,s,d,window,dtype", [
    (1, 4, 2, 64, 32, None, "float32"),       # GQA, causal
    (2, 4, 4, 128, 32, 48, "float32"),        # MHA, sliding window
    (1, 8, 2, 64, 64, None, "bfloat16"),
    (1, 4, 1, 128, 32, 32, "bfloat16"),       # MQA + window
])
def test_k6_plain_matches_pallas_kernel_and_oracle(b, hq, hkv, s, d, window, dtype):
    q, k, v = _qkv(0, b, hq, hkv, s, s, d, dtype)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              window=window, block_q=32, block_k=32, interpret=True),
                      np.float32)
    oracle = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=True, window=window), np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), oracle, atol=tol, rtol=0)


@pytest.mark.parametrize("s,window,dtype", [(37, None, "float32"), (100, 16, "float32"),
                                            (61, None, "bfloat16"), (130, 40, "bfloat16")])
def test_k6_ragged_lengths_match_attention_core(s, window, dtype):
    """Ragged prompt lengths (the Pallas kernel asserts divisibility; the
    port masks the tail) against the reference's attention_core, in its
    (B, S, H, D) layout, through the port's attention_core."""
    q, k, v = _qkv(1, 1, 4, 2, s, s, 32, dtype)
    q, k, v = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    want = np.asarray(JA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window, chunk=1024), np.float32)
    got = TA.attention_core(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(_np(got), want,
                               atol=F32_ATOL if dtype == "float32" else BF16_CORE_ATOL, rtol=0)


def test_k6_takes_strided_views_and_checks_inputs():
    q, k, v = _qkv(2, 1, 4, 2, 33, 33, 32, "float32")
    qt = _t(np.ascontiguousarray(np.swapaxes(q, 1, 2))).transpose(1, 2)  # a strided view
    assert not qt.is_contiguous()
    np.testing.assert_array_equal(ops.flash_attention(qt, _t(k), _t(v)).numpy(),
                                  ops.flash_attention(_t(q), _t(k), _t(v)).numpy())
    with pytest.raises(ValueError):
        ops.flash_attention(_t(q), _t(k)[:, :1, :, :16], _t(v))
    with pytest.raises(ValueError):
        ops.flash_attention(_t(q)[:, :3], _t(k), _t(v))  # 3 heads over 2
    with pytest.raises(TypeError):
        ops.flash_attention(_t(q).double(), _t(k).double(), _t(v).double())


# ---------------------------------------------------------------------------
# K7 SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, l, h, p, g, n, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    if dtype == "bfloat16":
        x, dt, bm, cm = (t.astype(ml_dtypes.bfloat16) for t in (x, dt, bm, cm))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [(1, 64, 4, 16, 2, 8, 32), (2, 96, 2, 8, 1, 16, 32)])
def test_k7_plain_matches_pallas_kernel_and_oracles(b, l, h, p, g, n, chunk):
    args = _ssd_inputs(0, b, l, h, p, g, n)
    jy, jh = j_ssd_kernel(*(jnp.asarray(t) for t in args), chunk=chunk, interpret=True)
    oy = np.asarray(jref.ssd_scan_ref(*(jnp.asarray(t) for t in args))[0])
    ry, rh = JM.ssd_reference(*(jnp.asarray(t) for t in args), chunk=chunk)
    y, hfin = ops.ssd_scan(*(_t(t) for t in args), chunk=chunk)
    for want in (np.asarray(jy), oy, np.asarray(ry)):
        np.testing.assert_allclose(y.numpy(), want, atol=SSD_ATOL, rtol=0)
    for want in (np.asarray(jh), np.asarray(rh)):
        np.testing.assert_allclose(hfin.numpy(), want, atol=SSD_ATOL, rtol=0)


@pytest.mark.parametrize("l,chunk,dtype", [(50, 32, "float32"), (100, 32, "float32"),
                                           (3, 32, "float32"), (77, 32, "bfloat16")])
def test_k7_ragged_lengths_match_ssd_reference(l, chunk, dtype):
    """L % chunk != 0: the reference zero-pads (dt = 0 steps are no-ops);
    the port's plain version and ssd_reference agree with it.  In bf16 the
    reference rounds x·dt to bf16 where K7's twin stays in f32."""
    args = _ssd_inputs(3, 1, l, 4, 16, 2, 8, dtype)
    ry, rh = JM.ssd_reference(*(jnp.asarray(t) for t in args), chunk=chunk)
    tol = SSD_ATOL if dtype == "float32" else BF16_ATOL
    for fn in (ops.ssd_scan, TM.ssd_reference):
        y, hfin = fn(*(_t(t) for t in args), chunk=chunk)
        # K7 returns x's dtype; ssd_reference, like the reference's, promotes
        want_dtype = _t(args[0]).dtype if fn is ops.ssd_scan else _t(np.asarray(ry)).dtype
        assert y.dtype == want_dtype and hfin.dtype == torch.float32
        np.testing.assert_allclose(_np(y), np.asarray(ry, np.float32), atol=tol, rtol=0)
        np.testing.assert_allclose(hfin.numpy(), np.asarray(rh), atol=tol, rtol=0)
    # the final state equals the O(L) recurrence of the oracle (f32)
    oy = np.asarray(jref.ssd_scan_ref(*(jnp.asarray(np.asarray(t, np.float32)) for t in args))[0])
    y, _ = ops.ssd_scan(*(_t(np.asarray(t, np.float32)) for t in args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), oy, atol=SSD_ATOL, rtol=0)


def test_k7_checks_inputs():
    x, dt, a, bm, cm = (_t(t) for t in _ssd_inputs(0, 1, 8, 4, 4, 2, 4))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :4], a, bm, cm)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a, bm[:, :, :1].expand(1, 8, 3, 4), cm[:, :, :1].expand(1, 8, 3, 4))
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, a, bm, cm)


# ---------------------------------------------------------------------------
# Whole models: prefill and decode against the reference
# ---------------------------------------------------------------------------


def _pair(arch, **replace):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    if replace:
        jcfg, cfg = dataclasses.replace(jcfg, **replace), dataclasses.replace(cfg, **replace)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _assert_tree_close(jtree, ttree, atol):
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jtree)), nest_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("arch,replace,prompt", [
    ("qwen3-8b", {}, 45),
    ("qwen3-8b", {"sliding_window": 16}, 40),  # the rolling tail of the SWA cache
    ("mamba2-370m", {}, 45),                    # ragged last chunk (45 % 32)
])
def test_prefill_and_decode_match_jax(arch, replace, prompt):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, prompt)).astype(np.int32)
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 64))
    log, cache = TT.lm_prefill(params, cfg, torch.from_numpy(toks), TT.init_cache(cfg, 2, 64, "cpu"))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    for _ in range(3):  # greedy continuation from the reference's logits
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
        log, cache = TT.lm_decode(params, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)


@pytest.mark.parametrize("arch", MODELS)
def test_decode_from_a_reference_cache(arch):
    """A cache filled by the reference crosses over and decodes the same."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(1, 20)).astype(np.int32)
    _, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 1, 32))
    cache = lm_cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert int(cache["pos"]) == 20
    tok = np.array([[7]], np.int32)
    jlog, _ = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
    log, _ = TT.lm_decode(params, cfg, torch.from_numpy(tok), cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)


@pytest.mark.parametrize("arch", MODELS)
def test_slotted_decode_equals_per_slot_decode(arch):
    """The engine's batched decode over slots (one parameter set per row,
    one position per row) equals decoding each slot on its own."""
    _, cfg, _, params = _pair(arch)
    bundle = get_bundle(cfg, "cpu")
    params2 = bundle.init(seed=1)
    caches, logits = [], []
    for p, n in ((params, 9), (params2, 14)):
        c = bundle.init_cache(1, 32)
        toks = torch.arange(n).reshape(1, n) % cfg.vocab_size
        bundle.prefill(p, {"tokens": toks}, c)
        caches.append(c)
        logits.append(bundle.decode(p, torch.tensor([[3]]), c)[0])
    # re-prefill, then stack the caches and the parameters over a slot axis
    stacked_cache = {}
    for p, n, i in ((params, 9, 0), (params2, 14, 1)):
        c = bundle.init_cache(1, 32)
        bundle.prefill(p, {"tokens": torch.arange(n).reshape(1, n) % cfg.vocab_size}, c)
        caches[i] = c
    from repro_torch.utils.pytree import nest_map
    stacked_cache = nest_map(lambda a, b: torch.stack([a, b]), caches[0], caches[1])
    slot_params = nest_map(lambda a, b: torch.stack([a, b]), params, params2)
    out, stacked_cache = bundle.decode_slots(slot_params, torch.tensor([[3], [3]]), stacked_cache)
    assert stacked_cache["pos"].tolist() == [10, 15]
    for i in range(2):
        np.testing.assert_allclose(out[i].numpy(), logits[i][0].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Weights, configurations, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MODELS)
def test_bf16_weights_round_trip_through_uint16(arch):
    jcfg = j_get_reduced(arch, dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(1), jcfg))
    params = lm_params_from_jax(jparams, "cpu")
    dtypes = {t.dtype for t in nest_leaves(params)}
    assert torch.bfloat16 in dtypes  # norms/projections; a_log etc. stay f32
    back = lm_params_to_numpy(params, ml_dtypes.bfloat16)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    raw = lm_params_to_numpy(params)  # without the dtype: the bits as uint16
    assert any(x.dtype == np.uint16 for x in jax.tree.leaves(raw))
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, 1, 8))
    back_c = lm_cache_to_numpy(lm_cache_from_jax(cache, "cpu"), ml_dtypes.bfloat16)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(back_c)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", MODELS + ("qwen3-8b-swa",))
def test_configs_match_reference(arch):
    from repro.configs import get_config as j_get_config

    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):  # SSMConfig: another class, same fields
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert mine.param_count() == theirs.param_count()
        assert mine.layer_kinds() == theirs.layer_kinds()
        assert mine.ffn_kinds() == theirs.ffn_kinds()
        assert mine.scan_period() == theirs.scan_period()
    assert get_config("qwen3-8b").param_count() == 8_190_427_136  # 8.19 B


def test_unported_families_and_short_prompts_raise():
    from repro_torch.configs import get_config as cfg_of

    with pytest.raises(NotImplementedError, match="A14"):
        cfg_of("mixtral-8x7b")
    base = get_reduced("qwen3-8b")
    for bad in ({"moe": object()}, {"attn_impl": "mla"}, {"is_enc_dec": True},
                {"mrope_sections": (4, 6, 6)}, {"hybrid_period": ("attn", "mamba")}):
        with pytest.raises(NotImplementedError, match="A14"):
            get_bundle(dataclasses.replace(base, **bad), "cpu")
    bundle = get_bundle(get_reduced("mamba2-370m"), "cpu")
    params = bundle.init(0)
    with pytest.raises(ValueError, match="at least 3"):
        bundle.prefill(params, {"tokens": torch.zeros((1, 2), dtype=torch.long)},
                       bundle.init_cache(1, 8))
    with pytest.raises(NotImplementedError):
        bundle.loss(params, {})
