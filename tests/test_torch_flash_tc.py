"""K6's tensor-core path, the parts the CPU can check: the plain version's
model of the kernel's rounding (``flash_attention_ref(p_dtype=bfloat16)``:
the unnormalised probabilities rounded to bf16 before P·V) held against the
JAX package's Pallas kernel in interpret mode, its oracle and the
reference's ``attention_core`` on the same numpy inputs; the default
``p_dtype`` leaving results bit-identical; and the TMA stride rule the
wrapper enforces before it launches the bf16 kernel.  The kernel itself is
held against this plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import tma_strides  # noqa: E402

BF16 = torch.bfloat16
# bf16 output against the f32 oracle and the Pallas kernel (which keeps P in
# f32): the output's rounding plus P's, as test_torch_lm.py's bf16 cases
BF16_ATOL = 2e-2
# against the reference's attention_core, which also rounds the scores to
# bf16 before the softmax (attention.py:129-132), as test_torch_lm.py
BF16_CORE_ATOL = 4e-2


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


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 4, 64, 32, None),    # MHA
    (1, 8, 2, 64, 64, None),    # GQA
    (1, 4, 1, 128, 128, 32),    # MQA + window
    (2, 4, 2, 96, 32, 16),      # batch 2, short window
])
def test_p_bf16_plain_matches_pallas_kernel_and_oracle(b, hq, hkv, s, d, window):
    q, k, v = _qkv(10, b, hq, hkv, s, s, d, "bfloat16")
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              window=window, block_q=32, block_k=32, interpret=True),
                      np.float32)
    oracle = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=True, window=window), np.float32)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True, window=window, p_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(_np(got), want, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got), oracle, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("s,window,hkv", [(37, None, 2), (61, None, 1), (130, 40, 2),
                                          (100, 16, 4)])
def test_p_bf16_plain_matches_attention_core(s, window, hkv):
    """Ragged prompt lengths in the reference's (B, S, H, D) layout."""
    q, k, v = _qkv(11, 1, 4, hkv, s, s, 32, "bfloat16")
    q, k, v = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    want = np.asarray(JA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window, chunk=1024), np.float32)
    got = ref.flash_attention_ref(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                  _t(v).transpose(1, 2), causal=True, window=window,
                                  p_dtype=BF16).transpose(1, 2)
    np.testing.assert_allclose(_np(got), want, atol=BF16_CORE_ATOL, rtol=0)


def _softmax_form(q, k, v, causal, window):
    """The plain version as it was before ``p_dtype``: one-pass softmax in
    float32, then P·V."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(d)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vf).to(q.dtype)


@pytest.mark.parametrize("dtype,window", [("float32", None), ("float32", 8),
                                          ("bfloat16", None)])
def test_default_p_dtype_is_bit_identical(dtype, window):
    q, k, v = (_t(x) for x in _qkv(12, 1, 4, 2, 45, 45, 32, dtype))
    got = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert torch.equal(got, _softmax_form(q, k, v, True, window))
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                                    p_dtype=torch.float32))


def test_p_bf16_rounds_only_the_probabilities():
    """In float32 inputs the bf16 model differs from the softmax form by P's
    rounding alone: within 2^-8 relative of max |v| (one bf16 rounding of
    each p, averaged), and not bit-equal."""
    q, k, v = (_t(x) for x in _qkv(13, 1, 2, 1, 64, 64, 32, "float32"))
    exact = ref.flash_attention_ref(q, k, v)
    model = ref.flash_attention_ref(q, k, v, p_dtype=BF16)
    assert model.dtype == torch.float32
    err = float((model - exact).abs().max())
    assert 0.0 < err <= 2.0 ** -8 * float(v.abs().max())


def _bf16(*shape):
    return torch.zeros(*shape, dtype=BF16)


@pytest.mark.parametrize("view,want", [
    # (B, S, H, D) activation seen as (B, H, S, D): heads one D apart
    (lambda: _bf16(2, 40, 8, 128).transpose(1, 2), (40 * 8 * 128, 128, 8 * 128)),
    # a k / v slice of a longer cache
    (lambda: _bf16(1, 4, 700, 64)[:, :, :500], (64, 700 * 64, 64)),
    # size-1 batch and head: their strides are never stepped over
    (lambda: _bf16(1, 1, 33, 32), (32, 32, 32)),
    (lambda: _bf16(1, 33, 1, 32).transpose(1, 2), (32, 32, 32)),
])
def test_tma_strides_of_valid_views(view, want):
    assert tma_strides(view(), "q") == want


@pytest.mark.parametrize("view,dim", [
    (lambda: _bf16(1, 1, 50, 129)[..., :128], 2),  # rows 258 bytes apart
    # (B, S, H, D) rows padded by 4 elements: positions 1032 bytes apart
    (lambda: torch.as_strided(_bf16(60000), (1, 4, 50, 128), (0, 128, 516, 1)), 2),
    (lambda: _bf16(2, 9, 4, 36)[..., :32].transpose(1, 2), 1),  # heads 72 bytes apart
    (lambda: torch.as_strided(_bf16(4000), (3, 2, 5, 32), (331, 160, 32, 1)), 0),
])
def test_tma_strides_reject_unaligned_strides(view, dim):
    with pytest.raises(ValueError, match=rf"k\.stride\({dim}\)"):
        tma_strides(view(), "k")


def test_tma_strides_reject_an_unaligned_base():
    t = _bf16(2 * 4 * 7 * 64 + 1)[1:].view(2, 4, 7, 64)
    with pytest.raises(ValueError, match="base address"):
        tma_strides(t, "k")


# ---------------------------------------------------------------------------
# The zoo's head dims: Nemotron-4's 192, MLA's q/k 192 (48 reduced) against a
# smaller v head dim 128 (32 reduced)
# ---------------------------------------------------------------------------


def _qkv_dv(seed, b, hq, hkv, s, d, dv, dtype):
    q, k, _ = _qkv(seed, b, hq, hkv, s, s, d, dtype)
    v = np.random.default_rng(seed + 1).normal(size=(b, hkv, s, dv)).astype(np.float32)
    return q, k, (v.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else v)


@pytest.mark.parametrize("b,hq,hkv,s,d,dv,window,dtype", [
    (1, 8, 2, 64, 192, 192, None, "float32"),     # Nemotron-4's GQA head dim
    (1, 4, 1, 96, 192, 192, 40, "bfloat16"),
    (1, 4, 4, 64, 48, 32, None, "float32"),       # reduced MLA: q/k 48, v 32
    (2, 4, 4, 64, 192, 128, None, "float32"),     # MLA: q/k 192, v 128
    (1, 4, 4, 64, 192, 128, None, "bfloat16"),
])
def test_zoo_head_dims_plain_matches_pallas_kernel_and_attention_core(b, hq, hkv, s, d, dv,
                                                                      window, dtype):
    """The plain version (what the wrapper runs on the CPU) at D = 192 and
    with v's head dim below q's, against the Pallas kernel in interpret mode
    on v zero-padded to D (its BlockSpecs take one head dim; the padded
    columns come out zero and are sliced off) and against the reference's
    attention_core, which takes v's own head dim.  The scale is 1/sqrt(D)."""
    from repro_torch.kernels import ops

    q, k, v = _qkv_dv(14, b, hq, hkv, s, d, dv, dtype)
    v_pad = np.concatenate([v, np.zeros(v.shape[:3] + (d - dv,), v.dtype)], axis=-1)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v_pad), causal=True,
                              window=window, block_q=32, block_k=32, interpret=True),
                      np.float32)
    assert not want[..., dv:].any()
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert got.shape == (b, hq, s, dv) and got.dtype == _t(q).dtype
    tol = 2e-6 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(got), want[..., :dv], atol=tol, rtol=0)
    if dtype == "bfloat16":
        model = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True, window=window,
                                        p_dtype=BF16)
        np.testing.assert_allclose(_np(model), want[..., :dv], atol=BF16_ATOL, rtol=0)
    qs, ks, vs = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    core = np.asarray(JA.attention_core(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                                        causal=True, window=window, chunk=1024), np.float32)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), core,
                               atol=tol if dtype == "float32" else BF16_CORE_ATOL, rtol=0)


def test_zoo_head_dims_refused_shapes():
    from repro_torch.kernels import ops

    q, k, v = (_t(x) for x in _qkv_dv(15, 1, 4, 4, 16, 48, 64, "float32"))
    with pytest.raises(ValueError, match="do not fit"):  # v's head dim above q's
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="do not fit"):  # v's length not k's
        ops.flash_attention(q, k, v[:, :, :8, :32])


@pytest.mark.parametrize("view,want", [
    # Nemotron-4's (B, S, H, 192) activation as (B, H, S, 192): 384-byte rows
    (lambda: _bf16(2, 40, 96, 192).transpose(1, 2), (40 * 96 * 192, 192, 96 * 192)),
    # MLA's key: cat(k_nope, broadcast k_rope) materialised contiguous
    (lambda: torch.cat([_bf16(2, 40, 16, 128), _bf16(2, 40, 1, 64).expand(2, 40, 16, 64)],
                       dim=-1).transpose(1, 2), (40 * 16 * 192, 192, 16 * 192)),
    # MLA's v zero-padded from 128 to 192 (a fresh contiguous (B, H, S, 192))
    (lambda: torch.nn.functional.pad(_bf16(2, 40, 16, 128).transpose(1, 2), (0, 64)),
     (16 * 40 * 192, 40 * 192, 192)),
])
def test_tma_strides_at_head_dim_192(view, want):
    assert tma_strides(view(), "k") == want


def test_tma_strides_at_head_dim_192_reject_unaligned_rows():
    # a 192-wide slice of 196-wide rows: positions 392 bytes apart
    with pytest.raises(ValueError, match=r"k\.stride\(2\)"):
        tma_strides(_bf16(1, 2, 30, 196)[..., :192], "k")
