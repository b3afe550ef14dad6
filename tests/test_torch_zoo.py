"""The decoder-only half of the LM zoo beyond Qwen3-8B and Mamba2-370m —
Mixtral-8x7B (MoE, sliding window), DeepSeek-V2-Lite (MLA, fine-grained MoE
with shared experts, a dense first layer), Jamba-v0.1 (hybrid Mamba /
attention without RoPE, MoE every other layer), Qwen2.5-14B (QKV bias),
Granite-20B (MQA) and Nemotron-4-340B (squared ReLU, head dim 192) — held
against the JAX package at ``reduced()`` size on the same numpy inputs:
prefill and decode logits and caches (with every MoE layer's routes equal
to the reference's), decode from a reference cache, the slotted decode,
bf16 weights, configurations and their JSON, and MLA's materialised forward
and absorbed decode on their own.  The helpers are ``test_torch_lm.py``'s."""
import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from test_torch_lm import LM_ATOL, _assert_tree_close, _pair  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import KeyGen  # noqa: E402
from repro.models.rope import rope_cos_sin as j_rope_cos_sin  # noqa: E402
from repro.models.rope import text_positions as j_text_positions  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.models.rope import rope_cos_sin, text_positions  # noqa: E402
from repro_torch.utils.pytree import nest_leaves, nest_map  # noqa: E402
from repro_torch.weights import (  # noqa: E402
    lm_cache_from_jax,
    lm_cache_to_numpy,
    lm_params_from_jax,
    lm_params_to_numpy,
    tree_from_jax,
)

ZOO = ("mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b", "qwen2.5-14b", "granite-20b",
       "nemotron-4-340b")


class _Routes:
    """Every MoE layer's (top_idx, logits) in the order the layers run: the
    reference's through a debug callback (its layers run inside lax.scan),
    the port's from its ``route``."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_route, t_route = JMoE._route, TMoE.route

        def j_wrapped(logits, mo):
            out = j_route(logits, mo)
            jax.debug.callback(lambda i, lg: self.jax.append((np.asarray(i), np.asarray(lg))),
                               out[0], logits, ordered=True)
            return out

        def t_wrapped(logits, mo):
            out = t_route(logits, mo)
            self.port.append((out[0].numpy(), logits.detach().numpy()))
            return out

        monkeypatch.setattr(JMoE, "_route", j_wrapped)
        monkeypatch.setattr(TMoE, "route", t_wrapped)

    def check(self, k, what):
        """The routes of every (token, layer) equal; on a difference, the
        smallest gap between the k-th and (k+1)-th router logits, so a flip
        at a near-tie can be told from a wrong dispatch."""
        assert len(self.jax) == len(self.port), (len(self.jax), len(self.port))
        for layer, ((ji, jl), (ti, _)) in enumerate(zip(self.jax, self.port)):
            ji = ji.reshape(ti.shape)
            if not np.array_equal(ji, ti):
                srt = -np.sort(-jl.reshape(-1, jl.shape[-1]).astype(np.float64), axis=-1)
                gap = float(np.min(srt[:, k - 1] - srt[:, k]))
                raise AssertionError(f"{what}: MoE call {layer}: routes differ at "
                                     f"{int(np.sum(np.any(ji != ti, axis=-1)))} tokens; smallest "
                                     f"k-th to (k+1)-th router logit gap {gap:.3e}")
        self.jax.clear()
        self.port.clear()


@pytest.mark.parametrize("arch,prompt", [
    ("mixtral-8x7b", 45),          # longer than the window (32): the rolling cache's tail
    ("mixtral-8x7b", 20),
    ("deepseek-v2-lite-16b", 45),
    ("jamba-v0.1-52b", 45),        # ragged last SSD chunk (45 % 32)
    ("qwen2.5-14b", 45),
    ("granite-20b", 45),
    ("nemotron-4-340b", 45),
])
def test_prefill_and_decode_match_jax(arch, prompt, monkeypatch):
    routes = _Routes(monkeypatch)
    jcfg, cfg, jparams, params = _pair(arch)
    k = cfg.moe.top_k if cfg.moe else 1
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, prompt)).astype(np.int32)
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 64))
    log, cache = TT.lm_prefill(params, cfg, torch.from_numpy(toks), TT.init_cache(cfg, 2, 64, "cpu"))
    routes.check(k, f"{arch} prefill")
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)
    for step in range(3):  # greedy continuation from the reference's logits
        tok = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlog, jcache = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
        log, cache = TT.lm_decode(params, cfg, torch.from_numpy(tok), cache)
        routes.check(k, f"{arch} decode step {step}")
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache, cache, LM_ATOL)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_from_a_reference_cache(arch):
    """A cache filled by the reference (KV, MLA's c_kv / k_rope, Jamba's
    conv / ssm beside k / v) crosses over and decodes the same."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(1, 20)).astype(np.int32)
    _, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 1, 32))
    cache = lm_cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert int(cache["pos"]) == 20
    tok = np.array([[7]], np.int32)
    jlog, jcache2 = JT.lm_decode(jparams, jcfg, jnp.asarray(tok), jcache)
    log, cache2 = TT.lm_decode(params, cfg, torch.from_numpy(tok), cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jcache2, cache2, LM_ATOL)


@pytest.mark.parametrize("arch", ZOO)
def test_slotted_decode_equals_per_slot_decode(arch):
    """The engine's batched decode over slots (one parameter set, one
    position and, under MoE, one routing group per row) equals decoding
    each slot on its own."""
    _, cfg, _, params = _pair(arch)
    bundle = get_bundle(cfg, "cpu")
    params2 = bundle.init(seed=1)
    caches, logits = [], []
    for p, n in ((params, 9), (params2, 14)):
        c = bundle.init_cache(1, 32)
        bundle.prefill(p, {"tokens": torch.arange(n).reshape(1, n) % cfg.vocab_size}, c)
        caches.append(nest_map(torch.clone, c))
        logits.append(bundle.decode(p, torch.tensor([[3]]), c)[0])
    stacked_cache = nest_map(lambda a, b: torch.stack([a, b]), caches[0], caches[1])
    slot_params = nest_map(lambda a, b: torch.stack([a, b]), params, params2)
    out, stacked_cache = bundle.decode_slots(slot_params, torch.tensor([[3], [3]]), stacked_cache)
    assert stacked_cache["pos"].tolist() == [10, 15]
    for i in range(2):
        np.testing.assert_allclose(out[i].numpy(), logits[i][0].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ZOO)
def test_bf16_weights_round_trip_through_uint16(arch):
    """Every leaf (the f32 router and SSM leaves among bf16 ones) and the
    caches cross to the port and back bit for bit."""
    jcfg = j_get_reduced(arch, dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(1), jcfg))
    params = lm_params_from_jax(jparams, "cpu")
    assert torch.bfloat16 in {t.dtype for t in nest_leaves(params)}
    back = lm_params_to_numpy(params, ml_dtypes.bfloat16)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    tparams = TT.init_lm(get_reduced(arch, "bfloat16"), seed=0, device="cpu")
    assert [tuple(t.shape) for t in nest_leaves(tparams)] == [a.shape for a in
                                                              jax.tree.leaves(jparams)]
    assert [str(t.dtype).removeprefix("torch.") for t in nest_leaves(tparams)] == [
        str(a.dtype) for a in jax.tree.leaves(jparams)]
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, 1, 8))
    back_c = lm_cache_to_numpy(lm_cache_from_jax(cache, "cpu"), ml_dtypes.bfloat16)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(back_c)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tcache = TT.init_cache(get_reduced(arch, "bfloat16"), 1, 8, "cpu")
    assert [tuple(t.shape) for t in nest_leaves(tcache)] == [a.shape for a in
                                                             jax.tree.leaves(cache)]


@pytest.mark.parametrize("arch", ZOO)
def test_configs_match_reference(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):  # MoE / SSM / MLA: another class, same fields
                assert type(a).__name__ == type(b).__name__
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.supports_long_decode() == theirs.supports_long_decode()
        assert mine.layer_kinds() == theirs.layer_kinds()
        assert mine.ffn_kinds() == theirs.ffn_kinds()
        assert mine.scan_period() == theirs.scan_period()
        assert TT._period_patterns(mine) == JT._period_patterns(theirs)


@pytest.mark.parametrize("arch", ZOO)
def test_config_json_round_trip_against_the_reference(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        text = json.dumps(tconfig.config_to_dict(mine))
        assert text == json.dumps(jconfig.config_to_dict(theirs))
        assert tconfig.config_from_dict(json.loads(text)) == mine
        assert jconfig.config_from_dict(json.loads(text)) == theirs


def test_mla_materialised_forward_and_absorbed_decode_match_jax():
    """One MLA layer alone: the training forward (materialised K/V, q/k head
    dim 48 against v 32), the prefill core through the kernel's plain
    version, and the absorbed decode over the latent cache."""
    jcfg, cfg = j_get_reduced("deepseek-v2-lite-16b"), get_reduced("deepseek-v2-lite-16b")
    jp = JA.init_mla(KeyGen(jax.random.PRNGKey(3)), jcfg, jnp.float32)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(8).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    rope = cfg.mla.rope_head_dim
    jcs = j_rope_cos_sin(j_text_positions(2, 40, 0), rope, jcfg.rope_theta)
    tcs = rope_cos_sin(text_positions(2, 40, 0), rope, cfg.rope_theta)
    want = JA.mla_forward(jp, jcfg, jnp.asarray(x), jcs)
    np.testing.assert_allclose(TA.mla_forward(tp, cfg, torch.from_numpy(x), tcs).numpy(),
                               np.asarray(want), atol=LM_ATOL, rtol=0)
    parts = TA._mla_qkr(tp, cfg, torch.from_numpy(x), tcs)
    q, k, v = TA.mla_qkv(tp, *parts)
    assert q.shape[-1] == k.shape[-1] == 48 and v.shape[-1] == 32 and k.is_contiguous()
    core = TA.attention_core(q, k, v, causal=True)
    y = torch.einsum("bshk,hkd->bsd", core, tp["wo"])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=LM_ATOL, rtol=0)
    # absorbed decode: prefill 39 tokens into the latent cache, decode the 40th
    jcache = JA.mla_fill_cache(JA.init_mla_cache(jcfg, 2, 48, jnp.float32),
                               *JA._mla_qkr(jp, jcfg, jnp.asarray(x[:, :39]),
                                            jax.tree.map(lambda t: t[:, :39], jcs))[2:])
    tcache = TA.mla_fill_cache(TA.init_mla_cache(cfg, 2, 48, torch.float32),
                               *TA._mla_qkr(tp, cfg, torch.from_numpy(x[:, :39]),
                                            tuple(t[:, :39] for t in tcs))[2:])
    jy, jc = JA.mla_decode(jp, jcfg, jnp.asarray(x[:, 39:]),
                           jax.tree.map(lambda t: t[:, 39:], jcs), jcache, 39)
    ty = TA.mla_decode(tp, cfg, torch.from_numpy(x[:, 39:]), tuple(t[:, 39:] for t in tcs),
                       tcache, torch.full((2,), 39))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LM_ATOL, rtol=0)
    _assert_tree_close(jc, tcache, LM_ATOL)
    # the absorbed decode equals the materialised attention's last position
    np.testing.assert_allclose(ty.numpy(), np.asarray(want)[:, 39:], atol=LM_ATOL, rtol=0)


def test_unported_archs_name_the_roadmap():
    """All ten ids resolve through get_config, get_reduced and get_bundle
    (the encoder-decoder and the VLM among them, configs equal to the
    reference's through its JSON); the attention logit softcap, once
    unported, now builds for both families too (its numbers are held in
    ``tests/test_torch_softcap.py``)."""
    for arch in ("seamless-m4t-medium", "qwen2-vl-2b"):
        for mine, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_reduced(arch), j_get_reduced(arch))):
            assert tconfig.config_to_dict(mine) == jconfig.config_to_dict(theirs)
            cfg = tconfig.config_from_dict(jconfig.config_to_dict(theirs))
            assert get_bundle(cfg, "cpu").cfg == mine
        softcap = dataclasses.replace(get_reduced(arch), attn_logit_softcap=30.0)
        assert get_bundle(softcap, "cpu").cfg.attn_logit_softcap == 30.0


def test_normal_init_draws_large_leaves_in_slices(monkeypatch):
    """A leaf past DRAW_CHUNK float32 elements is drawn in slices along its
    first axis; one that fits is one draw, bit for bit the plain one."""
    from repro_torch.models import layers as TL

    def draws(shape, rows):
        g = torch.Generator().manual_seed(0)
        parts = [torch.randn((min(rows, shape[0] - r),) + shape[1:], generator=g)
                 for r in range(0, shape[0], rows)]
        return (torch.cat(parts) * 0.02).to(torch.bfloat16)

    for shape, dtype in (((7, 3), torch.bfloat16), ((7, 3), torch.float32), ((), torch.float32)):
        g = torch.Generator().manual_seed(0)
        want = (torch.randn(shape, generator=g) * 0.02).to(dtype)
        assert torch.equal(TL.normal_init(torch.Generator().manual_seed(0), shape, 0.02, dtype),
                           want)
    monkeypatch.setattr(TL, "DRAW_CHUNK", 8)  # 2 rows of 3 a slice
    got = TL.normal_init(torch.Generator().manual_seed(0), (7, 3), 0.02, torch.bfloat16)
    assert got.shape == (7, 3) and torch.equal(got, draws((7, 3), 2))
