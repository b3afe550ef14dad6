"""The MoE layer in the port, held against the JAX package's
``repro.models.moe`` on the same numpy inputs: the twins of
``tests/test_moe.py``, routing (both gate modes, ties to the lower index),
the sort-based capacity dispatch with the reference's own routes fed in,
whole layers with shared experts and every MLP type, drops at
``capacity_factor`` 1.0, the load-balance loss, and the slotted form against
a loop over the slots.

Routes are discontinuous: a top-k over near-equal router logits flips under
another summation order.  Every comparison of a whole layer first holds the
port's routes equal to the reference's and, where they differ, names the
smallest gap between the k-th and (k+1)-th logits."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hyp import given, settings, st  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.layers import KeyGen  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.weights import tree_from_jax  # noqa: E402

# float32 through one layer: a few ulps of the outputs
LM_ATOL = 1e-5


def _cfgs(n_experts=4, top_k=2, capacity_factor=4.0, gate_mode="softmax_topk", n_shared=0,
          mlp_type="swiglu", d_expert=48):
    kw = dict(name="moe-test", arch_type="moe", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab_size=64, mlp_type=mlp_type)
    mo = dict(n_experts=n_experts, top_k=top_k, d_expert=d_expert,
              capacity_factor=capacity_factor, gate_mode=gate_mode, n_shared=n_shared)
    return JModelConfig(moe=JMoEConfig(**mo), **kw), ModelConfig(moe=MoEConfig(**mo), **kw)


def _params(jcfg, seed=0):
    jp = JM.init_moe(KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32)
    return jp, tree_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _min_gap(logits, k):
    """Smallest gap between the k-th and (k+1)-th largest logit of any row."""
    srt = -np.sort(-np.asarray(logits, np.float64), axis=-1)
    return float(np.min(srt[:, k - 1] - srt[:, k])) if srt.shape[1] > k else float("inf")


def _assert_routes_equal(jidx, tidx, logits, k, what):
    jidx, tidx = np.asarray(jidx), np.asarray(tidx)
    bad = np.argwhere(np.any(jidx != tidx, axis=-1)).ravel()
    assert bad.size == 0, (f"{what}: routes differ at rows {bad[:8].tolist()} (smallest k-th to "
                           f"(k+1)-th logit gap {_min_gap(logits, k):.3e})")


# ---------------------------------------------------------------------------
# Twins of tests/test_moe.py
# ---------------------------------------------------------------------------


def _dense_reference(params, cfg, x):
    """Dropless ground truth in the port: every expert on every token."""
    mo = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    top_idx, top_w, _ = TM.route(xf @ params["router"], mo)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, params["w_gate"]))
    h = h * torch.einsum("td,edf->tef", xf, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])
    w_full = torch.zeros(xf.shape[0], mo.n_experts).scatter(1, top_idx, top_w)
    return torch.einsum("te,ted->td", w_full, y_all).reshape(x.shape)


def test_dropless_matches_dense_reference():
    _, cfg = _cfgs(capacity_factor=4.0)
    _, params = _params(_cfgs()[0])
    x = torch.from_numpy(_x(0, (2, 16, cfg.d_model)))
    y, aux = TM.moe_forward(params, cfg, x)
    np.testing.assert_allclose(y.numpy(), _dense_reference(params, cfg, x).numpy(), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("gate_mode", ["softmax_topk", "topk_softmax"])
def test_gate_weights_sum_to_one(gate_mode):
    _, cfg = _cfgs(gate_mode=gate_mode)
    _, top_w, probs = TM.route(torch.from_numpy(_x(1, (64, cfg.moe.n_experts))), cfg.moe)
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)


@given(seed=st.integers(0, 30))
@settings(max_examples=10, deadline=None)
def test_aux_loss_minimized_by_uniform_routing(seed):
    """Load-balance loss >= coef (its value under uniform routing), and the
    reference's value on the same routes."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(120, cfg.moe.n_experts))
    probs = torch.softmax(torch.from_numpy(logits), -1).float()
    top_idx = torch.from_numpy(rng.integers(0, cfg.moe.n_experts, size=(120, cfg.moe.top_k)))
    loss = float(TM.aux_load_balance_loss(probs, top_idx, cfg.moe))
    assert loss >= cfg.moe.router_aux_coef * 0.8
    want = float(JM.aux_load_balance_loss(jnp.asarray(probs.numpy()),
                                          jnp.asarray(top_idx.numpy()), jcfg.moe))
    np.testing.assert_allclose(loss, want, rtol=1e-6)


def test_tight_capacity_drops_tokens():
    _, cfg_full = _cfgs(capacity_factor=4.0)
    _, cfg_drop = _cfgs(capacity_factor=0.5)
    _, params = _params(_cfgs()[0])
    x = torch.from_numpy(_x(2, (2, 32, cfg_full.d_model)))
    y_full, _ = TM.moe_forward(params, cfg_full, x)
    y_drop, _ = TM.moe_forward(params, cfg_drop, x)
    assert float((y_full - y_drop).abs().max()) > 1e-4


def test_shared_experts_added():
    jcfg, cfg = _cfgs(n_shared=1)
    _, params = _params(jcfg)
    _, cfg_no = _cfgs()
    x = torch.from_numpy(_x(3, (1, 8, cfg.d_model)))
    y_with, _ = TM.moe_forward(params, cfg, x)
    from repro_torch.models.mlp import mlp_forward

    shared = mlp_forward(params["shared"], "swiglu", x)
    y_without, _ = TM.moe_forward({k: v for k, v in params.items() if k != "shared"}, cfg_no, x)
    np.testing.assert_allclose(y_with.numpy(), (y_without + shared).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate_mode", ["softmax_topk", "topk_softmax"])
def test_routes_match_reference_with_ties_to_the_lower_index(gate_mode):
    jcfg, cfg = _cfgs(n_experts=8, top_k=3, gate_mode=gate_mode)
    logits = _x(4, (200, 8))
    logits[:20, 2:6] = 9.0  # four-way ties at the top
    logits[20:40] = 0.0  # all experts tied
    jidx, jw, jprobs = JM._route(jnp.asarray(logits), jcfg.moe)
    tidx, tw, tprobs = TM.route(torch.from_numpy(logits), cfg.moe)
    _assert_routes_equal(jidx, tidx, logits, 3, gate_mode)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    assert tidx[:20, :3].tolist() == [[2, 3, 4]] * 20
    assert tidx[20:40].tolist() == [[0, 1, 2]] * 20


@pytest.mark.parametrize("gate_mode,n_shared,mlp_type,cf", [
    ("softmax_topk", 0, "swiglu", 4.0),
    ("topk_softmax", 2, "swiglu", 4.0),
    ("topk_softmax", 1, "squared_relu", 1.25),
    ("softmax_topk", 0, "gelu", 1.25),
    ("softmax_topk", 0, "swiglu", 1.0),     # drops: capacity 1.0 · T · k / E
    ("topk_softmax", 1, "swiglu", 1.0),
])
def test_moe_forward_matches_reference(gate_mode, n_shared, mlp_type, cf, monkeypatch):
    jcfg, cfg = _cfgs(n_experts=6, top_k=2, capacity_factor=cf, gate_mode=gate_mode,
                      n_shared=n_shared, mlp_type=mlp_type)
    jp, params = _params(jcfg, seed=1)
    x = _x(5, (2, 24, cfg.d_model))
    routes = []
    real = TM.route
    monkeypatch.setattr(TM, "route", lambda lg, mo: routes.append((lg, real(lg, mo))) or
                        routes[-1][1])
    jy, jaux = JM.moe_forward(jp, jcfg, jnp.asarray(x))
    y, aux = TM.moe_forward(params, cfg, torch.from_numpy(x))
    logits = routes[0][0].numpy()
    jidx = JM._route(jnp.asarray(logits), jcfg.moe)[0]
    _assert_routes_equal(jidx, routes[0][1][0], logits, 2, "moe_forward")
    if cf == 1.0:  # some expert is over its capacity: tokens are dropped
        counts = np.bincount(np.asarray(jidx).ravel(), minlength=6)
        assert counts.max() > TM.capacity(cfg.moe, 48)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=LM_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_dispatch_alone_with_the_reference_routes(cf, monkeypatch):
    """The reference's own top_idx / top_w fed into the port's dispatch:
    the sort, the per-expert capacity and the drops are held apart from
    the routing."""
    jcfg, cfg = _cfgs(n_experts=4, top_k=2, capacity_factor=cf, gate_mode="topk_softmax")
    jp, params = _params(jcfg, seed=2)
    x = _x(6, (1, 40, cfg.d_model))
    jr = JM._route(jnp.asarray(x.reshape(40, -1)) @ jp["router"], jcfg.moe)
    fed = tuple(torch.from_numpy(np.array(a)) for a in jr)
    monkeypatch.setattr(TM, "route", lambda lg, mo: fed)
    jy, _ = JM.moe_forward(jp, jcfg, jnp.asarray(x))
    y, _ = TM.moe_forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=LM_ATOL, rtol=0)


def test_slotted_form_equals_a_loop_over_slots():
    """One parameter set and one routing group per row, capacity of the
    row's own tokens (jax.vmap of the reference's layer over the slots)."""
    jcfg, cfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.0, n_shared=1)
    rows = [_params(jcfg, seed=s)[1] for s in (3, 4, 5)]
    slot_params = {k: ({kk: torch.stack([r[k][kk] for r in rows]) for kk in v}
                       if isinstance(v, dict) else torch.stack([r[k] for r in rows]))
                   for k, v in rows[0].items()}
    for seq in (1, 12):
        x = torch.from_numpy(_x(7 + seq, (3, seq, cfg.d_model)))
        y, aux = TM.moe_forward(slot_params, cfg, x, slotted=True)
        assert aux.shape == (3,)
        for i, p in enumerate(rows):
            y_i, aux_i = TM.moe_forward(p, cfg, x[i:i + 1])
            assert torch.equal(y[i], y_i[0]) and float(aux[i]) == float(aux_i)
    # the reference vmapped over the slots, at one token a slot (decode)
    jrows = [_params(jcfg, seed=s)[0] for s in (3, 4, 5)]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jrows)
    x1 = _x(9, (3, 1, 1, cfg.d_model))
    jy, _ = jax.vmap(lambda p, xx: JM.moe_forward(p, jcfg, xx))(jstack, jnp.asarray(x1))
    y, _ = TM.moe_forward(slot_params, cfg, torch.from_numpy(x1[:, 0]), slotted=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, 0], atol=LM_ATOL, rtol=0)


def test_capacity_is_the_reference_s():
    for t in (1, 7, 500, 4608):
        for n_experts, top_k, cf in ((8, 2, 1.25), (64, 6, 1.25), (16, 2, 1.25), (4, 2, 4.0)):
            mo = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=8, capacity_factor=cf)
            want = max(1, min(int(cf * t * top_k / n_experts), t * top_k))
            assert TM.capacity(mo, t) == want
    assert TM.capacity(MoEConfig(8, 2, 8), 4608) == 1440  # Mixtral's prefill at S = 4,608
    assert dataclasses.asdict(MoEConfig(8, 2, 8)) == dataclasses.asdict(JMoEConfig(8, 2, 8))


@pytest.mark.parametrize("gate_mode,mlp_type", [("softmax_topk", "swiglu"),
                                                ("topk_softmax", "squared_relu")])
def test_one_token_in_place_equals_the_batched_dispatch(gate_mode, mlp_type):
    """A decode step's token reads its k experts in place; the batched
    (E, cap, d) product, the reference's form, gives the same outputs."""
    jcfg, cfg = _cfgs(n_experts=6, top_k=2, capacity_factor=1.0, gate_mode=gate_mode,
                      mlp_type=mlp_type)
    _, params = _params(jcfg, seed=6)
    experts = {n: params[n] for n in ("w_gate", "w_up", "w_down") if n in params}
    for seed in range(4):
        xf = torch.from_numpy(_x(20 + seed, (1, cfg.d_model)))
        top_idx, top_w, _ = TM.route(xf @ params["router"], cfg.moe)
        a = TM.dispatch_in_place(experts, cfg, xf, top_idx, top_w)
        b = TM.dispatch_batched(experts, cfg, xf, top_idx, top_w)
        assert a.shape == b.shape == (1, 2, cfg.d_model)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=LM_ATOL, rtol=0)
