"""Serving the MoE, MLA and hybrid models: the reduced Mixtral-8x7B,
DeepSeek-V2-Lite and Jamba-v0.1 through the port's fleets and engine against
the JAX package's.  Synthetic fleets over the 3-D router / 4-D expert leaves
and the shared experts bit-equal; every delta format (dense, top-k, q8,
low-rank factored as ``(shape[0], rest)``) encoded as the reference encodes
it; greedy ``run_load`` with the reference engine's tokens and report
(capacity per slot, as its ``jax.vmap`` over the slots); admit, step and
dense-fleet token streams bit-identical; and ``python -m repro_torch.serve
--arch mixtral-8x7b --reduced``, the reference serving example's own run."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402

from repro import serve as J  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

MOE = ("mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
COSTS = (0.05, 0.01)  # fixed prefill / decode seconds
# low-rank products: float32 SVDs (LAPACK here, numpy's there) of the same
# residuals, within 1e-5 of 1 + max |product| (tests/test_torch_fleet.py)
LOWRANK_ATOL = 1e-5


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    """(JAX bundle, port bundle, JAX base params, port base params)."""
    jb = j_get_bundle(j_get_reduced(request.param))
    tb = get_bundle(get_reduced(request.param), "cpu")
    jbase = jb.init(jax.random.PRNGKey(0))
    return jb, tb, jbase, lm_params_from_jax(jax.tree.map(np.asarray, jbase), "cpu")


def _leaves_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), nest_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


def _delta_leaves(tree):
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _delta_leaves(tree[k])]
    if isinstance(tree, list):
        return [d for x in tree for d in _delta_leaves(x)]
    return [tree]


def _trace(M, n_agents, vocab, n=5, prompt_len=9, gen=5, seed=11):
    return M.make_requests(M.ArrivalProcess(rate=4.0), n, n_agents=n_agents, vocab_size=vocab,
                           prompt_len=prompt_len, max_new_tokens=gen, seed=seed)


def test_synthetic_fleet_bit_equal(pair):
    _, _, jbase, tbase = pair
    jf = J.FleetDelta.synthetic(jbase, 4, fraction=0.05, seed=3)
    tf = S.FleetDelta.synthetic(tbase, 4, fraction=0.05, seed=3)
    _leaves_equal(jf.deltas, tf.deltas)
    assert (tf.nbytes(), tf.naive_nbytes()) == (jf.nbytes(), jf.naive_nbytes())
    _leaves_equal(J.materialize(jf.base, jf.deltas, [2, 0]),
                  S.materialize(tf.base, tf.deltas, [2, 0]))
    shapes = [tuple(t.shape) for t in nest_leaves(tbase)]
    assert any(len(s) == 4 for s in shapes)  # (periods, experts, d_in, d_out)


@pytest.mark.parametrize("spec", ["dense", "topk:f=0.1", "topk:f=0.3,q8", "lowrank:r=2"])
def test_every_delta_format_encodes_as_the_reference(pair, spec):
    _, _, jbase, tbase = pair
    rng = np.random.default_rng(4)
    jstacked = jax.tree.map(
        lambda l: np.asarray(l)[None] + rng.normal(scale=0.01, size=(3,) + l.shape).astype(
            np.asarray(l).dtype), jbase)
    jf = J.FleetDelta.from_stacked(jstacked, J.DeltaSpec.parse(spec))
    tf = S.FleetDelta.from_stacked(lm_params_from_jax(jstacked, "cpu"), S.DeltaSpec.parse(spec))
    _leaves_equal(jf.base, tf.base)
    jd = jax.tree.leaves(jf.deltas, is_leaf=J.delta._is_delta)
    td = _delta_leaves(tf.deltas)
    assert [type(d).__name__ for d in jd] == [type(d).__name__ for d in td]
    for a, b in zip(jd, td):
        if type(b).__name__ == "LowRankDelta":  # factors are not unique: their products
            assert b.u.shape == a.u.shape and b.v.shape == a.v.shape
            want = np.einsum("nir,nrj->nij", np.asarray(a.u), np.asarray(a.v))
            got = torch.bmm(b.u, b.v).numpy()
            np.testing.assert_allclose(got, want, atol=LOWRANK_ATOL * (1 + np.abs(want).max()),
                                       rtol=0)
        else:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
    if spec.startswith("lowrank"):  # a 4-D expert leaf factored as (shape[0], rest)
        moe_pos = [p for p, leaf in tbase["layers"].items() if "router" in leaf.get("ffn", {})]
        assert moe_pos
        for p in moe_pos:
            shape = tuple(tbase["layers"][p]["ffn"]["w_up"].shape)
            up = tf.deltas["layers"][p]["ffn"]["w_up"]
            assert len(shape) == 4 and up.u.shape[1] == shape[0]
            assert up.v.shape[2] == int(np.prod(shape[1:]))


def test_greedy_run_load_matches_jax_engine(pair):
    jb, tb, jbase, tbase = pair
    jf = J.FleetDelta.synthetic(jbase, 5, seed=3)
    tf = S.FleetDelta.synthetic(tbase, 5, seed=3)
    vocab = tb.cfg.vocab_size
    jrep = J.run_load(J.ContinuousBatcher(J.DecodeEngine(jb, jf, n_slots=2, max_seq=40)),
                      _trace(J, 5, vocab), costs=J.StepCosts(*COSTS))
    trep = S.run_load(S.ContinuousBatcher(S.DecodeEngine(tb, tf, n_slots=2, max_seq=40)),
                      _trace(S, 5, vocab), costs=S.StepCosts(*COSTS))
    assert {r.rid: r.tokens for r in trep.requests} == {r.rid: r.tokens for r in jrep.requests}
    assert trep.to_dict() == jrep.to_dict()
    assert trep.total_tokens == 25


def test_admit_step_dense_bit_identical(pair):
    _, tb, _, tbase = pair
    fleet = S.FleetDelta.synthetic(tbase, 6, seed=9)
    vocab = tb.cfg.vocab_size

    def tokens(fl, mode):
        eng = S.DecodeEngine(tb, fl, n_slots=2, max_seq=40, materialize=mode)
        rep = S.run_load(S.ContinuousBatcher(eng), _trace(S, 6, vocab, seed=12),
                         costs=S.StepCosts(*COSTS))
        return {r.rid: list(r.tokens) for r in rep.requests}

    dense = tokens(S.materialize_fleet(fleet), "admit")
    assert sum(len(t) for t in dense.values()) == 25
    assert tokens(fleet, "admit") == dense
    assert tokens(fleet, "step") == dense


def test_cli_serves_the_reference_example_s_default_arch(capsys):
    """``examples/serve_decode.py`` defaults to mixtral-8x7b; its reduced
    run through the port's twin."""
    from repro_torch.serve.__main__ import main

    main(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu", "--agents", "3",
          "--requests", "3", "--gen", "3", "--prompt-len", "8", "--slots", "2"])
    out = capsys.readouterr().out
    assert "arch=mixtral-8x7b-reduced" in out and "served 3 requests / 9 tokens" in out
