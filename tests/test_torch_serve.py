"""The port's serving path against the JAX package: synthetic fleets and
request traces bit-equal to the reference's, greedy serving through the
engine and the batcher with the same tokens and the same report, the
admit / step / dense bit-identity, and the properties of temperature
sampling (whose bits cannot match JAX's PRNG)."""
import dataclasses

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
from repro_torch.serve.batcher import request_generator  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

MODELS = ("qwen3-8b", "mamba2-370m")
COSTS = (0.05, 0.01)  # fixed prefill / decode seconds


@pytest.fixture(scope="module", params=MODELS)
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


def _trace(M, n_agents, vocab, n=5, prompt_len=9, gen=5, seed=11):
    return M.make_requests(M.ArrivalProcess(rate=4.0), n, n_agents=n_agents, vocab_size=vocab,
                           prompt_len=prompt_len, max_new_tokens=gen, seed=seed)


# ---------------------------------------------------------------------------
# Fleets and traces: bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [0.02, 0.5])
def test_synthetic_fleet_bit_equal(pair, fraction):
    _, _, jbase, tbase = pair
    jf = J.FleetDelta.synthetic(jbase, 4, fraction=fraction, seed=3)
    tf = S.FleetDelta.synthetic(tbase, 4, fraction=fraction, seed=3)
    _leaves_equal(jf.deltas, tf.deltas)
    assert (tf.nbytes(), tf.naive_nbytes(), tf.spec.name) == (jf.nbytes(), jf.naive_nbytes(),
                                                              jf.spec.name)
    _leaves_equal(J.materialize(jf.base, jf.deltas, [2, 0]),
                  S.materialize(tf.base, tf.deltas, [2, 0]))


@pytest.mark.parametrize("spec", ["dense", "topk:f=0.1", "topk:f=0.3,q8", "topk:f=1"])
def test_from_stacked_payloads_equal(pair, spec):
    _, _, jbase, tbase = pair
    rng = np.random.default_rng(4)
    jstacked = jax.tree.map(
        lambda l: np.asarray(l)[None] + rng.normal(scale=0.01, size=(3,) + l.shape).astype(
            np.asarray(l).dtype), jbase)
    tstacked = lm_params_from_jax(jstacked, "cpu")
    jf = J.FleetDelta.from_stacked(jstacked, J.DeltaSpec.parse(spec))
    tf = S.FleetDelta.from_stacked(tstacked, S.DeltaSpec.parse(spec))
    _leaves_equal(jf.base, tf.base)
    _leaves_equal(jf.deltas, tf.deltas)
    _leaves_equal(J.materialize(jf.base, jf.deltas), S.materialize(tf.base, tf.deltas))


@pytest.mark.parametrize("arrival", ["poisson:rate=4", "bursty:rate=2,burst=3"])
def test_make_requests_bit_equal(arrival):
    kw = dict(n_agents=7, vocab_size=512, prompt_len=13, max_new_tokens=4, eos_id=3, seed=9)
    jr = J.make_requests(J.ArrivalProcess.parse(arrival), 10, **kw)
    tr = S.make_requests(S.ArrivalProcess.parse(arrival), 10, **kw)
    assert S.ArrivalProcess.parse(arrival).name == J.ArrivalProcess.parse(arrival).name
    for a, b in zip(jr, tr):
        assert (a.rid, a.agent_id, a.arrival_s, a.max_new_tokens, a.eos_id) == (
            b.rid, b.agent_id, b.arrival_s, b.max_new_tokens, b.eos_id)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype


def test_spec_grammar_and_refusals():
    assert S.DeltaSpec.parse("topk:f=0.05,q8").name == J.DeltaSpec.parse("topk:f=0.05,q8").name
    for bad in ("sparse", "topk:g=1", "dense,q8"):
        with pytest.raises(ValueError):
            S.DeltaSpec.parse(bad)
    with pytest.raises(NotImplementedError, match="A15"):
        S.DeltaSpec.parse("lowrank:r=4")
    with pytest.raises(ValueError):
        S.ArrivalProcess.parse("uniform:rate=1")


# ---------------------------------------------------------------------------
# Greedy serving: the reference's tokens and report
# ---------------------------------------------------------------------------


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
    """The port of the reference's engine pin (tests/test_serve.py:262)."""
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
    assert tokens(S.materialize_fleet(fleet), "step") == dense


def test_engine_slot_buffer_holds_the_agent_and_rejects_bad_inputs(pair):
    _, tb, _, tbase = pair
    fleet = S.FleetDelta.synthetic(tbase, 3, seed=1)
    eng = S.DecodeEngine(tb, fleet, n_slots=2, max_seq=16)
    eng.admit(1, 2, np.arange(5))
    want = fleet.gather([2])
    for a, b in zip(nest_leaves(want), nest_leaves(eng.slot_params)):
        assert torch.equal(a[0], b[1])
    assert int(eng.cache["pos"][1]) == 5 and int(eng.cache["pos"][0]) == 0
    with pytest.raises(ValueError):
        S.DecodeEngine(tb, fleet, materialize="eager")
    with pytest.raises(TypeError):
        S.DecodeEngine(tb, {"not": "a fleet"})
    enc_dec = dataclasses.replace(tb.cfg, is_enc_dec=True)
    with pytest.raises(ValueError):
        S.DecodeEngine(dataclasses.replace(tb, cfg=enc_dec), fleet)


# ---------------------------------------------------------------------------
# Temperature sampling: properties, not bits
# ---------------------------------------------------------------------------


class _Engine:
    n_slots = 2


def test_sampling_streams_are_pure_and_domain_separated():
    draws = lambda seed, rid: torch.rand(8, generator=request_generator(seed, rid))  # noqa: E731
    assert torch.equal(draws(0, 5), draws(0, 5))
    assert not torch.equal(draws(0, 5), draws(0, 6))
    assert not torch.equal(draws(0, 5), draws(1, 5))
    # a request's tokens do not depend on which other requests were sampled
    logits = np.random.default_rng(0).normal(size=64).astype(np.float32)

    def tokens(rids):
        b = S.ContinuousBatcher(_Engine(), temperature=1.0, seed=3)
        reqs = {rid: S.Request(rid=rid, agent_id=0, prompt=np.zeros(1), max_new_tokens=99)
                for rid in rids}
        out = {rid: [] for rid in rids}
        for _ in range(6):
            for rid in rids:
                t = b._sample(reqs[rid], logits)
                reqs[rid].tokens.append(t)
                out[rid].append(t)
        return out

    assert tokens([4])[4] == tokens([1, 4, 7])[4]


def test_sampling_distribution_and_greedy_limit():
    logits = np.log(np.array([0.5, 0.3, 0.15, 0.05], np.float32))
    b = S.ContinuousBatcher(_Engine(), temperature=1.0, seed=0)
    counts = np.zeros(4)
    for rid in range(4000):
        counts[b._sample(S.Request(rid=rid, agent_id=0, prompt=np.zeros(1), max_new_tokens=1),
                         logits)] += 1
    # four-sigma binomial bounds around the softmax probabilities
    p = np.exp(logits) / np.exp(logits).sum()
    assert np.all(np.abs(counts / 4000 - p) <= 4 * np.sqrt(p * (1 - p) / 4000))
    cold = S.ContinuousBatcher(_Engine(), temperature=1e-3, seed=0)
    req = S.Request(rid=0, agent_id=0, prompt=np.zeros(1), max_new_tokens=1)
    assert all(cold._sample(req, logits) == 0 for _ in range(20))
    greedy = S.ContinuousBatcher(_Engine(), seed=0)
    assert greedy._sample(req, logits) == 0


def test_cli_serves_a_reduced_model(capsys):
    from repro_torch.serve.__main__ import main

    main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu", "--agents", "3",
          "--requests", "3", "--gen", "3", "--prompt-len", "8", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
