"""Dynamic networks on the port (``TopologyProcess``, ``ParticipationProcess``,
the dynamic dense and sparse mixers) against the JAX package on the same
numpy inputs: host draws bit-equal, the per-round CSR weights against the
dense W_k, the masked and weighted server means, the plain versions of K3,
K4 and K5 over per-round weights against the Pallas kernels in interpret
mode, whole runs through both ``Experiment.run`` calls with equal bytes, and
the port's twins of ``tests/test_network.py`` and the dynamic cases of
``tests/test_sparse.py``."""
import dataclasses
import functools
import json
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_logreg import make_logreg_problem  # noqa: E402

from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.sparse_mix import sparse_compressed_mix as j_scm  # noqa: E402
from repro.kernels.sparse_mix import sparse_mix as j_sparse_mix  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro.utils import pytree as jtree  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.utils import pytree as ttree  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)

KINDS = ("static", "bernoulli:0.4", "matching", "roundrobin:2", "cohort:0.5")
NS = (1, 2, 3, 8, 16)
# Mixed outputs against the Pallas kernels (other summation orders):
# max |err| <= MIX_TOL * (1 + max |x|), as test_torch_sparse_compression.py.
# Whole runs: as test_torch_pisco.py (loss to 1e-5 relative per round;
# grad_sq and consensus error to 1e-3).
MIX_TOL = 1e-6
LOSS_RTOL = 1e-5
MEAN_TOL = 1e-6
# Deterministic rounding (q8d) may round a near-tie a step apart across
# frameworks: in pisco-sparse-cohort-q8d an idle agent's m/s sits 2.7e-5 of
# a step from a half-integer at round 4, where x differs by 6e-8 between the
# packages (float summation orders), and the two residuals land at +s/2 and
# -s/2; the run then parts by 2.5e-5 (tools/parity_readings.py).  That case
# alone holds four times its reading; every other case, q8d included, parts
# by at most 2.3e-7 and holds LOSS_RTOL.
TIED_LOSS_RTOL = {"pisco-sparse-cohort-q8d": 1e-4}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, x):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    assert err <= MIX_TOL * (1.0 + float(np.abs(x).max())), err


def _bases(pkg, sparse: bool, n: int):
    """A base topology of each package: a ring up to 3 agents; above, an
    Erdos-Renyi graph (dense) or a random 4-regular expander (sparse)."""
    if sparse:
        return (pkg.make_sparse_topology("ring", n) if n <= 3
                else pkg.make_sparse_topology("random_regular", n, seed=2))
    return (pkg.make_topology("ring", n) if n <= 3
            else pkg.make_topology("erdos_renyi", n, prob=0.4, seed=3))


# ---------------------------------------------------------------------------
# Host draws: bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", KINDS)
def test_host_draws_bit_equal(kind, sparse, n):
    jp = jtopo.make_topology_process(kind, _bases(jtopo, sparse, n), seed=5)
    tp = ttopo.make_topology_process(kind, _bases(ttopo, sparse, n), seed=5)
    assert tp.spec() == jp.spec() and tp.static == jp.static
    for k in range(6):
        jw, jmsg = jp.realize(k)
        tw, tmsg = tp.realize(k)
        np.testing.assert_array_equal(tw, jw)
        assert tmsg == jmsg == tp.messages_at(k)
        for a, b in zip(tp.realize_sparse(k), jp.realize_sparse(k)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tp.edges_at(k), jp.edges_at(k))
        np.testing.assert_array_equal(tp.edge_mask_at(k), jp.edge_mask_at(k))
    for a, b in zip(tp.draw_block(2, 7), jp.draw_block(2, 7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.draw_sparse_block(2, 7), jp.draw_sparse_block(2, 7)):
        np.testing.assert_array_equal(a, b)
    for frac in (0.3, 0.5, 1.0):
        jpp = jtopo.ParticipationProcess(n, frac, seed=9)
        tpp = ttopo.ParticipationProcess(n, frac, seed=9)
        assert tpp.m == jpp.m
        for k in range(4):
            np.testing.assert_array_equal(tpp.participants_at(k), jpp.participants_at(k))
            np.testing.assert_array_equal(tpp.server_matrix_at(k), jpp.server_matrix_at(k))
            np.testing.assert_array_equal(tpp.participant_mask_at(k), jpp.participant_mask_at(k))
        for a, b in zip(tpp.draw_block(1, 5), jpp.draw_block(1, 5)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tpp.draw_mask_block(1, 5), jpp.draw_mask_block(1, 5)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [None, "static", "bernoulli", "bernoulli:0.25", "matching",
                                  "roundrobin", "roundrobin:3", "cohort", "cohort:0.1"])
def test_parse_process_spec_matches_the_reference(spec):
    assert ttopo.parse_process_spec(spec) == jtopo.parse_process_spec(spec)


@pytest.mark.parametrize("spec", ["bernouli:0.3", "bernoulli:1.5", "matching:3", "roundrobin:0",
                                  "cohort:0", "cohort:1.5", "static:1"])
def test_parse_process_spec_errors_match_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jtopo.parse_process_spec(spec)
    with pytest.raises(ValueError) as got:
        ttopo.parse_process_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("participation", [1.0, 0.5])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_network_context_draws_equal_the_reference(sparse, participation):
    """The port's ``NetworkContext.draw_block`` is the reference's host draw
    array for array (the reference's server placeholder is None here)."""
    n = 8
    make_j = jmixing.make_sparse_network_mixing if sparse else jmixing.make_network_mixing
    make_t = tmixing.make_sparse_network_mixing if sparse else tmixing.make_network_mixing
    jnet = make_j(_bases(jtopo, sparse, n), "bernoulli:0.3", participation, seed=4).network
    tnet = make_t(_bases(ttopo, sparse, n), CPU, "bernoulli:0.3", participation, seed=4).network
    jd, td = jnet.draw_block(3, 9), tnet.draw_block(3, 9)
    if sparse:
        for key in ("edge_w", "self_w"):
            np.testing.assert_array_equal(td[0][key], jd[0][key])
    else:
        np.testing.assert_array_equal(td[0], jd[0])
    if participation == 1.0:
        assert td[1] is None and not np.any(jd[1])
    else:
        np.testing.assert_array_equal(td[1], jd[1])
    for a, b in zip(td[2:], jd[2:]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Per-round CSR weights: the permutation against the dense W_k
# ---------------------------------------------------------------------------


def _dense_from_csr(indptr, indices, data, self_w):
    n = len(self_w)
    w = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for e in range(indptr[i], indptr[i + 1]):
            w[i, indices[e]] += data[e]
    w[np.arange(n), np.arange(n)] += self_w
    return w


@pytest.mark.parametrize("kind", KINDS)
def test_csr_weights_are_the_rounds_dense_w(kind):
    """Round k's staged CSR operand (the directed weights permuted into the
    base CSR's order) is the dense W_k of the realization, entry for entry;
    a wrong permutation would still preserve the mean."""
    n = 16
    mixing = tmixing.make_sparse_network_mixing(
        ttopo.make_sparse_topology("random_regular", n, seed=2), CPU, kind, 0.5, seed=7)
    net = mixing.network
    proc = net.process
    operands, messages, participants = net.device_block(0, 6)
    x = _rand(1, n, 5)
    for i in range(6):
        net.stage(operands, i)
        csr = [t.numpy() for t in net.gossip_w]
        got = _dense_from_csr(*csr)
        edge_w, self_w, msgs = proc.realize_sparse(i)
        want = np.zeros((n, n))
        e = proc.base.edges
        want[e[:, 0], e[:, 1]] = edge_w
        want[e[:, 1], e[:, 0]] = edge_w
        want[np.arange(n), np.arange(n)] = self_w
        np.testing.assert_array_equal(got, want.astype(np.float32))
        np.testing.assert_allclose(got, proc.realize(i)[0], atol=1e-7)
        assert messages[i] == msgs == 2 * int((edge_w > 0).sum())
        out = mixing.gossip({"w": _t(x)})["w"].numpy()
        np.testing.assert_allclose(out, proc.realize(i)[0] @ x, atol=1e-6)
        mask = net.server_w.numpy()
        assert mask.sum() == participants[i] == 8
        np.testing.assert_array_equal(mask, net.participation.participant_mask_at(i))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["bernoulli:1.0", "matching", "roundrobin:4"])
def test_rounds_with_every_edge_dropped_are_the_identity(kind, n):
    """Where a round keeps no edge (self_w = 1, edge_w = 0), K4's and K5's
    plain versions and the dense W_k leave x exactly as it is; K5's EF form
    keeps its residual m - q."""
    x = _rand(n, n, 7) * 3.0
    sparse = tmixing.make_sparse_network_mixing(ttopo.make_sparse_topology("ring", n), CPU,
                                                kind, seed=1)
    dense = tmixing.make_network_mixing(ttopo.make_topology("ring", n), CPU, kind, seed=1)
    empty = [k for k in range(8) if sparse.network.process.messages_at(k) == 0]
    if kind == "bernoulli:1.0" or n == 1:
        assert empty == list(range(8))
    for net_mix in (sparse, dense):
        ops_, _, _ = net_mix.network.device_block(0, 8)
        for k in empty:
            net_mix.network.stage(ops_, k)
            np.testing.assert_array_equal(net_mix.gossip({"w": _t(x)})["w"].numpy(), x)
    ops_, _, _ = sparse.network.device_block(0, 8)
    for k in empty:
        sparse.network.stage(ops_, k)
        csr = sparse.network.gossip_w
        assert torch.equal(csr[3], torch.ones(n)) and not csr[2].any()
        out, res = ops.sparse_compressed_mix_csr(_t(x), None, *csr, ops.row_absmax(_t(x)), bits=8)
        np.testing.assert_array_equal(out.numpy(), x)
        r = _t(0.1 * _rand(5, n, 7))
        absmax = ops.row_absmax(_t(x), r)
        out, res = ops.sparse_compressed_mix_csr(_t(x), r, *csr, absmax, bits=8)
        np.testing.assert_array_equal(out.numpy(), x)
        assert torch.equal(res, ops.quant_codes(_t(x), absmax, bits=8, residual=r)[1])


# ---------------------------------------------------------------------------
# Masked and weighted server means
# ---------------------------------------------------------------------------


def test_masked_and_weighted_means_match_the_reference():
    n = 9
    tree = {"a": _rand(0, n, 3), "b": _rand(1, n, 2, 4)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: _t(v) for k, v in tree.items()}
    part = ttopo.ParticipationProcess(n, 0.4, seed=3)
    for k in range(3):
        mask = part.participant_mask_at(k)
        got = ttree.tree_agent_masked_mean(tt, _t(mask))
        want = jtree.tree_agent_masked_mean(jt, jnp.asarray(mask))
        s_k = part.server_matrix_at(k).astype(np.float32)
        for key in tree:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MEAN_TOL)
            dense = np.tensordot(s_k, tree[key], axes=(1, 0))
            np.testing.assert_allclose(got[key].numpy(), dense, atol=MEAN_TOL)
        w = mask / mask.sum()
        keep = 1.0 - mask
        got = ttree.tree_agent_weighted_mean(tt, _t(w), _t(keep))
        want = jtree.tree_agent_weighted_mean(jt, jnp.asarray(w), jnp.asarray(keep))
        for key in tree:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MEAN_TOL)


# ---------------------------------------------------------------------------
# K3, K4, K5 plain versions over per-round weights against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bernoulli:0.5", "cohort:0.25", "matching"])
def test_k4_k5_over_realized_weights_match_pallas(kind):
    n, d = 24, 37
    jt_ = jtopo.make_sparse_topology("random_regular", n, seed=2)
    jp = jtopo.make_topology_process(kind, jt_, seed=3)
    mixing = tmixing.make_sparse_network_mixing(
        ttopo.make_sparse_topology("random_regular", n, seed=2), CPU, kind, seed=3)
    net = mixing.network
    operands, _, _ = net.device_block(0, 3)
    e = jt_.edges
    s = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
    r = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
    for k in range(3):
        edge_w, self_w, _ = jp.realize_sparse(k)
        assert (edge_w == 0).any() or kind == "bernoulli:0.5"
        ew = np.concatenate([edge_w, edge_w]).astype(np.float32)
        sw = self_w.astype(np.float32)
        net.stage(operands, k)
        csr = net.gossip_w
        x = _rand(10 + k, n, d) * 2.0
        jk = j_sparse_mix(jnp.asarray(x), s, r, ew, sw, interpret=True)
        _close(ops.sparse_mix_csr(_t(x), *csr).numpy(), np.asarray(jk), x)
        for bits, gamma in ((8, 1.0), (4, 0.5)):
            jk = j_scm(jnp.asarray(x), s, r, ew, sw, bits=bits, gamma=gamma, interpret=True)
            out, _ = ops.sparse_compressed_mix_csr(_t(x), None, *csr, ops.row_absmax(_t(x)),
                                                   bits=bits, gamma=gamma)
            _close(out.numpy(), np.asarray(jk), x)


def test_k3_over_a_matching_w_matches_pallas():
    n, d = 10, 50
    proc = jtopo.make_topology_process("matching", jtopo.make_topology("ring", n), seed=2)
    for k in range(3):
        w = proc.realize(k)[0].astype(np.float32)
        x = _rand(3 + k, n, d)
        jk = jops.fused_compressed_mix(jnp.asarray(x), jnp.asarray(w), bits=8, interpret=True)
        out, r = ops.compressed_mix(_t(x), None, _t(w), ops.row_absmax(_t(x)), bits=8)
        assert r is None
        np.testing.assert_allclose(np.asarray(jk), out.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Whole runs through both packages
# ---------------------------------------------------------------------------

RUNS = {
    "pisco-dense-bern-part": dict(network="bernoulli:0.4", participation=0.6),
    "pisco-dense-matching-q8d": dict(network="matching", participation=0.6, compression="q8d"),
    "pisco-dense-rr-top": dict(network="roundrobin:2", compression="top0.1"),
    "pisco-sparse-bern-part": dict(network="bernoulli:0.4", participation=0.6, sparse=True),
    "pisco-sparse-cohort-q8d": dict(cohort=0.5, compression="q8d", sparse=True),
    "pisco-sparse-matching-top": dict(network="matching", participation=0.6,
                                      compression="top0.1", sparse=True),
    "pisco-dense-bern-loop": dict(network="bernoulli:0.4", participation=0.6, driver="loop"),
    "dsgt-dense-matching-part": dict(algo="dsgt", network="matching", participation=0.6),
    "dsgt-sparse-rr-q8d": dict(algo="dsgt", network="roundrobin:2", compression="q8d",
                               sparse=True),
    "gossip_pga-dense-bern-q8d": dict(algo="gossip_pga", network="bernoulli:0.4",
                                      participation=0.6, compression="q8d"),
    "gossip_pga-sparse-cohort-part": dict(algo="gossip_pga", cohort=0.5, participation=0.6,
                                          sparse=True),
}
# stochastic rounding draws from JAX PRNG in the reference and a torch
# generator here: bytes and flags equal, Lemma 1 held, losses not compared
STOCHASTIC = {
    "pisco-dense-bern-q8": dict(network="bernoulli:0.4", participation=0.6, compression="q8"),
    "pisco-sparse-cohort-q8": dict(cohort=0.5, compression="q8", sparse=True),
}


def _specs(**kw):
    base = dict(algo="pisco", n_agents=10, t_o=2, eta_l=0.3, p=0.3, seed=1, rounds=7,
                eval_every=3, block_size=3)
    base.update(kw)
    js = JSpec.create(**base)
    return js, ExperimentSpec.from_json(js.to_json())


def _run_both(js, ts):
    n = js.config.n_agents
    x, y = synthetic_a9a(1600, d=24, seed=0)
    jd, td = JData.from_arrays(x, y, n), FederatedDataset.from_arrays(x, y, n)
    xa, ya = jnp.asarray(jd.x_test), jnp.asarray(jd.y_test)
    xt, yt = torch.as_tensor(td.x_test), torch.as_tensor(td.y_test)
    jh = JExperiment(
        js, loss_fn=J_LOSS, params0={"w": jnp.zeros(24)},
        eval_fn=lambda p: {"test_loss": float(J_LOSS(p, (xa, ya)))},
        sampler_factory=lambda s: JSampler(jd, 16, s.config.t_o, s.config.seed),
    ).run()
    th = Experiment(
        ts, loss_fn=T_LOSS, params0={"w": np.zeros(24, np.float32)},
        eval_fn=lambda p: {"test_loss": float(T_LOSS(p, (xt, yt)))},
        sampler_factory=lambda s: RoundSampler(td, 16, s.config.t_o, s.config.seed, device=CPU),
        device=CPU,
    ).run()
    return jh, th


def _gt_gap(state) -> float:
    return max(float((state.y[k].mean(0) - state.g[k].mean(0)).abs().max()) for k in state.y)


@pytest.mark.parametrize("case", list(RUNS) + list(STOCHASTIC))
def test_whole_run_parity(case):
    js, ts = _specs(**(RUNS.get(case) or STOCHASTIC[case]))
    assert ts.to_json() == js.to_json()
    jh, th = _run_both(js, ts)
    assert th.is_global == [bool(f) for f in jh.is_global]
    assert any(th.is_global) or js.algo == "gossip_pga"
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert dataclasses.asdict(th.byte_model) == dataclasses.asdict(jh.byte_model)
    if case in STOCHASTIC:
        assert np.isfinite(th.loss).all() and _gt_gap(th.final_state) < 2e-5
        return
    rtol = TIED_LOSS_RTOL.get(case, LOSS_RTOL)
    assert np.isfinite(th.loss).all() and np.isfinite(jh.loss).all()
    np.testing.assert_allclose(th.loss, jh.loss, rtol=rtol)
    np.testing.assert_allclose(th.grad_sq_norm, jh.grad_sq_norm, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(th.consensus_err, jh.consensus_err, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose([m["test_loss"] for m in th.eval_metrics],
                               [m["test_loss"] for m in jh.eval_metrics], rtol=rtol)


# ---------------------------------------------------------------------------
# Twins of tests/test_network.py and the dynamic cases of tests/test_sparse.py
# ---------------------------------------------------------------------------

N_AGENTS = 5


def _experiment(spec, n=N_AGENTS, seeded=False):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=n)
    factory = ((lambda s: sampler_factory(s.config.t_o, seed=s.config.seed)) if seeded
               else (lambda s: sampler_factory(s.config.t_o)))
    return Experiment(spec, loss_fn=loss_fn, params0={"w": torch.zeros(d)},
                      sampler_factory=factory, device=CPU)


@pytest.mark.parametrize("compression", [None, "q8", "top0.3"])
@pytest.mark.parametrize("network", ["bernoulli:0.4", "matching"])
def test_gt_invariant_survives_sampled_links_and_compression(network, compression):
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.3, seed=2,
        network=network, participation=0.6, compression=compression,
        rounds=8, eval_every=4, driver="scan", block_size=3,
    )
    hist = _experiment(spec).run()
    assert np.isfinite(hist.loss).all()
    scale = max(1.0, float(hist.final_state.g["w"].mean(0).abs().max()))
    assert _gt_gap(hist.final_state) <= 2e-5 * scale


def test_realized_gossip_bytes_match_hand_computed_edge_count():
    """roundrobin:2 on a 4-ring realizes 2 of the 4 base edges a round: two
    mixes over 4 directed messages, not the static graph's 8."""
    n, rounds = 4, 4
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n, t_o=1, eta_l=0.1, p=0.0, seed=0,
        network="roundrobin:2", rounds=rounds, driver="scan", block_size=2,
    )
    hist = _experiment(spec, n=n).run()
    msg = 16 * 4
    per_round = 2 * (2 * 2) * msg
    assert hist.byte_model.gossip_message_bytes == msg
    assert hist.accountant.per_round_bytes == [per_round] * rounds
    assert hist.accountant.agent_to_agent_bytes == rounds * per_round
    assert hist.accountant.agent_to_server_bytes == 0
    assert hist.byte_model.gossip_round_bytes == 2 * per_round


def test_realized_server_bytes_price_sampled_participants():
    n, rounds = 4, 3
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n, t_o=1, eta_l=0.1, p=1.0, seed=0,
        network="static", participation=0.5, rounds=rounds, driver="scan", block_size=2,
    )
    hist = _experiment(spec, n=n).run()
    per_round = 2 * 2 * 2 * 16 * 4  # payloads x 2 dirs x m participants x message
    assert hist.accountant.per_round_bytes == [per_round] * rounds
    assert hist.accountant.agent_to_server_bytes == rounds * per_round
    assert hist.byte_model.server_round_bytes == 2 * per_round


def test_joint_compression_dynamic_participation_bytes_hand_counted():
    """q8 gossip x roundrobin:2 x m-of-n participation, hand-counted:
    gossip 2 mixes x 4 directed x 20 B = 160 B; server 2 payloads x 2 dirs
    x 2 participants x 64 B = 512 B; equal under the loop driver."""
    n, rounds = 4, 6
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n, t_o=1, eta_l=0.1, p=0.5, seed=3,
        network="roundrobin:2", participation=0.5, compression="q8",
        rounds=rounds, driver="scan", block_size=2,
    )
    hist = _experiment(spec, n=n).run()
    assert hist.byte_model.gossip_message_bytes == 20
    assert hist.byte_model.server_message_bytes == 64
    expected = [512 if g else 160 for g in hist.is_global]
    assert hist.accountant.per_round_bytes == expected
    assert 0 < sum(hist.is_global) < rounds
    loop = _experiment(spec.replace(driver="loop"), n=n).run()
    assert loop.accountant.per_round_bytes == expected


def test_static_process_bytes_and_losses_match_legacy_dense_path():
    """network='static' runs through the dynamic machinery and realizes the
    base W every round: bit-equal to the frozen-W path on the CPU."""
    base_kw = dict(algo="dsgt", n_agents=N_AGENTS, t_o=1, eta_l=0.1, p=0.3, seed=1,
                   rounds=7, driver="scan", block_size=3)
    h_legacy = _experiment(ExperimentSpec.create(**base_kw)).run()
    h_static = _experiment(ExperimentSpec.create(network="static", **base_kw)).run()
    assert h_legacy.is_global == h_static.is_global
    assert h_legacy.accountant.per_round_bytes == h_static.accountant.per_round_bytes
    assert h_legacy.loss == h_static.loss
    for sparse in (False, True):
        kw = dict(base_kw, algo="pisco", sparse=sparse, compression="q8d")
        a = _experiment(ExperimentSpec.create(**kw)).run()
        b = _experiment(ExperimentSpec.create(network="static", **kw)).run()
        assert a.loss == b.loss and a.accountant.per_round_bytes == b.accountant.per_round_bytes


def test_network_spec_round_trips_and_reproduces_history_exactly():
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.15, p=0.3, seed=5,
        network="bernoulli:0.35", participation=0.6, rounds=8, eval_every=4, block_size=3,
    )
    copies = [ExperimentSpec.from_dict(spec.to_dict()), ExperimentSpec.from_json(spec.to_json()),
              pickle.loads(pickle.dumps(spec))]
    assert all(c == spec for c in copies)
    payload = json.loads(spec.to_json())
    assert payload["network"] == "bernoulli:0.35" and payload["participation"] == 0.6
    for driver in ("loop", "scan"):
        ref = _experiment(spec.replace(driver=driver)).run()
        for c in copies:
            rerun = _experiment(c.replace(driver=driver)).run()
            assert rerun.is_global == ref.is_global and rerun.loss == ref.loss
            assert rerun.grad_sq_norm == ref.grad_sq_norm
            assert rerun.accountant.per_round_bytes == ref.accountant.per_round_bytes


def test_sweep_seeds_threads_dynamic_network_operands():
    """Every seed of a sweep sees the same realized network (the draws are
    the spec's); the seed whose sampler matches a solo run reproduces it."""
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=4, t_o=1, eta_l=0.1, p=0.4, seed=0,
        network="matching", participation=0.5, rounds=6, driver="scan", block_size=3,
    )
    swept = _experiment(spec, n=4, seeded=True).sweep(seeds=[0, 1])
    solo = _experiment(spec, n=4, seeded=True).run()
    assert swept[0].is_global == solo.is_global and swept[0].loss == solo.loss
    for hist in swept:
        assert len(hist.loss) == 6 and np.isfinite(hist.loss).all()
        assert hist.accountant.per_round_bytes == solo.accountant.per_round_bytes
    assert swept[0].loss != swept[1].loss


def test_participation_validation():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="participation"):
            ExperimentSpec.create(algo="pisco", n_agents=4, participation=bad)


def test_network_spec_validated_at_construction():
    with pytest.raises(ValueError, match="unknown topology process"):
        ExperimentSpec.create(algo="pisco", n_agents=4, network="bernouli:0.3")
    with pytest.raises(ValueError, match="failure prob"):
        ExperimentSpec.create(algo="pisco", n_agents=4, network="bernoulli:1.5")
    with pytest.raises(ValueError, match="takes no argument"):
        ExperimentSpec.create(algo="pisco", n_agents=4, network="matching:3")


def test_old_spec_payloads_still_load():
    spec = ExperimentSpec.create(algo="dsgd", n_agents=4, p=0.0, rounds=5)
    d = spec.to_dict()
    d.pop("network")
    d.pop("participation")
    old = ExperimentSpec.from_dict(d)
    assert old.network is None and old.participation == 1.0 and old == spec


@pytest.mark.parametrize("network", [None, "bernoulli:0.4", "cohort:0.5"])
def test_sparse_experiment_spec_matches_dense(network):
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.3, seed=2,
        network=network, rounds=6, driver="scan", block_size=3,
    )
    hd = _experiment(spec.replace(sparse=False)).run()
    hs = _experiment(spec.replace(sparse=True)).run()
    np.testing.assert_allclose(hd.loss, hs.loss, rtol=1e-5, atol=1e-6)
    assert hd.accountant.per_round_bytes == hs.accountant.per_round_bytes


@pytest.mark.parametrize("compression", ["q8", "top0.3"])
@pytest.mark.parametrize("network", ["bernoulli:0.4", "cohort:0.5"])
def test_gt_invariant_on_sparse_path(network, compression):
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=N_AGENTS, t_o=2, eta_l=0.1, p=0.3, seed=2,
        network=network, participation=0.6, compression=compression,
        sparse=True, rounds=8, eval_every=4, driver="scan", block_size=3,
    )
    hist = _experiment(spec).run()
    assert np.isfinite(hist.loss).all()
    scale = max(1.0, float(hist.final_state.g["w"].mean(0).abs().max()))
    assert _gt_gap(hist.final_state) <= 2e-5 * scale


def test_sparse_realized_gossip_bytes_match_hand_count():
    n, rounds = 4, 4
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=n, t_o=1, eta_l=0.1, p=0.0, seed=0,
        network="roundrobin:2", sparse=True, rounds=rounds, driver="scan", block_size=2,
    )
    hist = _experiment(spec, n=n).run()
    per_round = 2 * (2 * 2) * 16 * 4
    assert hist.accountant.per_round_bytes == [per_round] * rounds
    dense = _experiment(spec.replace(sparse=False), n=n).run()
    assert dense.accountant.per_round_bytes == hist.accountant.per_round_bytes


def test_cohort_field_expands_to_network_spec():
    spec = ExperimentSpec.create(algo="pisco", n_agents=8, t_o=1, eta_l=0.1, p=0.3,
                                 cohort=0.25, rounds=2)
    assert spec.effective_network == "cohort:0.25"
    assert spec.make_mixing(CPU).network.process.spec() == "cohort:0.25"
    with pytest.raises(ValueError, match="cohort"):
        ExperimentSpec.create(algo="pisco", n_agents=8, t_o=1, eta_l=0.1, p=0.3,
                              cohort=0.25, network="static", rounds=2)


def test_cohort_process_edges_are_seed_incident():
    proc = ttopo.make_topology_process("cohort:0.5", ttopo.make_sparse_topology("ring", 8), seed=1)
    for k in range(4):
        seeds = set(proc.seeds_at(k))
        assert len(seeds) == 4
        for i, j in proc.edges_at(k):
            assert i in seeds or j in seeds


def test_spec_json_round_trip_and_legacy_payload():
    spec = ExperimentSpec.create(algo="pisco", n_agents=2048, t_o=2, eta_l=0.1, p=0.1,
                                 sparse=True, cohort=0.25, rounds=4)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert JSpec.from_json(spec.to_json()).effective_network == spec.effective_network
    legacy = json.loads(spec.to_json())
    del legacy["sparse"], legacy["cohort"]
    old = ExperimentSpec.from_dict(legacy)
    assert old.sparse is None and old.cohort is None and old.effective_network == old.network


def test_dynamic_mixers_compose_with_compression():
    """compress_mixing over a dynamic base reads the round's operand that
    the driver staged, at each call: K3's W_k densely, K5's CSR sparsely."""
    for sparse in (False, True):
        spec = ExperimentSpec.create(n_agents=6, sparse=sparse, network="matching",
                                     compression="q8d")
        mixing = spec.make_mixing(CPU)
        cg = mixing.compression
        assert cg.base_gossip is None and (cg.w is None) == sparse and (cg.csr is None) != sparse
        ops_, _, _ = mixing.network.device_block(0, 2)
        for i in (1, 0):
            mixing.network.stage(ops_, i)
            w, csr = cg._operands()
            staged = mixing.network.gossip_w
            assert (csr is staged and w is None) if sparse else (w is staged and csr is None)


# ---------------------------------------------------------------------------
# The fig_dynamic twin against benchmarks/fig_dynamic.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logreg_quick():
    from benchmarks import common as jbench
    from repro_torch.figures import common as tbench

    return jbench.make_logreg_workload(quick=True, seed=0), tbench.make_logreg_workload(
        quick=True, seed=0, device=CPU)


@pytest.mark.parametrize("topo,q,frac", [("ring", 0.4, 0.5), ("ring", 0.0, 1.0),
                                         ("full", 0.3, 0.5)])
def test_fig_dynamic_quick_cell_matches_reference(logreg_quick, topo, q, frac):
    """One cell of the quick sweep (150 rounds) through both packages'
    ``run_pisco_variant``: flags and realized bytes equal round by round,
    the eval series within 1e-4 relative (as tests/test_torch_figures.py;
    1e-7 absolute near the optimum), the
    readout equal to the reference's ``_cell_readout`` but for the final
    gradient norm (1e-5)."""
    from benchmarks import common as jbench
    from benchmarks import fig_dynamic as jfig
    from repro_torch.figures import common as tbench
    from repro_torch.figures import fig_dynamic as tfig

    (jdata, jloss, jeval, jp0), (tdata, tloss, teval, tp0) = logreg_quick
    kw = dict(topology_name=topo, p=0.1, t_o=1, eta_l=0.5, rounds=150, seed=0,
              **tfig.cell_spec(q, frac))
    jh, _ = jbench.run_pisco_variant(data=jdata, loss_fn=jloss, eval_fn=jeval, params0=jp0, **kw)
    th, _ = tbench.run_pisco_variant(data=tdata, loss_fn=tloss, eval_fn=teval, params0=tp0,
                                     device=CPU, **kw)
    assert th.is_global == jh.is_global
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    # near the optimum the full-data gradient is small and its relative
    # error grows as it shrinks: a floor of 1e-7 (the series starts at ~2e-2)
    np.testing.assert_allclose([m["grad_sq"] for m in th.eval_metrics],
                               [m["grad_sq"] for m in jh.eval_metrics], rtol=1e-4, atol=1e-7)
    got, want = tfig.cell_readout(th, tfig.GRAD_TARGET), jfig._cell_readout(jh, tfig.GRAD_TARGET)
    np.testing.assert_allclose(got.pop("final_grad_sq"), want.pop("final_grad_sq"), rtol=1e-5)
    assert got == want


def test_fig_dynamic_derived_readout_matches_reference():
    from benchmarks import fig_dynamic as jfig
    from repro_torch.figures import fig_dynamic as tfig

    cells = {f"topo=ring,q={q:.2f},part={f:.2f}": {"server_bytes": b}
             for (q, f, b) in ((0.0, 1.0, 800), (0.0, 0.5, 400), (0.3, 1.0, 900),
                               (0.3, 0.5, 300), (0.6, 1.0, 0), (0.6, 0.5, 0))}
    assert tfig.participation_byte_savings(cells) == jfig.participation_byte_savings(cells) == 3.0
    assert tfig.participation_byte_savings({}) is jfig.participation_byte_savings({}) is None
    assert tfig.CSV_FIELDS == jfig.CSV_FIELDS
    assert (tfig.FAILURE_GRID, tfig.PARTICIPATION_GRID, tfig.TOPOLOGIES) == \
        (jfig.FAILURE_GRID, jfig.PARTICIPATION_GRID, jfig.TOPOLOGIES)
