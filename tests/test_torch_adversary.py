"""Byzantine agents and robust server rules on the port
(``repro_torch.core.adversary``, the robust rules of
``repro_torch.utils.pytree``) against the JAX package on the same numpy
inputs, and the port's twins of ``tests/test_adversary.py``.

Tolerances:

* masks, the sign-flip corruption, the median (even and odd n) and Krum's
  selection and broadcast are held **bit for bit**; the trimmed mean within
  rtol 1e-6 (another summation order);
* whole runs under ``signflip``, and under ``collusion`` with the
  reference's direction put in place of the port's draw
  (:meth:`AdversaryProcess.collusion_direction`): losses and the per-group
  eval within LOSS_RTOL = 1e-5 per round, q8d within Q8D_LOSS_RTOL = 1e-4
  (a near-tie of the int8 grid may round a step apart across frameworks);
  flags, bytes and ``sim_time_s`` equal, round by round;
* ``random`` draws its noise from torch generators, the reference from JAX
  PRNG: held to properties (pure in (seed, k), the same under the loop,
  block and events drivers, honest rows untouched);
* the sign flip folded into W or the CSR against the written-out
  ``W corrupt(q)``: MIX_TOL (1e-6 of 1 + max |x|, another summation order).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_adversary import ref_collusion_direction  # noqa: E402
from _torch_logreg import make_logreg_problem  # noqa: E402
from repro.core import Experiment as JExperiment, ExperimentSpec as JSpec  # noqa: E402
from repro.core import adversary as jadv  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import FederatedDataset as JData, RoundSampler as JSampler  # noqa: E402
from repro.data.synthetic import synthetic_a9a  # noqa: E402
from repro.models import simple as jm  # noqa: E402
from repro.utils import pytree as jtree  # noqa: E402
from repro_torch.core import Experiment, ExperimentSpec, PiscoConfig  # noqa: E402
from repro_torch.core import adversary as tadv  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.adversary import (  # noqa: E402
    AdversarialNetwork,
    AdversaryProcess,
    adversary_mask,
    make_adversarial_mixing,
    parse_adversary_spec,
    unwrap_network,
)
from repro_torch.core.compression import compress_mixing, make_compressor  # noqa: E402
from repro_torch.core.mixing import make_robust_agg, parse_robust_spec  # noqa: E402
from repro_torch.core.pisco import init_state, make_round_fn, replicate_params  # noqa: E402
from repro_torch.data import FederatedDataset, RoundSampler  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import simple as tm  # noqa: E402
from repro_torch.utils import pytree as ttree  # noqa: E402

CPU = torch.device("cpu")
J_LOSS = functools.partial(jm.logreg_loss, rho=0.01)
T_LOSS = functools.partial(tm.logreg_loss, rho=0.01)
LOSS_RTOL = 1e-5
Q8D_LOSS_RTOL = 1e-4
MIX_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _col(values):
    """(n, 1) float32 single-leaf fleet from a value-per-agent list."""
    return {"w": torch.tensor(values, dtype=torch.float32).reshape(-1, 1)}


def _fleet(seed, n, *shapes):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.normal(size=(n,) + s).astype(np.float32) for i, s in enumerate(shapes)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()}, {k: _t(v) for k, v in tree.items()})


@pytest.fixture
def ref_direction(monkeypatch):
    monkeypatch.setattr(AdversaryProcess, "collusion_direction", ref_collusion_direction)


# ---------------------------------------------------------------------------
# The robust rules against the reference
# ---------------------------------------------------------------------------

ROBUST_SHAPES = ((3,), (2, 5))


@pytest.mark.parametrize("n", [4, 5, 16, 17])
def test_median_bit_equal_at_even_and_odd_n(n):
    jt, tt = _both(_fleet(n, n, *ROBUST_SHAPES))
    want, got = jtree.tree_agent_median(jt), ttree.tree_agent_median(tt)
    for k in tt:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # not torch.median, whose even-n median is the lower middle value
    if n % 2 == 0:
        assert not torch.equal(got["l0"][0], torch.median(tt["l0"], dim=0).values)


@pytest.mark.parametrize("n,trim", [(5, 1), (16, 4), (17, 0), (9, 3)])
def test_trimmed_mean_matches_reference(n, trim):
    jt, tt = _both(_fleet(n + 100, n, *ROBUST_SHAPES))
    want, got = jtree.tree_agent_trimmed_mean(jt, trim), ttree.tree_agent_trimmed_mean(tt, trim)
    for k in tt:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
        assert got[k].is_contiguous() and got[k].shape == tt[k].shape


@pytest.mark.parametrize("n,n_byz", [(6, 2), (16, 4), (9, 1), (3, 2)])
def test_krum_index_and_broadcast_match_reference(n, n_byz):
    jt, tt = _both(_fleet(n + 200, n, *ROBUST_SHAPES))
    want, got = jtree.tree_agent_krum(jt, n_byz), ttree.tree_agent_krum(tt, n_byz)
    sel = int(torch.argmin(ttree.krum_scores(tt, n_byz)))
    for k in tt:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k][0].numpy(), tt[k][sel].numpy())


def test_robust_rules_keep_the_leaf_dtype():
    x = {"w": torch.randn(6, 4).to(torch.bfloat16)}
    for rule in ("trimmed", "median", "krum"):
        out = make_robust_agg(rule, 6)(x)
        assert out["w"].dtype == torch.bfloat16 and out["w"].shape == (6, 4)


# ---------------------------------------------------------------------------
# Twins of tests/test_adversary.py: hand pins of the robust primitives
# ---------------------------------------------------------------------------


def test_trimmed_mean_hand_pin():
    fleet = _col([1.0, 2.0, 3.0, 4.0, 100.0])
    np.testing.assert_allclose(ttree.tree_agent_trimmed_mean(fleet, trim=1)["w"].numpy(), 3.0)
    np.testing.assert_allclose(ttree.tree_agent_trimmed_mean(fleet, trim=0)["w"].numpy(),
                               ttree.tree_agent_mean(fleet)["w"].numpy(), rtol=1e-7)


def test_trimmed_mean_is_coordinatewise():
    x = torch.tensor([[0.0, 5.0], [1.0, 6.0], [2.0, 7.0], [99.0, -99.0]])
    out = ttree.tree_agent_trimmed_mean({"w": x}, trim=1)["w"]
    np.testing.assert_allclose(out[0].numpy(), [1.5, 5.5])


def test_median_hand_pin():
    np.testing.assert_allclose(ttree.tree_agent_median(_col([1.0, 2.0, 3.0, 4.0, 100.0]))["w"],
                               3.0)
    np.testing.assert_allclose(ttree.tree_agent_median(_col([1.0, 2.0, 3.0, 10.0]))["w"], 2.5)


def test_krum_hand_pin():
    # agents at 2 and 3 tie on score 2; argmin takes the first (agent 1)
    out = ttree.tree_agent_krum(_col([1.0, 2.0, 3.0, 4.0, 100.0]), n_byz=1)
    np.testing.assert_allclose(out["w"].numpy(), 2.0)


def test_krum_distance_sums_across_leaves():
    fleet = {"a": torch.tensor([1.0, 2.0, 3.0, 4.0, 100.0]).reshape(-1, 1),
             "b": torch.tensor([0.0, 10.0, 0.0, 0.0, 0.0]).reshape(-1, 1)}
    out = ttree.tree_agent_krum(fleet, n_byz=1)
    np.testing.assert_allclose(out["a"].numpy(), 3.0)
    np.testing.assert_allclose(out["b"].numpy(), 0.0)


def test_krum_returns_an_actual_submission():
    rows = torch.as_tensor(np.random.default_rng(3).normal(size=(6, 4)), dtype=torch.float32)
    out = ttree.tree_agent_krum({"w": rows}, n_byz=2)["w"]
    assert any(torch.equal(out[0], rows[i]) for i in range(6))


@pytest.mark.parametrize("n,seed", [(5, 0), (8, 100), (12, 200), (7, 3), (11, 57)])
def test_trimmed_mean_survives_signflip_minority(n, seed):
    rng = np.random.default_rng(seed)
    n_byz = int(rng.integers(1, (n - 1) // 2 + 1))
    c = 5.0
    honest = c + rng.normal(size=(n, 3)) * 0.05
    byz = rng.choice(n, size=n_byz, replace=False)
    values = honest.copy()
    values[byz] = -honest[byz]
    honest_mean = honest[np.setdiff1d(np.arange(n), byz)].mean(axis=0)
    fleet = {"w": torch.as_tensor(values, dtype=torch.float32)}
    trimmed = ttree.tree_agent_trimmed_mean(fleet, trim=n_byz)["w"][0].numpy()
    median = ttree.tree_agent_median(fleet)["w"][0].numpy()
    mean = ttree.tree_agent_mean(fleet)["w"][0].numpy()
    assert np.max(np.abs(trimmed - honest_mean)) < 0.5
    assert np.max(np.abs(median - honest_mean)) < 0.5
    assert np.max(np.abs(mean - honest_mean)) > 2.0 * c * n_byz / n - 0.5


# ---------------------------------------------------------------------------
# Spec grammars, against the reference's parsers
# ---------------------------------------------------------------------------


def test_parse_adversary_spec_grammar():
    adv = parse_adversary_spec("signflip:f=0.25", n_agents=8, seed=3)
    assert (adv.kind, adv.f, adv.n_byz) == ("signflip", 0.25, 2)
    adv = parse_adversary_spec("random:f=0.1,scale=5", n_agents=10)
    assert (adv.kind, adv.scale, adv.needs_round) == ("random", 5.0, True)
    adv = parse_adversary_spec("collusion:f=0.25,target=drift", n_agents=8)
    assert adv.spec() == "collusion:f=0.25,target=drift"
    for s in ("signflip:f=0.2", "random:f=0.3,scale=2", "collusion:f=0.25"):
        adv = parse_adversary_spec(s, n_agents=8)
        assert parse_adversary_spec(adv.spec(), n_agents=8) == adv
        assert dataclasses.asdict(adv) == dataclasses.asdict(
            jadv.parse_adversary_spec(s, n_agents=8))


@pytest.mark.parametrize("bad", [
    "omniscient:f=0.2", "signflip:frac=0.2", "signflip:f=0", "signflip:f=1.0",
    "collusion:f=0.2,target=mean",
])
def test_parse_adversary_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_adversary_spec(bad, n_agents=8)
    with pytest.raises(ValueError):
        jadv.parse_adversary_spec(bad, n_agents=8)


def test_adversary_needs_one_honest_agent():
    with pytest.raises(ValueError):
        AdversaryProcess(kind="signflip", f=0.9, n_agents=2)


def test_parse_robust_spec():
    for s in ("trimmed:f=0.3", "median", "krum", "krum:f=0.1", "mean"):
        assert parse_robust_spec(s) == jmixing.parse_robust_spec(s)
    assert make_robust_agg("mean", 8) is None
    for bad in ("huber", "median:f=0.1", "trimmed:g=0.1", "trimmed:f=0.6"):
        with pytest.raises(ValueError):
            parse_robust_spec(bad)
    with pytest.raises(ValueError):
        make_robust_agg("trimmed:f=0.45", 4)


# ---------------------------------------------------------------------------
# The adversary process: masks and corruption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,f,seed", [(16, 0.2, 4), (10, 0.1, 0), (512, 0.25, 7),
                                      (10000, 0.2, 0), (7, 0.5, 123)])
def test_masks_bit_equal_to_reference(n, f, seed):
    spec = f"signflip:f={f}"
    assert adversary_mask(spec, n, seed) == jadv.adversary_mask(spec, n, seed)


def test_mask_pure_in_seed():
    a = AdversaryProcess(kind="signflip", f=0.2, n_agents=16, seed=4)
    np.testing.assert_array_equal(a.mask(), a.mask())
    assert int(a.mask().sum()) == a.n_byz == 4
    b = AdversaryProcess(kind="signflip", f=0.2, n_agents=16, seed=5)
    assert not np.array_equal(a.mask(), b.mask())
    assert adversary_mask(None, 16) is None
    assert adversary_mask("signflip:f=0.2", 16, seed=4) == list(a.mask())


def test_signflip_corruption_rows():
    adv = AdversaryProcess(kind="signflip", f=0.25, scale=2.0, n_agents=8)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    got = adv.make_corrupt()({"w": _t(x)})["w"].numpy()
    want = np.asarray(jadv.AdversaryProcess(kind="signflip", f=0.25, scale=2.0, n_agents=8)
                      .make_corrupt()({"w": jnp.asarray(x)}, None)["w"])
    np.testing.assert_array_equal(got, want)
    mask = adv.mask()
    np.testing.assert_array_equal(got[~mask], x[~mask])
    np.testing.assert_array_equal(got[mask], -2.0 * x[mask])


def test_random_corruption_pure_in_seed_and_round():
    adv = AdversaryProcess(kind="random", f=0.25, n_agents=8, seed=9)
    tree = {"a": torch.ones(8, 3), "b": torch.ones(8, 2, 2)}
    c1 = adv.make_corrupt()
    c2 = AdversaryProcess(kind="random", f=0.25, n_agents=8, seed=9).make_corrupt()
    for k in ("a", "b"):
        assert torch.equal(c1(tree, 3)[k], c2(tree, 3)[k])
    mask = adv.mask()
    out3, out4 = c1(tree, 3)["a"].numpy(), c1(tree, 4)["a"].numpy()
    np.testing.assert_array_equal(out3[~mask], 1.0)
    assert not np.array_equal(out3[mask], out4[mask])
    other = AdversaryProcess(kind="random", f=0.25, n_agents=8, seed=10).make_corrupt()
    assert not torch.equal(other(tree, 3)["a"], c1(tree, 3)["a"])
    # leaves draw apart, and a leaf's noise does not depend on its neighbours
    assert not torch.equal(c1(tree, 3)["a"][mask][:, :2], c1(tree, 3)["b"][mask][:, 0])
    assert torch.equal(c1({"a": tree["a"]}, 3)["a"], c1(tree, 3)["a"])


def test_collusion_rows_agree(ref_direction):
    adv = AdversaryProcess(kind="collusion", f=0.4, scale=3.0, n_agents=5)
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    got = adv.make_corrupt()({"w": _t(x)})["w"].numpy()
    want = np.asarray(jadv.AdversaryProcess(kind="collusion", f=0.4, scale=3.0, n_agents=5)
                      .make_corrupt()({"w": jnp.asarray(x)}, None)["w"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    mask = adv.mask()
    byz = got[mask]
    np.testing.assert_array_equal(byz, np.broadcast_to(byz[0], byz.shape))
    np.testing.assert_array_equal(got[~mask], x[~mask])
    np.testing.assert_allclose(np.linalg.norm(byz[0] - x.mean(axis=0)), 3.0, rtol=1e-5)


def test_port_collusion_direction_is_a_unit_host_draw():
    adv = AdversaryProcess(kind="collusion", f=0.4, n_agents=5, seed=2)
    d0, d1 = adv.collusion_direction(0, (3, 4)), adv.collusion_direction(1, (3, 4))
    assert d0.device.type == "cpu" and d0.dtype == torch.float32 and d0.shape == (3, 4)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(d0)), 1.0, rtol=1e-6)
    assert torch.equal(d0, adv.collusion_direction(0, (3, 4))) and not torch.equal(d0, d1)


# ---------------------------------------------------------------------------
# The MixingOps wrapper
# ---------------------------------------------------------------------------


def test_clean_path_returns_base_object():
    for base in (tmixing.dense_mixing(ttopo.make_topology("ring", 6), CPU),
                 tmixing.sparse_mixing(ttopo.make_sparse_topology("ring", 6), CPU)):
        assert make_adversarial_mixing(base, None, "mean", n_agents=6) is base


def test_wrapper_preserves_accounting_metadata():
    base = tmixing.dense_mixing(ttopo.make_topology("ring", 6), CPU)
    wrapped = make_adversarial_mixing(base, "signflip:f=0.2", "trimmed", n_agents=6)
    assert wrapped.gossip_edges == base.gossip_edges
    assert wrapped.gossip_messages == base.gossip_messages
    jbase = jmixing.dense_mixing(jtopo.make_topology("ring", 6))
    assert wrapped.name == jadv.make_adversarial_mixing(jbase, "signflip:f=0.2", "trimmed",
                                                        n_agents=6).name


def test_adversarial_network_unwraps_to_base():
    base = tmixing.dense_mixing(ttopo.make_topology("ring", 6), CPU)
    wrapped = make_adversarial_mixing(base, "random:f=0.2", n_agents=6)
    assert isinstance(wrapped.network, AdversarialNetwork)
    assert unwrap_network(wrapped.network) is base.network
    assert unwrap_network(base.network) is base.network
    # over frozen operands it reports the static counts, as the reference's
    _, msgs, parts = wrapped.network.device_block(3, 6)
    assert list(msgs) == [2 * base.gossip_edges] * 3 and list(parts) == [6] * 3


def test_wrapped_global_avg_applies_rule_to_corrupted_payloads():
    n = 6
    base = tmixing.dense_mixing(ttopo.make_topology("full", n), CPU)
    tree = {"w": torch.ones(n, 2)}
    m_mean = make_adversarial_mixing(base, "signflip:f=0.2", "mean", n_agents=n)
    m_trim = make_adversarial_mixing(base, "signflip:f=0.2", "trimmed:f=0.2", n_agents=n)
    np.testing.assert_allclose(m_mean.global_avg(tree)["w"].numpy(), 1.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(m_trim.global_avg(tree)["w"].numpy(), 1.0)


def test_collective_mixers_are_refused():
    """Collective bases were refused before the adversary over rank meshes
    was ported (the name is kept): now each rank of the mesh wraps its own
    agent (the rank paths are held against the reference in
    ``test_torch_adversary_ranks.py``).  Only a collective mixer that does
    not name its agent axes, or whose mesh holds another number of agents,
    is refused."""
    from repro_torch.launch.mesh import CountingMesh

    n = 4
    mask = adversary_mask("signflip:f=0.25", n, seed=2)
    for r in range(n):
        mesh = CountingMesh({"data": n}, CPU, rank=r)
        base = tmixing.collective_shift_mixing(
            mesh, ("data",), {"data": [(0, 0.5), (1, 0.25), (-1, 0.25)]})
        adv = make_adversarial_mixing(base, "signflip:f=0.25", "trimmed", n_agents=n, seed=2)
        assert adv.name == "collective/shift/adv:signflip:f=0.25/robust:trimmed"
        assert adv.rank_adversary.byzantine == mask[r] and adv.network.adversarial
        assert adv.plain_gossip is base.gossip and adv.shifts == base.shifts
        x = torch.arange(6.0).reshape(2, 3)
        sent = adv.wire_corrupt(x, 0)
        assert torch.equal(sent, -x if mask[r] else x)
    with pytest.raises(ValueError, match="agent axes"):
        make_adversarial_mixing(dataclasses.replace(base, agent_axes=None), "signflip:f=0.25",
                                n_agents=n)
    with pytest.raises(ValueError, match="agents"):
        make_adversarial_mixing(base, "signflip:f=0.25", n_agents=8)


@pytest.mark.parametrize("axes,adversary,robust,refused", [
    (("pod", "data"), "signflip:f=0.25", "krum", True),
    (("pod", "data"), None, "krum", True),
    (("pod", "data"), "random:f=0.25", "mean", True),
    (("pod", "data"), "collusion:f=0.25", "trimmed", True),
    (("pod", "data"), "signflip:f=0.25", "median", False),
    (("data", "model"), "collusion:f=0.25", "krum", True),
    (("data", "model"), "signflip:f=0.25", "trimmed", False),
])
def test_agents_over_several_ranks_need_their_shards(axes, adversary, robust, refused):
    """Four agents over two ranks each (pod-as-agent's data axis, or a model axis):
    Krum and the ``random`` / ``collusion`` draws read the agent's whole
    leaves, so the default route (no ``shards=``) refuses them rather than
    treat each rank's block as the whole leaf; a sign flip and the
    elementwise rules take it.  Under pod-as-agent ``agent_shards`` derives
    the shards from the placement's data dims and every case is taken."""
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.launch.steps import agent_shards, mesh_gossip_shifts

    agent_axes = axes[:1]
    mesh = CountingMesh({axes[0]: 4, axes[1]: 2}, CPU, rank=1)
    base = tmixing.collective_shift_mixing(mesh, agent_axes,
                                           mesh_gossip_shifts(mesh, agent_axes))
    if refused:
        with pytest.raises(ValueError, match="shards="):
            make_adversarial_mixing(base, adversary, robust, n_agents=4, seed=2)
    else:
        assert make_adversarial_mixing(base, adversary, robust, n_agents=4,
                                       seed=2).mesh is mesh
    whole = {"b": (3,), "w": (8, 3)}
    if axes[-1] == "model":
        with pytest.raises(ValueError, match="model axis"):
            agent_shards(whole, {"b": None, "w": 0}, mesh)
        return
    shards = agent_shards(whole, {"b": None, "w": 0}, mesh)
    adv = make_adversarial_mixing(base, adversary, robust, n_agents=4, seed=2, shards=shards)
    assert adv.mesh is mesh and shards.replicas == {"b": 2, "w": 1}
    w = torch.arange(24.0).reshape(8, 3)  # rank 1: pod 0, data 1, the second half of w's rows
    assert torch.equal(shards.cut("w", w), w[4:]) and torch.equal(shards.cut("b", w[0]), w[0])


# ---------------------------------------------------------------------------
# The sign flip folded into the operator, against the written-out form
# ---------------------------------------------------------------------------


def _asymmetric_w(n, seed):
    """A non-symmetric W: the fold must scale each *sender's* weights."""
    w = np.random.default_rng(seed).uniform(size=(n, n)).astype(np.float32)
    return _t(w / w.sum(axis=1, keepdims=True))


def test_fold_scales_each_senders_weights_dense_and_csr():
    n = 7
    adv = AdversaryProcess(kind="signflip", f=0.3, scale=1.5, n_agents=n, seed=2)
    c = adv.make_corrupt()
    x = _t(np.random.default_rng(1).normal(size=(n, 5)).astype(np.float32))
    w = _asymmetric_w(n, 0)
    want = ttree.tree_agent_mix({"x": c.leaf(x, 0)}, w)["x"]
    got = ttree.tree_agent_mix({"x": x}, tadv.fold_senders(w, c.sender_weights(CPU)))["x"]
    assert float((got - want).abs().max()) <= MIX_TOL * (1 + float(x.abs().max()))
    topo = ttopo.make_sparse_topology("random_regular", n + 1, degree=4)
    csr = tmixing._csr_of(topo, CPU)
    c8 = AdversaryProcess(kind="signflip", f=0.3, n_agents=n + 1, seed=2).make_corrupt()
    x8 = _t(np.random.default_rng(2).normal(size=(n + 1, 5)).astype(np.float32))
    want = ref.sparse_mix_csr_ref(c8.leaf(x8, 0), *csr)
    got = ref.sparse_mix_csr_ref(x8, *tadv.fold_senders(csr, c8.sender_weights(CPU)))
    assert torch.equal(got, want)  # scale 1: the fold is exact


@pytest.mark.parametrize("kernel", ["k3", "k5"])
def test_fold_under_the_fused_compressed_mixes(kernel):
    """K3's and K5's plain versions over the folded operand against the
    reference's x + (W corrupt(q) - q) with q written out (K9's plain
    version)."""
    n, d = 8, 33
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(n, d)).astype(np.float32))
    r = _t(0.01 * rng.normal(size=(n, d)).astype(np.float32))
    c = AdversaryProcess(kind="signflip", f=0.25, n_agents=n, seed=1).make_corrupt()
    absmax = ref.row_absmax_ref(x, r)
    q, new_r = ref.rowwise_quant_dequant_ref(x, absmax, 8, r, None)
    if kernel == "k3":
        w = _asymmetric_w(n, 3)
        want = x + (ttree.tree_agent_mix({"q": c.leaf(q, 0)}, w)["q"] - q)
        got, got_r = ref.compressed_mix_ref(x, r, tadv.fold_senders(w, c.sender_weights(CPU)),
                                            absmax, 8, 1.0, None)
    else:
        csr = tmixing._csr_of(ttopo.make_sparse_topology("random_regular", n, degree=3), CPU)
        want = x + (ref.sparse_mix_csr_ref(c.leaf(q, 0), *csr) - q)
        got, got_r = ref.sparse_compressed_mix_csr_ref(
            x, r, *tadv.fold_senders(csr, c.sender_weights(CPU)), absmax, 8, 1.0, None)
    assert float((got - want).abs().max()) <= MIX_TOL * (1 + float(x.abs().max()))
    assert torch.equal(got_r, new_r)


def test_fold_applies_to_the_staged_operand_every_round():
    topo = ttopo.make_sparse_topology("random_regular", 12, degree=4)
    base = tmixing.make_sparse_network_mixing(topo, CPU, "bernoulli:0.5", seed=3)
    wrapped = make_adversarial_mixing(base, "signflip:f=0.25", n_agents=12, seed=3)
    net = wrapped.network
    c = AdversaryProcess(kind="signflip", f=0.25, n_agents=12, seed=3).make_corrupt()
    x = {"w": _t(np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32))}
    ops, _, _ = net.device_block(0, 3)
    for i in range(3):
        net.stage(ops, i)
        assert net.k == i and wrapped.network.gossip_w is net.gossip_w  # folded once a round
        want = base.gossip(c(x))["w"]
        assert torch.equal(wrapped.gossip(x)["w"], want)


# ---------------------------------------------------------------------------
# Lemma 1: where gradient tracking's invariant survives and where it breaks
# ---------------------------------------------------------------------------


def _tracking_deviation(mixing, n=8, rounds=3):
    loss_fn, sampler_factory, d = make_logreg_problem(n_agents=n)
    cfg = PiscoConfig(n_agents=n, t_o=2, eta_l=0.1, eta_c=0.9, p=0.5)
    sampler = sampler_factory(2)
    state = init_state(loss_fn, replicate_params({"w": torch.zeros(d)}, n), sampler(-1)[1])
    fn = make_round_fn(loss_fn, cfg, mixing, global_round=True)
    for k in range(rounds):
        state, _ = fn(state, *sampler(k))
    return max(float((state.y[k].mean(0) - state.g[k].mean(0)).abs().max()) for k in state.y)


def test_lemma1_survives_clean_breaks_under_corruption_and_robust_rules():
    base = tmixing.dense_mixing(ttopo.make_topology("ring", 8), CPU)
    clean = _tracking_deviation(base)
    corrupted = _tracking_deviation(
        make_adversarial_mixing(base, "signflip:f=0.25", "mean", n_agents=8))
    robust = _tracking_deviation(make_adversarial_mixing(base, None, "trimmed:f=0.2", n_agents=8))
    assert clean < 1e-5
    assert corrupted > 1e-3
    assert robust > 10 * max(clean, 1e-7)


# ---------------------------------------------------------------------------
# ExperimentSpec wiring: validation, JSON, accounting, History series
# ---------------------------------------------------------------------------


def _data(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(240, 5)).astype(np.float32)
    y = np.sign(rng.normal(size=240)).astype(np.float32)
    return FederatedDataset.from_arrays(x, y, n, heterogeneous=False, seed=seed)


def _experiment(n=6, rounds=6, **spec_kw):
    data = _data(n)
    xt, yt = torch.as_tensor(data.x_test), torch.as_tensor(data.y_test)
    spec = ExperimentSpec.create(algo="pisco", n_agents=n, t_o=2, eta_l=0.1, p=0.5, seed=0,
                                 rounds=rounds, eval_every=max(1, rounds // 2), **spec_kw)
    return Experiment(
        spec, loss_fn=tm.logreg_loss, params0={"w": torch.zeros(5)}, device=CPU,
        sampler_factory=lambda s: RoundSampler(data, 8, s.config.t_o, s.config.seed,
                                               device=CPU),
        eval_fn=lambda p: {"loss": float(tm.logreg_loss(p, (xt, yt)))},
    )


def test_spec_validates_adversary_and_robust():
    _experiment(adversary="signflip:f=0.2", robust_agg="trimmed")
    for kw in (dict(adversary="bogus:f=0.2"), dict(robust_agg="huber"),
               dict(adversary="signflip:f=0.9", n_agents=2),
               dict(robust_agg="median", participation=0.5),
               dict(robust_agg="median", driver="events", systems="uniform",
                    async_="constant:buffer=3")):
        kw = dict(dict(algo="pisco", n_agents=6), **kw)
        with pytest.raises(ValueError):
            ExperimentSpec.create(**kw)
        with pytest.raises(ValueError):
            JSpec.create(**kw)


def test_spec_json_round_trip_and_legacy_payloads():
    spec = ExperimentSpec.create(algo="pisco", n_agents=8, adversary="signflip:f=0.25",
                                 robust_agg="trimmed:f=0.25", rounds=4)
    again = ExperimentSpec.from_json(spec.to_json())
    assert again.adversary == "signflip:f=0.25" and again.robust_agg == "trimmed:f=0.25"
    assert again == spec
    assert JSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    legacy = spec.to_dict()
    del legacy["adversary"], legacy["robust_agg"]
    old = ExperimentSpec.from_dict(legacy)
    assert old.adversary is None and old.robust_agg == "mean"


def test_accounting_identical_clean_vs_adversarial():
    h_clean = _experiment(systems="lognormal-stragglers").run()
    h_adv = _experiment(adversary="random:f=0.2", robust_agg="trimmed",
                        systems="lognormal-stragglers").run()
    assert h_adv.accountant.total_bytes == h_clean.accountant.total_bytes
    assert h_adv.to_dict()["accountant"] == h_clean.to_dict()["accountant"]
    assert h_adv.sim_time_s == h_clean.sim_time_s and len(h_adv.sim_time_s) == 6


def test_history_records_mask_and_per_agent_eval():
    h = _experiment(adversary="signflip:f=0.2").run()
    mask = h.adversary_mask
    assert isinstance(mask, list) and len(mask) == 6 and sum(mask) == 2
    assert h.eval_per_agent and all(
        "honest_loss" in e and "byz_loss" in e and isinstance(e["round"], int)
        for e in h.eval_per_agent)
    d = json.loads(json.dumps(h.to_dict()))
    assert d["adversary_mask"] == mask
    assert len(d["eval_per_agent"]) == len(h.eval_per_agent)
    h0 = _experiment().run()
    assert h0.adversary_mask is None and h0.eval_per_agent == []
    assert json.loads(json.dumps(h0.to_dict()))["adversary_mask"] is None


@pytest.mark.parametrize("kind,network", [
    ("signflip:f=0.2", None), ("random:f=0.2,scale=0.5", None),
    ("random:f=0.2,scale=0.5", "bernoulli:0.3"), ("collusion:f=0.2,scale=0.5", None),
])
def test_loop_and_scan_drivers_agree_under_adversary(kind, network):
    h_loop = _experiment(adversary=kind, robust_agg="trimmed", driver="loop",
                         network=network).run()
    h_scan = _experiment(adversary=kind, robust_agg="trimmed", driver="scan",
                         network=network, block_size=4).run()
    assert h_loop.loss == h_scan.loss and h_loop.is_global == h_scan.is_global
    assert h_loop.eval_per_agent == h_scan.eval_per_agent


@pytest.mark.parametrize("compression", [None, "q8d"])
def test_events_trivial_path_matches_scan_under_adversary(compression):
    from repro_torch.sim import FREE_NETWORK

    kw = dict(adversary="random:f=0.2,scale=0.5", robust_agg="trimmed", systems=FREE_NETWORK,
              compression=compression)
    h_scan = _experiment(driver="scan", **kw).run()
    h_ev = _experiment(driver="events", **kw).run()
    assert h_scan.loss == h_ev.loss
    assert h_ev.adversary_mask == h_scan.adversary_mask
    assert h_ev.eval_per_agent == h_scan.eval_per_agent


def test_random_corruption_leaves_honest_rows_and_local_compute():
    """One round under a random adversary: the Byzantine agents' local
    steps are honest (their x before mixing is the clean run's), and what
    they send is noise of the given scale."""
    n = 8
    base = tmixing.dense_mixing(ttopo.make_topology("ring", n), CPU)
    adv = make_adversarial_mixing(base, "random:f=0.25,scale=0.5", n_agents=n, seed=3)
    x = {"w": torch.ones(n, 4000)}
    adv.network.stage(adv.network.device_block(5, 6)[0], 0)
    sent = adv.global_avg(x)["w"][0]
    mask = adversary_mask("random:f=0.25", n, seed=3)
    noise = (n * sent - (n - sum(mask)) * 1.0) / sum(mask)  # mean of the noise rows
    assert abs(float(noise.mean())) < 0.05 and 0.1 < float(noise.std()) < 0.5
    assert torch.equal(adv.gossip(x)["w"], adv.gossip(x)["w"])  # pure in the round


# ---------------------------------------------------------------------------
# Whole runs against the reference
# ---------------------------------------------------------------------------

RUNS = {
    "signflip-dense": dict(adversary="signflip:f=0.2"),
    "signflip-dense-trimmed": dict(adversary="signflip:f=0.2", robust_agg="trimmed"),
    "signflip-sparse-median": dict(adversary="signflip:f=0.2", robust_agg="median",
                                   sparse=True),
    "signflip-dense-krum": dict(adversary="signflip:f=0.2,scale=2", robust_agg="krum"),
    "signflip-dynamic-dense-q8d": dict(adversary="signflip:f=0.2", network="bernoulli:0.4",
                                       compression="q8d"),
    "signflip-dynamic-sparse-q8d": dict(adversary="signflip:f=0.3", network="matching",
                                        sparse=True, compression="q8d"),
    "signflip-sparse-top": dict(adversary="signflip:f=0.2", sparse=True, compression="top0.3"),
    "signflip-dsgt-dense-q8d": dict(algo="dsgt", adversary="signflip:f=0.2",
                                    compression="q8d"),
    "collusion-dense-q8d-median": dict(adversary="collusion:f=0.25", robust_agg="median",
                                       compression="q8d"),
    "collusion-sparse-q8d": dict(adversary="collusion:f=0.2,scale=0.5", sparse=True,
                                 compression="q8d"),
    "collusion-dynamic-sparse": dict(adversary="collusion:f=0.2", network="bernoulli:0.5",
                                     sparse=True, robust_agg="trimmed"),
    "signflip-events-async-q8d": dict(adversary="signflip:f=0.2", driver="events",
                                      systems="lognormal-stragglers", compression="q8d",
                                      async_="poly:alpha=0.5,bound=2,buffer=5"),
    "collusion-events-async-sparse": dict(adversary="collusion:f=0.2", driver="events",
                                          systems="wan-gossip", sparse=True,
                                          async_="poly:alpha=0.5,bound=1,buffer=4"),
    "signflip-timed-trimmed": dict(adversary="signflip:f=0.2", robust_agg="trimmed",
                                   systems="lognormal-stragglers"),
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


@pytest.mark.parametrize("case", list(RUNS))
def test_whole_run_parity(case, ref_direction):
    js, ts = _specs(**RUNS[case])
    jh, th = _run_both(js, ts)
    assert th.is_global == [bool(f) for f in jh.is_global] and any(th.is_global)
    assert th.accountant.per_round_bytes == jh.accountant.per_round_bytes
    assert dataclasses.asdict(th.accountant) == dataclasses.asdict(jh.accountant)
    assert th.sim_time_s == list(jh.sim_time_s)
    assert th.adversary_mask == jh.adversary_mask and sum(th.adversary_mask) > 0
    rtol = Q8D_LOSS_RTOL if "q8d" in case else LOSS_RTOL
    np.testing.assert_allclose(th.loss, jh.loss, rtol=rtol)
    assert [e["round"] for e in th.eval_per_agent] == [e["round"] for e in jh.eval_per_agent]
    for key in ("honest_test_loss", "byz_test_loss"):
        np.testing.assert_allclose([e[key] for e in th.eval_per_agent],
                                   [e[key] for e in jh.eval_per_agent], rtol=rtol)
    # bytes and simulated seconds are the clean run's: wrong bytes, not fewer
    clean = {k: v for k, v in RUNS[case].items() if k not in ("adversary", "robust_agg")}
    jc, tc = _specs(**clean)
    _, th_clean = _run_both(jc, tc)
    assert th.accountant.per_round_bytes == th_clean.accountant.per_round_bytes
    assert th.sim_time_s == th_clean.sim_time_s


def test_q8d_signflip_corrupts_the_wire():
    """The sign flip rides the compressed wire: the q8d run differs from the
    clean one and matches the reference's x + (W corrupt(q) - q)."""
    js, ts = _specs(compression="q8d", adversary="signflip:f=0.2", p=0.0)
    jh, th = _run_both(js, ts)
    _, th_clean = _run_both(*_specs(compression="q8d", p=0.0))
    assert not any(th.is_global)
    assert np.max(np.abs(np.subtract(th.loss[1:], th_clean.loss[1:]))) > 1e-4
    np.testing.assert_allclose(th.loss, jh.loss, rtol=Q8D_LOSS_RTOL)


@pytest.mark.parametrize("compression", ["q8", "top0.3"])
def test_random_corruption_under_compression_keeps_the_clean_streams(compression):
    """q written out for the noise, then mixed by the plain gossip: the loop
    and block drivers agree bit for bit, the run differs from the clean one
    and the bytes do not."""
    h_loop = _experiment(driver="loop", compression=compression, adversary="random:f=0.2").run()
    h_scan = _experiment(driver="scan", compression=compression, adversary="random:f=0.2",
                         block_size=4).run()
    h_clean = _experiment(driver="scan", compression=compression).run()
    assert h_loop.loss == h_scan.loss and h_loop.loss != h_clean.loss
    assert np.all(np.isfinite(h_loop.loss))
    assert h_loop.accountant.per_round_bytes == h_clean.accountant.per_round_bytes


def test_written_out_route_keeps_the_clean_noise_stream():
    """Under a non-folding adversary the stochastic rounding draws from the
    clean path's generator (the spec's seed, one row per agent): with the
    corruption the identity, the written-out route is the fused one."""
    base = tmixing.dense_mixing(ttopo.make_topology("ring", 6), CPU)
    ident = dataclasses.replace(base, wire_corrupt=lambda q, i: q)
    x = {"a": torch.randn(6, 5), "b": torch.randn(6, 3)}
    outs = []
    for mixing in (base, ident):
        cg = compress_mixing(mixing, make_compressor("q8"), seed=4).compression
        ef = cg.init_ef(x)
        outs.append(cg(x, ef["x"], ef["gen"]))
    for k in x:
        assert float((outs[0][0][k] - outs[1][0][k]).abs().max()) <= 1e-6
        assert torch.equal(outs[0][1][k], outs[1][1][k])
