"""Host layer of the PyTorch port against the JAX package, bit for bit:
topologies (W and the CSR triple), the Bernoulli schedule, synthetic data,
the round sampler's batches, the byte model and the spec JSON."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import experiment as jexp  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.compression import make_byte_model as j_byte_model  # noqa: E402
from repro.core.mixing import dense_mixing as j_dense  # noqa: E402
from repro.core.mixing import sparse_mixing as j_sparse  # noqa: E402
from repro.core.compression import compress_mixing as j_compress, make_compressor as j_comp  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import experiment as texp  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

CPU = torch.device("cpu")

GRAPHS = [
    ("ring", 10, {}),
    ("erdos_renyi", 24, {"prob": 0.3, "seed": 7}),
    ("torus", 16, {}),
    ("random_regular", 30, {"degree": 4, "seed": 3}),
    ("star", 9, {}),
]


@pytest.mark.parametrize("name,n,kw", GRAPHS)
def test_dense_topology_bit_equal(name, n, kw):
    a, b = jtopo.make_topology(name, n, **kw), ttopo.make_topology(name, n, **kw)
    np.testing.assert_array_equal(a.w, b.w)
    np.testing.assert_array_equal(a.adj, b.adj)
    assert (a.lambda_w, a.connected, a.shifts) == (b.lambda_w, b.connected, b.shifts)


@pytest.mark.parametrize("name,n,kw", GRAPHS)
def test_sparse_topology_csr_bit_equal(name, n, kw):
    a, b = jtopo.make_sparse_topology(name, n, **kw), ttopo.make_sparse_topology(name, n, **kw)
    for f in ("edges", "edge_weight", "self_weight", "indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.connected, a.lambda_w) == (b.connected, b.lambda_w)
    np.testing.assert_array_equal(a.dense_w(), b.dense_w())


@pytest.mark.parametrize("p,seed", [(0.1, 0), (0.37, 5), (0.0, 1), (1.0, 2)])
def test_bernoulli_flags_bit_equal(p, seed):
    a, b = jsched.make_schedule(p, seed), tsched.make_schedule(p, seed)
    assert [a(k) for k in range(200)] == [b(k) for k in range(200)]


def test_synthetic_data_bit_equal():
    for fn, args in [("synthetic_a9a", (500,)), ("synthetic_mnist", (300,)),
                     ("synthetic_cifar", (50,))]:
        for ja, ta in zip(getattr(jsyn, fn)(*args, seed=3), getattr(tsyn, fn)(*args, seed=3)):
            assert ja.dtype == ta.dtype
            np.testing.assert_array_equal(ja, ta)


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_round_sampler_batches_bit_equal(heterogeneous):
    x, y = jsyn.synthetic_mnist(400, d=20, seed=1)
    jd = jfed.FederatedDataset.from_arrays(x, y, 8, heterogeneous=heterogeneous, seed=2)
    td = tfed.FederatedDataset.from_arrays(x, y, 8, heterogeneous=heterogeneous, seed=2)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(jd, f), getattr(td, f))
    js = jfed.RoundSampler(jd, batch_size=5, t_o=3, seed=4)
    ts = tfed.RoundSampler(td.to(CPU), batch_size=5, t_o=3, seed=4, device=CPU)
    for k in (-1, 0, 7):
        (jl, jc), (tl, tc) = js(k), ts(k)
        for a, b in zip(jl + jc, tl + tc):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _template(n):
    return {"w1": np.zeros((n, 4, 6), np.float32), "c1": np.zeros((n, 4), np.float32)}


@pytest.mark.parametrize("sparse,compression", [(False, None), (True, None),
                                                (False, "q8"), (False, "q4d"),
                                                (True, "q8"), (True, "q4d"),
                                                (False, "top0.1"), (True, "top0.25")])
def test_round_byte_model_equal(sparse, compression):
    n = 12
    tmpl = _template(n)
    if sparse:
        jm = j_sparse(jtopo.make_sparse_topology("ring", n))
        tm = tmix.sparse_mixing(ttopo.make_sparse_topology("ring", n), CPU)
    else:
        jm = j_dense(jtopo.make_topology("erdos_renyi", n, prob=0.4))
        tm = tmix.dense_mixing(ttopo.make_topology("erdos_renyi", n, prob=0.4), CPU)
    if compression:
        jm = j_compress(jm, j_comp(compression))
        tm = tcomp.compress_mixing(tm, tcomp.make_compressor(compression))
    jb = j_byte_model(jm, {k: jnp.asarray(v) for k, v in tmpl.items()}, n)
    tb = tcomp.make_byte_model(tm, {k: torch.from_numpy(v) for k, v in tmpl.items()}, n)
    assert dataclasses.asdict(jb) == dataclasses.asdict(tb)
    assert [jb.round_bytes(f) for f in (0, 1)] == [tb.round_bytes(f) for f in (0, 1)]


def test_spec_json_round_trips_across_packages():
    js = jexp.ExperimentSpec.create(
        algo="pisco", n_agents=512, t_o=2, p=0.1, topology="erdos_renyi",
        topology_kwargs={"prob": 0.3, "seed": 7}, compression="q8", rounds=20,
    )
    ts = texp.ExperimentSpec.from_json(js.to_json())
    assert ts.to_json() == js.to_json()
    assert jexp.ExperimentSpec.from_json(ts.to_json()) == js


@pytest.mark.parametrize("field,value", [
    ("adversary", "signflip:f=0.2"), ("robust_agg", "median"),
])
def test_unported_spec_fields_raise(field, value):
    kw = {"n_agents": 8, field: value}
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        texp.ExperimentSpec.create(**kw)


# the events driver needs a systems profile, async_ needs the events driver
_EVENTS = {"driver": "events", "systems": "uniform"}


@pytest.mark.parametrize("field,value", [
    ("network", "bernoulli:0.1"), ("participation", 0.5), ("cohort", 0.5),
    ("optimizer", "momentum"), ("server_optimizer", "fedadam"),
    ("lr_schedule", "cosine"), ("opt_policy", "keep"),
    ("systems", "uniform"), ("driver", "events"), ("async_", "constant"),
])
def test_ported_spec_fields_build(field, value):
    """The dynamic-network, update-rule, systems and async fields build in
    the port, and their JSON loads in the reference unchanged."""
    kw = {field: value}
    if field in ("driver", "async_"):
        kw = dict(_EVENTS, **kw)
    spec = texp.ExperimentSpec.create(n_agents=8, **kw)
    assert jexp.ExperimentSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    assert getattr(spec, field) == value
    mixing = spec.make_mixing(CPU)
    assert (mixing.network is not None) == (field in ("network", "participation", "cohort"))


def test_malformed_opt_policy_raises():
    with pytest.raises(ValueError, match="opt_policy"):
        texp.ExperimentSpec.create(n_agents=8, opt_policy="sync")


def test_compression_over_sparse_mixer_raises():
    """Quantized gossip over the sparse mixer builds (K5), and so does top-k
    over it and over the dense mixer (gamma 0.5 chosen as the reference
    chooses it, the byte model equal to the reference's); a malformed top-k
    spec raises the reference's ValueError."""
    spec = texp.ExperimentSpec.create(n_agents=16, sparse=True, compression="q8")
    mixing = spec.make_mixing(CPU)
    assert mixing.csr is not None and mixing.compression.csr is mixing.csr
    n, tmpl = 16, _template(16)
    for sparse in (True, False):
        spec = texp.ExperimentSpec.create(n_agents=n, sparse=sparse, compression="top0.1")
        tm = spec.make_mixing(CPU)
        jm = jexp.ExperimentSpec.from_json(spec.to_json()).make_mixing()
        assert tm.compression.gamma == jm.compression.gamma == 0.5
        assert (tm.csr is not None) == sparse and tm.name == jm.name
        jb = j_byte_model(jm, {k: jnp.asarray(v) for k, v in tmpl.items()}, n)
        tb = tcomp.make_byte_model(tm, {k: torch.from_numpy(v) for k, v in tmpl.items()}, n)
        assert dataclasses.asdict(jb) == dataclasses.asdict(tb)
    with pytest.raises(ValueError, match="top-k needs a fraction"):
        texp.ExperimentSpec.create(n_agents=16, sparse=True, compression="topk")


def test_identity_mixing_holds_iterates():
    tree = {"w": torch.arange(6.0).reshape(3, 2)}
    ops = tmix.identity_mixing(3)
    assert ops.gossip(tree) is tree and ops.gossip_edges == 0
    np.testing.assert_array_equal(ops.global_avg(tree)["w"].numpy(), [[2.0, 3.0]] * 3)
