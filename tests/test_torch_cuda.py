"""The Hopper kernels (K1-K9 and the codes pass of K3 and K5) against their
plain PyTorch versions on a card, short PISCO and baseline runs on the GPU
against the CPU, greedy serving of both reduced LMs on the GPU against the
CPU, and a two-rank gloo round of reduced Mamba2-370m training on the card
against the same ranks on the CPU.

Every test here needs a CUDA device (and ``nvcc`` for the first build); it
skips without one.  The file imports no JAX, so on a GPU machine without JAX
it runs alone, past the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.core.topology import make_sparse_topology
from repro_torch.data import FederatedDataset, RoundSampler
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.kernels import ops, ref
from repro_torch.models.simple import mlp_init, mlp_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


@pytest.mark.parametrize("shape,dtype", [((1000, 37), torch.float32),
                                         ((7, 3, 5), torch.bfloat16), ((1,), torch.float32)])
def test_k1_exact(cuda, gen, shape, dtype):
    x, y, gn, go = (torch.randn(*shape, generator=gen, device=cuda).to(dtype) for _ in range(4))
    for fn, rf in ((ops.fused_local_step, ref.fused_local_step_ref),
                   (ops.fused_track_step, ref.fused_track_step_ref)):
        for a, b in zip(fn(x, y, gn, go, 0.1), rf(x, y, gn, go, 0.1)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,d,bits,gamma,noise", [(37, 1000, 4, 0.5, False),
                                                  (64, 300, 8, 1.0, True), (3, 5, 8, 1.0, False)])
def test_k2_k3_q_grid_exact_mix_within_tolerance(cuda, gen, n, d, bits, gamma, noise):
    x = torch.randn(n, d, generator=gen, device=cuda)
    r = 0.01 * torch.randn(n, d, generator=gen, device=cuda)
    u = torch.rand(n, d, generator=gen, device=cuda) if noise else None
    w = torch.softmax(torch.randn(n, n, generator=gen, device=cuda), dim=0)
    am = ops.row_absmax(x, r)
    assert torch.equal(am, ref.row_absmax_ref(x, r))
    out, res = ops.compressed_mix(x, r, w, am, bits=bits, gamma=gamma, noise=u)
    out2, res2 = ref.compressed_mix_ref(x, r, w, am, bits, gamma, u)
    assert torch.equal(res, res2)  # the quantizer grid is exact
    # W^T q sums in another order than cuBLAS
    torch.testing.assert_close(out, out2, rtol=1e-5, atol=1e-5)


# d % 4 != 0 and d < 4 take K4's 4-byte loads, d % 4 == 0 its 16-byte ones;
# n = 1 is a fleet of one agent (self weight only)
@pytest.mark.parametrize("name,n,d", [("random_regular", 300, 517), ("ring", 7, 3),
                                      ("random_regular", 1024, 320), ("ring", 5, 2),
                                      ("ring", 1, 5)])
def test_k4_within_tolerance(cuda, gen, name, n, d):
    topo = make_sparse_topology(name, n)
    csr = (torch.as_tensor(topo.indptr, device=cuda), torch.as_tensor(topo.indices, device=cuda),
           torch.as_tensor(topo.data, dtype=torch.float32, device=cuda),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=cuda))
    x = torch.randn(n, d, generator=gen, device=cuda)
    # the plain version's index_add_ adds with atomics, in no fixed order
    torch.testing.assert_close(ops.sparse_mix_csr(x, *csr), ref.sparse_mix_csr_ref(x, *csr),
                               rtol=1e-6, atol=1e-6)


def test_k4_unaligned_base_and_receiver_without_in_edges(cuda, gen):
    """Rows of a view whose base is 4 bytes past a 16-byte boundary (d % 4
    == 0, so only the base forbids 16-byte loads), and a CSR whose first
    receiver has no in-edges (its output is self_w x alone), against the
    plain version; one launch each."""
    n, d = 300, 256
    topo = make_sparse_topology("random_regular", n)
    csr = (torch.as_tensor(topo.indptr, device=cuda), torch.as_tensor(topo.indices, device=cuda),
           torch.as_tensor(topo.data, dtype=torch.float32, device=cuda),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=cuda))
    x = torch.randn(n * d + 1, generator=gen, device=cuda)[1:].view(n, d)
    assert x.data_ptr() % 16 == 4
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.sparse_mix_csr(x, *csr), ref.sparse_mix_csr_ref(x, *csr),
                               rtol=1e-6, atol=1e-6)
    indptr = torch.tensor([0, 0, 2, 3], device=cuda)
    indices = torch.tensor([0, 2, 1], device=cuda)
    data = torch.tensor([0.3, 0.2, 0.5], device=cuda)
    self_w = torch.tensor([1.0, 0.5, 0.5], device=cuda)
    x = torch.randn(3, 9, generator=gen, device=cuda)
    out = ops.sparse_mix_csr(x, indptr, indices, data, self_w)
    assert ops.launch_counts()["sparse_mix"] == 2
    assert torch.equal(out[0], x[0])
    torch.testing.assert_close(out, ref.sparse_mix_csr_ref(x, indptr, indices, data, self_w),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,d,bits,gamma,ef", [(300, 517, 8, 1.0, True), (1024, 320, 4, 0.5, True),
                                               (300, 517, 8, 1.0, False), (7, 10, 4, 0.5, False),
                                               (1, 5, 8, 1.0, True)])
def test_k5_q_grid_exact_mix_within_tolerance(cuda, gen, n, d, bits, gamma, ef):
    topo = make_sparse_topology("random_regular" if n > 7 else "ring", n)
    csr = (torch.as_tensor(topo.indptr, device=cuda), torch.as_tensor(topo.indices, device=cuda),
           torch.as_tensor(topo.data, dtype=torch.float32, device=cuda),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=cuda))
    x = torch.randn(n, d, generator=gen, device=cuda)
    r = 0.01 * torch.randn(n, d, generator=gen, device=cuda) if ef else None
    u = torch.rand(n, d, generator=gen, device=cuda) if ef else None
    am = ops.row_absmax(x, r)
    out, res = ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=bits, gamma=gamma, noise=u)
    out2, res2 = ref.sparse_compressed_mix_csr_ref(x, r, *csr, am, bits, gamma, u)
    if ef:
        assert torch.equal(res, res2)  # the quantizer grid is exact
    else:
        assert res is None and res2 is None
    # the plain version's index_add_ adds with atomics, in no fixed order
    torch.testing.assert_close(out, out2, rtol=1e-5, atol=1e-5)


# The codes pass: codes and r' exact; d % 8 == 0 with aligned bases takes
# the 16-byte path, ragged d or a base 4 bytes past a 16-byte boundary the
# one-element path
@pytest.mark.parametrize("n,d,bits,res,noise,unaligned", [
    (300, 517, 8, True, True, False), (64, 320, 4, True, False, False),
    (3, 5, 8, False, True, False), (64, 256, 8, True, True, True), (1, 8, 8, False, False, False)])
def test_quant_codes_exact(cuda, gen, n, d, bits, res, noise, unaligned):
    x = torch.randn(n * d + 1, generator=gen, device=cuda)[1:].view(n, d) if unaligned else \
        torch.randn(n, d, generator=gen, device=cuda)
    r = 0.01 * torch.randn(n, d, generator=gen, device=cuda) if res else None
    u = torch.rand(n, d, generator=gen, device=cuda) if noise else None
    am = ops.row_absmax(x, r)
    ops.reset_launch_counts()
    codes, r_new = ops.quant_codes(x, am, bits=bits, residual=r, noise=u)
    assert ops.launch_counts()["quant_codes"] == 1
    codes_p, r_p = ref.quant_codes_ref(x, r, am, bits, u)
    assert codes.dtype == torch.int8 and torch.equal(codes, codes_p)
    assert (r_new is None and r_p is None) if r is None else torch.equal(r_new, r_p)


def _k5_csr(topo, device):
    return (torch.as_tensor(topo.indptr, device=device),
            torch.as_tensor(topo.indices, device=device),
            torch.as_tensor(topo.data, dtype=torch.float32, device=device),
            torch.as_tensor(topo.self_weight, dtype=torch.float32, device=device))


# K5's two passes against the plain version on the CPU, which adds in edge
# order as the kernel does: bit for bit.  d = 2048 takes 8 codes a lane,
# d <= 1024 four, d % 4 != 0 the one-element path.
@pytest.mark.parametrize("n,d,gamma,ef", [(300, 517, 1.0, True), (1024, 320, 0.5, True),
                                          (300, 2048, 1.0, False), (7, 10, 0.5, False),
                                          (1, 5, 1.0, True)])
def test_k5_two_passes_bit_equal_to_cpu_plain(cuda, gen, n, d, gamma, ef):
    topo = make_sparse_topology("random_regular" if n > 7 else "ring", n)
    csr, csr_cpu = _k5_csr(topo, cuda), _k5_csr(topo, "cpu")
    x = torch.randn(n, d, generator=gen, device=cuda)
    r = 0.01 * torch.randn(n, d, generator=gen, device=cuda) if ef else None
    u = torch.rand(n, d, generator=gen, device=cuda) if ef else None
    am = ops.row_absmax(x, r)
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    ops.reset_launch_counts()
    out, res = ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, gamma=gamma, noise=u)
    counts = ops.launch_counts()
    assert counts["quant_codes"] == 1 and counts["sparse_compressed_mix"] == 1
    want, res_want = ref.sparse_compressed_mix_csr_ref(cpu(x), cpu(r), *csr_cpu, cpu(am), 8, gamma,
                                                       cpu(u))
    assert torch.equal(out.cpu(), want)
    assert (res is None and res_want is None) if r is None else torch.equal(res.cpu(), res_want)
    codes, _ = ops.quant_codes(x, am, bits=8, residual=r, noise=u)
    alone = ops.sparse_code_mix_csr(x, codes, *csr, am, bits=8, gamma=gamma)
    assert torch.equal(alone.cpu(), ref.sparse_code_mix_csr_ref(
        cpu(x), codes.cpu(), *csr_cpu, cpu(am), 8, gamma))


# K3's contraction on the tensor cores against its plain version with W' as
# three bf16 terms (the kernel's rounding model); ragged n and d included
@pytest.mark.parametrize("n,d,gamma", [(37, 1000, 0.5), (64, 300, 1.0), (512, 256, 1.0),
                                       (3, 5, 1.0), (200, 4096, 1.0)])
def test_k3_second_pass_within_tolerance(cuda, gen, n, d, gamma):
    x = torch.randn(n, d, generator=gen, device=cuda)
    w = torch.softmax(torch.randn(n, n, generator=gen, device=cuda), dim=0)
    am = ops.row_absmax(x)
    codes, _ = ops.quant_codes(x, am, bits=8)
    ops.reset_launch_counts()
    out = ops.code_mix(x, codes, w, am, bits=8, gamma=gamma)
    assert ops.launch_counts()["compressed_mix"] == 1
    torch.testing.assert_close(out, ref.code_mix_ref(x, codes, w, am, 8, gamma, bf16_split=True),
                               rtol=1e-5, atol=1e-5)


def test_k3_contraction_as_accurate_as_cublas(cuda, gen):
    """W'^T c - q (x = 0) against an f64 contraction of the same q: max
    |err| within chip_smoke's 4x of cuBLAS's f32 w.T @ q - q."""
    n, d = 512, 2048
    x = torch.randn(n, d, generator=gen, device=cuda)
    w = torch.softmax(torch.randn(n, n, generator=gen, device=cuda), dim=0)
    am = ops.row_absmax(x)
    codes, _ = ops.quant_codes(x, am, bits=8)
    q = codes.float() * (am / torch.full_like(am, 127.0))[:, None]
    exact = w.double().T @ q.double() - q.double()
    err = (ops.code_mix(torch.zeros_like(x), codes, w, am, bits=8) - exact).abs().max()
    lib = ((w.T @ q - q) - exact).abs().max()
    assert 0 < lib and err <= 4.0 * lib, (float(err), float(lib))


@pytest.mark.parametrize("kw", [{"topology": "erdos_renyi", "compression": "q8d"},
                                {"topology": "random_regular", "sparse": True},
                                {"topology": "random_regular", "sparse": True, "compression": "q8d"},
                                {"algo": "dsgt", "topology": "random_regular", "sparse": True,
                                 "compression": "q8d"},
                                {"algo": "scaffold", "topology": "ring"}])
def test_short_run_gpu_matches_cpu(cuda, kw):
    n = 32
    x, y = synthetic_mnist(n * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n)
    spec = ExperimentSpec.create(n_agents=n, t_o=2, eta_l=0.1, p=0.3, rounds=4, **kw)
    hists = []
    ops.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        resident = data.to(dev)
        hists.append(Experiment(
            spec, loss_fn=mlp_loss, params0=mlp_init(0), device=dev,
            sampler_factory=lambda s: RoundSampler(resident, 16, 2, s.config.seed, device=dev),
        ).run())
    counts = ops.launch_counts()
    if kw.get("algo") is None:  # PISCO's local steps
        assert counts["fused_local_step"] > 0
    if kw.get("algo") != "scaffold":  # SCAFFOLD has no gossip round
        kernel = "compressed_mix"
        if kw.get("sparse"):
            kernel = "sparse_compressed_mix" if kw.get("compression") else "sparse_mix"
        assert counts[kernel] > 0
    gpu, cpu = hists
    assert gpu.is_global == cpu.is_global
    np.testing.assert_allclose(gpu.loss, cpu.loss, rtol=1e-4)



# Dynamic networks: K4 and K5 over each round's CSR weights (zeros on
# dropped edges; "bernoulli:1.0" drops every edge, where both must return x
# exactly), K3 over a new matching W_k each round
@pytest.mark.parametrize("kind", ["bernoulli:0.5", "cohort:0.25", "bernoulli:1.0"])
def test_k4_k5_over_per_round_weights(cuda, gen, kind):
    from repro_torch.core.mixing import make_sparse_network_mixing

    n, d = 300, 517
    mixing = make_sparse_network_mixing(make_sparse_topology("random_regular", n), cuda, kind,
                                        seed=3)
    net = mixing.network
    operands, messages, _ = net.device_block(0, 4)
    for i in range(4):
        net.stage(operands, i)
        csr = net.gossip_w
        csr_cpu = tuple(t.cpu() for t in csr)
        x = torch.randn(n, d, generator=gen, device=cuda)
        r = 0.01 * torch.randn(n, d, generator=gen, device=cuda)
        u = torch.rand(n, d, generator=gen, device=cuda)
        am = ops.row_absmax(x, r)
        ops.reset_launch_counts()
        mixed = ops.sparse_mix_csr(x, *csr)
        out, res = ops.sparse_compressed_mix_csr(x, r, *csr, am, bits=8, noise=u)
        counts = ops.launch_counts()
        assert counts["sparse_mix"] == 1 and counts["sparse_compressed_mix"] == 1
        torch.testing.assert_close(mixed, ref.sparse_mix_csr_ref(x, *csr), rtol=1e-6, atol=1e-6)
        want, res_want = ref.sparse_compressed_mix_csr_ref(x.cpu(), r.cpu(), *csr_cpu, am.cpu(), 8,
                                                           1.0, u.cpu())
        assert torch.equal(out.cpu(), want) and torch.equal(res.cpu(), res_want)
        if messages[i] == 0:
            assert torch.equal(mixed, x) and torch.equal(out, x)


def test_k3_over_a_new_matching_w_each_round(cuda, gen):
    from repro_torch.core.mixing import make_network_mixing
    from repro_torch.core.topology import make_topology

    n, d = 64, 300
    mixing = make_network_mixing(make_topology("erdos_renyi", n, prob=0.3, seed=7), cuda,
                                 "matching", seed=2)
    net = mixing.network
    operands, _, _ = net.device_block(0, 3)
    for i in range(3):
        net.stage(operands, i)
        w = net.gossip_w
        x = torch.randn(n, d, generator=gen, device=cuda)
        am = ops.row_absmax(x)
        codes, _ = ops.quant_codes(x, am, bits=8)
        ops.reset_launch_counts()
        out = ops.code_mix(x, codes, w, am, bits=8)
        assert ops.launch_counts()["compressed_mix"] == 1
        torch.testing.assert_close(out, ref.code_mix_ref(x, codes, w, am, 8, 1.0, bf16_split=True),
                                   rtol=1e-5, atol=1e-5)


def _event_block(spec, device):
    """An engine block for ``spec`` staged through its async mixing's
    ``EventNetwork`` on ``device``: (mixing, operands, engine)."""
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.core.compression import make_byte_model
    from repro_torch.core.driver import predraw_schedule
    from repro_torch.events import make_async_mixing, make_event_engine

    n = spec.config.n_agents
    base = spec.make_mixing(torch.device("cpu"))
    flags = predraw_schedule(get_algorithm(spec.algo).make_default_schedule(spec.config), 0,
                             spec.rounds)
    engine = make_event_engine(spec, make_byte_model(base, {"w": torch.zeros(n, 8)}, n), flags,
                               network=base.network)
    assert not engine.trivial
    mixing = make_async_mixing(spec, device)
    mixing.network.engine = engine
    operands, _, _ = mixing.network.device_block(0, spec.rounds)
    return mixing, operands, engine


# The async mixers: K4 over an event engine's CSR weights (stragglers dropped
# past the staleness bound) and K3 over its W_k, against the plain versions
def test_k4_k3_over_an_event_engine_block(cuda, gen):
    sparse = ExperimentSpec.create(
        algo="pisco", n_agents=300, p=0.2, seed=0, topology="random_regular", sparse=True,
        rounds=6, driver="events", systems="lognormal-stragglers",
        async_="poly:alpha=0.5,bound=1,buffer=150")
    mixing, operands, engine = _event_block(sparse, cuda)
    net = mixing.network
    for i in np.nonzero(~engine.flags)[0]:
        net.stage(operands, i)
        x = torch.randn(300, 517, generator=gen, device=cuda)
        ops.reset_launch_counts()
        mixed = ops.sparse_mix_csr(x, *net.gossip_w)
        assert ops.launch_counts()["sparse_mix"] == 1
        torch.testing.assert_close(mixed, ref.sparse_mix_csr_ref(x, *net.gossip_w), rtol=1e-6,
                                   atol=1e-6)
    dense = ExperimentSpec.create(
        algo="pisco", n_agents=64, p=0.2, seed=0, topology="erdos_renyi",
        topology_kwargs={"prob": 0.3, "seed": 7}, rounds=6, driver="events",
        systems="wan-gossip", async_="poly:alpha=0.5,bound=1,buffer=32", compression="q8")
    mixing, operands, engine = _event_block(dense, cuda)
    net = mixing.network
    for i in np.nonzero(~engine.flags)[0]:
        net.stage(operands, i)
        w = net.gossip_w
        assert mixing.compression._operands()[0] is w
        x = torch.randn(64, 300, generator=gen, device=cuda)
        am = ops.row_absmax(x)
        codes, _ = ops.quant_codes(x, am, bits=8)
        ops.reset_launch_counts()
        out = ops.code_mix(x, codes, w, am, bits=8)
        assert ops.launch_counts()["compressed_mix"] == 1
        torch.testing.assert_close(out, ref.code_mix_ref(x, codes, w, am, 8, 1.0, bf16_split=True),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"topology": "erdos_renyi", "compression": "q8d", "network": "matching",
     "participation": 0.5},
    {"topology": "random_regular", "sparse": True, "network": "bernoulli:0.3",
     "participation": 0.5},
    {"topology": "random_regular", "sparse": True, "compression": "q8d", "cohort": 0.25},
    {"algo": "dsgt", "topology": "ring", "network": "roundrobin:2", "optimizer": "momentum:lr=0.1"},
    {"topology": "ring", "optimizer": "adam:lr=0.05", "server_optimizer": "fedadam"},
])
def test_dynamic_and_rule_runs_gpu_match_cpu(cuda, kw):
    n = 32
    x, y = synthetic_mnist(n * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n)
    spec = ExperimentSpec.create(n_agents=n, t_o=2, eta_l=0.1, p=0.3, rounds=4, **kw)
    hists = []
    for dev in (cuda, torch.device("cpu")):
        resident = data.to(dev)
        hists.append(Experiment(
            spec, loss_fn=mlp_loss, params0=mlp_init(0), device=dev,
            sampler_factory=lambda s: RoundSampler(resident, 16, 2, s.config.seed, device=dev),
        ).run())
    gpu, cpu = hists
    assert gpu.is_global == cpu.is_global
    assert gpu.accountant.per_round_bytes == cpu.accountant.per_round_bytes
    # deterministic rounding may round a near-tie a step apart (chip_smoke's q8d limit)
    np.testing.assert_allclose(gpu.loss, cpu.loss, rtol=1e-3 if kw.get("compression") else 1e-4)


def test_static_process_and_sgd_rule_bit_equal_on_the_card(cuda):
    """network="static" realizes the base W every round and optimizer="sgd"
    is the inline step (K1 rounds eta*y before subtracting, as the rule's
    x + (-eta*y) does): both bit-equal to the plain spec on the card."""
    n = 10
    x, y = synthetic_mnist(n * 20, seed=0)
    resident = FederatedDataset.from_arrays(x, y, n).to(cuda)
    spec = ExperimentSpec.create(n_agents=n, t_o=2, eta_l=0.1, p=0.3, rounds=6, topology="ring")

    def run(s):
        return Experiment(s, loss_fn=mlp_loss, params0=mlp_init(0), device=cuda,
                          sampler_factory=lambda s_: RoundSampler(resident, 16, 2, s_.config.seed,
                                                                  device=cuda)).run()

    base = run(spec)
    for other in (run(spec.replace(network="static")), run(spec.replace(optimizer="sgd"))):
        assert other.loss == base.loss
        assert all(torch.equal(other.final_state.x[k], base.final_state.x[k]) for k in base.final_state.x)


@pytest.mark.parametrize("sparse", [False, True])
def test_topk_gossip_gpu_matches_cpu(cuda, sparse):
    """Top-k gossip (stateless and with error feedback) on the card against
    the CPU: the kept coordinates and the residual bit-equal, the mixed
    output within 1e-5 (W q summed in another order); over the sparse mixer
    W q runs K4."""
    from repro_torch.core.compression import compress_mixing, make_compressor
    from repro_torch.core.mixing import dense_mixing, sparse_mixing
    from repro_torch.core.topology import make_topology

    n = 64
    rng = np.random.default_rng(0)
    tree = {"w1": rng.normal(size=(n, 32, 25)).astype(np.float32),
            "b1": rng.normal(size=(n, 10)).astype(np.float32)}
    res = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in tree.items()}
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        base = (sparse_mixing(make_sparse_topology("random_regular", n), dev) if sparse else
                dense_mixing(make_topology("erdos_renyi", n, prob=0.3, seed=7), dev))
        mixing = compress_mixing(base, make_compressor("top0.1"))
        t = {k: torch.as_tensor(v, device=dev) for k, v in tree.items()}
        r = {k: torch.as_tensor(v, device=dev) for k, v in res.items()}
        ops.reset_launch_counts()
        mixed, new_res = mixing.compression(t, r, None)
        stateless = mixing.gossip(t)
        counts = ops.launch_counts()
        outs[dev.type] = (mixed, new_res, stateless)
        if dev.type == "cuda":
            assert counts.get("sparse_mix", 0) == (4 if sparse else 0), counts
    (mg, rg, sg), (mc, rc, sc) = outs["cuda"], outs["cpu"]
    for k in tree:
        assert torch.equal(rg[k].cpu(), rc[k])
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=1e-5, atol=1e-5)


def test_seed_sweep_seed0_equals_run_on_the_card(cuda):
    n = 16
    x, y = synthetic_mnist(n * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n).to(cuda)
    xt, yt = data.x_test, data.y_test
    spec = ExperimentSpec.create(n_agents=n, t_o=2, eta_l=0.1, p=0.3, rounds=6, eval_every=3,
                                 block_size=4, compression="q8")
    exp = Experiment(
        spec, loss_fn=mlp_loss, params0=mlp_init(0), device=cuda,
        eval_fn=lambda p: {"loss": float(mlp_loss(p, (xt, yt)))},
        sampler_factory=lambda s: RoundSampler(data, 16, s.config.t_o, s.config.seed, device=cuda),
    )
    ops.reset_launch_counts()
    hists = exp.sweep(seeds=[0, 1])
    assert ops.launch_counts()["compressed_mix"] > 0
    single = exp.run()
    assert hists[0].loss == single.loss and hists[0].eval_metrics == single.eval_metrics
    assert hists[1].loss != single.loss and hists[1].is_global == single.is_global
    for k in single.final_state.x:
        assert torch.equal(hists[0].final_state.x[k], single.final_state.x[k])


def _bf16_ulp(x):
    """One bf16 ulp at |x| (2^(e - 7) for |x| in [2^e, 2^(e + 1)))."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("b,hq,hkv,s,d,window,dtype,cache", [
    (1, 32, 8, 300, 128, None, torch.bfloat16, None), (2, 4, 2, 77, 32, None, torch.float32, None),
    (1, 8, 8, 130, 64, 50, torch.float32, None), (1, 4, 1, 64, 128, 16, torch.bfloat16, None),
    # the tensor-core path: ragged lengths around its 128-row tiles ...
    (1, 8, 2, 1, 128, None, torch.bfloat16, None), (1, 8, 2, 63, 128, None, torch.bfloat16, None),
    (1, 8, 2, 127, 128, None, torch.bfloat16, None), (1, 8, 2, 129, 128, None, torch.bfloat16, None),
    (1, 32, 8, 500, 128, None, torch.bfloat16, None),
    (1, 32, 8, 2048, 128, None, torch.bfloat16, None),
    # ... head dims 32 and 64; MHA, GQA by 4, MQA by 8
    (1, 8, 8, 200, 32, None, torch.bfloat16, None), (1, 8, 2, 200, 64, None, torch.bfloat16, None),
    (2, 8, 1, 150, 128, None, torch.bfloat16, None),
    # windows of 16 and of 256 at S = 1000
    (1, 8, 2, 300, 128, 16, torch.bfloat16, None), (1, 8, 2, 1000, 128, 256, torch.bfloat16, None),
    # k and v the first 500 positions of a 700-long cache
    (1, 8, 2, 500, 128, None, torch.bfloat16, 700), (2, 4, 4, 333, 64, 100, torch.bfloat16, 400),
])
def test_k6_within_tolerance(cuda, gen, b, hq, hkv, s, d, window, dtype, cache):
    # q as the prefill hands it over: a (B, H, S, D) view of (B, S, H, D)
    q = torch.randn(b, s, hq, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn(b, hkv, cache or s, d, generator=gen, device=cuda).to(dtype)[:, :, :s]
            for _ in range(2))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_tc"] == (1 if dtype == torch.bfloat16 else 0)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    # f32: the ROADMAP's 2e-6; bf16: the output's rounding, 2e-2
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=tol)
    if dtype == torch.bfloat16:
        # against the plain version that rounds P to bf16 as the kernel does:
        # one bf16 ulp (the two outputs may round apart) plus 2^-8 (P rounded
        # against the running max, not the final one)
        model = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                        p_dtype=torch.bfloat16).float()
        assert bool(((out.float() - model).abs() <= _bf16_ulp(model) + 2.0 ** -8).all())


def test_k6_raises_on_strides_tma_cannot_take(cuda, gen):
    # (B, S, H, D) rows padded to 132 elements: positions 264 bytes apart
    x = torch.randn(1, 40, 4 * 132, generator=gen, device=cuda).to(torch.bfloat16)
    q = x.view(1, 40, 4, 132)[..., :128].transpose(1, 2)
    k, v = (torch.randn(1, 2, 40, 128, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"q\.stride\(1\)"):
        ops.flash_attention(q, k, v)
    # k's positions 2 * 128 + 4 elements (520 bytes) apart, heads 256 bytes
    kbuf = torch.randn(40, 260, generator=gen, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match=r"k\.stride\(2\)"):
        ops.flash_attention(q.contiguous(), kbuf.as_strided((1, 2, 40, 128), (0, 128, 260, 1)), v)
    assert ops.launch_counts()["flash_attention"] == 0
    # the same values through an aligned copy launch the tensor-core kernel
    out = ops.flash_attention(q.contiguous(), k, v)
    assert ops.launch_counts()["flash_attention_tc"] == 1
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v).float(), rtol=0,
                               atol=2e-2)


def _k7_check(x, dt, a, bm, cm):
    """K7 against its plain version, one launch counted per call: the
    ROADMAP's 5e-4 scaled by the output's size; bf16 y is rounded to bf16
    (one bf16 ulp, 2^-8 relative)."""
    ops.reset_launch_counts()
    y, hfin = ops.ssd_scan(x, dt, a, bm, cm, chunk=256)
    assert ops.launch_counts()["ssd_scan"] == 1
    y2, h2 = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
    assert y.shape == y2.shape and y.dtype == x.dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(hfin).all()
    ymax = 1.0 + float(y2.float().abs().max())
    ytol = 5e-4 if x.dtype == torch.float32 else 2.0 ** -8
    assert float((y.float() - y2.float()).abs().max()) <= ytol * ymax
    assert float((hfin - h2).abs().max()) <= 5e-4 * (1.0 + float(h2.abs().max()))


# L = 1 and 65: one step, and one step past the kernel's 64-step chunk
@pytest.mark.parametrize("b,l,h,p,g,n,dtype", [
    (1, 300, 32, 64, 1, 128, torch.bfloat16), (2, 77, 8, 32, 2, 16, torch.float32),
    (1, 1000, 4, 64, 1, 128, torch.float32), (1, 3, 2, 16, 1, 8, torch.float32),
    (1, 1, 4, 64, 1, 128, torch.bfloat16), (1, 65, 4, 64, 1, 128, torch.bfloat16),
    (2, 77, 8, 32, 2, 16, torch.bfloat16), (1, 65, 2, 16, 1, 8, torch.float32)])
def test_k7_within_tolerance(cuda, gen, b, l, h, p, g, n, dtype):
    x = torch.randn(b, l, h, p, generator=gen, device=cuda).to(dtype)
    dt = (0.1 * torch.rand(b, l, h, generator=gen, device=cuda)).to(dtype)
    a = -0.5 - 4 * torch.rand(h, generator=gen, device=cuda)
    bm, cm = (torch.randn(b, l, g, n, generator=gen, device=cuda).to(dtype) for _ in range(2))
    _k7_check(x, dt, a, bm, cm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_strong_decay(cuda, gen, dtype):
    """dt = 0.1, A = -16: a 64-step chunk decays by e^-102, past where
    exp(-cum) overflows f32; y and the state stay finite and within
    tolerance."""
    b, l, h, p, g, n = 1, 1000, 8, 64, 1, 128
    x = torch.randn(b, l, h, p, generator=gen, device=cuda).to(dtype)
    dt = torch.full((b, l, h), 0.1, device=cuda).to(dtype)
    a = torch.full((h,), -16.0, device=cuda)
    bm, cm = (torch.randn(b, l, g, n, generator=gen, device=cuda).to(dtype) for _ in range(2))
    _k7_check(x, dt, a, bm, cm)


# offset 1 puts every row 2 bytes past a 16-byte boundary: the kernel
# stages those tiles through registers instead of cp.async
@pytest.mark.parametrize("offset", [0, 1])
def test_k7_reads_the_prefills_split_views(cuda, gen, offset):
    """x, B and C as the prefill hands them over: reshaped column slices of
    one (B, L, d_in + 2 G N) conv output, read through their strides with no
    copy, and dt a column slice of a wider projection."""
    b, l, h, p, g, n = 2, 200, 8, 64, 2, 128
    w = h * p + 2 * g * n
    flat = torch.randn(b * l * w + offset, generator=gen, device=cuda).to(torch.bfloat16)
    xbc = flat[offset:].view(b, l, w)
    xs, bs, cs = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    x, bm, cm = xs.reshape(b, l, h, p), bs.reshape(b, l, g, n), cs.reshape(b, l, g, n)
    assert x.data_ptr() == xbc.data_ptr() and not bm.is_contiguous()
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    dt = (0.1 * torch.rand(b, l, h + 5, generator=gen, device=cuda)).to(torch.bfloat16)[..., :h]
    a = -1.0 - 15.0 * torch.rand(h, generator=gen, device=cuda)
    _k7_check(x, dt, a, bm, cm)


@pytest.mark.parametrize("shape,dtype,wire,has_y,has_right", [
    ((1000, 37), torch.float32, torch.float32, True, True),
    ((4096, 8), torch.bfloat16, torch.bfloat16, True, True),
    ((3, 1001), torch.bfloat16, torch.float32, False, True),
    ((2048,), torch.float32, torch.float32, False, False),
    ((5,), torch.bfloat16, torch.float32, False, False)])
def test_k8_exact(cuda, gen, shape, dtype, wire, has_y, has_right):
    xk, xt, yt = (torch.randn(*shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    left, right = (torch.randn(*shape, generator=gen, device=cuda).to(wire) for _ in range(2))
    yt = yt if has_y else None
    right = right if has_right else None
    kw = dict(eta_c=0.7, eta_l=0.05, w_self=0.5, w_left=0.25, w_right=0.25 if has_right else 0.0)
    ops.reset_launch_counts()
    if has_y:
        out = ops.fused_mix_combine(xk, xt, yt, left, right, **kw)
    else:
        kw.pop("eta_l")
        out = ops.mix_combine_half(xk, xt, left, right, **kw)
        kw["eta_l"] = 0.0
    assert ops.launch_counts()["fused_mix_combine"] == 1
    want = ref.fused_mix_combine_ref(xk, xt, yt, left, right, kw["eta_c"], kw["eta_l"],
                                     kw["w_self"], kw["w_left"], kw["w_right"])
    assert out.dtype == dtype and torch.equal(out, want)  # same roundings, f32 math


@pytest.mark.parametrize("n,d,dtype,bits,res,noise", [
    (1, 200_003, torch.float32, 8, True, False), (1, 1 << 20, torch.bfloat16, 8, True, False),
    (4, 4096, torch.bfloat16, 4, False, True), (3, 1001, torch.float32, 8, True, True),
    (512, 328, torch.float32, 8, False, False)])
def test_k2_one_row_and_k9_exact(cuda, gen, n, d, dtype, bits, res, noise):
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    r = (0.01 * torch.randn(n, d, generator=gen, device=cuda)).to(dtype) if res else None
    u = torch.rand(n, d, generator=gen, device=cuda) if noise else None
    ops.reset_launch_counts()
    am = ops.row_absmax(x, r)
    assert torch.equal(am, ref.row_absmax_ref(x, r))  # max is exact in any order
    q, r_new = ops.rowwise_quant_dequant(x, am, bits=bits, residual=r, noise=u)
    assert ops.launch_counts()["rowwise_quant_dequant"] == 1
    q2, r2 = ref.rowwise_quant_dequant_ref(x, am, bits, r, u)
    assert q.dtype == dtype and torch.equal(q, q2)
    assert (r_new is None) == (r is None)
    if r is not None:
        assert torch.equal(r_new, r2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m"])
def test_reduced_serving_gpu_matches_cpu(cuda, arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import (ArrivalProcess, ContinuousBatcher, DecodeEngine, FleetDelta,
                                   StepCosts, make_requests, run_load)
    from repro_torch.utils.pytree import nest_map

    streams = []
    # one set of weights for both devices: drawn on the CPU (a CUDA generator
    # draws other numbers from the same seed), moved to the card
    base = get_bundle(get_reduced(arch), "cpu").init(0)
    ops.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        bundle = get_bundle(get_reduced(arch), dev)
        fleet = FleetDelta.synthetic(nest_map(lambda t: t.to(dev), base), 4, seed=0)
        reqs = make_requests(ArrivalProcess(rate=4.0), 4, n_agents=4, vocab_size=512,
                             prompt_len=37, max_new_tokens=6, seed=1)
        rep = run_load(ContinuousBatcher(DecodeEngine(bundle, fleet, n_slots=2, max_seq=48)),
                       reqs, costs=StepCosts())
        streams.append({r.rid: r.tokens for r in rep.requests})
    kernel = "flash_attention" if arch == "qwen3-8b" else "ssd_scan"
    assert ops.launch_counts()[kernel] == 2 * 4  # two layers, four admissions
    assert streams[0] == streams[1]


_TWO_RANKS = textwrap.dedent("""
    import os
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.pisco import init_rank_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, rank_slice
    from repro_torch.launch.steps import build_train_steps, flat_value_and_grad
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths

    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=2)
    cfg = get_reduced("mamba2-370m")
    sampler = make_lm_sampler(cfg, 2, 2, 48, 2, seed=0)
    draws = [sampler(k) for k in range(3)]
    x0 = flatten_paths(get_bundle(cfg, "cpu").init(seed=0))
    finals = {}
    for dev in ("cuda", "cpu"):
        bundle = get_bundle(cfg, dev)
        mesh = make_mesh((2, 1), ("data", "model"), dev)
        assert mesh.stage_on_host == (dev == "cuda")  # gloo moves host tensors only
        steps = build_train_steps(bundle, InputShape("t", 48, 4, "train"), mesh, t_o=2,
                                  eta_l=0.05, eta_c=0.9)
        batches = [tuple(rank_slice(b, mesh, ("data",), axis=1 - i) for i, b in enumerate(d))
                   for d in draws]
        vg = flat_value_and_grad(bundle)
        state = init_rank_state(vg, {k: v.to(dev) for k, v in x0.items()}, batches[0][1])
        ops.reset_launch_counts()
        state, _ = steps["train_gossip"].fn(state, *batches[1])
        state, _ = steps["train_global"].fn(state, *batches[2])
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["fused_mix_combine"] == len(x0), counts  # one per leaf
            assert counts["fused_local_step"] == 2 * 2 * len(x0), counts
        finals[dev] = {k: v.cpu() for k, v in state.x.items()}
    for k, want in finals["cpu"].items():
        # float32, other summation orders on the card over two rounds
        err = float((finals["cuda"][k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (k, err)
    # bf16 state, eta_c = 0.7, the f32 wire: K8's output is bit for bit the
    # plain combine of the float32 candidates of the rank and its neighbour
    import torch
    from repro_torch.core import mixing as M
    from repro_torch.kernels import ref
    ring = M.collective_shift_mixing(make_mesh((2, 1), ("data", "model"), "cuda"), ("data",),
                                     {"data": [(0, 0.5), (1, 0.25), (-1, 0.25)]},
                                     wire_dtype="float32")
    g = torch.Generator().manual_seed(0)
    xs, hs = (torch.randn(2, 1000, 37, generator=g).bfloat16() for _ in range(2))
    got = M.mix_candidate(ring, {"w": xs[rank].cuda()}, {"w": hs[rank].cuda()}, 0.7)["w"]
    u = [(1.0 - 0.7) * xs[i].float() + 0.7 * hs[i].float() for i in range(2)]
    want = ref.fused_mix_combine_ref(xs[rank], hs[rank], None, u[1 - rank], u[1 - rank],
                                     0.7, 0.0, 0.5, 0.25, 0.25)
    assert torch.equal(got.cpu(), want)
    dist.destroy_process_group()
    print("RANK-OK")
""")


def test_two_rank_gloo_round_on_the_card_matches_cpu(cuda):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src), PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "RANK-OK" in log, log[-3000:]
