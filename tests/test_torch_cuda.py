"""The five Hopper kernels against their plain PyTorch versions on a card,
and short PISCO and baseline runs on the GPU against the CPU.

Every test here needs a CUDA device (and ``nvcc`` for the first build); it
skips without one.  The file imports no JAX, so on a GPU machine without JAX
it runs alone, past the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
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


@pytest.mark.parametrize("name,n,d", [("random_regular", 300, 517), ("ring", 7, 3)])
def test_k4_within_tolerance(cuda, gen, name, n, d):
    topo = make_sparse_topology(name, n)
    csr = (torch.as_tensor(topo.indptr, device=cuda), torch.as_tensor(topo.indices, device=cuda),
           torch.as_tensor(topo.data, dtype=torch.float32, device=cuda),
           torch.as_tensor(topo.self_weight, dtype=torch.float32, device=cuda))
    x = torch.randn(n, d, generator=gen, device=cuda)
    # the plain version's index_add_ adds with atomics, in no fixed order
    torch.testing.assert_close(ops.sparse_mix_csr(x, *csr), ref.sparse_mix_csr_ref(x, *csr),
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

