"""The port's collective path across ranks, held against the JAX package's
collective mixers on the same numpy inputs.

One spawn of four gloo ranks on the CPU runs every case of the port, and one
JAX process with four host devices (``--xla_force_host_platform_device_count=4``,
as ``tests/test_distributed.py`` runs it) runs the reference's; both start
together from a module fixture and write their results to npz files, which
the tests below compare:

* each collective mixer (global mean, ring shift in both wire dtypes, 2 x 2
  torus, hierarchical, dense W from an Erdos-Renyi graph, compressed int8
  gossip and top-k gossip, each with and without error feedback) on one
  agent-stacked tree;
* the fused candidate combine (K8) of the ring's x-gossip against the
  reference's candidate pushed through its ring gossip, and in bfloat16
  against the plain combine of the float32 candidates (port only);
* stochastic int8 gossip with error feedback over the ring, held to its
  invariants (port only: the two frameworks draw different noise);
* one gossip round, one server round and one compressed (q8d, error
  feedback) gossip round of PISCO on reduced Mamba2-370m, float32, four
  ranks in a ring, against ``make_round_fn`` over ``collective_shift_mixing``.

Tolerance: 1e-5 of the largest reference magnitude, per leaf (float32; the
ring's combine and the gradients sum in other orders than XLA's), and one
bfloat16 rounding step (2^-8 relative) for the bfloat16 leaf.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax  # noqa: F401  (both packages in one test process, JAX on the CPU)

from repro.configs import get_reduced as j_get_reduced
from repro.models import transformer as JT

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD = 4
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
LM = dict(seq=64, batch=2, t_o=2, eta_l=0.05, eta_c=0.9)

# The tree every mixer case mixes, drawn identically on both sides.
_TREE = """
def make_tree():
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(4, 7)).astype(np.float32),
            "w": rng.normal(size=(4, 6, 5)).astype(np.float32)}
    half = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in tree.items()}
    res = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32) for k, v in tree.items()}
    bf = rng.normal(size=(4, 33)).astype(np.float32)
    return tree, half, res, bf
"""

_PORT = _TREE + textwrap.dedent("""
    import json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out = int(os.environ["RANK"]), os.environ["OUT"]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=4)

    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import mixing as M
    from repro_torch.core.compression import StochasticQuantizer, TopKCompressor, compress_mixing
    from repro_torch.core.pisco import (PiscoConfig, init_compression_state, init_rank_state,
                                        make_rank_round_fn)
    from repro_torch.core.topology import make_topology
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh, rank_slice
    from repro_torch.launch.steps import build_train_steps, flat_value_and_grad
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle

    LM = json.loads(os.environ["LM"])
    res = {}
    def keep(name, tree):
        for k, v in tree.items():
            res[name + "/" + k] = v.detach().float().numpy()

    tree, half, resid, bf = make_tree()
    ring = make_mesh((4,), ("data",), "cpu")
    torus = make_mesh((2, 2), ("pod", "data"), "cpu")
    mine = lambda t, mesh, axes: rank_slice(t, mesh, axes)
    x = mine(tree, ring, ("data",))

    g = M.collective_global_mixing(ring, ("data",))
    keep("global", g.global_avg(x))
    shifts = {"data": [(0, 0.5), (1, 0.25), (-1, 0.25)]}
    for wire in (None, "float32"):
        ops_ = M.collective_shift_mixing(ring, ("data",), shifts, wire_dtype=wire)
        keep(f"ring-{wire}", ops_.gossip(x))
        hb = mine({"h": bf}, ring, ("data",))["h"].bfloat16()
        keep(f"ring-{wire}-bf16", ops_.gossip({"h": hb}))
    ops_ = M.collective_shift_mixing(ring, ("data",), shifts, wire_dtype="float32")
    keep("candidate", M.mix_candidate(ops_, x, mine(half, ring, ("data",)), 0.9))
    bf_tree = lambda t: {k: v.bfloat16() for k, v in mine(t, ring, ("data",)).items()}
    keep("candidate-bf16", M.mix_candidate(ops_, bf_tree(tree), bf_tree(half), 0.7))
    tshifts = {"pod": [(0, 0.5), (1, 0.25)], "data": [(1, 0.25)]}
    xt = mine(tree, torus, ("pod", "data"))
    keep("torus", M.collective_shift_mixing(torus, ("pod", "data"), tshifts).gossip(xt))
    h = M.hierarchical_mixing(torus)
    keep("hier-gossip", h.gossip(xt))
    keep("hier-global", h.global_avg(xt))
    topo = make_topology("erdos_renyi", 4, prob=0.6, seed=3)
    keep("dense", M.collective_dense_mixing(ring, ("data",), topo).gossip(x))
    comp = M.compressed_mixing(M.collective_shift_mixing(ring, ("data",), shifts), bits=8)
    keep("q8d-stateless", comp.gossip(x))
    mixed, new_res = comp.compression(x, mine(resid, ring, ("data",)), None)
    keep("q8d-ef", mixed)
    keep("q8d-ef-res", new_res)
    noisy = compress_mixing(M.collective_shift_mixing(ring, ("data",), shifts),
                            StochasticQuantizer(bits=8), seed=0).compression
    mixed, new_res = noisy(x, mine(resid, ring, ("data",)), noisy.init_ef(x)["gen"])
    keep("q8-ef", mixed)
    keep("q8-ef-res", new_res)
    top = compress_mixing(M.collective_shift_mixing(ring, ("data",), shifts), TopKCompressor(0.25))
    keep("top-stateless", top.gossip(x))
    mixed, new_res = top.compression(x, mine(resid, ring, ("data",)), None)
    keep("top-ef", mixed)
    keep("top-ef-res", new_res)

    # PISCO on reduced Mamba2-370m, one agent per rank
    cfg = get_reduced("mamba2-370m")
    bundle = get_bundle(cfg, "cpu")
    x0 = {k: torch.from_numpy(v) for k, v in np.load(os.environ["X0"]).items()}
    mesh = make_debug_mesh((4, 1), device="cpu")  # (data, model)
    agent = ("data",)
    steps = build_train_steps(bundle, InputShape("t", LM["seq"], 4 * LM["batch"], "train"), mesh,
                              t_o=LM["t_o"], eta_l=LM["eta_l"], eta_c=LM["eta_c"])
    vg = flat_value_and_grad(bundle)
    sampler = make_lm_sampler(cfg, 4, LM["batch"], LM["seq"], LM["t_o"], seed=0)
    # local batches carry the agent axis second, the comm batch first
    batches = [tuple(rank_slice(b, mesh, agent, axis=1 - i) for i, b in enumerate(sampler(k)))
               for k in range(4)]
    state0 = init_rank_state(vg, x0, batches[0][1])
    state, loss = steps["train_gossip"].fn(state0, *batches[1])
    for f in ("x", "y", "g"):
        keep("round-gossip/" + f, getattr(state, f))
    res["round-gossip/loss"] = np.array(float(loss))
    state, loss = steps["train_global"].fn(state, *batches[2])
    for f in ("x", "y", "g"):
        keep("round-global/" + f, getattr(state, f))
    res["round-global/loss"] = np.array(float(loss))
    cmix = M.compressed_mixing(steps["train_gossip"].mixing, bits=8)
    q8d_round = make_rank_round_fn(
        vg, PiscoConfig(4, LM["t_o"], LM["eta_l"], LM["eta_c"]), cmix, global_round=False)
    state, loss = q8d_round(init_compression_state(state0, cmix), *batches[3])
    for f in ("x", "y", "g"):
        keep("round-q8d/" + f, getattr(state, f))
    keep("round-q8d/res-x", state.ef["x"])
    keep("round-q8d/res-y", state.ef["y"])
    res["round-q8d/loss"] = np.array(float(loss))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")

_JAX = _TREE + textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_reduced
    from repro.core import mixing as M
    from repro.core.compression import TopKCompressor, compress_mixing
    from repro.core.pisco import (PiscoConfig, init_compression_state, init_state,
                                  make_round_fn, replicate_params)
    from repro.core.topology import make_topology
    from repro.launch.steps import mesh_gossip_shifts
    from repro.launch.train import make_lm_sampler
    from repro.models import get_bundle
    from repro.models import transformer as JT
    from repro.utils.compat import make_mesh

    LM = json.loads(os.environ["LM"])
    res = {}
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat(tree[k], prefix + k + "/"))
            return out
        if isinstance(tree, (list, tuple)):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, prefix + str(i) + "/"))
            return out
        return {prefix[:-1]: tree}
    def keep(name, tree):
        for k, v in flat(tree).items():
            res[name + "/" + k] = np.asarray(jnp.asarray(v, jnp.float32))

    tree, half, resid, bf = make_tree()
    tree = {k: jnp.asarray(v) for k, v in tree.items()}
    ring = make_mesh((4,), ("data",))
    torus = make_mesh((2, 2), ("pod", "data"))
    spec = {k: P("data") for k in tree}
    g = M.collective_global_mixing(ring, ("data",), spec)
    keep("global", jax.jit(g.global_avg)(tree))
    shifts = {"data": [(0, 0.5), (1, 0.25), (-1, 0.25)]}
    for wire in (None, "float32"):
        ops_ = M.collective_shift_mixing(ring, ("data",), spec, shifts, wire_dtype=wire)
        keep(f"ring-{wire}", jax.jit(ops_.gossip)(tree))
        ops_h = M.collective_shift_mixing(ring, ("data",), {"h": P("data")}, shifts,
                                          wire_dtype=wire)
        keep(f"ring-{wire}-bf16", jax.jit(ops_h.gossip)({"h": jnp.asarray(bf, jnp.bfloat16)}))
    ops_ = M.collective_shift_mixing(ring, ("data",), spec, shifts, wire_dtype="float32")
    cand = {k: (1.0 - 0.9) * tree[k] + 0.9 * jnp.asarray(half[k]) for k in tree}
    keep("candidate", jax.jit(ops_.gossip)(cand))
    tspec = {k: P(("pod", "data")) for k in tree}
    tshifts = mesh_gossip_shifts(torus, ("pod", "data"))
    assert tshifts == {"pod": [(0, 0.5), (1, 0.25)], "data": [(1, 0.25)]}, tshifts
    keep("torus", jax.jit(M.collective_shift_mixing(torus, ("pod", "data"), tspec,
                                                    tshifts).gossip)(tree))
    h = M.hierarchical_mixing(torus, tspec)
    keep("hier-gossip", jax.jit(h.gossip)(tree))
    keep("hier-global", jax.jit(h.global_avg)(tree))
    topo = make_topology("erdos_renyi", 4, prob=0.6, seed=3)
    keep("dense", jax.jit(M.collective_dense_mixing(ring, ("data",), spec, topo).gossip)(tree))
    comp = M.compressed_mixing(M.collective_shift_mixing(ring, ("data",), spec, shifts), bits=8)
    keep("q8d-stateless", jax.jit(comp.gossip)(tree))
    mixed, new_res = jax.jit(comp.compression.__call__)(
        tree, {k: jnp.asarray(v) for k, v in resid.items()}, jax.random.PRNGKey(0))
    keep("q8d-ef", mixed)
    keep("q8d-ef-res", new_res)
    top = compress_mixing(M.collective_shift_mixing(ring, ("data",), spec, shifts),
                          TopKCompressor(0.25))
    keep("top-stateless", jax.jit(top.gossip)(tree))
    mixed, new_res = jax.jit(top.compression.__call__)(
        tree, {k: jnp.asarray(v) for k, v in resid.items()}, jax.random.PRNGKey(0))
    keep("top-ef", mixed)
    keep("top-ef-res", new_res)

    cfg = get_reduced("mamba2-370m")
    bundle = get_bundle(cfg)
    params = JT.init_lm(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh((4, 1), ("data", "model"))
    pspec = jax.tree.map(lambda a: P("data"), params)
    pcfg = PiscoConfig(n_agents=4, t_o=LM["t_o"], eta_l=LM["eta_l"], eta_c=LM["eta_c"])
    shifts = mesh_gossip_shifts(mesh, ("data",))
    gossip = M.collective_shift_mixing(mesh, ("data",), pspec, shifts, wire_dtype="float32")
    sampler = make_lm_sampler(cfg, 4, LM["batch"], LM["seq"], LM["t_o"], seed=0)
    batches = [sampler(k) for k in range(4)]
    state0 = init_state(bundle.loss, replicate_params(params, 4), batches[0][1])
    def run(mixing, state, k, is_global):
        fn = jax.jit(make_round_fn(bundle.loss, pcfg, mixing, global_round=is_global))
        return fn(state, *batches[k])
    state, met = run(gossip, state0, 1, False)
    for f in ("x", "y", "g"):
        keep("round-gossip/" + f, getattr(state, f))
    res["round-gossip/loss"] = np.asarray(met.loss)
    state, met = run(gossip, state, 2, True)
    for f in ("x", "y", "g"):
        keep("round-global/" + f, getattr(state, f))
    res["round-global/loss"] = np.asarray(met.loss)
    cmix = M.compressed_mixing(gossip, bits=8)
    state, met = run(cmix, init_compression_state(state0, cmix), 3, False)
    for f in ("x", "y", "g"):
        keep("round-q8d/" + f, getattr(state, f))
    keep("round-q8d/res-x", state.ef["x"])
    keep("round-q8d/res-y", state.ef["y"])
    res["round-q8d/loss"] = np.asarray(met.loss)
    np.savez(os.path.join(os.environ["OUT"], "jax.npz"), **res)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + k + "/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + str(i) + "/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Run the four port ranks and the JAX process once, side by side."""
    out = str(tmp_path_factory.mktemp("collective"))
    x0 = os.path.join(out, "x0.npz")
    np.savez(x0, **_flat(JT.init_lm(jax.random.PRNGKey(0), j_get_reduced("mamba2-370m"))))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, X0=x0, LM=json.dumps(LM),
               PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _JAX], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _PORT], env=dict(env, RANK=str(r)),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    port = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)]
    stacked = {k: np.stack([p[k] for p in port]) for k in port[0]}
    return stacked, dict(np.load(os.path.join(out, "jax.npz")))


def _compare(results, name, tol=F32_TOL, scale_of=None, flips=0.0):
    """Every leaf of case ``name`` within ``tol`` of its largest reference
    magnitude — or of case ``scale_of``'s leaf of the same name: an
    error-feedback residual m - q is held to the scale of the message m,
    since it inherits m's rounding (the reference's jitted quantizer may
    place the scale one ulp apart, see test_torch_kernels).

    ``flips``: the share of elements allowed past ``tol`` when the case
    quantizes values that the two frameworks computed to within rounding
    (a gradient step): where m / s lies within rounding of a half-integer
    the deterministic grid rounds the two apart, by one quantization step
    s <= max |m| / 127.  Those elements must stay within two such steps."""
    port, ref = results
    keys = [k for k in ref if k == name or k.startswith(name + "/")]
    assert keys, name
    for k in keys:
        want = ref[k]
        got = port[k] if not k.endswith("/loss") else port[k].mean()
        base = want if scale_of is None else ref[scale_of + k[len(name):]]
        scale = max(float(np.abs(base).max()), 1e-30)
        diff = np.abs(got - want)
        off = float(np.mean(diff > tol * scale))
        assert off <= flips, f"{k}: {off} of the elements past {tol} * {scale} (allowed {flips})"
        bound = tol * scale if not flips else 2 * scale / 127
        assert float(diff.max()) <= bound, f"{k}: max |err| {float(diff.max())} > {bound}"


@pytest.mark.parametrize("case", ["global", "ring-None", "ring-float32", "torus", "hier-gossip",
                                  "hier-global", "dense", "q8d-stateless", "q8d-ef",
                                  "q8d-ef-res", "top-stateless", "top-ef", "top-ef-res"])
def test_collective_mixer_matches_jax(results, case):
    _compare(results, case, scale_of="q8d-ef" if case == "q8d-ef-res" else None)


@pytest.mark.parametrize("wire", ["None", "float32"])
def test_ring_gossip_of_bf16_leaf_matches_jax(results, wire):
    _compare(results, f"ring-{wire}-bf16", BF16_TOL)


def test_fused_candidate_combine_matches_jax_ring_gossip(results):
    _compare(results, "candidate")


@pytest.mark.parametrize("kind", ["round-gossip", "round-global", "round-q8d"])
def test_lm_round_across_ranks_matches_jax(results, kind):
    _compare(results, f"{kind}/loss")
    if kind != "round-q8d":
        for f in ("x", "y", "g"):
            _compare(results, f"{kind}/{f}")
        return
    # The compressed round quantizes the candidate, which the two frameworks
    # computed to within rounding: a few elements round apart at ties of the
    # int8 grid (see _compare), x and its residual by one step there.  g is
    # then taken at points a step apart on those elements: 1e-3 of its scale.
    # y's message carries g's difference, so any of its elements may round
    # to the neighbouring grid point: within two steps everywhere.
    _compare(results, f"{kind}/x", flips=1e-4)
    _compare(results, f"{kind}/res-x", scale_of=f"{kind}/x", flips=1e-4)
    _compare(results, f"{kind}/g", tol=1e-3)
    _compare(results, f"{kind}/y", flips=1.0)
    _compare(results, f"{kind}/res-y", scale_of=f"{kind}/y", flips=1.0)


def _inputs():
    ns = {"np": np}
    exec(_TREE, ns)
    return ns["make_tree"]()


def test_bf16_candidate_combine_sends_its_float32_candidate(results):
    """bfloat16 state, eta_c = 0.7, the float32 wire: each rank's output is
    bit for bit the plain combine of its own candidate and those of its
    neighbours (the rank 1 behind first), each formed in float32 as K8 forms
    the rank's own term; so the sum over ranks is kept within one bfloat16
    rounding of each output."""
    import torch

    from repro_torch.kernels import ref

    port, _ = results
    tree, half, _, _ = _inputs()
    for k in tree:
        xk = torch.from_numpy(tree[k]).bfloat16()
        xh = torch.from_numpy(half[k]).bfloat16()
        u = (1.0 - 0.7) * xk.float() + 0.7 * xh.float()
        got = port["candidate-bf16/" + k]
        for r in range(WORLD):
            want = ref.fused_mix_combine_ref(xk[r], xh[r], None, u[(r - 1) % WORLD],
                                             u[(r + 1) % WORLD], 0.7, 0.0, 0.5, 0.25, 0.25)
            np.testing.assert_array_equal(got[r], want.float().numpy(), err_msg=f"{k} rank {r}")
        drift = np.abs(got.astype(np.float64).sum(0) - u.double().numpy().sum(0)).max()
        assert drift <= WORLD * 2.0 ** -9 * np.abs(got).max(), (k, drift)


def test_stochastic_collective_gossip_keeps_the_mean_and_the_grid(results):
    """Stochastic int8 gossip with error feedback (noise from the rank's own
    generator on its device): the sum over ranks of x is kept to float32
    rounding, each rank's message q = m - r' lies on its int8 grid within
    one step of m = x + r, and some elements round away from the nearest
    grid point (the noise was drawn)."""
    port, _ = results
    tree, _, resid, _ = _inputs()
    away = total = 0
    for k in tree:
        out, new_res = port["q8-ef/" + k], port["q8-ef-res/" + k]
        m = tree[k] + resid[k]
        vmax = max(np.abs(m).max(), np.abs(out).max())
        drift = np.abs(out.astype(np.float64).sum(0) - tree[k].astype(np.float64).sum(0)).max()
        assert drift <= WORLD * 2.0 ** -18 * vmax, (k, drift)
        for r in range(WORLD):
            s = np.abs(m[r]).max() / 127
            steps = (m[r] - new_res[r]).astype(np.float64) / s
            grid = np.round(steps)
            assert np.abs(steps - grid).max() <= 1e-3 and np.abs(grid).max() <= 127, (k, r)
            assert np.abs(new_res[r]).max() <= s * (1 + 1e-3), (k, r)
            away += int(np.sum(grid != np.round(m[r].astype(np.float64) / s)))
            total += m[r].size
    assert away > 0.05 * total, (away, total)
