"""Byzantine agents over rank meshes: ``make_adversarial_mixing`` wrapping
the port's collective mixers, on four gloo ranks on the CPU, held against
the reference's ``make_adversarial_mixing`` over its collective mixers
(one JAX process with ``--xla_force_host_platform_device_count=4``, as
``tests/test_torch_collective.py`` runs it) and against the port's own
dense path on the same W.

Each case runs three PISCO rounds (gossip, server, gossip) of a least-squares
model with two leaves, ``b`` (3,) and ``w`` (8, 3):

* flat, four agents on a ring (the fused candidate combine, K8) or under a
  dense W from an Erdos-Renyi graph, under ``signflip``, ``collusion`` and
  ``random`` with the mean, trimmed, median and Krum server rules, and one
  ring wrapped in q8d (deterministic int8 with error feedback);
* pod-as-agent, two agents on ``pod`` over two ``data`` ranks each, ``w``
  split over ``data`` (its rows; ``b`` held by both), ``w`` gathered in the
  loss and its gradient reduce-scattered (``repro_torch.launch.mesh.DataAxis``,
  ``repro_torch.launch.steps.sharded_value_and_grad``),
  the agent's shards given by ``repro_torch.launch.steps.agent_shards``.

The Byzantine masks are bit-equal to the reference's.  ``signflip`` and
``collusion`` (the reference's direction put in place of the port's draw,
as ``tests/_torch_adversary.py`` does) are held against the reference's
states after the three rounds; ``random``, whose noise the two frameworks
draw differently, against the port's dense path with the same W (the
noise pure in (seed, round, leaf)), and so is every sign flip.  Tolerance:
1e-6 of the largest reference magnitude per leaf (float32); q8d's
candidates land on the int8 grid, where a value that the two frameworks
computed to within rounding may round one step apart (as in
``test_torch_collective``'s q8d round).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both packages in one test process, JAX on the CPU)

from repro.core import adversary as jadv

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-6
SEED = 3
LS = dict(batch=6, t_o=2, eta_l=0.05, eta_c=0.9)

# name: (mesh, mixer, adversary, robust rule, compressed, against the reference)
CASES = {
    "ring-signflip-mean": ("flat", "ring", "signflip:f=0.25", "mean", False, True),
    "ring-signflip-trimmed": ("flat", "ring", "signflip:f=0.25", "trimmed", False, True),
    "ring-signflip2-krum": ("flat", "ring", "signflip:f=0.25,scale=2", "krum", False, True),
    "ring-collusion-median": ("flat", "ring", "collusion:f=0.25", "median", False, True),
    "ring-collusion-krum": ("flat", "ring", "collusion:f=0.25,scale=0.5", "krum", False, True),
    "ring-collusion-mean": ("flat", "ring", "collusion:f=0.25", "mean", False, True),
    "dense-collusion-trimmed": ("flat", "dense", "collusion:f=0.25", "trimmed", False, True),
    "dense-signflip-median": ("flat", "dense", "signflip:f=0.25", "median", False, True),
    "ring-random-mean": ("flat", "ring", "random:f=0.25,scale=0.5", "mean", False, False),
    "ring-random-trimmed": ("flat", "ring", "random:f=0.25,scale=0.5", "trimmed", False, False),
    "ring-random-krum": ("flat", "ring", "random:f=0.25,scale=0.5", "krum", False, False),
    "ring-signflip-q8d": ("flat", "ring", "signflip:f=0.25", "mean", True, True),
    "pod-signflip-mean": ("pod", "ring", "signflip:f=0.25", "mean", False, True),
    "pod-collusion-median": ("pod", "ring", "collusion:f=0.25", "median", False, True),
    "pod-signflip-krum": ("pod", "ring", "signflip:f=0.25", "krum", False, True),
    "pod-random-mean": ("pod", "ring", "random:f=0.25,scale=0.5", "mean", False, False),
}
N_AGENTS = {"flat": 4, "pod": 2}

_DATA = """
def make_data(n):
    # x0 and four batch draws: Z^0, then each of the three rounds' local
    # batches (T_O, n, B, .) and comm batch (n, B, .)
    rng = np.random.default_rng(7)
    x0 = {"b": (0.1 * rng.normal(size=(3,))).astype(np.float32),
          "w": (0.3 * rng.normal(size=(8, 3))).astype(np.float32)}
    w_true = rng.normal(size=(n, 8, 3))
    rounds = []
    for k in range(4):
        loc = {"x": rng.normal(size=(T_O, n, B, 8)).astype(np.float32)}
        loc["y"] = (np.einsum("tnbi,nij->tnbj", loc["x"], w_true)
                    + 0.1 * rng.normal(size=(T_O, n, B, 3))).astype(np.float32)
        com = {"x": rng.normal(size=(n, B, 8)).astype(np.float32)}
        com["y"] = (np.einsum("nbi,nij->nbj", com["x"], w_true)
                    + 0.1 * rng.normal(size=(n, B, 3))).astype(np.float32)
        rounds.append((loc, com))
    return x0, rounds
"""

_PORT = textwrap.dedent("""
    import dataclasses, json, os, types
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out = int(os.environ["RANK"]), os.environ["OUT"]
    LS, SEED = json.loads(os.environ["LS"]), int(os.environ["SEED"])
    T_O, B = LS["t_o"], LS["batch"]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=4)
""") + _DATA + textwrap.dedent("""
    from repro_torch.core import adversary as A
    from repro_torch.core import mixing as M
    from repro_torch.core.pisco import (PiscoConfig, init_compression_state, init_rank_state,
                                        make_rank_round_fn)
    from repro_torch.core.topology import make_topology
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh

    dirs = dict(np.load(os.environ["DIRS"]))
    A.AdversaryProcess.collusion_direction = (
        lambda self, i, shape: torch.from_numpy(dirs[f"{i}/" + "x".join(map(str, shape))]))

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    # what sharded_value_and_grad reads of a model bundle; the tree is flat
    # (params_from_paths keeps an encoder-decoder's as it is)
    @dataclasses.dataclass
    class Bundle:
        fsdp: object = None  # pod-as-agent's DataAxis: the loss gathers w
        cfg = types.SimpleNamespace(is_enc_dec=True)

        def value_and_grad(self, p, b):
            live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            with torch.enable_grad():
                value = loss(live if self.fsdp is None else self.fsdp.gather(live, ""), b)
                grads = torch.autograd.grad(value, [live[k] for k in sorted(live)])
            return value.detach(), dict(zip(sorted(live), grads))

    meshes = {"flat": make_mesh((4,), ("data",), "cpu"),
              "pod": make_mesh((2, 2), ("pod", "data"), "cpu")}
    res = {}
    for name, (kind, mixer, adversary, robust, compressed, _) in json.loads(
            os.environ["CASES"]).items():
        mesh = meshes[kind]
        agent_axes = ("data",) if kind == "flat" else ("pod",)
        n = mesh.size(agent_axes)
        a = mesh.index(agent_axes)
        x0, rounds = make_data(n)
        if mixer == "ring":
            base = M.collective_shift_mixing(mesh, agent_axes,
                                             ST.mesh_gossip_shifts(mesh, agent_axes))
        else:
            base = M.collective_dense_mixing(mesh, agent_axes,
                                             make_topology("erdos_renyi", n, prob=0.6, seed=3))
        shards, fn = None, Bundle().value_and_grad
        mine = lambda t: torch.from_numpy(np.ascontiguousarray(t))  # noqa: E731
        x = {k: mine(v) for k, v in x0.items()}
        if kind == "pod":  # w's rows split over data, b held by both data ranks
            d, nd = mesh.coords["data"], mesh.shape["data"]
            dims = {"b": None, "w": 0}
            shards = ST.agent_shards({k: v.shape for k, v in x0.items()}, dims, mesh)
            fn = ST.sharded_value_and_grad(Bundle(), mesh, dims)
            x = ST.shard_leaves(x, dims, mesh)
        mixing = A.make_adversarial_mixing(base, adversary, robust, n_agents=n, seed=SEED,
                                           shards=shards)
        if compressed:
            mixing = M.compressed_mixing(mixing, bits=8)

        def agent_batches(k):
            loc, com = rounds[k]
            loc = {kk: mine(v[:, a]) for kk, v in loc.items()}
            com = {kk: mine(v[a]) for kk, v in com.items()}
            if kind == "pod":  # this data rank's rows of the agent's batch
                loc = {kk: v.chunk(nd, 1)[d].clone() for kk, v in loc.items()}
                com = {kk: v.chunk(nd, 0)[d].clone() for kk, v in com.items()}
            return loc, com

        cfg = PiscoConfig(n, LS["t_o"], LS["eta_l"], LS["eta_c"])
        state = init_compression_state(init_rank_state(fn, x, agent_batches(0)[1]), mixing)
        for k, is_global in enumerate((False, True, False), start=1):
            rf = make_rank_round_fn(fn, cfg, mixing, global_round=is_global)
            state, _ = rf(state, *agent_batches(k))
        for f in ("x", "y", "g"):
            for kk, v in getattr(state, f).items():
                res[f"{name}/{f}/{kk}"] = v.numpy()
        res[name + "/byzantine"] = np.array(mixing.rank_adversary.byzantine)
        res[name + "/agent"] = np.array(a)
        res[name + "/k"] = np.array(mixing.network.k)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")

_JAX = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    LS = json.loads(os.environ["LS"])
    T_O, B = LS["t_o"], LS["batch"]
""") + _DATA + textwrap.dedent("""
    from repro.core import adversary as A
    from repro.core import mixing as M
    from repro.core.pisco import (PiscoConfig, init_compression_state, init_state,
                                  make_round_fn, replicate_params)
    from repro.core.topology import make_topology
    from repro.launch.steps import mesh_gossip_shifts
    from repro.utils.compat import make_mesh

    def loss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    meshes = {"flat": make_mesh((4,), ("data",)), "pod": make_mesh((2, 2), ("pod", "data"))}
    res = {}
    for name, (kind, mixer, adversary, robust, compressed, vs_ref) in json.loads(
            os.environ["CASES"]).items():
        if not vs_ref:
            continue
        mesh = meshes[kind]
        agent_axes = ("data",) if kind == "flat" else ("pod",)
        n = 4 if kind == "flat" else 2
        x0, rounds = make_data(n)
        spec = {k: P(agent_axes[0]) for k in x0}
        if mixer == "ring":
            base = M.collective_shift_mixing(mesh, agent_axes, spec,
                                             mesh_gossip_shifts(mesh, agent_axes))
        else:
            base = M.collective_dense_mixing(mesh, agent_axes, spec,
                                             make_topology("erdos_renyi", n, prob=0.6, seed=3))
        mixing = A.make_adversarial_mixing(base, adversary, robust, n_agents=n, seed=%d)
        if compressed:
            mixing = M.compressed_mixing(mixing, bits=8)
        cfg = PiscoConfig(n, LS["t_o"], LS["eta_l"], LS["eta_c"])
        batch = lambda t: jax.tree.map(jnp.asarray, t)
        state = init_state(loss, replicate_params(jax.tree.map(jnp.asarray, x0), n),
                           batch(rounds[0][1]))
        state = init_compression_state(state, mixing)
        for k, is_global in enumerate((False, True, False), start=1):
            rf = jax.jit(make_round_fn(loss, cfg, mixing, global_round=is_global))
            state, _ = rf(state, batch(rounds[k][0]), batch(rounds[k][1]))
        for f in ("x", "y", "g"):
            for kk, v in getattr(state, f).items():
                res[f"{name}/{f}/{kk}"] = np.asarray(v)
    np.savez(os.path.join(os.environ["OUT"], "jax.npz"), **res)
""" % SEED)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _directions(path):
    """The reference's collusion direction of each leaf (sorted order: b,
    then w), at every seed-free shape the cases use."""
    from _torch_adversary import ref_collusion_direction

    proc = jadv.parse_adversary_spec("collusion:f=0.25", 4, SEED)
    dirs = {f"{i}/" + "x".join(map(str, shape)): ref_collusion_direction(proc, i, shape).numpy()
            for i, shape in ((0, (3,)), (1, (8, 3)))}
    np.savez(path, **dirs)


def _dense_runs(cases):
    """The port's dense path on the same W (the ring's circulant W, or the
    Erdos-Renyi W), the agents stacked: each case's state after the three
    rounds, with the round index staged as the rank path takes it."""
    from repro_torch.core import adversary as A
    from repro_torch.core import mixing as M
    from repro_torch.core.pisco import (PiscoConfig, init_compression_state, init_state,
                                        make_round_fn, replicate_params)
    from repro_torch.core.topology import make_topology

    ns = {"np": np, "T_O": LS["t_o"], "B": LS["batch"]}
    exec(_DATA, ns)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    out = {}
    for name, (kind, mixer, adversary, robust, compressed, _) in cases.items():
        n = N_AGENTS[kind]
        x0, rounds = ns["make_data"](n)
        if mixer == "ring":
            w = (np.full((2, 2), 0.5) if n == 2 else
                 0.5 * np.eye(n) + 0.25 * (np.roll(np.eye(n), 1, 1) + np.roll(np.eye(n), -1, 1)))
            topo = dataclasses.replace(make_topology("full", n), name="ring", w=w)
        else:
            topo = make_topology("erdos_renyi", n, prob=0.6, seed=3)
        base = M.dense_mixing(topo, torch.device("cpu"))
        mixing = A.make_adversarial_mixing(base, adversary, robust, n_agents=n, seed=SEED)
        if compressed:
            mixing = M.compressed_mixing(mixing, bits=8)
        t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
        cfg = PiscoConfig(n, LS["t_o"], LS["eta_l"], LS["eta_c"])
        state = init_compression_state(
            init_state(loss, replicate_params(t(x0), n), t(rounds[0][1])), mixing)
        for k, is_global in enumerate((False, True, False), start=1):
            if mixing.network is not None:
                mixing.network.stage(mixing.network.device_block(k - 1, k)[0], 0)
            rf = make_round_fn(loss, cfg, mixing, global_round=is_global)
            state, _ = rf(state, t(rounds[k][0]), t(rounds[k][1]))
        for f in ("x", "y", "g"):
            for kk, v in getattr(state, f).items():
                out[f"{name}/{f}/{kk}"] = v.numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("adv_ranks"))
    dirs = os.path.join(out, "dirs.npz")
    _directions(dirs)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, DIRS=dirs,
               LS=json.dumps(LS), CASES=json.dumps(CASES), PORT=str(_free_port()), SEED=str(SEED),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _JAX], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _PORT], env=dict(env, RANK=str(r)),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(4)]
    try:
        dense = _dense_runs(CASES)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)]
    return ranks, dict(np.load(os.path.join(out, "jax.npz"))), dense


def _agent_state(ranks, name, kind):
    """The agent-stacked state (b and w whole) from the ranks' results."""
    out = {}
    for f in ("x", "y", "g"):
        for k in ("b", "w"):
            if kind == "flat":
                rows = [None] * 4
                for res in ranks:
                    rows[int(res[name + "/agent"])] = res[f"{name}/{f}/{k}"]
            else:  # ranks (pod, data) row-major: w's rows over data
                rows = []
                for p in range(2):
                    mine = [ranks[2 * p + d][f"{name}/{f}/{k}"] for d in range(2)]
                    if k == "w":
                        rows.append(np.concatenate(mine, 0))
                    else:
                        np.testing.assert_array_equal(mine[0], mine[1])
                        rows.append(mine[0])
            out[f"{f}/{k}"] = np.stack(rows)
    return out


def _close(got, want, what, flips=0.0, q_tol=None):
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = np.abs(got.astype(np.float64) - want)
    off = float(np.mean(diff > TOL * scale))
    assert off <= flips, f"{what}: {off} of the elements past {TOL} x {scale}"
    bound = TOL * scale if not flips else q_tol
    assert float(diff.max()) <= bound, f"{what}: max |err| {float(diff.max())} > {bound}"


@pytest.mark.parametrize("name", list(CASES))
def test_masks_bit_equal_to_the_reference(results, name):
    ranks, _, _ = results
    kind, _, adversary, _, _, _ = CASES[name]
    n = N_AGENTS[kind]
    want = jadv.parse_adversary_spec(adversary, n, SEED).mask()
    got = np.zeros(n, bool)
    for res in ranks:
        got[int(res[name + "/agent"])] = bool(res[name + "/byzantine"])
    np.testing.assert_array_equal(got, want)
    assert all(int(res[name + "/k"]) == 2 for res in ranks)  # the third round's index


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_three_rounds_match_the_reference(results, name):
    ranks, ref, _ = results
    kind, _, _, _, compressed, _ = CASES[name]
    got = _agent_state(ranks, name, kind)
    for key, v in got.items():
        want = ref[f"{name}/{key}"]
        if compressed:  # see the module docstring: one int8 step where a tie flips
            _close(v, want, f"{name} {key}", flips=0.05,
                   q_tol=2 * float(np.abs(want).max()) / 127)
        else:
            _close(v, want, f"{name} {key}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if not c[4] and ("random" in n or "signflip" in n)])
def test_three_rounds_match_the_dense_path_on_the_same_w(results, name):
    ranks, _, dense = results
    kind = CASES[name][0]
    for key, v in _agent_state(ranks, name, kind).items():
        _close(v, dense[f"{name}/{key}"], f"{name} {key} against the dense path")


def test_random_corruption_moves_the_run(results):
    """The random adversary's rounds differ from the sign flip's (the noise
    was drawn and sent), and the dense path draws it alike."""
    ranks, _, _ = results
    a = _agent_state(ranks, "ring-random-mean", "flat")["x/w"]
    b = _agent_state(ranks, "ring-signflip-mean", "flat")["x/w"]
    assert np.abs(a - b).max() > 1e-3 and np.all(np.isfinite(a))
