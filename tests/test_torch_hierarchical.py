"""Pod-as-agent (``build_train_steps(agent_mode="hierarchical")``) across
gloo ranks on the CPU, held against the flat round and the reference.

Two pods of two data ranks each (mesh pod 2 x data 2 x model 1, four
processes) run a gossip round, a server round and a gossip round of PISCO on
a reduced Qwen3-8B widened to d_model 1,024 (so that the reference's FSDP
rule, the first dim >= 1,024 that divides by the data axis, shards nearly
every leaf), each rank holding its data shard of its pod's x, y and g and
its row of the pod's batch.  Beside them two processes run the flat round
(mesh pod 2 x model 1: one rank per agent, each on the agent's whole
batch), and this process runs the reference's ``make_round_fn`` over the two
agents stacked, with the same gossip weights (ring of two: W = J / 2 + I /
2 = J), on the same numpy weights and tokens.  Every leaf of x, y and g
after each round, gathered from the shards, and each round's loss agree
within 1e-5 of the leaf's largest magnitude (float32; the data ranks' mean
gradient sums in another order than one rank's); each rank's shard is the
placement's block of the gathered leaf; the reduce-scatter also equals
this rank's block of the all-reduce over the same ranks, bit for bit.  eta_l is 0.01: at 0.05 this widened model's
loss rises round over round and float32 differences grow past 1e-5 in every
path, the flat one against the reference included.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core.pisco import (PiscoConfig, init_state, make_round_fn,  # noqa: E402
                              replicate_params)
from repro.core.topology import make_topology  # noqa: E402
from repro.launch.train import make_lm_sampler as j_make_lm_sampler  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-5
RUN = dict(seq=32, batch=2, t_o=2, eta_l=0.01, eta_c=0.9, d_model=1024, rounds=3)
KINDS = ("gossip", "global", "gossip")

_RANK = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, out = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
    RUN = json.loads(os.environ["RUN"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=world)

    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.pisco import init_rank_state
    from repro_torch.launch.mesh import make_mesh, rank_slice
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle

    cfg = dataclasses.replace(get_reduced("qwen3-8b"), d_model=RUN["d_model"])
    bundle = get_bundle(cfg, "cpu")
    hier = world == 4
    mesh = (make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu") if hier
            else make_mesh((2, 1), ("pod", "model"), "cpu"))
    shape = InputShape("t", RUN["seq"], 2 * RUN["batch"], "train")
    steps = S.build_train_steps(bundle, shape, mesh, t_o=RUN["t_o"], eta_l=RUN["eta_l"],
                                eta_c=RUN["eta_c"],
                                agent_mode="hierarchical" if hier else "flat")
    notes = steps["train_gossip"].notes
    agent = ("pod",)
    # every agent starts from the same whole weights (the reference's replicate_params)
    x0 = {k: torch.from_numpy(v) for k, v in np.load(os.environ["X0"]).items()}
    sampler = make_lm_sampler(cfg, 2, RUN["batch"], RUN["seq"], RUN["t_o"], seed=0)
    batches = [tuple(rank_slice(b, mesh, agent, axis=1 - i) for i, b in enumerate(sampler(k)))
               for k in range(RUN["rounds"] + 1)]
    vg = S.flat_value_and_grad(bundle)
    res = {}
    if hier:
        dims = notes["data_dims"]
        bd = notes["batch_dims"]
        batches = [(S.batch_share(loc, bd["local"], mesh), S.batch_share(com, bd["comm"], mesh))
                   for loc, com in batches]
        x0 = S.shard_leaves(x0, dims, mesh)
        vg = S.sharded_value_and_grad(bundle, mesh, dims)
        res["n_sharded"] = np.array(sum(d is not None for d in dims.values()))
        # the reduce-scatter against this rank's block of the all-reduce over
        # the same sub-group, bit for bit
        probe = torch.randn(6, 8, generator=torch.Generator().manual_seed(rank))
        rs = mesh.reduce_scatter_sum(probe, ("data",), 1)
        fb = mesh.all_reduce_sum(probe, ("data",)).chunk(2, 1)[mesh.coords["data"]]
        res["rs_equal"] = np.array(bool(torch.equal(rs, fb)))
        res["rs_shape"] = np.array(rs.shape)
    state = init_rank_state(vg, x0, batches[0][1])
    for k, kind in enumerate(json.loads(os.environ["KINDS"]), start=1):
        state, loss = steps["train_" + kind].fn(state, *batches[k])
        res[f"{k}/loss"] = np.array(float(loss))
        for f in ("x", "y", "g"):
            tree = getattr(state, f)
            if hier:
                for name, shard in tree.items():
                    res[f"{k}/{f}-shard/{name}"] = shard.numpy()
                tree = S.gather_leaves(tree, dims, mesh)
            for name, v in tree.items():
                res[f"{k}/{f}/{name}"] = v.numpy()
    if hier:
        res["dims"] = np.array(json.dumps(dims))
    np.savez(os.path.join(out, f"{'hier' if hier else 'flat'}{rank}.npz"), **res)
    dist.destroy_process_group()
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


def _reference(jcfg, jparams):
    """The reference's stacked round over the two agents: the same gossip
    weights, the same batches; per round, each agent's x, y, g and the
    round's mean loss."""
    bundle = j_get_bundle(jcfg)
    pcfg = PiscoConfig(n_agents=2, t_o=RUN["t_o"], eta_l=RUN["eta_l"], eta_c=RUN["eta_c"])
    mixing = jmixing.dense_mixing(make_topology("full", 2))
    sampler = j_make_lm_sampler(jcfg, 2, RUN["batch"], RUN["seq"], RUN["t_o"], seed=0)
    batches = [sampler(k) for k in range(RUN["rounds"] + 1)]
    state = init_state(bundle.loss, replicate_params(jparams, 2), batches[0][1])
    fns = {g: jax.jit(make_round_fn(bundle.loss, pcfg, mixing, global_round=g))
           for g in (False, True)}
    out = {}
    for k, kind in enumerate(KINDS, start=1):
        state, met = fns[kind == "global"](state, *batches[k])
        out[f"{k}/loss"] = float(met.loss)
        for f in ("x", "y", "g"):
            for name, v in _flat(getattr(state, f)).items():
                out[f"{k}/{f}/{name}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hierarchical"))
    jcfg = dataclasses.replace(j_get_reduced("qwen3-8b"), d_model=RUN["d_model"])
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    x0 = os.path.join(out, "x0.npz")
    np.savez(x0, **_flat(jparams))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, X0=x0,
               RUN=json.dumps(RUN), KINDS=json.dumps(KINDS), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = []
    for world in (4, 2):
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _RANK],
                                   env=dict(env, RANK=str(r), WORLD=str(world), PORT=port),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    try:
        ref = _reference(jcfg, jparams)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    hier = [dict(np.load(os.path.join(out, f"hier{r}.npz"))) for r in range(4)]
    flat = [dict(np.load(os.path.join(out, f"flat{r}.npz"))) for r in range(2)]
    return hier, flat, ref


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def test_reduce_scatter_equals_its_fallback_and_leaves_are_sharded(runs):
    hier, _, _ = runs
    assert all(bool(h["rs_equal"]) for h in hier)
    assert all(tuple(h["rs_shape"]) == (6, 4) for h in hier)
    dims = json.loads(str(hier[0]["dims"]))
    # all but the QK norms (head dim 32) shard over data at d_model 1,024
    assert int(hier[0]["n_sharded"]) == len(dims) - 2
    assert {k for k, d in dims.items() if d is None} == {
        "layers/pos0/mixer/q_norm", "layers/pos0/mixer/k_norm"}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hierarchical_round_equals_flat_and_reference(runs, k):
    hier, flat, ref = runs
    dims = json.loads(str(hier[0]["dims"]))
    for agent in (0, 1):
        ranks = hier[2 * agent: 2 * agent + 2]  # pod-major: (pod, data) ranks 2a, 2a + 1
        for h in ranks:  # the agent's loss, the mean over its data ranks
            _close(h[f"{k}/loss"], flat[agent][f"{k}/loss"], f"round {k} agent {agent} loss")
        for f in ("x", "y", "g"):
            for name in dims:
                want = ref[f"{k}/{f}/{name}"][agent]
                for d, h in enumerate(ranks):
                    got = h[f"{k}/{f}/{name}"]
                    _close(got, want, f"round {k} agent {agent} {f}/{name} (hierarchical)")
                    shard = h[f"{k}/{f}-shard/{name}"]
                    block = got if dims[name] is None else np.split(got, 2, dims[name])[d]
                    np.testing.assert_array_equal(shard, block)
                _close(flat[agent][f"{k}/{f}/{name}"], want,
                       f"round {k} agent {agent} {f}/{name} (flat)")
    # the reference's metric is the mean over agents
    _close(np.mean([f[f"{k}/loss"] for f in flat]), ref[f"{k}/loss"], f"round {k} loss (flat)")
    _close(np.mean([hier[0][f"{k}/loss"], hier[2][f"{k}/loss"]]), ref[f"{k}/loss"],
           f"round {k} loss (hierarchical)")
    if KINDS[k - 1] == "global":  # both agents equal after the server round
        for name in dims:
            np.testing.assert_array_equal(hier[0][f"{k}/x/{name}"], hier[2][f"{k}/x/{name}"])
