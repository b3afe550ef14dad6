"""The harness of the tensor-parallel PISCO rounds (``test_torch_tp_rounds``,
``test_torch_tp_pod``): PISCO rounds with the model axis, across gloo
ranks on the CPU, held against the reference's ``make_round_fn`` on the
stacked agents.

Flat (mesh data 2 x model 2, four processes): two agents, each over two
model ranks, on the reduced Mamba2-370m in float32 (Mamba-2 split by head
with B and C whole, the tied vocabulary split): a gossip round, a server
round and a q8d gossip round with error feedback, each rank holding its
model shard of x, y and g, gossip and the server sum running over the ranks
with the same model coordinate, the quantiser scaling each leaf by the whole
leaf's abs-max (the max over the model ranks).  Pod-as-agent (mesh pod 1 x
data 2 x model 2, four processes): one agent over two data ranks, each
holding the data shard of its model shard, on the reduced Qwen3-8B widened
to d_model 1,024 (as ``tests/test_torch_hierarchical.py`` widens it, so that
the FSDP rule shards the model shards); gossip, server, gossip.  This
process runs the reference's round over the agents stacked, with the same
gossip weights (a ring of two is W = J) on the same numpy weights and
tokens.  Every leaf of x, y and g, gathered over data and model, and each
loss agree within 1e-5 of the leaf's largest magnitude (float32); the leaves
held whole are bit-identical across an agent's model ranks after every
round.  The q8d round quantizes a candidate that the two computed to within
rounding, so it is held as ``tests/test_torch_collective.py`` holds its q8d
round (a few elements a grid step apart at ties of the int8 grid).  The
quantiser on the shards is held exactly by a probe: the stateless q8d gossip
of an agent-stacked tree drawn here, each rank quantizing its model shard,
against the reference's on the whole leaves, within 1e-5 and no element
apart (without the max over the ranks, the shard that lacks the leaf's
abs-max would quantize on a finer grid).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

import jax  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core.pisco import (PiscoConfig, init_compression_state, init_state,  # noqa: E402
                              make_round_fn, replicate_params)
from repro.core.topology import make_topology  # noqa: E402
from repro.launch.train import make_lm_sampler as j_make_lm_sampler  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-5
MODES = {
    "flat": dict(arch="mamba2-370m", replace={}, agents=2, mesh=[[2, 2], ["data", "model"]],
                 kinds=["gossip", "global", "q8d"], seq=32, batch=2, t_o=2, eta_l=0.05,
                 eta_c=0.9),
    "hier": dict(arch="qwen3-8b", replace={"d_model": 1024}, agents=1,
                 mesh=[[1, 2, 2], ["pod", "data", "model"]], kinds=["gossip", "global", "gossip"],
                 seq=16, batch=2, t_o=2, eta_l=0.01, eta_c=0.9),
}

_RANK = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out, mode = int(os.environ["RANK"]), os.environ["OUT"], os.environ["MODE"]
    RUN = json.loads(os.environ["RUN"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=4)

    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import mixing as M
    from repro_torch.core.pisco import (PiscoConfig, init_compression_state, init_rank_state,
                                        make_rank_round_fn)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import ModelAxis, make_mesh, rank_slice
    from repro_torch.launch.specs import gather_model, shard_model
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models.registry import get_bundle

    cfg = dataclasses.replace(get_reduced(RUN["arch"]), **RUN["replace"])
    bundle = get_bundle(cfg, "cpu")
    mesh = make_mesh(tuple(RUN["mesh"][0]), tuple(RUN["mesh"][1]), "cpu")
    n = RUN["agents"]
    hier = mode == "hier"
    steps = S.build_train_steps(bundle, InputShape("t", RUN["seq"], n * RUN["batch"], "train"),
                                mesh, t_o=RUN["t_o"], eta_l=RUN["eta_l"], eta_c=RUN["eta_c"],
                                agent_mode="hierarchical" if hier else "flat")
    notes = steps["train_gossip"].notes
    agent = tuple(notes["agent_axes"])
    layout, differs, _ = S.param_layout(bundle, mesh)
    x0 = shard_model({k: torch.from_numpy(v) for k, v in np.load(os.environ["X0"]).items()},
                     layout, mesh)
    sampler = make_lm_sampler(cfg, n, RUN["batch"], RUN["seq"], RUN["t_o"], seed=0)
    batches = [tuple(rank_slice(b, mesh, agent, axis=1 - i) for i, b in enumerate(sampler(k)))
               for k in range(4)]
    vg = S.flat_value_and_grad(get_bundle(cfg, "cpu", ModelAxis(mesh)))
    if hier:
        dims, bd = notes["data_dims"], notes["batch_dims"]
        batches = [(S.batch_share(loc, bd["local"], mesh), S.batch_share(com, bd["comm"], mesh))
                   for loc, com in batches]
        x0 = S.shard_leaves(x0, dims, mesh)
        vg = S.sharded_value_and_grad(get_bundle(cfg, "cpu", ModelAxis(mesh)), mesh, dims)
    res = {"differs": np.array(json.dumps(differs)), "notes": np.array(json.dumps(
        {k: notes[k] for k in ("model_axis", "layout_differs", "agent_axes", "n_agents")}))}

    def whole(tree):
        if hier:
            tree = S.gather_leaves(tree, dims, mesh)
        return gather_model(tree, layout, mesh)

    def keep(k, state):
        for f in ("x", "y", "g"):
            tree = getattr(state, f)
            for name, v in tree.items():
                if layout[name] is None:
                    res[f"{k}/{f}-own/{name}"] = v.numpy()
            for name, v in whole(tree).items():
                res[f"{k}/{f}/{name}"] = v.numpy()
        if state.ef:
            for s in ("x", "y"):
                for name, v in whole(state.ef[s]).items():
                    res[f"{k}/res-{s}/{name}"] = v.numpy()

    if not hier:  # the q8d probe: this agent's row of the drawn tree
        a = mesh.coords["data"]
        probe = shard_model({k: torch.from_numpy(v[a]) for k, v in
                             np.load(os.environ["PROBE"]).items()}, layout, mesh)
        cmix = M.compressed_mixing(steps["train_gossip"].mixing, bits=8)
        for name, v in gather_model(cmix.gossip(probe), layout, mesh).items():
            res[f"probe/{name}"] = v.numpy()
    state0 = init_rank_state(vg, x0, batches[0][1])
    state = state0
    pcfg = PiscoConfig(n, RUN["t_o"], RUN["eta_l"], RUN["eta_c"])
    for k, kind in enumerate(RUN["kinds"], start=1):
        if kind == "q8d":
            cmix = M.compressed_mixing(steps["train_gossip"].mixing, bits=8)
            fn = make_rank_round_fn(vg, pcfg, cmix, global_round=False)
            state, loss = fn(init_compression_state(state0, cmix), *batches[k])
        else:
            state, loss = steps["train_" + kind].fn(state, *batches[k])
        res[f"{k}/loss"] = np.array(float(loss))
        keep(str(k), state)
    np.savez(os.path.join(out, f"{mode}{rank}.npz"), **res)
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


def _reference(run, jcfg, jparams):
    """The reference's stacked round over the agents with the same gossip
    weights and batches: per round each agent's x, y, g (and residuals) and
    the round's mean loss; the q8d round starts from the initial state."""
    bundle = j_get_bundle(jcfg)
    n = run["agents"]
    pcfg = PiscoConfig(n_agents=n, t_o=run["t_o"], eta_l=run["eta_l"], eta_c=run["eta_c"])
    mixing = jmixing.dense_mixing(make_topology("full", n))
    sampler = j_make_lm_sampler(jcfg, n, run["batch"], run["seq"], run["t_o"], seed=0)
    batches = [sampler(k) for k in range(4)]
    state0 = init_state(bundle.loss, replicate_params(jparams, n), batches[0][1])
    state = state0
    out = {}
    for k, kind in enumerate(run["kinds"], start=1):
        if kind == "q8d":
            cmix = jmixing.compressed_mixing(mixing, bits=8)
            fn = jax.jit(make_round_fn(bundle.loss, pcfg, cmix, global_round=False))
            state, met = fn(init_compression_state(state0, cmix), *batches[k])
            for s in ("x", "y"):
                for name, v in _flat(state.ef[s]).items():
                    out[f"{k}/res-{s}/{name}"] = np.asarray(v, np.float32)
        else:
            fn = jax.jit(make_round_fn(bundle.loss, pcfg, mixing, global_round=kind == "global"))
            state, met = fn(state, *batches[k])
        out[f"{k}/loss"] = float(met.loss)
        for f in ("x", "y", "g"):
            for name, v in _flat(getattr(state, f)).items():
                out[f"{k}/{f}/{name}"] = np.asarray(v, np.float32)
    return out


def run_modes(tmp_path_factory, modes):
    out = str(tmp_path_factory.mktemp("tp_rounds"))
    procs, pairs = [], {}
    for mode in modes:
        run = MODES[mode]
        jcfg = dataclasses.replace(j_get_reduced(run["arch"]), **run["replace"])
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        x0 = os.path.join(out, f"{mode}_x0.npz")
        np.savez(x0, **_flat(jparams))
        pairs[mode] = (jcfg, jparams)
        rng = np.random.default_rng(7)
        probe = {k: rng.normal(size=(run["agents"],) + v.shape).astype(np.float32)
                 for k, v in _flat(jparams).items()}
        np.savez(os.path.join(out, f"{mode}_probe.npz"), **probe)
        env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, X0=x0, MODE=mode,
                   PROBE=os.path.join(out, f"{mode}_probe.npz"),
                   RUN=json.dumps(run), OMP_NUM_THREADS="1", PORT=str(_free_port()))
        env.pop("XLA_FLAGS", None)
        procs += [subprocess.Popen([sys.executable, "-c", _RANK], env=dict(env, RANK=str(r)),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for r in range(4)]
    try:
        ref = {mode: _reference(MODES[mode], *pair) for mode, pair in pairs.items()}
        if "flat" in modes:
            probe = dict(np.load(os.path.join(out, "flat_probe.npz")))
            jq = jmixing.compressed_mixing(jmixing.dense_mixing(make_topology("full", 2)),
                                           bits=8)
            for k, v in jax.jit(jq.gossip)(probe).items():
                ref["flat"][f"probe/{k}"] = np.asarray(v)
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    port = {mode: [dict(np.load(os.path.join(out, f"{mode}{r}.npz"))) for r in range(4)]
            for mode in modes}
    return port, ref


def _close(got, want, what, tol=TOL, flips=0.0):
    """Within ``tol`` of the largest reference magnitude; with ``flips``, that
    share of the elements may be past it, each within two int8 grid steps
    (``tests/test_torch_collective.py``'s rule for a quantized candidate)."""
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = np.abs(np.asarray(got, np.float32) - want)
    off = float(np.mean(diff > tol * scale))
    assert off <= flips, f"{what}: {off} of the elements past {tol} x {scale}"
    bound = tol * scale if not flips else 2 * scale / 127
    assert float(diff.max()) <= bound, f"{what}: {float(diff.max())} > {bound}"


# the q8d round's allowances: tests/test_torch_collective.py's
Q8D = {"x": dict(flips=1e-4), "g": dict(tol=1e-3), "y": dict(flips=1.0)}


def _agent_of(mode, rank):
    """The agent of a rank (row-major ranks: the model axis is last)."""
    return rank // 2 if mode == "flat" else 0


def check_round(runs, mode, k):
    """Round ``k`` of ``mode`` on every rank, gathered, against the
    reference's agent."""
    port, ref = runs
    want = ref[mode]
    names = sorted(n[len(f"{k}/x/"):] for n in want if n.startswith(f"{k}/x/"))
    for r, res in enumerate(port[mode]):
        a = _agent_of(mode, r)
        # the loss a rank returns is its agent's; the reference's, the mean
        losses = [float(port[mode][q][f"{k}/loss"]) for q in (0, 2)]
        _close(np.mean(losses) if mode == "flat" else res[f"{k}/loss"], want[f"{k}/loss"],
               f"{mode} round {k} loss")
        q8d = MODES[mode]["kinds"][k - 1] == "q8d"
        for f in ("x", "y", "g"):
            for name in names:
                _close(res[f"{k}/{f}/{name}"], want[f"{k}/{f}/{name}"][a],
                       f"{mode} round {k} rank {r} {f}/{name}", **(Q8D[f] if q8d else {}))
        if q8d:
            for s in ("x", "y"):
                for name in names:
                    want_res = want[f"{k}/res-{s}/{name}"][a]
                    # a residual is held to the scale of its message
                    scale = float(np.abs(want[f"{k}/{s}/{name}"][a]).max())
                    diff = np.abs(res[f"{k}/res-{s}/{name}"] - want_res)
                    assert float(np.mean(diff > TOL * scale)) <= Q8D[s].get("flips", 0.0)
                    assert float(diff.max()) <= 2 * scale / 127, f"residual {s}/{name}"


def check_q8d_probe(runs):
    port, ref = runs
    names = sorted(n for n in ref["flat"] if n.startswith("probe/"))
    assert names
    for r, res in enumerate(port["flat"]):
        for name in names:
            _close(res[name], ref["flat"][name][_agent_of("flat", r)], f"rank {r} {name}")


def check_whole_leaves_identical(runs, mode, k):
    port, _ = runs
    own = sorted(n for n in port[mode][0] if n.startswith(f"{k}/") and "-own/" in n)
    assert own
    for r in (0, 2):  # model rank 0 of each (agent or data) pair against model rank 1
        for name in own:
            np.testing.assert_array_equal(port[mode][r][name], port[mode][r + 1][name],
                                          err_msg=f"{mode} round {k} {name}")


def notes_of(runs, mode):
    return json.loads(str(runs[0][mode][0]["notes"]))
