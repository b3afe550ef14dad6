"""Pod-as-agent's per-period gather (``launch.mesh.DataAxis``, threaded
through the models by ``launch.steps.sharded_value_and_grad``) against the
whole-agent gather it replaces, and against the reference.

Four gloo ranks on the CPU run one pod-as-agent gradient call
(``sharded_value_and_grad``) per case, each rank on its data shard of its
agent and its share of the agent's batch: the reduced Qwen3-8B, the reduced
SeamlessM4T-medium (encoder-decoder) and the reduced DeepSeek-V2-Lite (a
dense head layer, MLA, MoE), each widened to d_model 1,024 so that the
reference's FSDP rule (the first dim >= 1,024 that divides by the data axis)
shards them, on mesh pod 2 x data 2 x model 1 with full remat; the Qwen3-8B
also under the ``dots`` policy and without remat; and on mesh pod 1 x data 2
x model 2 the Qwen3-8B and the Mamba2-370m (a tied embedding, in_proj packed
by ``Segments``), where the data ranks gather model shards.  Each rank also
runs the oracle (``tests/_torch_fsdp.py``): the agent's whole model shard
gathered before the call (``gather_leaves``), the gradient, then each
sharded leaf's gradient reduce-scattered and each whole one all-reduced.
Loss and gradient shards are bit-equal to the oracle's (two data ranks:
every sum is of two terms, the same in any order).  Each rank reads the
collectives over ``data`` that the handle counts: an all-gather and a
reduce-scatter per period, head layer and top-level leaf that holds a
sharded leaf, one more all-gather per period under remat (the backward
re-gathers it), and per MoE layer and forward pass (two under remat) an
all-gather of its expert counts and an all-reduce of its router
probabilities, and one all-reduce for their backward.  The agents' loss and
gathered gradients hold within 1e-5 of the reference's
``jax.value_and_grad`` on the same weights and the agent's whole batch; for
an MoE model that holds the load-balance loss, nonlinear in the batch, and
the expert capacity, sized and filled over the agent's whole batch, to the
whole batch's.  The reduced configurations' capacity factor of 4 drops no
entry; the reduced DeepSeek-V2-Lite (a shared expert, ``topk_softmax``) and
Mixtral-8x7B (``softmax_topk``) at capacity factor 1.0, in both packages,
overflow experts (on pod 2 x data 2 x model 1, and the DeepSeek-V2-Lite on
pod 1 x data 2 x model 2), and from each rank's recorded routes each rank's
own capacity would keep another set than the agent's.

On the dry run's counting mesh (pod 2 x data 16 x model 16, meta tensors)
a reduced Qwen3-8B and Mamba2-370m at eight layers count their all-gathers
per period, and one gradient call's ``peak_bytes`` lies below the
whole-gather oracle's by at least the gathered parameters.
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

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.launch.train import make_lm_sampler as j_make_lm_sampler  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, model_axis  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.models.transformer import _period_patterns  # noqa: E402
from repro_torch.utils.roofline import count_call  # noqa: E402

from _torch_fsdp import reference_kept, whole_gather_value_and_grad  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
TOL = 1e-5
POD = [[2, 2, 1], ["pod", "data", "model"]]
TP = [[1, 2, 2], ["pod", "data", "model"]]
CASES = {
    "qwen3-8b": dict(arch="qwen3-8b", replace={}, mesh=POD, jax=True),
    "seamless-m4t-medium": dict(arch="seamless-m4t-medium", replace={}, mesh=POD, jax=True),
    "deepseek-v2-lite-16b": dict(arch="deepseek-v2-lite-16b", replace={}, mesh=POD, jax=True),
    "qwen3-8b-dots": dict(arch="qwen3-8b", replace={"remat_policy": "dots"}, mesh=POD, jax=False),
    "qwen3-8b-no-remat": dict(arch="qwen3-8b", replace={"remat": False}, mesh=POD, jax=False),
    "qwen3-8b-tp": dict(arch="qwen3-8b", replace={}, mesh=TP, jax=False),
    "mamba2-370m-tp": dict(arch="mamba2-370m", replace={}, mesh=TP, jax=False),
    # capacity factor 1.0: experts overflow, and the agent's capacity keeps
    # another set than each rank's would
    "deepseek-v2-lite-16b-cf1": dict(arch="deepseek-v2-lite-16b", replace={}, mesh=POD, jax=True,
                                     cf=1.0),
    "mixtral-8x7b-cf1": dict(arch="mixtral-8x7b", replace={}, mesh=POD, jax=True, cf=1.0),
    "deepseek-v2-lite-16b-cf1-tp": dict(arch="deepseek-v2-lite-16b", replace={}, mesh=TP,
                                        jax=True, cf=1.0),
}
RUN = dict(seq=16, batch=2, d_model=1024)

_RANK = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out = int(os.environ["RANK"]), os.environ["OUT"]
    RUN, CASES = json.loads(os.environ["RUN"]), json.loads(os.environ["CASES"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=4)

    from _torch_fsdp import whole_gather_value_and_grad
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh, model_axis, rank_slice
    from repro_torch.launch.specs import gather_model, shard_model
    from repro_torch.launch.train import make_lm_sampler
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths

    routes, real_route = [], MOE.route

    def recording_route(logits, mo):
        out = real_route(logits, mo)
        routes.append(out[0].numpy())
        return out

    MOE.route = recording_route
    res = {}
    for name, case in CASES.items():
        cfg = dataclasses.replace(get_reduced(case["arch"]), d_model=RUN["d_model"],
                                  **{"remat": True, **case["replace"]})
        if case.get("cf"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=case["cf"]))
        bundle = get_bundle(cfg, "cpu")
        mesh = make_mesh(tuple(case["mesh"][0]), tuple(case["mesh"][1]), "cpu")
        n = mesh.shape["pod"]
        notes = S.build_train_steps(bundle, InputShape("t", RUN["seq"], n * RUN["batch"], "train"),
                                    mesh, t_o=1, agent_mode="hierarchical")["train_gossip"].notes
        dims = notes["data_dims"]
        tp = model_axis(mesh)
        tb = get_bundle(cfg, "cpu", tp)
        if case["jax"]:
            whole = {k: torch.from_numpy(v) for k, v in np.load(os.environ["X0_" + name]).items()}
        else:
            whole = flatten_paths(bundle.init(seed=0))
        layout = S.param_layout(bundle, mesh)[0] if tp is not None else None
        if layout is not None:
            whole = shard_model(whole, layout, mesh)
        shards = S.shard_leaves(whole, dims, mesh)
        comm = make_lm_sampler(cfg, n, RUN["batch"], RUN["seq"], 1, seed=0)(0)[1]
        batch = S.batch_share(rank_slice(comm, mesh, ("pod",)), notes["batch_dims"]["comm"], mesh)

        new = S.sharded_value_and_grad(tb, mesh, dims)
        routes.clear()
        loss, grads = new(shards, batch)
        if routes:  # the forward's routes (the recompute's follow them)
            res[name + "/routes"] = np.stack(routes)
        res[name + "/counts"] = np.array(json.dumps(new.data_axis.stats))
        o_loss, o_grads = whole_gather_value_and_grad(tb, mesh, dims)(shards, batch)
        res[name + "/differ"] = np.array(json.dumps(
            [k for k, g in o_grads.items() if not torch.equal(g, grads[k])]))
        res[name + "/loss_equal"] = np.array(bool(torch.equal(loss, o_loss)))
        res[name + "/loss"] = np.array(float(loss))
        res[name + "/dims"] = np.array(json.dumps(dims))
        if case["jax"]:
            whole_grads = S.gather_leaves(grads, dims, mesh)
            if layout is not None:
                whole_grads = gather_model(whole_grads, layout, mesh)
            for k, v in whole_grads.items():
                res[name + "/grad/" + k] = v.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
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


def _with_cf(cfg, case):
    if not case.get("cf"):
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=case["cf"]))


def _cfg(case):
    return _with_cf(dataclasses.replace(get_reduced(case["arch"]), d_model=RUN["d_model"],
                                        **{"remat": True, **case["replace"]}), case)


def _jcfg(case):
    return _with_cf(dataclasses.replace(j_get_reduced(case["arch"]), d_model=RUN["d_model"],
                                        **{"remat": True, **case["replace"]}), case)


def _agents(case) -> int:
    return case["mesh"][0][0]


def _reference(jcfg, jparams, n_agents):
    """Per agent: the reference's loss and flat gradients on the agent's
    comm batch of round 0 (every agent starts from the same weights)."""
    bundle = j_get_bundle(jcfg)
    comm = j_make_lm_sampler(jcfg, n_agents, RUN["batch"], RUN["seq"], 1, seed=0)(0)[1]
    vg = jax.jit(jax.value_and_grad(bundle.loss))
    out = []
    for a in range(n_agents):
        loss, grads = vg(jparams, jax.tree.map(lambda v, a=a: v[a], comm))
        out.append((float(loss), _flat(grads)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp_layers"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.abspath(SRC), TESTS]), OUT=out,
               RUN=json.dumps(RUN),
               CASES=json.dumps(CASES), OMP_NUM_THREADS="1", PORT=str(_free_port()))
    env.pop("XLA_FLAGS", None)
    jparams = {}
    for name, case in CASES.items():
        if case["jax"]:
            jcfg = _jcfg(case)
            jparams[name] = j_get_bundle(jcfg).init(jax.random.PRNGKey(0))
            env["X0_" + name] = os.path.join(out, name + ".npz")
            np.savez(env["X0_" + name], **_flat(jparams[name]))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        ref = {name: _reference(_jcfg(CASES[name]), p, _agents(CASES[name]))
               for name, p in jparams.items()}
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)], ref


def _counts(cfg, dims) -> dict:
    """The collectives over ``data`` that the handle counts in one gradient
    call: an all-gather and a reduce-scatter per period, head layer and
    top-level leaf that holds a sharded leaf, an all-gather more per period
    under remat; per MoE layer and forward pass (two under remat) an
    all-gather of its expert counts and an all-reduce of its router
    probabilities, and one all-reduce of their gradient."""
    def sharded(prefix):
        return any(d is not None for k, d in dims.items() if k == prefix or
                   k.startswith(prefix + "/"))

    tops = sum(sharded(k) for k in ("embed", "lm_head", "final_norm", "enc_norm"))
    if cfg.is_enc_dec:
        heads, periods = 0, (cfg.n_encoder_layers * sharded("enc_layers")
                             + cfg.n_layers * sharded("dec_layers"))
        moe = 0
    else:
        head_pat, period_pat, n_periods = _period_patterns(cfg)
        heads = sum(sharded(f"head_layers/{j}") for j in range(len(head_pat)))
        periods = n_periods * sharded("layers")
        moe = (sum(f == "moe" for _, f in head_pat)
               + n_periods * sum(f == "moe" for _, f in period_pat))
    forward = tops + heads + periods
    passes = 2 if cfg.remat else 1
    return {"all-gather": forward + (periods if cfg.remat else 0) + moe * passes,
            "reduce-scatter": forward, "all-reduce": moe * (passes + 1)}


@pytest.mark.parametrize("name", list(CASES))
def test_per_period_gather_is_bit_equal_to_the_whole_gather(runs, name):
    ranks, _ = runs
    cfg = _cfg(CASES[name])
    for r, res in enumerate(ranks):
        dims = json.loads(str(res[name + "/dims"]))
        assert sum(d is not None for d in dims.values()) >= len(dims) // 2, dims
        assert json.loads(str(res[name + "/differ"])) == [], f"rank {r}"
        assert bool(res[name + "/loss_equal"]), f"rank {r}"
        assert json.loads(str(res[name + "/counts"])) == _counts(cfg, dims), f"rank {r}"


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["jax"]])
def test_per_period_gather_matches_the_reference(runs, name):
    ranks, ref = runs
    n_agents = _agents(CASES[name])
    per = len(ranks) // n_agents  # pod-major: agent a's ranks are per·a … per·a + per - 1
    for agent in range(n_agents):
        want_loss, want = ref[name][agent]
        for res in ranks[per * agent: per * (agent + 1)]:
            assert abs(float(res[name + "/loss"]) - want_loss) <= TOL * abs(want_loss)
            for k, w in want.items():
                got = res[name + "/grad/" + k]
                scale = max(float(np.abs(w).max()), 1e-30)
                err = float(np.abs(got - w).max())
                assert err <= TOL * scale, f"agent {agent} {k}: {err} > {TOL} x {scale}"


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.get("cf")])
def test_agent_capacity_keeps_another_set_than_each_rank_s(runs, name):
    """From the routes each data rank recorded: the agent's capacity over
    its whole batch (the reference's) and each rank's over its own rows
    keep different (token, expert) entries, so the reference comparison
    above sees the rule."""
    ranks, _ = runs
    case = CASES[name]
    mo = _cfg(case).moe
    pods, data, model = case["mesh"][0]
    differ = dropped = 0
    for a in range(pods):
        # the agent's data ranks at model coordinate 0, in row order
        mine = [ranks[(a * data + i) * model][name + "/routes"] for i in range(data)]
        # the forward's MoE layers (then the recompute's)
        for layer in range(mine[0].shape[0] // 2):
            per_rank = [m[layer] for m in mine]  # (T_rank, k) each
            t = per_rank[0].shape[0]
            agent = reference_kept(np.concatenate(per_rank).reshape(-1), mo.n_experts,
                                   capacity(mo, data * t))
            own = np.concatenate([reference_kept(r.reshape(-1), mo.n_experts, capacity(mo, t))
                                  for r in per_rank])
            differ += int(np.sum(agent != own))
            dropped += int(np.sum(~agent))
    assert dropped > 0 and differ > 0, (dropped, differ)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m"])
@pytest.mark.parametrize("remat", [True, False])
def test_counting_mesh_gathers_per_period_and_peaks_lower(arch, remat):
    cfg = dataclasses.replace(get_reduced(arch), d_model=1024, n_layers=8, remat=remat)
    mesh = make_production_mesh(multi_pod=True)
    spec = S.build_train_steps(get_bundle(cfg, "meta"), InputShape("t", 64, 64, "train"), mesh,
                               agent_mode="hierarchical")["train_gossip"]
    dims = spec.notes["data_dims"]
    assert spec.notes["gather"] == S.GATHER_NOTE
    bundle = get_bundle(cfg, "meta", model_axis(mesh))
    shards, batch = spec.args[0].x, spec.args[2]
    new = count_call(S.sharded_value_and_grad(bundle, mesh, dims), (shards, batch), mesh)
    old = count_call(whole_gather_value_and_grad(bundle, mesh, dims), (shards, batch), mesh)
    want = _counts(cfg, dims)
    gathers, scatters = want["all-gather"], want["reduce-scatter"]
    assert (new["collectives"]["n_all-gather"], new["collectives"]["n_reduce-scatter"]) == (
        gathers, scatters)
    assert new["flops_int"] == old["flops_int"]
    # the same bytes reduce-scattered; under remat each period gathered twice
    assert new["collectives"]["reduce-scatter"] == old["collectives"]["reduce-scatter"]
    params = sum(v.numel() * v.element_size() * (1 if dims[k] is None else mesh.shape["data"])
                 for k, v in shards.items())
    if remat:
        assert old["memory"]["peak_bytes"] - new["memory"]["peak_bytes"] >= params
    else:  # autograd keeps every gathered period for the backward
        assert new["memory"]["peak_bytes"] <= old["memory"]["peak_bytes"]
    # the round: two gradient calls at t_o = 1, and the gossip's own
    # collectives, none of them an all-gather or a reduce-scatter
    counts = spec.lower()["collectives"]
    assert (counts["n_all-gather"], counts["n_reduce-scatter"]) == (2 * gathers, 2 * scatters)
