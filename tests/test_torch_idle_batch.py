"""A batch-1 decode over the idle axes (the reference's ``--opt-idle-batch``)
on gloo ranks on the CPU, against the JAX package's decode on the whole
cache.

One module fixture writes each case's reference weights (``reduced()``,
float32), a reference cache of one sequence drawn from a seed (every K/V,
latent, conv and SSM entry, the encoder memory) at ``pos`` and the decode
tokens to npz files, then starts two gloo groups of four ranks as
subprocesses, mesh (data 2, model 2) and (data 4, model 1), while this
process runs the JAX package's ``bundle.decode`` on the whole cache with
every MoE layer's routes recorded.  Each rank carries the weights and the
cache over (``lm_params_from_jax``, ``lm_cache_from_jax``), cuts them with
``repro_torch.launch.steps.idle_layouts`` (the model shard, then the idle
block: the caches' sequence, the SSM state's heads, the experts) and takes
4 decode steps whose writes cross the boundary between the data ranks'
blocks (Mixtral's window is below the cache: its writes wrap the ring at
``pos % 32``), then gathers the cache over the idle axes and ``model``.

Tolerance: 1e-5 of the largest reference magnitude, per logits tensor and
per cache leaf (float32; the split softmax and the expert partials sum in
another order than one device).
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

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.models import encdec as JE
from repro.models import get_bundle as j_get_bundle
from repro.models import moe as JMoE
from repro.models import transformer as JT

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-5
MESHES = {"d2m2": (2, 2), "d4m1": (4, 1)}
S, T_MEM, N_DECODE = 32, 8, 4
# (case id, arch, config replacements, pos): writes at pos .. pos + 3 cross
# the data ranks' boundary at slot 16 (Mixtral's ring: 46 % 32 = 14)
CASES = [
    ("mixtral", "mixtral-8x7b", {}, 46),
    ("jamba", "jamba-v0.1-52b", {}, 14),
    ("mamba2", "mamba2-370m", {}, 14),
    ("deepseek", "deepseek-v2-lite-16b", {}, 14),
    ("qwen3", "qwen3-8b", {}, 14),
    ("seamless", "seamless-m4t-medium", {}, 14),
]
IDS = [c[0] for c in CASES]

_RANK = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out, mesh_id = int(os.environ["RANK"]), os.environ["OUT"], os.environ["MESH_ID"]
    shape = tuple(json.loads(os.environ["MESH"]))
    S, T_MEM, N_DECODE = json.loads(os.environ["SIZES"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=4)

    from repro_torch.configs import get_reduced
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import idle_axis, make_mesh, model_axis
    from repro_torch.launch.specs import gather_model
    from repro_torch.models import moe as TMoE
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths, nest_map_with_path
    from repro_torch.weights import lm_cache_from_jax, lm_params_from_jax

    routes = []
    route = TMoE.route
    def recorded(logits, mo):
        got = route(logits, mo)
        routes.append(got[0].numpy())
        return got
    TMoE.route = recorded

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = {}
    for cid, arch, replace, pos in json.loads(os.environ["CASES"]):
        cfg = dataclasses.replace(get_reduced(arch), **replace)
        flat = dict(np.load(os.path.join(out, cid + "_params.npz")))
        flat_cache = dict(np.load(os.path.join(out, cid + "_cache.npz")))
        tokens = torch.from_numpy(np.load(os.path.join(out, cid + "_tokens.npy")))
        whole = get_bundle(cfg, "cpu")
        kw = {"mem_len": T_MEM} if cfg.is_enc_dec else {}
        template = whole.init_cache(1, S, **kw)
        cache = lm_cache_from_jax(nest_map_with_path(lambda p, t: flat_cache[p], template), "cpu")
        lay = ST.idle_layouts(whole, cache, mesh)
        idle = dataclasses.replace(idle_axis(mesh), seq=lay.seq)
        bundle = get_bundle(cfg, "cpu", model_axis(mesh), idle)
        params = lay.shard_params(lm_params_from_jax(T.params_from_paths(flat, cfg), "cpu"), mesh)
        cache = lay.shard_cache(cache, mesh)
        del routes[:]
        with torch.no_grad():
            for i in range(N_DECODE):
                logits, cache = bundle.decode(params, tokens[:, i:i + 1], cache)
                res[f"{cid}/decode{i}"] = logits.numpy()
        res[cid + "/routes"] = np.array(json.dumps([r.tolist() for r in routes]))
        res[cid + "/idle_calls"] = np.array(idle.stats["calls"])
        res[cid + "/split"] = np.array(json.dumps(
            sorted(k for k, d in {**lay.params, **lay.cache}.items() if d is not None)))
        shards = flatten_paths(cache)
        got = gather_model(gather_model(shards, lay.cache, mesh, lay.axes), lay.model_cache, mesh)
        for k, v in got.items():
            res[f"{cid}/cache/{k}"] = v.numpy()
    np.savez(os.path.join(out, f"{mesh_id}r{rank}.npz"), **res)
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


def _drawn_cache(jb, jcfg, pos, seed):
    """The reference's cache of one sequence with every float entry drawn
    from ``seed`` (K/V and latents 0.5-scaled normals, the SSM state and
    conv window too, the encoder memory) and ``pos`` set."""
    cache = (jb.init_cache(1, S, mem_len=T_MEM) if jcfg.is_enc_dec else jb.init_cache(1, S))
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return jnp.asarray(pos, x.dtype)
        return jnp.asarray((0.5 * rng.normal(size=x.shape)).astype(x.dtype))

    return jax.tree.map(draw, cache)


def _reference(jcfg, jparams, cache, tokens):
    """The JAX package's decode steps on the whole cache: each step's
    logits, the final cache and every MoE layer's routes, in order."""
    routes = []
    j_route = JMoE._route

    def recorded(logits, mo):
        got = j_route(logits, mo)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), got[0], ordered=True)
        return got

    JMoE._route = recorded
    try:
        decode = jax.jit(j_get_bundle(jcfg).decode)
        out = {}
        for i in range(N_DECODE):
            logits, cache = decode(jparams, jnp.asarray(tokens[:, i:i + 1]), cache)
            out[f"decode{i}"] = np.asarray(logits)
        jax.effects_barrier()
    finally:
        JMoE._route = j_route
    out.update({"cache/" + k: v for k, v in _flat(cache).items()})
    out["routes"] = routes
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("idle"))
    pairs = {}
    for i, (cid, arch, replace, pos) in enumerate(CASES):
        jcfg = dataclasses.replace(j_get_reduced(arch), **replace)
        init = JE.init_encdec if jcfg.is_enc_dec else JT.init_lm
        jparams = init(jax.random.PRNGKey(0), jcfg)
        cache = _drawn_cache(j_get_bundle(jcfg), jcfg, pos, 20 + i)
        tokens = np.random.default_rng(40 + i).integers(
            0, jcfg.vocab_size, size=(1, N_DECODE)).astype(np.int32)
        np.savez(os.path.join(out, cid + "_params.npz"), **_flat(jparams))
        np.savez(os.path.join(out, cid + "_cache.npz"), **_flat(cache))
        np.save(os.path.join(out, cid + "_tokens.npy"), tokens)
        pairs[cid] = (jcfg, jparams, cache, tokens)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, OMP_NUM_THREADS="1",
               CASES=json.dumps([list(c) for c in CASES]),
               SIZES=json.dumps([S, T_MEM, N_DECODE]))
    env.pop("XLA_FLAGS", None)
    procs = []
    for mesh_id, shape in MESHES.items():
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _RANK],
                                   env=dict(env, RANK=str(r), PORT=port, MESH_ID=mesh_id,
                                            MESH=json.dumps(shape)),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for r in range(4)]
    try:
        ref = {cid: _reference(*pair) for cid, pair in pairs.items()}
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    port = {m: [dict(np.load(os.path.join(out, f"{m}r{r}.npz"))) for r in range(4)]
            for m in MESHES}
    return port, ref


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cid", IDS)
def test_decode_logits_match_jax_on_the_whole_cache(runs, cid, mesh):
    port, ref = runs
    for r, res in enumerate(port[mesh]):
        for i in range(N_DECODE):
            got, want = res[f"{cid}/decode{i}"], ref[cid][f"decode{i}"]
            assert got.shape == want.shape
            _close(got, want, f"{cid} on {mesh}, rank {r}, decode step {i}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cid", IDS)
def test_gathered_cache_matches_jax(runs, cid, mesh):
    """The ranks' blocks gathered over the idle axes and model are the
    reference's whole cache after the steps (the writes landed on the rank
    that holds each slot, and nowhere else)."""
    port, ref = runs
    want = {k[len("cache/"):]: v for k, v in ref[cid].items() if k.startswith("cache/")}
    for r, res in enumerate(port[mesh]):
        got = {k[len(cid) + len("/cache/"):]: v for k, v in res.items()
               if k.startswith(cid + "/cache/")}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            _close(got[k], want[k], f"{cid} on {mesh}, rank {r}: cache {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cid", ["mixtral", "jamba", "deepseek"])
def test_every_rank_routes_as_jax(runs, cid, mesh):
    port, ref = runs
    want = [np.asarray(r).reshape(-1).tolist() for r in ref[cid]["routes"]]
    assert want
    for res in port[mesh]:
        got = [np.asarray(r).reshape(-1).tolist() for r in json.loads(str(res[cid + "/routes"]))]
        assert got == want


SPLIT = {  # what the idle axes split on (data 2, model 2), by leaf name
    "mixtral": {"k", "v", "w_down", "w_gate", "w_up"},
    "jamba": {"k", "v", "ssm", "w_down", "w_gate", "w_up"},
    "mamba2": {"ssm"},
    "deepseek": {"c_kv", "k_rope", "w_down", "w_gate", "w_up"},
    "qwen3": {"k", "v"},
    "seamless": {"k", "v"},
}


@pytest.mark.parametrize("cid", IDS)
def test_the_idle_axes_split_the_caches_state_and_experts(runs, cid):
    port, _ = runs
    for res in port["d2m2"]:
        split = json.loads(str(res[cid + "/split"]))
        assert {k.rsplit("/", 1)[-1] for k in split} == SPLIT[cid]
        assert not any("shared" in k for k in split)
        assert int(res[cid + "/idle_calls"]) > 0
