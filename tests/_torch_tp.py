"""Shared harness of the tensor-parallel model tests (``test_torch_tp_*``).

Each test module names its cases, ``(case id, arch, config replacements,
inputs)``.  One module fixture (:func:`run_cases`) writes every case's
reference weights (``JT.init_lm`` / ``JE.init_encdec`` at ``reduced()``,
float32) and inputs to npz files, starts the port's ranks as subprocesses —
one gloo group of 2 model ranks and one of 4, mesh (data 1, model m) — and
computes the JAX package's results in this process meanwhile.  Each rank
carries the weights over with ``lm_params_from_jax(..., layout, mesh)``
(its model shard), runs the loss and its gradients, the training forward,
the prefill and 4 decode steps on its shard, gathers the logits and the
gradients over ``model`` and writes them, with the list of model-axis
collectives it ran, to an npz file.

Tolerance: 1e-5 relative — of the largest reference magnitude, per leaf or
per logits tensor (float32; the model ranks' partial sums add in another
order than one device's dot products).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.models import encdec as JE
from repro.models import get_bundle as j_get_bundle
from repro.models import transformer as JT

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-5
WORLDS = (2, 4)
B, S, T_FRAMES, S_IMG, N_DECODE = 2, 16, 8, 4, 4

_RANK = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, out = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
    B, S, T_FRAMES, S_IMG, N_DECODE = json.loads(os.environ["SIZES"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=world)

    from repro_torch.configs import get_reduced
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh, ModelAxis
    from repro_torch.launch.specs import gather_model, shard_tree
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import flatten_paths
    from repro_torch.weights import lm_params_from_jax

    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    tp = ModelAxis(mesh)
    log = []
    for name in ("all_reduce_sum", "all_reduce_max", "all_gather"):
        def wrapped(x, axes, *a, _f=getattr(mesh, name), _n=name):
            log.append([_n, list(x.shape)])
            return _f(x, axes, *a)
        setattr(mesh, name, wrapped)
    res = {}
    for cid, arch, replace in json.loads(os.environ["CASES"]):
        cfg = dataclasses.replace(get_reduced(arch), **replace)
        flat = dict(np.load(os.path.join(out, cid + "_params.npz")))
        inp = {k: torch.from_numpy(v)
               for k, v in np.load(os.path.join(out, cid + "_in.npz")).items()}
        bundle = get_bundle(cfg, "cpu", tp)
        layout, differs, _ = ST.param_layout(bundle, mesh)
        params = lm_params_from_jax(T.params_from_paths(flat, cfg), "cpu", layout, mesh)
        batch = {k: v for k, v in inp.items() if k != "decode"}
        del log[:]
        loss, grads = bundle.value_and_grad(params, batch)
        res[cid + "/log"] = np.array(json.dumps(log))
        res[cid + "/loss"] = np.array(float(loss))
        for k, g in gather_model(flatten_paths(grads), layout, mesh).items():
            res[cid + "/grad/" + k] = g.numpy()
        with torch.no_grad():
            if cfg.is_enc_dec:
                mem = E.encode(params, cfg, batch["frames"], tp)
                res[cid + "/logits"] = E.decode_train(params, cfg, batch["tokens"], mem, tp).numpy()
                whole = bundle.init_cache(B, S + N_DECODE, mem_len=T_FRAMES)
            else:
                logits, _ = T.lm_forward(params, cfg, batch["tokens"],
                                         prefix_embeds=batch.get("prefix_embeds"), tp=tp)
                res[cid + "/logits"] = logits.numpy()
                whole = bundle.init_cache(B, S + S_IMG + N_DECODE)
            c_layout, _ = ST.cache_layout(bundle, whole, mesh)
            cache = shard_tree(whole, c_layout, mesh)
            logits, cache = bundle.prefill(params, batch, cache)
            res[cid + "/prefill"] = logits.numpy()
            for i in range(N_DECODE):
                logits, cache = bundle.decode(params, inp["decode"][:, i:i + 1], cache)
                res[cid + f"/decode{i}"] = logits.numpy()
    np.savez(os.path.join(out, f"w{world}r{rank}.npz"), **res)
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


def _inputs(cfg, seed, prefix):
    rng = np.random.default_rng(seed)
    inp = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab_size, size=(B, N_DECODE)).astype(np.int32)}
    if cfg.is_enc_dec:
        inp["frames"] = rng.normal(size=(B, T_FRAMES, cfg.d_model)).astype(np.float32)
    elif prefix:
        inp["prefix_embeds"] = rng.normal(size=(B, S_IMG, cfg.d_model)).astype(np.float32)
    return inp


def _reference(jcfg, jparams, inp):
    """The JAX package's loss, gradients, forward logits, prefill and
    decode logits on the same weights and inputs."""
    batch = {k: jnp.asarray(v) for k, v in inp.items() if k != "decode"}
    out = {}
    if jcfg.is_enc_dec:
        loss_fn = lambda p: JE.encdec_loss(p, jcfg, batch)  # noqa: E731
        fwd = jax.jit(lambda p: JE.decode_train(p, jcfg, batch["tokens"],
                                                JE.encode(p, jcfg, batch["frames"])))
        jb = j_get_bundle(jcfg)
        cache = jb.init_cache(B, S + N_DECODE, mem_len=T_FRAMES)
    else:
        loss_fn = lambda p: JT.lm_loss(p, jcfg, batch)  # noqa: E731
        fwd = jax.jit(lambda p: JT.lm_forward(p, jcfg, batch["tokens"],
                                              prefix_embeds=batch.get("prefix_embeds"))[0])
        jb = j_get_bundle(jcfg)
        cache = jb.init_cache(B, S + S_IMG + N_DECODE)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    out["loss"] = float(loss)
    out.update({"grad/" + k: v for k, v in _flat(grads).items()})
    out["logits"] = np.asarray(fwd(jparams))
    logits, cache = jax.jit(jb.prefill)(jparams, batch, cache)
    out["prefill"] = np.asarray(logits)
    decode = jax.jit(jb.decode)
    for i in range(N_DECODE):
        logits, cache = decode(jparams, jnp.asarray(inp["decode"][:, i:i + 1]), cache)
        out[f"decode{i}"] = np.asarray(logits)
    return out


def run_cases(tmp_path_factory, cases):
    """``(port, ref)``: ``port[world]`` the ranks' npz dicts, ``ref[case
    id]`` the reference's results.  ``cases``: ``(case id, arch, config
    replacements, prefix)``, ``prefix`` True for a VLM batch with a prefix
    of patch embeddings."""
    import dataclasses

    out = str(tmp_path_factory.mktemp("tp"))
    pairs = {}
    for i, (cid, arch, replace, prefix) in enumerate(cases):
        jcfg = dataclasses.replace(j_get_reduced(arch), **replace)
        init = JE.init_encdec if jcfg.is_enc_dec else JT.init_lm
        jparams = init(jax.random.PRNGKey(0), jcfg)
        inp = _inputs(jcfg, 10 + i, prefix)
        np.savez(os.path.join(out, cid + "_params.npz"), **_flat(jparams))
        np.savez(os.path.join(out, cid + "_in.npz"), **inp)
        pairs[cid] = (jcfg, jparams, inp)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OUT=out, OMP_NUM_THREADS="1",
               CASES=json.dumps([[c, a, r] for c, a, r, _ in cases]),
               SIZES=json.dumps([B, S, T_FRAMES, S_IMG, N_DECODE]))
    env.pop("XLA_FLAGS", None)
    procs = []
    for world in WORLDS:
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _RANK],
                                   env=dict(env, RANK=str(r), WORLD=str(world), PORT=port),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    try:
        ref = {cid: _reference(*pair) for cid, pair in pairs.items()}
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    port = {w: [dict(np.load(os.path.join(out, f"w{w}r{r}.npz"))) for r in range(w)]
            for w in WORLDS}
    return port, ref


def close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def check_loss_and_grads(port, ref, cid, world):
    """Every rank's loss, and the gradients gathered over model, against
    the reference; the ranks ran the same model-axis collectives in the
    same order."""
    ranks = port[world]
    want = ref[cid]
    grads = sorted(k for k in want if k.startswith("grad/"))
    assert grads == sorted(k[len(cid) + 1:] for k in ranks[0] if k.startswith(cid + "/grad/"))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res[cid + "/loss"]), want["loss"], rtol=TOL)
        for k in grads:
            close(res[f"{cid}/{k}"], want[k], f"{cid} on {world} ranks, rank {r}: {k}")
    logs = [json.loads(str(res[cid + "/log"])) for res in ranks]
    assert logs[0] and all(lg == logs[0] for lg in logs)


def check_serving(port, ref, cid, world):
    """The training forward's logits, the prefill's and 4 decode steps',
    gathered over model, on every rank, against the reference."""
    for r, res in enumerate(port[world]):
        for k in ["logits", "prefill"] + [f"decode{i}" for i in range(N_DECODE)]:
            assert res[f"{cid}/{k}"].shape == ref[cid][k].shape, k
            close(res[f"{cid}/{k}"], ref[cid][k], f"{cid} on {world} ranks, rank {r}: {k}")


def collective_counts(port, cid, world):
    log = json.loads(str(port[world][0][cid + "/log"]))
    return {k: sum(1 for n, _ in log if n == k)
            for k in ("all_reduce_sum", "all_reduce_max", "all_gather")}
