"""The PyTorch port imports neither JAX nor the JAX package ``repro``, and
exports the reference packages' public names (their ``__all__``), or lists
here why a name has no counterpart."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([PORT], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.quantize" in mods and "repro_torch.core.experiment" in mods
    assert "repro_torch.core.baselines" in mods and "repro_torch.kernels.sparse_mix" in mods
    for name in ("kernels.flash_attention", "kernels.ssd_scan", "models.config",
                 "models.layers", "models.rope", "models.mlp", "models.attention",
                 "models.mamba2", "models.transformer", "models.registry", "configs",
                 "configs.qwen3_8b", "configs.mamba2_370m", "serve", "serve.delta",
                 "models.moe", "configs.qwen2_5_14b", "configs.granite_20b",
                 "configs.nemotron_4_340b", "configs.mixtral_8x7b",
                 "configs.deepseek_v2_lite_16b", "configs.jamba_v01_52b",
                 "serve.engine", "serve.batcher", "serve.load", "serve.__main__",
                 "configs.shapes", "launch", "launch.mesh", "launch.steps", "launch.train",
                 "launch.input_specs", "figures.common", "figures.run", "figures.fig4_p_sweep",
                 "figures.fig5_local_updates", "figures.fig6_topology", "figures.fig7_cnn",
                 "figures.table2_complexity", "figures.fig_compression",
                 "figures.ablation_eta_c", "figures.fig_sparse", "examples.quickstart",
                 "examples.semi_decentralized_cnn", "figures.fig_dynamic",
                 "figures.fig_optimizers", "optim", "optim.update_rules", "optim.schedules",
                 "optim.optimizers", "sim", "sim.profiles", "sim.costmodel", "sim.tuner",
                 "events", "events.staleness", "events.clock", "events.driver",
                 "figures.fig_timecost", "figures.fig_async", "core.adversary",
                 "figures.fig_robust", "checkpoint", "checkpoint.checkpoint", "obs",
                 "obs.trace", "obs.export", "obs.metrics", "obs.regress", "obs.profile",
                 "launch.serve", "examples.train_federated_lm", "figures.fig_serve",
                 "figures.bench_driver", "figures.check_regress", "models.encdec",
                 "configs.seamless_m4t_medium", "configs.qwen2_vl_2b", "launch.dryrun",
                 "launch.cost_correction", "utils.roofline", "figures.roofline",
                 "figures.experiments_md", "launch.specs"):
        assert f"repro_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')"
        " or m == 'benchmarks' or m.startswith('benchmarks.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_file_of_the_port_names_jax_or_repro():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert offenders == []


# reference name -> why the port has no counterpart (never an alias to
# something else); the ROADMAP item where one will come
NO_COUNTERPART = {
    "repro.core": {
        "dynamic_round_fns": "jit wrappers staging a round's operands; the port's "
                             "NetworkContext.stage does it eagerly",
        "make_block_fn": "the lax.scan body; the port's block driver (run_block) is a "
                         "Python loop, not its twin",
        "run_training": "a deprecated shim over Experiment in the reference",
        "make_algorithm_round_fns": "a deprecated shim over get_algorithm(...).bind",
    },
    "repro.models": {},
    "repro.kernels": {
        "fused_compressed_mix": "K3's port is compressed_mix(x, residual, w, absmax, ...): "
                                "the error-feedback form with K2's abs-max passed in",
        "ssd_scan_kernel": "K7's port is ssd_scan(...), three chunk passes with "
                           "another signature",
    },
    "repro.utils": {},
    "repro.data": {},
    "repro.checkpoint": {},
    "repro.obs": {},
    "repro.serve": {},
}


# a reference module outside the packages' ``__all__`` whose twin has
# another name, or lacks some of its names -> (the twin, the reference's
# public names without a counterpart there, with the reason)
RENAMED_TWINS = {
    "repro.launch.specs": ("repro_torch.launch.specs", {
        "to_shardings": "NamedSharding objects for jax.jit's in/out shardings; the port's "
                        "ranks cut and gather their shards themselves (launch.steps."
                        "shard_leaves, gather_leaves, batch_share)",
    }),
    "repro.utils.hlo": ("repro_torch.utils.roofline", {
        "collective_bytes": "no HLO to parse: eager PyTorch compiles no module; the dry run's "
                            "CountingMesh counts the bytes its collectives would move",
        "shape_bytes": "no HLO shape strings: the counters read tensor shapes",
        "COLLECTIVE_KINDS": "kept by the mesh that counts them, "
                            "repro_torch.launch.mesh.COLLECTIVE_KINDS",
        "ICI_BW": "a TPU link rate; the port's link term is NVLink's, LINK_BW",
    }),
}


@pytest.mark.parametrize("module", sorted(RENAMED_TWINS))
def test_renamed_twins_cover_the_reference_module(module):
    """Every public name of the reference module is in its twin, or listed
    with its reason."""
    import importlib

    ref = importlib.import_module(module)
    twin_name, listed = RENAMED_TWINS[module]
    twin = importlib.import_module(twin_name)
    public = [n for n in vars(ref) if not n.startswith("_")
              and getattr(getattr(ref, n), "__module__", module) == module
              and not isinstance(getattr(ref, n), type(importlib))]
    missing = [n for n in public if n not in listed and not hasattr(twin, n)]
    assert missing == []
    assert all(not hasattr(twin, n) for n in listed) and set(listed) <= set(public)


@pytest.mark.parametrize("package", sorted(NO_COUNTERPART))
def test_public_surfaces_match_the_reference(package):
    """Every name of the reference package's ``__all__`` is in the port's
    twin (and its ``__all__``), or listed above with its reason."""
    import importlib

    ref = importlib.import_module(package)
    port = importlib.import_module(package.replace("repro", "repro_torch", 1))
    listed = NO_COUNTERPART[package]
    missing = [n for n in ref.__all__ if n not in listed
               and not (hasattr(port, n) and n in port.__all__)]
    assert missing == []
    assert all(not hasattr(port, n) for n in listed), "a listed name now exists"
    assert set(listed) <= set(ref.__all__)
