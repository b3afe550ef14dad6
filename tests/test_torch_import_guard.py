"""The PyTorch port imports neither JAX nor the JAX package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys

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
                 "figures.fig_timecost", "figures.fig_async"):
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
