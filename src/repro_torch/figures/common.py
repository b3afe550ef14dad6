"""Shared harness of the figure twins (twin of ``benchmarks/common.py``)."""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import time
from typing import Optional

import torch

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.core.mixing import MixingOps
from repro_torch.core.topology import make_topology
from repro_torch.data import FederatedDataset, RoundSampler
from repro_torch.data.synthetic import synthetic_a9a
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import simple as S

PACKAGE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REPO = os.path.abspath(os.path.join(PACKAGE, "..", ".."))
ARTIFACTS = os.path.join(REPO, "artifacts", "torch")


def card_name(device: torch.device) -> Optional[str]:
    """``name, power limit`` of the card as ``nvidia-smi`` prints them, or
    None on the CPU."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    index = device.index or 0
    if index < len(out):
        return out[index].strip()
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def git_rev() -> Optional[str]:
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10, cwd=REPO).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return rev or None


def source_digest(root: str = PACKAGE) -> str:
    """sha256 over the port's sources under ``root`` (each ``.py``, ``.cu``
    and ``.cuh`` file's relative path and bytes, in path order).  It names
    the code a payload came from where the checkout has no ``.git``."""
    paths = []
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        paths += [os.path.join(base, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    h = hashlib.sha256()
    for rel in sorted(os.path.relpath(p, root) for p in paths):
        with open(os.path.join(root, rel), "rb") as f:
            h.update(rel.replace(os.sep, "/").encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def save_result(name: str, payload: dict, out_dir: Optional[str] = None, *,
                device: DeviceLike) -> str:
    """Write ``payload`` to ``<out_dir>/<name>.json`` (``artifacts/torch``
    by default), stamped with the device it ran on (None for an analytic
    payload) — the card's name and power limit on a GPU — the git rev of
    the checkout (None outside one) and :func:`source_digest`."""
    dev = None if device is None else torch.device(device)
    payload = dict(payload, device=None if dev is None else dev.type,
                   card=None if dev is None else card_name(dev), git_rev=git_rev(),
                   source_digest=source_digest())
    out_dir = ARTIFACTS if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_logreg_workload(n_agents: int = 10, quick: bool = False, seed: int = 0,
                         device: DeviceLike = None):
    """§5.1 workload: synthetic-a9a, sorted split, logreg + nonconvex reg;
    the data resident on ``device``.  The eval reads the full-data gradient
    norm (``torch.func.grad``) and the test accuracy at x̄ in one host sync."""
    dev = resolve_device(device)
    n_samples = 4000 if quick else 32560
    x, y = synthetic_a9a(n_samples, seed=seed)
    data = FederatedDataset.from_arrays(x, y, n_agents, heterogeneous=True, seed=seed).to(dev)
    loss_fn = functools.partial(S.logreg_loss, rho=0.01)
    d = x.shape[1]
    xt, yt = data.x_train.reshape(-1, d), data.y_train.reshape(-1)
    grad = torch.func.grad(lambda p: S.logreg_loss(p, (xt, yt), 0.01))

    def eval_fn(params):
        g = grad(params)
        gsq = sum(torch.sum(g[k] ** 2) for k in sorted(g))
        host = torch.stack([gsq, S.logreg_accuracy(params, data.x_test, data.y_test)]).cpu()
        return {"grad_sq": float(host[0]), "test_acc": float(host[1])}

    return data, loss_fn, eval_fn, {"w": torch.zeros((d,), dtype=torch.float32, device=dev)}


def run_pisco_variant(
    *,
    data: FederatedDataset,
    loss_fn,
    eval_fn,
    params0,
    topology_name: str = "ring",
    p: float = 0.1,
    t_o: int = 1,
    eta_l: float = 0.5,
    eta_c: float = 1.0,
    rounds: int = 400,
    batch: int = 256,
    seed: int = 0,
    algo: str = "pisco",
    eval_every: int = 1,
    topo_kwargs: Optional[dict] = None,
    compression: Optional[str] = None,
    error_feedback: bool = True,
    driver: str = "scan",
    network: Optional[str] = None,
    participation: float = 1.0,
    optimizer: Optional[str] = None,
    server_optimizer: Optional[str] = None,
    lr_schedule: Optional[str] = None,
    opt_policy: Optional[str] = None,
    adversary: Optional[str] = None,
    robust_agg: str = "mean",
    device: DeviceLike = None,
    mixing: Optional[MixingOps] = None,
):
    """One PISCO (or baseline) run of the figures: ``(History, Topology)``.
    A keyword whose feature is not ported raises ``NotImplementedError``
    from the spec, naming its ROADMAP item.  ``mixing`` replaces the
    spec's operator, so that a caller can reach the one the run used."""
    dev = resolve_device(device)
    spec = ExperimentSpec.create(
        algo=algo, n_agents=data.n_agents, t_o=t_o, eta_l=eta_l, eta_c=eta_c, p=p,
        seed=seed, topology=topology_name, topology_kwargs=topo_kwargs or {},
        network=network, participation=participation, compression=compression,
        error_feedback=error_feedback, optimizer=optimizer,
        server_optimizer=server_optimizer, lr_schedule=lr_schedule,
        opt_policy=opt_policy, adversary=adversary, robust_agg=robust_agg,
        rounds=rounds, eval_every=eval_every, driver=driver,
    )
    # build the topology once: the returned topo is the one trained on
    topo = make_topology(topology_name, data.n_agents, **(topo_kwargs or {}))
    resident = data.to(dev)
    b = min(batch, resident.samples_per_agent)
    hist = Experiment(
        spec, loss_fn=loss_fn, params0=params0, eval_fn=eval_fn,
        mixing=spec.make_mixing(dev) if mixing is None else mixing, device=dev,
        sampler_factory=lambda s: RoundSampler(resident, b, s.config.t_o, s.config.seed,
                                               device=dev),
    ).run()
    return hist, topo


def comm_rounds_to_targets(hist, grad_target=0.05, acc_target=0.80):
    """Paper Fig. 4 readout: (a2a, a2s) rounds when each target is first met."""
    out = {}
    for name, key, target, mode in (
        ("train", "grad_sq", grad_target, "running_le"),
        ("test", "test_acc", acc_target, "ge"),
    ):
        r = hist.rounds_to_threshold(key, target, mode=mode)
        if r is None:
            out[name] = None
        else:
            # eval_every=1 => round index == eval index
            a2a = sum(1 for g in hist.is_global[: r + 1] if not g)
            a2s = sum(1 for g in hist.is_global[: r + 1] if g)
            out[name] = {"rounds": r + 1, "a2a": a2a, "a2s": a2s}
    return out


class Tally:
    """Seconds and rounds of one figure: its payload's ``seconds`` (the
    whole figure on the host clock, set-up included, ended by a device
    synchronise), ``rounds`` (every round run) and ``ms_per_round``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = time.perf_counter()
        self.rounds = 0
        self.driver_s = 0.0

    def add(self, hist) -> None:
        self.rounds += len(hist.loss)
        self.driver_s += hist.wall_time_s

    def stamp(self, payload: dict) -> dict:
        sync(self.device)
        seconds = time.perf_counter() - self.t0
        return dict(payload, seconds=seconds, rounds=self.rounds,
                    driver_seconds=self.driver_s,
                    ms_per_round=1e3 * seconds / max(1, self.rounds))
