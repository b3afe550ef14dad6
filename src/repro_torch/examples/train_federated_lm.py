"""End-to-end driver: PISCO-train a ~126M-parameter decoder LM for a few
hundred communication rounds on heterogeneous token streams (the twin of the
reference's ``examples/train_federated_lm.py``).

The model (GQA + SwiGLU, 12 layers, d_model 768, vocab 8192, ~126M
parameters), per-agent Zipf streams with distinct bigram structure (the
heterogeneity), PISCO rounds with a Bernoulli(p) server schedule, a
checkpoint at every multiple of 100 rounds and at the end, with the model
config in the manifest, so ``python -m repro_torch.launch.serve --ckpt-dir``
rebuilds the bundle from the checkpoint alone:

    python -m repro_torch.examples.train_federated_lm --rounds 300 --ckpt-dir ckpt

Token streams and the round sampler draw with numpy exactly as the
reference does; the local steps run K1 (``fused_track_step``) once per leaf
and local step.  Agents' parameters are agent-stacked flat dicts keyed by
leaf path during training (the port's PISCO state); checkpoints and
``History.final_state`` carry x, y and g in the model's nested layout, as
the reference's state does, so either package reads the other's files.
Weights are drawn from the port's seeded generator, not the reference's
PRNG; :func:`train` takes ``params0`` to start from given weights.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import PiscoConfig, dense_mixing, make_topology, replicate_params
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.compression import make_byte_model
from repro_torch.core.driver import predraw_schedule, record_block, run_block
from repro_torch.core.trainer import History, record_wall_time
from repro_torch.data.synthetic import synthetic_lm_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train import nested_state
from repro_torch.models import ModelConfig, config_to_dict, get_bundle
from repro_torch.models.transformer import params_from_paths
from repro_torch.optim import resolve_update_rules
from repro_torch.utils.pytree import flatten_paths

LM_100M = ModelConfig(
    name="pisco-lm-100m",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=8192,
    mlp_type="swiglu",
    dtype="float32",
    attn_chunk=256,
    remat=False,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_federated_lm")
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--n-agents", type=int, default=4)
    ap.add_argument("--t-o", type=int, default=1)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--eta-l", type=float, default=0.1)
    ap.add_argument("--local-opt", default=None,
                    help="local update rule, e.g. momentum | adam:lr=0.01 "
                         "(default: the inline tracked SGD)")
    ap.add_argument("--server-opt", default=None, help="FedOpt server rule, e.g. fedavgm")
    ap.add_argument("--lr-schedule", default=None,
                    help="local-LR decay: linear | cosine | warmup_cosine")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return ap


def train(cfg: ModelConfig, args: argparse.Namespace, *, device: DeviceLike = None,
          params0: Optional[Any] = None) -> History:
    """The example's run: ``args`` as :func:`build_parser` makes them (its
    defaults for any missing), ``params0`` the nested start weights (the
    port's seeded init when None).  Returns the History, its ``final_state``
    in the nested layout; prints a line per ``--log-every`` rounds."""
    args = build_parser().parse_args([], namespace=argparse.Namespace(**vars(args)))
    dev = resolve_device(device)
    bundle = get_bundle(cfg, dev)
    n = args.n_agents
    print(f"model={cfg.name}: {cfg.param_count() / 1e6:.0f}M params, "
          f"{n} agents, T_o={args.t_o}, p={args.p}, on {bundle.device}")

    # heterogeneous per-agent streams (different bigram structure per agent)
    streams = [synthetic_lm_tokens(500_000, cfg.vocab_size, seed=31 * a + 1) for a in range(n)]
    rng = np.random.default_rng(0)

    def sample_round(_k):
        def one_set():
            out = []
            for a in range(n):
                s = streams[a]
                starts = rng.integers(0, len(s) - args.seq - 1, size=args.batch)
                out.append(np.stack([s[i: i + args.seq] for i in starts]))
            return np.stack(out)

        sets = np.stack([one_set() for _ in range(args.t_o + 1)])
        local = {"tokens": torch.from_numpy(sets[: args.t_o]).to(bundle.device)}
        comm = {"tokens": torch.from_numpy(sets[-1]).to(bundle.device)}
        return local, comm

    pcfg = PiscoConfig(n_agents=n, t_o=args.t_o, eta_l=args.eta_l, eta_c=1.0, p=args.p)
    mixing = dense_mixing(make_topology("ring", n), bundle.device)
    opt_kw = resolve_update_rules(args.local_opt, args.server_opt, args.lr_schedule,
                                  eta_l=args.eta_l, rounds=args.rounds, t_o=args.t_o)

    def loss_fn(flat, batch):
        return bundle.loss(params_from_paths(flat, cfg), batch)

    bound = get_algorithm("pisco").bind(loss_fn, pcfg, mixing, **opt_kw)
    params = bundle.init(0) if params0 is None else params0
    x0 = replicate_params(flatten_paths(params), n)
    _, comm0 = sample_round(-1)
    state = bound.init(loss_fn, x0, comm0)
    hist = History(byte_model=make_byte_model(
        mixing, x0, n, mixes_per_round=bound.comm.mixes_per_round,
        server_payloads=bound.comm.server_payloads))
    meta = {"model": config_to_dict(cfg)}

    t0 = time.perf_counter()
    k = 0
    with record_wall_time(hist):
        while k < args.rounds:
            # blocks end at log points and checkpoint multiples
            stop = min(k + args.log_every, args.rounds)
            if args.ckpt_dir:
                stop = min(stop, (k // 100 + 1) * 100)
            flags = predraw_schedule(bound.schedule, k, stop)
            state, metrics, realized = run_block(bound, state, sample_round, k, flags)
            record_block(hist, metrics, flags, realized, start=k)
            dt = time.perf_counter() - t0
            print(f"round {stop - 1:4d} [{'J' if flags[-1] else 'W'}] loss={hist.loss[-1]:.4f} "
                  f"consensus={hist.consensus_err[-1]:.2e} ({dt / stop:.1f}s/round)")
            if args.ckpt_dir and stop % 100 == 0:
                save_checkpoint(args.ckpt_dir, stop, nested_state(state, cfg), metadata=meta)
            k = stop
    hist.final_state = nested_state(state, cfg)

    if args.ckpt_dir:
        # the final state whatever the round count; the manifest carries the
        # model config, so the launcher rebuilds the bundle from the file alone
        path = save_checkpoint(args.ckpt_dir, args.rounds, hist.final_state, metadata=meta)
        print(f"saved final checkpoint: {path}")
        print(f"serve it:  python -m repro_torch.launch.serve --ckpt {path} "
              "--delta topk:f=0.05")
    acct = hist.accountant
    print(f"\nfinal: loss {hist.loss[0]:.4f} -> {hist.loss[-1]:.4f} over {args.rounds} rounds "
          f"({acct.agent_to_agent} gossip / {acct.agent_to_server} server)")
    return hist


def main(argv=None, cfg: ModelConfig = LM_100M) -> History:
    args = build_parser().parse_args(argv)
    hist = train(cfg, args, device=args.device)
    if not hist.loss[-1] < hist.loss[0]:
        raise RuntimeError(f"training must reduce loss: {hist.loss[0]} -> {hist.loss[-1]}")
    return hist


if __name__ == "__main__":
    main()
