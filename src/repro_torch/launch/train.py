"""End-to-end PISCO training of the LM architectures (the twin of
``repro.launch.train``): the sampler and the command line.

    python -m repro_torch.launch.train --arch qwen3-8b --reduced \
        --rounds 50 --t-o 4 --p 0.1 --batch 8 --seq 128

Every option of the reference's launcher keeps its name, default and
choices; ``--device`` (default: the GPU, and an error without one) picks
where it runs, ``--device cpu`` the plain PyTorch path.  The host loop is
the paper's line 8: a Bernoulli(p) draw per round picks the gossip or the
global round.  ``--driver scan`` draws a block's flags on the host and runs
the block, syncing at log and checkpoint cuts only; ``loop`` syncs every
round; ``events`` runs the asynchronous event queue over ``--systems``.
``--tune`` runs the p x tau autotuner instead of training.

The agents' parameters are agent-stacked flat dicts keyed by leaf path (the
port's PISCO state), and the loss reads them through
:func:`~repro_torch.models.transformer.params_from_paths`.  Checkpoints
carry the state's model trees in the reference's nested layout (an update
rule's state keeps the flat, path-keyed one; its leaves fall in the same
order), so either package's launcher restores the other's files: the
leaves are poured into the freshly initialised state in ``jax.tree_util``
order.  Weights are drawn from the port's seeded generator
(:meth:`~repro_torch.models.registry.ModelBundle.init`), not from the
reference's PRNG, so two packages' runs agree only from a shared checkpoint.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.adversary import (
    make_adversarial_mixing,
    parse_adversary_spec,
    unwrap_network,
)
from repro_torch.core.algorithms import get_algorithm, registered_algorithms
from repro_torch.core.compression import make_byte_model
from repro_torch.core.driver import predraw_schedule, record_flags, run_block
from repro_torch.core.experiment import Experiment, ExperimentSpec
from repro_torch.core.mixing import make_network_mixing, make_sparse_network_mixing
from repro_torch.core.pisco import PiscoConfig, replicate_params
from repro_torch.core.topology import make_sparse_topology, make_topology
from repro_torch.core.trainer import History
from repro_torch.data.synthetic import synthetic_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.events.staleness import AsyncConfig, parse_async_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_bundle
from repro_torch.models.rope import mrope_text_positions
from repro_torch.models.transformer import dtype_of, params_from_paths
from repro_torch.obs import TraceRecorder, profile_capture, write_trace
from repro_torch.optim.update_rules import RULE_NAMES, resolve_update_rules
from repro_torch.sim import PROFILE_NAMES, make_time_model, tune
from repro_torch.utils.pytree import flatten_paths

Batch = Dict[str, torch.Tensor]


def make_lm_sampler(cfg: ModelConfig, n_agents: int, batch: int, seq: int, t_o: int,
                    seed: int = 0) -> Callable[[int], Tuple[Batch, Batch]]:
    """Per-round sampler of ``(local_batches, comm_batch)``: token tensors
    (T_o, A, b, seq) and (A, b, seq), int32 on the CPU, bit-equal to the
    reference's for the same seed.  Each agent reads its own Zipf stream (a
    different seed per agent: the LM analogue of the paper's sorted-label
    split); every round draws all agents' windows from one shared numpy
    generator, so each rank draws them all and keeps its own slice.

    The stub frontends draw from the same generator after the tokens, as
    the reference's: a VLM's ``prefix_embeds`` (T_o, A, b, max(1, seq // 8),
    d_model) and the text-only M-RoPE ``positions`` (T_o, A, 3, b, seq +
    n_patch); an encoder-decoder's ``frames`` (T_o, A, b, max(1, seq // 4),
    d_model); in ``cfg.dtype``.  The comm batch takes the first local set of
    these (the reference's)."""
    streams = [synthetic_lm_tokens(200_000, cfg.vocab_size, seed=seed + 17 * i)
               for i in range(n_agents)]
    rng = np.random.default_rng(seed + 999)

    def batch_for(agent: int, b: int) -> np.ndarray:
        s = streams[agent]
        starts = rng.integers(0, len(s) - seq - 1, size=b)
        return np.stack([s[st:st + seq] for st in starts])

    def per_round(_k: int) -> Tuple[Batch, Batch]:
        toks = np.stack([np.stack([batch_for(a, batch) for a in range(n_agents)])
                         for _ in range(t_o + 1)])  # (T_o + 1, A, b, seq)
        local = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:t_o]))}
        comm = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[-1]))}
        if cfg.modality == "vlm":
            n_patch = max(1, seq // 8)
            local["prefix_embeds"] = embeds(n_patch)
            pos = mrope_text_positions(batch, seq + n_patch)
            local["positions"] = pos.expand((t_o, n_agents) + pos.shape).contiguous()
        if cfg.is_enc_dec:
            local["frames"] = embeds(max(1, seq // 4))
        for k in local.keys() - comm.keys():
            comm[k] = local[k][0]
        return local, comm

    def embeds(n: int) -> torch.Tensor:
        draw = rng.normal(size=(t_o, n_agents, batch, n, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(draw).to(dtype_of(cfg))

    return per_round


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The reference's options, with their defaults and choices, and
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true", help="use the smoke-size config")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--n-agents", type=int, default=4)
    ap.add_argument("--t-o", type=int, default=2)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--eta-l", type=float, default=0.05)
    ap.add_argument("--eta-c", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--network", default=None,
                    help="dynamic-topology process: static | bernoulli[:q] | "
                         "matching | roundrobin[:n] | cohort[:frac] (default: frozen base W)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of agents sampled into each server round")
    ap.add_argument("--sparse", action="store_true",
                    help="edge-list/CSR mixing (K4 gossip, O(n+m) state) — required for "
                         "large fleets; default dense n x n (auto-selected by "
                         "ExperimentSpec above 512 agents)")
    ap.add_argument("--cohort", type=float, default=None,
                    help="neighbor-sampled cohorts: fraction of agents seeding each "
                         "gossip round (sugar for --network cohort:FRAC)")
    ap.add_argument("--adversary", default=None,
                    help="Byzantine fault injection: signflip[:f=..,scale=..] | "
                         "random:f=..,scale=.. | collusion:f=..,target=drift — the "
                         "selected agents corrupt their outgoing gossip payloads and "
                         "server uploads (default: none)")
    ap.add_argument("--robust-agg", default="mean",
                    help="server-averaging rule at global rounds: mean (default, plain "
                         "average) | trimmed[:f=..] | median | krum[:f=..]")
    ap.add_argument("--systems", default=None,
                    help="simulated systems-cost profile: "
                         f"{'|'.join(PROFILE_NAMES)} with k=v overrides, e.g. "
                         "'wan-gossip' or 'uniform:latency=0'; prints the simulated "
                         "wall-clock split after training")
    ap.add_argument("--tune", action="store_true",
                    help="instead of training, run the p x tau communication autotuner "
                         "under --systems (default profile: uniform) and print the "
                         "simulated time-to-target frontier")
    ap.add_argument("--tune-p", type=float, nargs="+", default=[0.0, 0.05, 0.1, 0.3, 1.0],
                    help="server-probability grid for --tune")
    ap.add_argument("--tune-tau", type=int, nargs="+", default=None,
                    help="local-update (T_o) grid for --tune (default: just --t-o)")
    ap.add_argument("--tune-rounds", type=int, default=None,
                    help="round budget per tuner configuration (default: --rounds)")
    ap.add_argument("--tune-strategy", default="halving", choices=["grid", "halving"],
                    help="sweep every config fully, or successive-halving")
    ap.add_argument("--algo", default="pisco", choices=list(registered_algorithms()))
    ap.add_argument("--local-opt", default=None,
                    help="pluggable local update rule: "
                         f"{'|'.join(RULE_NAMES)} with k=v args, e.g. 'momentum:beta=0.9' "
                         "or 'clip:1.0|adam' (default: the inline tracked-SGD path)")
    ap.add_argument("--server-opt", default=None,
                    help="FedOpt server rule at global-averaging rounds: "
                         "fedavgm | fedadam | sgd:lr=... | momentum | adam")
    ap.add_argument("--lr-schedule", default=None,
                    help="per-round local-LR decay: linear[:final=..] | cosine[:final=..] | "
                         "warmup_cosine[:warmup=..]")
    ap.add_argument("--opt-policy", default=None, choices=["mix", "keep", "reset"],
                    help="what happens to agent-stacked optimizer buffers at "
                         "communication rounds (default: registry entry's)")
    ap.add_argument("--driver", default="scan", choices=["scan", "loop", "events"],
                    help="scan: a block of rounds per host sync; loop: one sync a "
                         "round; events: async event-queue over --systems")
    ap.add_argument("--async", dest="async_spec", default=None,
                    help="async aggregation rule for --driver events: "
                         "'<rule>[:k=v,...]' over constant|poly|buffer with keys "
                         "alpha/bound/buffer, e.g. 'poly:alpha=0.5,bound=2,buffer=4'")
    ap.add_argument("--staleness-bound", type=int, default=None,
                    help="gossip staleness bound B (events driver): agents more than B "
                         "rounds behind the front are dropped from their neighbors' "
                         "mixes until the next server reset")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="server buffer size m (events driver): a global round fires "
                         "at the m-th participant push instead of waiting for the "
                         "straggler tail")
    ap.add_argument("--block-size", type=int, default=16,
                    help="rounds per block (scan driver)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run (per-round spans "
                         "with byte/sim-second attribution; open the JSON at "
                         "ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="append the run's metrics-registry snapshot (rounds/bytes/"
                         "sim-seconds counters + histograms) as one line of this JSONL file")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of training into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain path)")
    return ap


_MODEL_FIELDS = ("x", "y", "g", "c_i", "c")  # a state's fields that hold model trees


def nested_state(state, cfg: ModelConfig):
    """The algorithm state with its model trees in the reference's nested
    layout (what checkpoints carry); an update rule's state stays flat."""
    return state._replace(**{f: params_from_paths(getattr(state, f), cfg)
                             for f in _MODEL_FIELDS if f in state._fields})


def _leaves(tree) -> Iterator[Any]:
    """Leaves in ``jax.tree_util`` order (sorted dict keys, sequences and
    NamedTuples in order; () has none)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _pour(template, leaves: Iterator[Any]):
    """``template``'s structure over the next leaves of ``leaves``, each
    moved to its template leaf's device."""
    if isinstance(template, dict):
        return {k: _pour(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_pour(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_pour(v, leaves) for v in template)
    if template is None:
        return None
    leaf = next(leaves)
    if isinstance(template, torch.Tensor) and isinstance(leaf, torch.Tensor):
        return leaf.to(template.device)
    return leaf


def restore_into(state, ckpt_tree, cfg: ModelConfig):
    """``state`` with the checkpoint's leaves poured in, in ``jax.tree_util``
    order (the reference launcher's restore); its model trees come back
    flat.  Raises the reference's ``ValueError`` when the leaf counts
    differ."""
    template = nested_state(state, cfg)
    leaves = list(_leaves(ckpt_tree))
    n_state = sum(1 for _ in _leaves(template))
    if len(leaves) != n_state:
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but the bound "
            f"algorithm state needs {n_state} — was it saved "
            f"with different --algo/--local-opt/--server-opt settings?"
        )
    poured = _pour(template, iter(leaves))
    return poured._replace(**{f: flatten_paths(getattr(poured, f))
                              for f in _MODEL_FIELDS if f in poured._fields})


def _on(device: torch.device, sampler: Callable) -> Callable:
    """The sampler with its batches moved to ``device``."""
    def per_round(k: int):
        return tuple({n: t.to(device) for n, t in part.items()} for part in sampler(k))

    return per_round


def _log_line(k: int, is_global: bool, metrics, i: int = -1) -> str:
    return (f"round {k:4d} [{'J' if is_global else 'W'}] "
            f"loss={float(metrics.loss[i]):.4f} "
            f"|grad|^2={float(metrics.grad_sq_norm[i]):.3e} "
            f"consensus={float(metrics.consensus_err[i]):.3e}")


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    bundle = get_bundle(cfg, dev)
    pcfg = PiscoConfig(
        n_agents=args.n_agents, t_o=args.t_o, eta_l=args.eta_l,
        eta_c=args.eta_c, p=args.p, seed=args.seed,
    )
    if args.cohort is not None and args.network is not None:
        ap.error("--cohort is sugar for --network cohort:FRAC; pass one, not both")
    network = f"cohort:{args.cohort:g}" if args.cohort is not None else args.network
    if args.sparse:
        topo = make_sparse_topology(args.topology, args.n_agents)
        mixing = make_sparse_network_mixing(topo, dev, network, args.participation,
                                            seed=args.seed)
    else:
        topo = make_topology(args.topology, args.n_agents)
        mixing = make_network_mixing(topo, dev, network, args.participation, seed=args.seed)
    # fault injection and the robust server rule wrap the mixing, as
    # ExperimentSpec.make_mixing layers them
    mixing = make_adversarial_mixing(mixing, args.adversary, args.robust_agg,
                                     n_agents=args.n_agents, seed=args.seed)
    lam = "n/a" if topo.lambda_w is None else f"{topo.lambda_w:.4f}"
    print(f"arch={cfg.name} params~{cfg.param_count():,} agents={args.n_agents} "
          f"topology={'sparse/' if args.sparse else ''}{args.topology} "
          f"network={network or 'frozen'} "
          f"participation={args.participation:g} lambda_w={lam} "
          f"p={args.p}")
    if args.adversary is not None or args.robust_agg != "mean":
        adv = (parse_adversary_spec(args.adversary, args.n_agents, args.seed)
               if args.adversary is not None else None)
        print(f"adversary={args.adversary or 'none'}"
              + (f" ({adv.n_byz}/{args.n_agents} Byzantine)" if adv else "")
              + f" robust_agg={args.robust_agg}")

    def loss_fn(flat, batch):
        return bundle.loss(params_from_paths(flat, cfg), batch)

    def sampler_for(t_o: int) -> Callable:
        return _on(dev, make_lm_sampler(cfg, args.n_agents, args.batch, args.seq, t_o,
                                        args.seed))

    sampler = sampler_for(args.t_o)
    params = flatten_paths(bundle.init(args.seed))
    x0 = replicate_params(params, args.n_agents)

    async_spec = args.async_spec
    if args.staleness_bound is not None or args.buffer_size is not None:
        acfg = parse_async_spec(async_spec) if async_spec else AsyncConfig()
        if args.staleness_bound is not None:
            acfg = dataclasses.replace(acfg, bound=args.staleness_bound)
        if args.buffer_size is not None:
            acfg = dataclasses.replace(acfg, buffer=args.buffer_size)
        async_spec = acfg.spec()
    if async_spec is not None and args.driver != "events":
        ap.error("--async/--staleness-bound/--buffer-size need --driver events")
    if args.driver == "events" and not args.systems:
        ap.error("--driver events needs --systems (the event clock is drawn "
                 "from the fleet profile)")

    # the declarative twin of this invocation: what the cost model and the
    # autotuner price
    spec = ExperimentSpec.create(
        algo=args.algo, n_agents=args.n_agents, t_o=args.t_o,
        eta_l=args.eta_l, eta_c=args.eta_c, p=args.p, seed=args.seed,
        topology=args.topology, network=args.network,
        sparse=args.sparse or None, cohort=args.cohort,
        participation=args.participation,
        systems=args.systems or ("uniform" if args.tune else None),
        async_=async_spec,
        adversary=args.adversary, robust_agg=args.robust_agg,
        optimizer=args.local_opt, server_optimizer=args.server_opt,
        lr_schedule=args.lr_schedule, opt_policy=args.opt_policy,
        rounds=args.rounds, driver=args.driver, block_size=args.block_size,
    )
    if args.tune:
        result = tune(
            spec,
            dict(loss_fn=loss_fn, params0=params, device=dev,
                 sampler_factory=lambda s: sampler_for(s.config.t_o)),
            p_grid=args.tune_p,
            tau_grid=tuple(args.tune_tau) if args.tune_tau else (None,),
            rounds=args.tune_rounds,
            strategy=args.tune_strategy,
        )
        print(f"tuner ({result.strategy}) under {result.systems!r}: "
              f"target smoothed loss {result.target_loss:.4f}")
        print(f"{'p':>6} {'T_o':>4} {'rounds':>6} {'sim s->target':>13} "
              f"{'total sim s':>11} {'final loss':>10}")
        for pt in result.points:
            tts = (f"{pt.time_to_target_s:13.2f}" if pt.time_to_target_s is not None
                   else f"{'---':>13}")
            print(f"{pt.p:6.2f} {pt.t_o:4d} {pt.rounds_run:6d} {tts} "
                  f"{pt.total_sim_time_s:11.2f} {pt.final_loss:10.4f}")
        print(f"fastest-to-target: p={result.best.p:g} T_o={result.best.t_o}")
        return 0

    recorder = None
    if args.trace_out:
        recorder = TraceRecorder(meta={
            "kind": "train", "arch": cfg.name, "algo": args.algo,
            "driver": args.driver, "n_agents": args.n_agents,
            "rounds": args.rounds, "systems": args.systems,
        })

    def write_telemetry(hist) -> None:
        if args.trace_out:
            write_trace(args.trace_out, recorder)
            print(f"trace written to {args.trace_out} (open at ui.perfetto.dev)")
        if args.metrics_out:
            hist.telemetry(meta=dict(recorder.meta) if recorder else {
                "kind": "train", "arch": cfg.name, "algo": args.algo,
                "driver": args.driver,
            }).write_jsonl(args.metrics_out)
            print(f"metrics appended to {args.metrics_out}")

    if args.driver == "events":
        if args.ckpt_dir:
            ap.error("checkpointing is not supported with --driver events")
        with profile_capture(args.profile):
            hist = Experiment(spec, loss_fn=loss_fn, params0=params, sampler=sampler,
                              recorder=recorder, device=dev).run()
        srv = np.asarray(hist.is_global, dtype=bool)
        secs = np.asarray(hist.sim_time_s, dtype=np.float64)
        stale = np.asarray(hist.staleness, dtype=np.int64)
        for k in range(0, args.rounds, max(1, args.log_every)):
            print(f"round {k:4d} [{'J' if hist.is_global[k] else 'W'}] "
                  f"loss={hist.loss[k]:.4f} sim_t={secs[: k + 1].sum():.2f}s "
                  f"max_staleness={int(stale[k].max())}")
        print(
            f"done (events, async={spec.async_ or 'constant'}): "
            f"{args.rounds} rounds, simulated {secs.sum():.2f}s under "
            f"{args.systems!r} (gossip {secs[~srv].sum():.2f}s / "
            f"{int((~srv).sum())} rounds, server {secs[srv].sum():.2f}s / "
            f"{int(srv.sum())} rounds, peak staleness {int(stale.max())})"
        )
        write_telemetry(hist)
        return 0

    start_round = 0
    ckpt_tree = None
    if args.ckpt_dir:
        latest = latest_checkpoint(args.ckpt_dir)
        if latest:
            start_round, ckpt_tree = restore_checkpoint(latest)
            print(f"restored {latest} at round {start_round}")

    opt_kw = resolve_update_rules(
        args.local_opt, args.server_opt, args.lr_schedule, args.opt_policy,
        eta_l=args.eta_l, rounds=args.rounds, t_o=args.t_o,
    )
    if opt_kw:
        lo, so = opt_kw.get("local_opt"), opt_kw.get("server_opt")
        print(f"update rules: local={lo.name if lo else 'sgd (default)'} "
              f"server={so.name if so else 'none'} "
              f"policy={opt_kw.get('opt_policy', 'registry default')}")
    bound = get_algorithm(args.algo).bind(loss_fn, pcfg, mixing, **opt_kw)
    # flags, bytes and seconds go through the History + record_flags seam the
    # Experiment drivers use, so telemetry threads the same way
    hist = History(byte_model=make_byte_model(
        mixing, x0, args.n_agents, mixes_per_round=bound.comm.mixes_per_round,
        server_payloads=bound.comm.server_payloads))
    if args.systems:
        hist.time_model = make_time_model(spec, hist.byte_model,
                                          network=unwrap_network(bound.network))
    hist.recorder = recorder
    acct = hist.accountant

    _, comm0 = sampler(-1)
    state = bound.init(loss_fn, x0, comm0)
    if ckpt_tree is not None:
        # the checkpoint stores NamedTuples as plain tuples; its leaves go
        # back into the fresh state (which checks that the bound algorithm
        # and rules match the snapshot)
        state = restore_into(state, ckpt_tree, cfg)

    def save(step: int) -> None:
        save_checkpoint(args.ckpt_dir, step, nested_state(state, cfg))

    t0 = time.perf_counter()
    with contextlib.ExitStack() as prof:
        prof.enter_context(profile_capture(args.profile))
        if args.driver == "loop":
            for k in range(start_round, args.rounds):
                flags = predraw_schedule(bound.schedule, k, k + 1)
                record_flags(hist, flags, start=k)
                state, metrics, _ = run_block(bound, state, sampler, k, flags)
                if k % args.log_every == 0 or k == args.rounds - 1:
                    print(_log_line(k, bool(flags[0]), metrics))
                if args.ckpt_dir and args.ckpt_every and (k + 1) % args.ckpt_every == 0:
                    save(k + 1)
        else:
            # blocks end at log points and at checkpoint multiples; the host
            # syncs only there
            k = start_round
            while k < args.rounds:
                stop = min(k + args.block_size, args.rounds)
                nxt_log = k if k % args.log_every == 0 else (
                    (k // args.log_every + 1) * args.log_every)
                if nxt_log < args.rounds:
                    stop = min(stop, nxt_log + 1)
                if args.ckpt_dir and args.ckpt_every:
                    stop = min(stop, (k // args.ckpt_every + 1) * args.ckpt_every)
                flags = predraw_schedule(bound.schedule, k, stop)
                state, metrics, _ = run_block(bound, state, sampler, k, flags)
                record_flags(hist, flags, start=k)
                k_end = stop - 1
                if k_end % args.log_every == 0 or k_end == args.rounds - 1:
                    print(_log_line(k_end, bool(flags[-1]), metrics))
                if args.ckpt_dir and args.ckpt_every and stop % args.ckpt_every == 0:
                    save(stop)
                k = stop
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    hist.wall_time_s = dt
    hist.final_state = state
    print(f"done: {args.rounds} rounds in {dt:.1f}s "
          f"({acct.agent_to_agent} gossip, {acct.agent_to_server} server rounds)")
    if args.systems:
        secs = np.asarray(hist.sim_time_s, dtype=np.float64)
        srv = np.asarray(hist.is_global, dtype=bool)
        print(f"simulated time under {args.systems!r}: {secs.sum():.2f}s "
              f"(gossip {secs[~srv].sum():.2f}s / {int((~srv).sum())} rounds, "
              f"server {secs[srv].sum():.2f}s / {int(srv.sum())} rounds)")
    write_telemetry(hist)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
