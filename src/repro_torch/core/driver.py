"""Round drivers: how communication rounds get executed on the device.

Two drivers, one contract — fill a :class:`~repro_torch.core.trainer.History`
and return the final algorithm state:

* **loop** — one round-function call per round and one device→host sync per
  round for its metrics (the reference semantics).
* **scan** — the block driver: the Bernoulli(p) flags of a *block* of rounds
  are pre-drawn on the host (the same draws, in round order, as the loop),
  each round's batches are gathered on the device inside the block, the
  rounds' metrics stay on the device, and the host syncs once per block.
  Blocks are cut at eval boundaries, so eval-at-x̄ matches the loop round
  for round.  (PyTorch runs eagerly; the block replaces ``lax.scan``'s one
  device program by one host sync.)

On a dynamic network (``bound.network``) the scan driver also draws the
block's gossip and server operands on the host once per block
(:meth:`~repro_torch.core.mixing.NetworkContext.device_block`, one copy to
the device per array) and stages round k's slices in the network context
before the round runs; the loop driver does the same per round.  Bytes are
then priced by the realized messages and participants.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import BoundAlgorithm
from repro_torch.core.pisco import RoundMetrics

Sampler = Callable[[int], tuple]
EvalFn = Callable[[Dict[str, torch.Tensor]], Dict[str, float]]

DEFAULT_BLOCK_SIZE = 32

DRIVERS = ("loop", "scan", "events")


def predraw_schedule(schedule, start: int, stop: int) -> np.ndarray:
    """Materialize ``schedule(k)`` for ``k in [start, stop)`` as a bool array.
    Draws happen in round order, so a stateful Bernoulli schedule yields the
    exact flag sequence the loop would have seen."""
    return np.array([bool(schedule(k)) for k in range(start, stop)], dtype=bool)


def block_bounds(
    rounds: int, *, eval_every: int = 0, block_size: int = DEFAULT_BLOCK_SIZE,
    start: int = 0,
) -> List[Tuple[int, int]]:
    """Split ``[start, rounds)`` into blocks that end right after every eval
    round (``eval_every <= 0`` disables eval cuts) and never exceed
    ``block_size`` rounds."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    bounds = []
    k = start
    while k < rounds:
        stop = min(k + block_size, rounds)
        if eval_every > 0:
            nxt = k if k % eval_every == 0 else (k // eval_every + 1) * eval_every
            nxt = min(nxt, rounds - 1)
            stop = min(stop, nxt + 1)
        bounds.append((k, stop))
        k = stop
    return bounds


def record_flags(hist, flags: np.ndarray, realized=None) -> None:
    """Record schedule flags and per-round bytes in the accountant.
    ``realized`` is an optional ``(messages, participants)`` pair of
    per-round counts of a dynamic network: bytes are then priced per
    realized edge and participant instead of the static round constants."""
    for i, f in enumerate(flags):
        f = bool(f)
        hist.is_global.append(f)
        if realized is None:
            nbytes = hist.byte_model.round_bytes(f)
        else:
            messages, participants = realized
            nbytes = hist.byte_model.realized_round_bytes(
                f, int(messages[i]), int(participants[i]))
        hist.accountant.record(f, nbytes)


def record_block(hist, metrics: RoundMetrics, flags: np.ndarray, realized=None) -> None:
    """One history append for a block of executed rounds: ``metrics`` leaves
    carry a leading round axis; this is the block's one device→host sync."""
    host = torch.stack(
        [metrics.loss, metrics.grad_sq_norm, metrics.consensus_err]
    ).to(torch.float64).cpu().numpy()
    hist.loss.extend(host[0].tolist())
    hist.grad_sq_norm.extend(host[1].tolist())
    hist.consensus_err.extend(host[2].tolist())
    record_flags(hist, flags, realized)


def eval_boundary(k: int, rounds: int, eval_every: int) -> bool:
    """Round ``k`` is an eval round every ``eval_every`` rounds and always at
    the final round."""
    return k % eval_every == 0 or k == rounds - 1


def maybe_eval(hist, eval_fn: Optional[EvalFn], eval_every: int, rounds: int,
               state, k: int) -> None:
    """Append the eval-at-x̄ readout when round ``k`` is an eval boundary."""
    if eval_fn is None or not eval_boundary(k, rounds, eval_every):
        return
    x_bar = {name: v.mean(dim=0) for name, v in sorted(state.x.items())}
    hist.eval_metrics.append(dict(eval_fn(x_bar), round=k))


def _stack_metrics(per_round: List[RoundMetrics]) -> RoundMetrics:
    return RoundMetrics(*(torch.stack(v) for v in zip(*per_round)))


def drive_scan(
    bound: BoundAlgorithm,
    state,
    sampler: Sampler,
    rounds: int,
    hist,
    *,
    eval_fn: Optional[EvalFn] = None,
    eval_every: int = 1,
    stop_when: Optional[Callable] = None,
    block_size: int = DEFAULT_BLOCK_SIZE,
):
    """Block driver.  ``stop_when`` is consulted at block boundaries (the only
    host-visible points), so a stop may overshoot the loop by one block."""
    cuts = block_bounds(
        rounds,
        eval_every=eval_every if eval_fn is not None else 0,
        block_size=block_size,
    )
    net = bound.network
    for start, stop in cuts:
        flags = predraw_schedule(bound.schedule, start, stop)
        realized = None
        if net is not None:
            operands, messages, participants = net.device_block(start, stop)
            realized = (messages, participants)
        per_round = []
        for i, (k, is_global) in enumerate(zip(range(start, stop), flags)):
            local, comm = sampler(k)  # one round's batches at a time
            if net is not None:
                net.stage(operands, i)
            fn = bound.global_round if is_global else bound.gossip_round
            state, metrics = fn(state, local, comm)
            per_round.append(metrics)
        record_block(hist, _stack_metrics(per_round), flags, realized)
        maybe_eval(hist, eval_fn, eval_every, rounds, state, stop - 1)
        if stop_when is not None and stop_when(hist):
            break
    return state


def drive_loop(
    bound: BoundAlgorithm,
    state,
    sampler: Sampler,
    rounds: int,
    hist,
    *,
    eval_fn: Optional[EvalFn] = None,
    eval_every: int = 1,
    stop_when: Optional[Callable] = None,
):
    """The per-round host loop (reference semantics)."""
    net = bound.network
    for k in range(rounds):
        local, comm = sampler(k)
        is_global = bool(bound.schedule(k))
        realized = None
        if net is not None:
            operands, messages, participants = net.device_block(k, k + 1)
            net.stage(operands, 0)
            realized = (messages, participants)
        fn = bound.global_round if is_global else bound.gossip_round
        state, metrics = fn(state, local, comm)
        record_block(hist, _stack_metrics([metrics]), np.array([is_global]), realized)
        maybe_eval(hist, eval_fn, eval_every, rounds, state, k)
        if stop_when is not None and stop_when(hist):
            break
    return state
