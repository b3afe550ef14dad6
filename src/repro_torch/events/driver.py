"""The ``events`` round driver: asynchronous execution of the round sequence
(the port's twin of ``repro.events.driver``).

:func:`drive_events` runs the block driver's body
(:func:`repro_torch.core.driver.run_block`) over the registry's round
functions **unchanged**; what changes is where the per-round operands come
from.  A synchronous driver draws the flags from the Bernoulli(p) schedule,
the mixing operands from the topology process and the seconds from the
barrier time model; the events driver takes all three from the
:class:`~repro_torch.events.clock.EventEngine`:

* gossip weights are built from the *active* edge set — realized edges minus
  those incident to agents beyond the staleness bound — and mixed by
  ``torch.matmul`` over the staged W_k (dense) or by the sparse-gossip
  kernel (K4) over the base CSR with the staged weights (sparse);
* server rounds average with the buffered aggregator's staleness weights
  through :func:`~repro_torch.utils.pytree.tree_agent_weighted_mean`;
* compressed gossip wraps on top as over any dynamic network, so the fused
  compressed mixes (K3 dense, K5 sparse) read the staged operands;
* per-round seconds come from the engine's availability clock.

When the engine reports ``trivial=True`` (degenerate fleet: nothing dropped,
uniform weights), :class:`~repro_torch.core.experiment.Experiment` binds the
ordinary spec mixing instead of :func:`make_async_mixing`, and this driver is
``drive_scan`` with an engine-priced clock: the same rounds, kernels and
sampler calls in the same order, which is the bit-exactness pin.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import BoundAlgorithm
from repro_torch.core.compression import compress_mixing, make_compressor
from repro_torch.core.driver import (
    DEFAULT_BLOCK_SIZE,
    block_bounds,
    maybe_eval,
    record_block,
    run_block,
)
from repro_torch.core.mixing import MixingOps, _csr_gossip, _csr_of, directed_csr_order
from repro_torch.core.topology import make_sparse_topology, make_topology
from repro_torch.events.clock import EventEngine
from repro_torch.utils.pytree import tree_agent_mix, tree_agent_weighted_mean


@dataclasses.dataclass(eq=False)
class EventNetwork:
    """The network handle of the async mixers, on the drivers' contract of
    :class:`~repro_torch.core.mixing.NetworkContext`: :meth:`device_block`
    takes the engine's host draw for a block (:meth:`EventEngine.draw_block`)
    and copies it to the device once — in sparse mode the directed edge
    weights permuted into the base CSR's order (``csr_order``) — and
    :meth:`stage` sets round i's slices as ``gossip_w`` (W_k, or the CSR
    ``(indptr, indices, data_k, self_w_k)``) and ``server_w`` (the
    ``{'w', 'keep'}`` staleness weights).  ``draw_s`` sums the host seconds
    of both.  ``engine`` is set by :func:`drive_events`."""

    device: torch.device
    sparse: bool = False
    csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    csr_order: Optional[np.ndarray] = None
    engine: Optional[EventEngine] = None
    draw_s: float = 0.0
    gossip_w: Any = None
    server_w: Any = None

    def device_block(self, start: int, stop: int):
        """``(operands, messages, participants)`` for rounds ``[start,
        stop)``: the engine's draws on the device, one copy per array."""
        t0 = time.perf_counter()
        w_gossip, w_server, messages, participants = self.engine.draw_block(start, stop)
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,  # noqa: E731
                                        device=self.device)
        if self.sparse:
            gossip = (put(w_gossip["edge_w"][:, self.csr_order]), put(w_gossip["self_w"]))
        else:
            gossip = put(w_gossip)
        server = (put(w_server["w"]), put(w_server["keep"]))
        self.draw_s += time.perf_counter() - t0
        return (gossip, server), messages, participants

    def stage(self, operands, i: int) -> None:
        """Stage round ``i`` of a block's device operands for the mixers."""
        gossip, (w, keep) = operands
        if self.sparse:
            self.gossip_w = (*self.csr, gossip[0][i], gossip[1][i])
        else:
            self.gossip_w = gossip[i]
        self.server_w = {"w": w[i], "keep": keep[i]}


def make_async_mixing(spec: Any, device: torch.device) -> MixingOps:
    """Mixing ops whose per-round operands are event-engine decisions.

    Gossip reads the W_k (dense, ``torch.matmul``) or the CSR weights
    (sparse, K4 over the base CSR) staged for the round; the server round
    averages participants with the staged staleness weights while absentees
    hold.  Compression wraps on top as over any dynamic network."""
    n = spec.config.n_agents
    kw = dict(spec.topology_kwargs)
    device = torch.device(device)
    if spec.use_sparse:
        stopo = make_sparse_topology(spec.topology, n, **kw)
        indptr, indices, _, _ = _csr_of(stopo, device)
        net = EventNetwork(device=device, sparse=True, csr=(indptr, indices),
                           csr_order=directed_csr_order(stopo.edges))
        gossip = _csr_gossip(lambda: net.gossip_w)
        gossip_edges, base_name = stopo.n_edges, stopo.name
    else:
        topo = make_topology(spec.topology, n, **kw)
        net = EventNetwork(device=device)

        def gossip(tree):
            return tree_agent_mix(tree, net.gossip_w)

        gossip_edges, base_name = int(topo.adj.sum()) // 2, topo.name

    def global_avg(tree):
        return tree_agent_weighted_mean(tree, net.server_w["w"], net.server_w["keep"])

    mixing = MixingOps(
        gossip=gossip,
        global_avg=global_avg,
        name=f"events/{base_name}",
        gossip_edges=gossip_edges,
        network=net,
    )
    if getattr(spec, "adversary", None) is not None:
        raise NotImplementedError(
            "an adversary over the async mixers is not ported yet (ROADMAP A12)")
    if spec.compression is not None:
        mixing = compress_mixing(
            mixing,
            make_compressor(spec.compression),
            error_feedback=spec.error_feedback,
            seed=spec.config.seed,
        )
    return mixing


def drive_events(
    bound: BoundAlgorithm,
    state,
    sampler: Callable[[int], tuple],
    rounds: int,
    hist,
    *,
    engine: EventEngine,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 1,
    stop_when: Optional[Callable] = None,
    block_size: int = DEFAULT_BLOCK_SIZE,
):
    """Event-queue driver: the block driver's body, engine-supplied flags,
    operands and seconds.

    The schedule was consumed once when the engine was built —
    ``engine.flags`` is the flag sequence (the same draws, in round order,
    the sync drivers would see), so ``bound.schedule`` is never called here.
    An :class:`EventNetwork` draws its operands from ``engine``; an ordinary
    network context (the trivial case) from its own processes.  Per-round
    seconds come from the engine's availability clock, and the per-agent
    staleness series is appended to ``hist.staleness`` as rounds execute."""
    net = bound.network
    if isinstance(net, EventNetwork):
        net.engine = engine
    cuts = block_bounds(
        rounds,
        eval_every=eval_every if eval_fn is not None else 0,
        block_size=block_size,
    )
    for start, stop in cuts:
        flags = engine.flags[start:stop]
        state, metrics, realized = run_block(bound, state, sampler, start, flags)
        record_block(hist, metrics, flags, realized, start=start,
                     seconds=engine.seconds[start:stop])
        hist.staleness.extend(engine.staleness[start:stop].tolist())
        maybe_eval(hist, eval_fn, eval_every, rounds, state, stop - 1)
        if stop_when is not None and stop_when(hist):
            break
    return state
