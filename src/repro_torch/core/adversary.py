"""Byzantine fault injection and robust server aggregation (the port's twin
of ``repro.core.adversary``).

An :class:`AdversaryProcess` corrupts the chosen agents' outgoing payloads,
gossip messages and server uploads alike, while their local compute stays
honest: the corruption is on the wire.

* *Which* agents are Byzantine is drawn once from
  ``np.random.default_rng((_ADV_TAG, seed))``, as the reference draws it,
  so the masks are bit-equal.
* *What* they send in round k is pure in ``(seed, k)``:

  - ``signflip`` sends ``-scale * x``, bit-equal to the reference;
  - ``collusion`` sends the fleet mean plus ``scale`` along a unit
    direction per leaf, drawn once on the host from a ``torch.Generator``
    seeded from ``(_ADV_TAG, seed, i)`` (leaf i in sorted-key order) and
    copied to the device, so the card and the CPU send the same value.  The
    reference draws its direction from JAX PRNG, which torch cannot
    reproduce: the draw sits behind :meth:`AdversaryProcess.collusion_direction`
    alone, and with the reference's direction put there the corruption is
    the reference's up to the order of the mean's sum;
  - ``random`` sends ``scale``-sized Gaussian noise drawn on the leaf's
    device from a generator seeded from ``(_ADV_TAG, seed, k, i)``: the
    loop, block and events drivers see the same noise at any block cut.
    The card and the CPU draw different noise, and both differ from the
    reference's JAX draws.

The round index reaches the corruption through the drivers' staging: an
:class:`AdversarialNetwork` wraps the network context (or stands alone over
frozen operands) and records k when a round is staged.  Its message and
participant counts are the base network's, so bytes and simulated seconds
cannot tell an adversarial run from a clean one; pricing and the event
engine see the base network (:func:`unwrap_network`).

:func:`make_adversarial_mixing` wraps a dense, sparse, dynamic,
asynchronous or collective mixing.  A sign flip folds into the gossip operator itself:
sender j's weights are scaled by d_j (-scale on Byzantine agents, 1
elsewhere) in the dense W (row j: ``out_i = sum_j W[j, i] x_j``) or in the
CSR (``data_e d[indices_e]``, ``self_w_i d_i``), frozen or staged each
round, so plain gossip (``torch.matmul``, K4) and compressed gossip (K3, K5)
run unchanged over it, with no extra pass over the payload.  ``random`` and
``collusion`` cannot fold: gossip corrupts the payload, then mixes it, and
compressed gossip writes q out to corrupt it (``MixingOps.wire_corrupt``).
The server round corrupts the uploads, then aggregates them with the base
rule or a robust one (:func:`repro_torch.core.mixing.make_robust_agg`).

Over a collective mixer (a rank mesh, flat or pod-as-agent) each rank
corrupts its own agent's payload (:class:`RankCorruption`), then the base
gossip or server sum runs; on a one-axis ring the fused candidate combine
(K8) sends the corrupted candidate, a sign flip folded into its self
weight.  A robust rule gathers the payloads over the agent axes and every
rank takes the same result.  The round index comes from the round
(:func:`repro_torch.core.pisco.make_rank_round_fn`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mixing import MixingOps, _csr_gossip, make_robust_agg, parse_robust_spec
from repro_torch.utils.pytree import krum_distances, krum_scores_of, tree_agent_mix

Tree = Dict[str, torch.Tensor]

_ADV_TAG = 0xB12A  # domain separation for the Byzantine-set draw

ADVERSARY_KINDS = ("signflip", "random", "collusion")


def _seed_of(*words: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative ints."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & 0x7FFFFFFFFFFFFFFF


@dataclasses.dataclass(frozen=True)
class AdversaryProcess:
    """Which agents are Byzantine and what they put on the wire (``kind``
    ``signflip``, ``random`` or ``collusion``; see the module docstring)."""

    kind: str
    f: float = 0.2
    scale: float = 1.0
    target: str = "drift"
    n_agents: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ADVERSARY_KINDS:
            raise ValueError(
                f"unknown adversary kind {self.kind!r}; "
                f"options: {ADVERSARY_KINDS}"
            )
        if not 0.0 < self.f < 1.0:
            raise ValueError(f"adversary fraction must be in (0, 1), got {self.f}")
        if self.kind == "collusion" and self.target != "drift":
            raise ValueError(
                f"collusion target {self.target!r} not supported (only 'drift')"
            )
        if self.n_byz >= self.n_agents:
            raise ValueError(
                f"f={self.f} makes all {self.n_agents} agents Byzantine — "
                "at least one honest agent is required"
            )

    @property
    def n_byz(self) -> int:
        return int(np.ceil(self.f * self.n_agents))

    @property
    def needs_round(self) -> bool:
        """Whether the corruption depends on the round index."""
        return self.kind == "random"

    @property
    def folds(self) -> bool:
        """Whether the corruption is a factor on each sender's weights."""
        return self.kind == "signflip"

    def spec(self) -> str:
        s = f"{self.kind}:f={self.f:g}"
        if self.scale != 1.0:
            s += f",scale={self.scale:g}"
        if self.kind == "collusion":
            s += f",target={self.target}"
        return s

    def mask(self) -> np.ndarray:
        """(n_agents,) bool, True where Byzantine; pure in ``seed``."""
        rng = np.random.default_rng((_ADV_TAG, int(self.seed)))
        byz = rng.choice(self.n_agents, size=self.n_byz, replace=False)
        out = np.zeros(self.n_agents, dtype=bool)
        out[byz] = True
        return out

    def collusion_direction(self, i: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """The unit direction (float32, on the CPU) of leaf ``i`` whose
        per-agent shape is ``shape``: a normal draw from a CPU generator
        seeded from ``(_ADV_TAG, seed, i)``, divided by its norm."""
        gen = torch.Generator().manual_seed(_seed_of(_ADV_TAG, int(self.seed) & 0x7FFFFFFF, i))
        d = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return d / torch.clamp_min(torch.linalg.vector_norm(d.reshape(-1)), 1e-12)

    def make_corrupt(self) -> "Corruption":
        return Corruption(self)


class Corruption:
    """``corrupt(tree, k)``: an agent-stacked payload on the wire.  Honest
    rows pass bit for bit; Byzantine rows are replaced per the process's
    kind, computed in float32 and cast back to the leaf's dtype.  Per-device
    copies of the Byzantine rows' indices, the sign-flip weights and the
    collusion directions are made once."""

    def __init__(self, adv: AdversaryProcess):
        self.adv = adv
        self.mask = adv.mask()
        self._index: Dict[torch.device, torch.Tensor] = {}
        self._sender_w: Dict[torch.device, torch.Tensor] = {}
        self._direction: Dict[tuple, torch.Tensor] = {}

    def index(self, device: torch.device) -> torch.Tensor:
        if device not in self._index:
            self._index[device] = torch.as_tensor(np.flatnonzero(self.mask), device=device)
        return self._index[device]

    def sender_weights(self, device: torch.device) -> torch.Tensor:
        """(n,) float32: -scale on Byzantine agents, 1 elsewhere."""
        if device not in self._sender_w:
            d = np.where(self.mask, -float(self.adv.scale), 1.0).astype(np.float32)
            self._sender_w[device] = torch.as_tensor(d, device=device)
        return self._sender_w[device]

    def direction(self, i: int, shape, device: torch.device) -> torch.Tensor:
        key = (i, tuple(shape), device)
        if key not in self._direction:
            self._direction[key] = self.adv.collusion_direction(i, tuple(shape)).to(device)
        return self._direction[key]

    def leaf(self, x: torch.Tensor, i: int, k: Optional[int] = None) -> torch.Tensor:
        """Leaf ``i`` (sorted-key order) of a payload as sent in round k."""
        adv, idx = self.adv, self.index(x.device)
        out = x.to(torch.float32, copy=True)
        if adv.kind == "signflip":
            out[idx] = -float(adv.scale) * out[idx]
        elif adv.kind == "random":
            seed = _seed_of(_ADV_TAG, int(adv.seed) & 0x7FFFFFFF, int(k), i)
            gen = torch.Generator(device=x.device).manual_seed(seed)
            noise = torch.randn((len(idx),) + tuple(x.shape[1:]), generator=gen,
                                dtype=torch.float32, device=x.device)
            out[idx] = float(adv.scale) * noise
        else:
            d = self.direction(i, x.shape[1:], x.device)
            out[idx] = out.mean(dim=0, keepdim=True) + float(adv.scale) * d[None]
        return out.to(x.dtype)

    def __call__(self, tree: Tree, k: Optional[int] = None) -> Tree:
        return {key: self.leaf(tree[key], i, k) for i, key in enumerate(sorted(tree))}


def parse_adversary_spec(spec: str, n_agents: int = 1, seed: int = 0) -> AdversaryProcess:
    """``AdversaryProcess`` from ``"kind[:k=v,...]"``, e.g.
    ``"signflip:f=0.2"``, ``"random:f=0.1,scale=5"``,
    ``"collusion:f=0.25,target=drift"``.  Fails fast on unknown kinds and
    keys."""
    head, _, tail = str(spec).partition(":")
    kw: dict = {}
    if tail:
        for item in tail.split(","):
            key, eq, v = item.partition("=")
            key = key.strip()
            if not eq or key not in ("f", "scale", "target"):
                raise ValueError(
                    f"bad adversary argument {item!r} in {spec!r} "
                    "(keys: f, scale, target)"
                )
            kw[key] = v if key == "target" else float(v)
    return AdversaryProcess(kind=head.strip(), n_agents=n_agents, seed=seed, **kw)


def adversary_mask(spec: Optional[str], n_agents: int, seed: int = 0) -> Optional[List[bool]]:
    """The Byzantine mask of a spec string (None passes through), the form
    :class:`~repro_torch.core.trainer.History` records."""
    if spec is None:
        return None
    return [bool(b) for b in parse_adversary_spec(spec, n_agents, seed).mask()]


# ---------------------------------------------------------------------------
# The sign flip as a factor on the senders' weights
# ---------------------------------------------------------------------------


def fold_senders(op, d: torch.Tensor):
    """A gossip operand with sender j's weights scaled by ``d[j]``: the dense
    W (n, n), whose row j weighs sender j, or the CSR ``(indptr, indices,
    data, self_w)``."""
    if isinstance(op, torch.Tensor):
        return d[:, None] * op
    indptr, indices, data, self_w = op
    return indptr, indices, data * d[indices], self_w * d


class AdversarialNetwork:
    """The network handle of an adversarial mixing, on the drivers' contract
    of :class:`~repro_torch.core.mixing.NetworkContext`: it wraps the base
    network (None over frozen operands), passes its block draws and staging
    through, and records the round index ``k`` a round is staged at.  Over
    frozen operands a block reports the static message count and the whole
    fleet as participants, as the reference's ``draw_block`` does.  With
    ``sender_w`` the staged ``gossip_w`` has those weights folded in (the
    sign flip), recomputed once per staged operand."""

    adversarial = True

    def __init__(self, base, n_agents: int, static_messages: int,
                 sender_w: Optional[Callable[[torch.device], torch.Tensor]] = None):
        self.base = base
        self.n_agents = n_agents
        self._static_messages = int(static_messages)
        self._sender_w = sender_w
        self._folded: tuple = (None, None)
        self.k: Optional[int] = None

    @property
    def sparse(self) -> bool:
        return bool(getattr(self.base, "sparse", False))

    def device_block(self, start: int, stop: int):
        """``(operands, messages, participants)`` for rounds ``[start, stop)``."""
        if self.base is None:
            block = stop - start
            return ((None, start), np.full(block, self._static_messages, dtype=int),
                    np.full(block, self.n_agents, dtype=int))
        operands, messages, participants = self.base.device_block(start, stop)
        return (operands, start), messages, participants

    def stage(self, operands, i: int) -> None:
        base_ops, start = operands
        self.k = start + i
        if self.base is not None:
            self.base.stage(base_ops, i)

    @property
    def gossip_w(self):
        g = self.base.gossip_w
        if self._sender_w is None:
            return g
        if self._folded[0] is not g:
            dev = g.device if isinstance(g, torch.Tensor) else g[2].device
            self._folded = (g, fold_senders(g, self._sender_w(dev)))
        return self._folded[1]

    @property
    def server_w(self):
        return self.base.server_w


def unwrap_network(net):
    """The base network pricing and the event engine see: the adversarial
    wrapper changes numerics only, never costs."""
    return net.base if isinstance(net, AdversarialNetwork) else net


def _staged_gossip(net) -> Callable[[Tree], Tree]:
    """Gossip over the operand staged in ``net`` for the round."""
    if net.sparse:
        return _csr_gossip(lambda: net.gossip_w)
    return lambda tree: tree_agent_mix(tree, net.gossip_w)


# ---------------------------------------------------------------------------
# Over a rank mesh: each rank corrupts its own agent's payload
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AgentShards:
    """Where a rank's leaves sit in its agent's whole leaves, when they are
    shards (an agent over several ranks: pod-as-agent's data axis, the
    model axis): ``shapes[key]`` the agent's whole leaf shape, ``cut(key,
    whole)`` this rank's block of a whole leaf, ``replicas[key]`` how many
    of the agent's ranks hold the same block
    (:func:`repro_torch.launch.steps.agent_shards` derives it from
    pod-as-agent's placement).  What reads it (Krum's distances, the
    ``random`` and ``collusion`` draws) is refused without it when an agent
    spans more than one rank (:func:`make_adversarial_mixing`)."""

    shapes: Dict[str, Tuple[int, ...]]
    cut: Callable[[str, torch.Tensor], torch.Tensor]
    replicas: Dict[str, int]


class RankCorruption:
    """One rank's side of a :class:`Corruption` over a collective mixer:
    its agent's payload on the wire, leaf by leaf.  The rank's agent is its
    index over the agent axes; a Byzantine agent's leaf is replaced as the
    agent-stacked :meth:`Corruption.leaf` replaces its row: ``signflip``
    exactly, ``random`` with the same draw of the Byzantine rows' noise
    (pure in (seed, round, leaf)) and this agent's row of it, ``collusion``
    with the fleet mean from a float32 sum over the agent axes (every rank
    joins it) plus the scaled direction.  Noise and direction are drawn at
    the agent's whole leaf shape and cut to the rank's block under
    ``shards``.  ``round_index()`` gives the round's k."""

    def __init__(self, corrupt: Corruption, mesh, agent_axes: Tuple[str, ...],
                 round_index: Callable[[], Optional[int]],
                 shards: Optional[AgentShards] = None):
        self.corrupt, self.mesh, self.axes = corrupt, mesh, tuple(agent_axes)
        self.round_index, self.shards = round_index, shards
        self.n = mesh.size(self.axes)
        self.agent = mesh.index(self.axes)
        byz = np.flatnonzero(corrupt.mask)
        self.byzantine = bool(corrupt.mask[self.agent])
        self.row = int(np.searchsorted(byz, self.agent)) if self.byzantine else -1
        adv = corrupt.adv
        self.folds = adv.folds
        # this rank's factor on its own term when the corruption folds
        self.sender_weight = -float(adv.scale) if self.byzantine and self.folds else 1.0

    def _whole_shape(self, key: Optional[str], x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape) if self.shards is None else tuple(self.shards.shapes[key])

    def _cut(self, key: Optional[str], whole: torch.Tensor) -> torch.Tensor:
        return whole if self.shards is None else self.shards.cut(key, whole)

    def leaf(self, x: torch.Tensor, i: int, key: Optional[str] = None) -> torch.Tensor:
        """Leaf ``i`` (sorted-key order; ``key`` its name, needed under
        ``shards``) of this rank's payload as sent in the current round."""
        adv = self.corrupt.adv
        if key is None and self.shards is not None:
            key = sorted(self.shards.shapes)[i]
        if adv.kind == "collusion":  # a collective: every rank of the agent axes joins
            mean = self.mesh.all_reduce_sum(x.to(torch.float32), self.axes) / self.n
        if not self.byzantine:
            return x
        if adv.kind == "signflip":
            return (-float(adv.scale) * x.to(torch.float32)).to(x.dtype)
        shape = self._whole_shape(key, x)
        if adv.kind == "random":
            k = self.round_index()
            seed = _seed_of(_ADV_TAG, int(adv.seed) & 0x7FFFFFFF, int(k), i)
            gen = torch.Generator(device=x.device).manual_seed(seed)
            noise = torch.randn((len(self.corrupt.index(x.device)),) + shape, generator=gen,
                                dtype=torch.float32, device=x.device)
            return (float(adv.scale) * self._cut(key, noise[self.row])).to(x.dtype)
        d = self._cut(key, self.corrupt.direction(i, shape, x.device))
        return (mean + float(adv.scale) * d).to(x.dtype)

    def __call__(self, tree: Tree) -> Tree:
        return {key: self.leaf(tree[key], i, key) for i, key in enumerate(sorted(tree))}


def _rank_robust_agg(robust_agg: str, n_agents: int, mesh, agent_axes: Tuple[str, ...],
                     shards: Optional[AgentShards]) -> Callable[[Tree], Tree]:
    """A robust server rule over a rank mesh: each leaf gathered over the
    agent axes, the rule applied to the stack, and this rank's row (every
    row alike) kept.  Krum's distances sum each leaf's term once per agent:
    terms of blocks split over the agent's ranks are summed over them, and
    a block held by ``r`` of them counts 1/r each."""
    rule, f = parse_robust_spec(robust_agg)
    stacked_rule = make_robust_agg(robust_agg, n_agents)
    me = mesh.index(agent_axes)
    intra = tuple(a for a in mesh.axis_names if a not in agent_axes and mesh.shape[a] > 1)

    def agg(tree: Tree) -> Tree:
        stacked = {k: mesh.all_gather(v, agent_axes) for k, v in tree.items()}
        if rule != "krum":
            return {k: v[me] for k, v in stacked_rule(stacked).items()}
        d2 = krum_distances(stacked, None if shards is None else
                            {k: 1.0 / shards.replicas[k] for k in stacked})
        if intra:
            d2 = mesh.all_reduce_sum(d2, intra)
        sel = int(torch.argmin(krum_scores_of(d2, int(np.ceil(f * n_agents)))))
        return {k: v[sel].clone() for k, v in stacked.items()}

    return agg


def _rank_adversarial_mixing(base: MixingOps, adv: Optional[AdversaryProcess],
                             robust_agg: str, robust, n_agents: int,
                             shards: Optional[AgentShards]) -> MixingOps:
    """:func:`make_adversarial_mixing` over a collective mixer (one agent
    per rank, or one per group of ranks under pod-as-agent)."""
    mesh, axes = base.mesh, base.agent_axes
    if axes is None:
        raise ValueError(f"collective mixer {base.name!r} does not name its agent axes")
    if mesh.size(axes) != n_agents:
        raise ValueError(f"n_agents={n_agents} but the mesh has {mesh.size(axes)} agents")
    intra = [a for a in mesh.axis_names if a not in axes and mesh.shape[a] > 1]
    needs = []  # what reads the agent's whole leaves
    if adv is not None and adv.kind in ("random", "collusion"):
        needs.append(f"the {adv.kind} draw")
    if robust is not None and parse_robust_spec(robust_agg)[0] == "krum":
        needs.append("Krum")
    if intra and shards is None and needs:
        raise ValueError(f"{' and '.join(needs)} over agents that span the {intra} ranks need "
                         "shards= (where a rank's leaves sit in its agent's: "
                         "repro_torch.launch.steps.agent_shards)")
    agg = (_rank_robust_agg(robust_agg, n_agents, mesh, axes, shards) if robust is not None
           else base.global_avg)
    name, changes = base.name, {}
    if adv is None:
        new_gossip, new_global = base.gossip, agg
    else:
        static_messages = (base.gossip_messages if base.gossip_messages is not None
                           else 2 * base.gossip_edges)
        net = AdversarialNetwork(None, n_agents, static_messages)
        rc = RankCorruption(adv.make_corrupt(), mesh, axes, lambda: net.k, shards)
        base_gossip = base.gossip

        def new_gossip(tree: Tree) -> Tree:
            return base_gossip(rc(tree))

        def new_global(tree: Tree) -> Tree:
            return agg(rc(tree))

        changes.update(network=net, wire_corrupt=rc.leaf, plain_gossip=base.gossip,
                       rank_adversary=rc)
        name += f"/adv:{adv.spec()}"
    if robust is not None:
        name += f"/robust:{robust_agg}"
    return dataclasses.replace(base, gossip=new_gossip, global_avg=new_global, name=name,
                               **changes)


def make_adversarial_mixing(
    base: MixingOps,
    adversary: Optional[str] = None,
    robust_agg: str = "mean",
    *,
    n_agents: int,
    seed: int = 0,
    shards: Optional[AgentShards] = None,
) -> MixingOps:
    """Wrap a dense, sparse, dynamic, asynchronous or collective mixing with
    fault injection and/or a robust server rule (see the module docstring).

    ``adversary=None`` with ``robust_agg="mean"`` returns ``base`` itself.
    Accounting metadata (``gossip_edges``, ``gossip_messages``, realized
    counts) is kept: Byzantine agents send wrong bytes, not fewer.  Wrap
    before compression.  Over a collective mixer (flat or pod-as-agent)
    each rank corrupts its own agent's payload before its gossip and its
    server upload (:class:`RankCorruption`; the round gives the round index
    to ``network.k``) and a robust rule runs on the payloads gathered over
    the agent axes.  When an agent spans more than one rank (pod-as-agent,
    a model axis), ``shards`` says where a rank's leaves sit in its agent's;
    Krum and the ``random`` and ``collusion`` draws read it and are refused
    without it.  A sign flip and the elementwise rules (mean, trimmed,
    median) act on any block alike and need none."""
    adv = parse_adversary_spec(adversary, n_agents, seed) if adversary is not None else None
    robust = make_robust_agg(robust_agg, n_agents)
    if adv is None and robust is None:
        return base
    if base.mesh is not None:
        return _rank_adversarial_mixing(base, adv, robust_agg, robust, n_agents, shards)
    agg = robust if robust is not None else base.global_avg
    name = base.name
    changes: dict = {}
    if adv is None:
        new_gossip, new_global = base.gossip, agg
    else:
        corrupt = adv.make_corrupt()
        net = base.network
        frozen = base.w is not None or base.csr is not None
        fold = adv.folds and (frozen or net is not None)
        if adv.needs_round or (fold and net is not None):
            static_messages = (base.gossip_messages if base.gossip_messages is not None
                               else 2 * base.gossip_edges)
            net = AdversarialNetwork(net, n_agents, static_messages,
                                     sender_w=corrupt.sender_weights if fold else None)
        get_k = (lambda: net.k) if adv.needs_round else (lambda: None)  # noqa: E731
        if fold:
            if base.w is not None:
                w = fold_senders(base.w, corrupt.sender_weights(base.w.device))
                new_gossip = lambda tree: tree_agent_mix(tree, w)  # noqa: E731
                changes["w"] = w
            elif base.csr is not None:
                csr = fold_senders(base.csr, corrupt.sender_weights(base.csr[2].device))
                new_gossip = _csr_gossip(lambda: csr)
                changes["csr"] = csr
            else:
                new_gossip = _staged_gossip(net)
        else:
            base_gossip = base.gossip

            def new_gossip(tree: Tree) -> Tree:
                return base_gossip(corrupt(tree, get_k()))

            changes["wire_corrupt"] = lambda x, i: corrupt.leaf(x, i, get_k())

        def new_global(tree: Tree) -> Tree:
            return agg(corrupt(tree, get_k()))

        changes["network"] = net
        name += f"/adv:{adv.spec()}"
    if robust is not None:
        name += f"/robust:{robust_agg}"
    return dataclasses.replace(base, gossip=new_gossip, global_avg=new_global, name=name,
                               **changes)
