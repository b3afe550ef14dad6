"""Compressed gossip: per-agent-row quantization or sparsification for the
communication path.

* :class:`Compressor` — per-agent-message lossy codecs (symmetric int8/int4
  quantization, top-k sparsification, identity) that also *price*
  themselves (:meth:`Compressor.wire_bits`) for the byte-level accounting.
* :class:`CompressedGossip` — gossip over the dense W, the sparse CSR W or a
  collective mixer in the **mean-preserving difference form**

      out_i = x_i + gamma (sum_j W_ji q(m_j) - q(m_i)),     m_i = x_i (+ e_i)

  with error feedback ``e' = m - q(m)``.  Each leaf runs the row abs-max of
  ``m`` (K2, :func:`repro_torch.kernels.quantize.row_absmax`) and then,
  over the dense W or the CSR, the fused quantize/mix/combine
  (:func:`repro_torch.kernels.quantize.compressed_mix`,
  :func:`repro_torch.kernels.sparse_mix.sparse_compressed_mix_csr`), which
  never writes q.  Over a collective mixer each rank must hold its message
  before sending it: :meth:`StochasticQuantizer.quantize` writes q (K9,
  :func:`repro_torch.kernels.quantize.rowwise_quant_dequant`), the base
  mixer exchanges it, and the difference form is combined in plain tensor
  code (as the reference does, the dequantised q crosses the wire).  Scales
  are per agent row **per leaf** (one row per rank on a collective mixer).
  Stochastic rounding draws uniform noise on the state's device from a
  ``torch.Generator`` seeded from the spec (and the rank, over a collective
  mixer) and carried in the state (it cannot reproduce JAX's PRNG bits; the
  rounding rule is the same).  Top-k gossip keeps the reference's form:
  ``q = topk(m)`` per agent row, then ``x + gamma (W q - q)`` through the
  base mixer's own gossip (``torch.matmul`` over the dense W, the sparse
  gossip kernel K4 over the CSR, the exchange over a collective mixer).
* :func:`compress_mixing` / :func:`make_byte_model` — attach a compressor to
  dense, sparse or collective mixing ops, and build the closed-form
  :class:`RoundByteModel`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.mixing import MixingOps
from repro_torch.core.schedule import RoundByteModel
from repro_torch.kernels.quantize import (
    compressed_mix,
    qmax_of,
    row_absmax,
    rowwise_quant_dequant,
)
from repro_torch.kernels.sparse_mix import sparse_compressed_mix_csr, sparse_mix_csr
from repro_torch.utils.pytree import tree_agent_mix, tree_leaves, tree_zeros_like

Tree = Dict[str, torch.Tensor]

SCALE_BITS = 32  # one fp32 scale per (leaf, agent) message row
INDEX_BITS = 32  # one int32 coordinate per surviving top-k entry


class Compressor:
    """Lossy codec for one agent-stacked leaf (axis 0 = agents)."""

    name: str = "abstract"

    def compress(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def wire_bits(self, n_elements: int, itemsize_bits: int = 32) -> int:
        """Exact wire bits for one agent's message of ``n_elements`` scalars
        from a single leaf (including the scale side channel)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    """Full precision — the pricing baseline (and the 'disabled' codec)."""

    name: str = "fp32"

    def compress(self, x, noise=None):
        return x

    def wire_bits(self, n_elements: int, itemsize_bits: int = 32) -> int:
        return n_elements * itemsize_bits


@dataclasses.dataclass(frozen=True)
class StochasticQuantizer(Compressor):
    """QSGD-style symmetric quantizer, per-agent-row max-abs scaling.

    ``bits`` ∈ {4, 8}: signed grid {-qmax..qmax}, qmax = 2^(bits-1) - 1.
    Deterministic mode rounds half to even; stochastic mode rounds
    ``floor(u + noise)`` with uniform noise, unbiased: E[q(x)] = x."""

    bits: int = 8
    stochastic: bool = True

    def __post_init__(self):
        qmax_of(self.bits)

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"q{self.bits}" + ("s" if self.stochastic else "")

    def quantize(
        self, rows: torch.Tensor, residual: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(q, new_residual)`` of the (n, d) message rows ``m = rows (+
        residual)``: the row abs-max (K2) and the round trip with the
        error-feedback update (K9), in the rows' dtype.  ``noise`` is used
        only in stochastic mode."""
        absmax = row_absmax(rows, residual)
        return rowwise_quant_dequant(rows, absmax, bits=self.bits, residual=residual,
                                     noise=noise if self.stochastic else None)

    def compress(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """Dequantized wire values of one agent-stacked leaf (K2 and K9 on
        a card).  Gossip over the dense or sparse W runs the fused kernels
        instead, which never write q; gossip over a collective mixer sends
        what :meth:`quantize` writes."""
        return self.quantize(x.reshape(x.shape[0], -1), None, noise)[0].reshape(x.shape)

    def wire_bits(self, n_elements: int, itemsize_bits: int = 32) -> int:
        return n_elements * self.bits + SCALE_BITS


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Keep the ``fraction`` largest-magnitude coordinates per agent row
    (contractive: ||x - q(x)||² <= (1 - k/d) ||x||²).  Wire format: (value,
    index) pairs.  Ties at the k-th magnitude keep the lower index, as
    ``jax.lax.top_k`` does, so the kept set is the reference's on every
    input and does not depend on the order ``torch.topk`` returns."""

    fraction: float = 0.1

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"top-k fraction must be in (0, 1], got {self.fraction}")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"top{self.fraction:g}"

    def k_for(self, n_elements: int) -> int:
        return max(1, int(math.ceil(self.fraction * n_elements)))

    def compress(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        rows = x.reshape(x.shape[0], -1)
        mag = rows.abs()
        k = self.k_for(rows.shape[1])
        kth = torch.topk(mag, k, dim=1).values[:, -1:]
        above = mag > kth
        # of the entries tied at the k-th magnitude, the lowest-indexed fill
        # the places left
        tied = mag == kth
        left = k - above.sum(dim=1, keepdim=True)
        mask = above | (tied & (torch.cumsum(tied, dim=1) <= left))
        return torch.where(mask, rows, torch.zeros_like(rows)).reshape(x.shape)

    def wire_bits(self, n_elements: int, itemsize_bits: int = 32) -> int:
        return self.k_for(n_elements) * (itemsize_bits + INDEX_BITS)


_REGISTRY: dict = {
    "none": lambda: IdentityCompressor(),
    "fp32": lambda: IdentityCompressor(),
    "q8": lambda: StochasticQuantizer(bits=8),
    "q4": lambda: StochasticQuantizer(bits=4),
    "q8d": lambda: StochasticQuantizer(bits=8, stochastic=False),
    "q4d": lambda: StochasticQuantizer(bits=4, stochastic=False),
}


def make_compressor(spec: str) -> Compressor:
    """Parse 'none' | 'fp32' | 'q8' | 'q4' | 'q8d' | 'q4d' | 'topK' (K a
    fraction)."""
    if spec in _REGISTRY:
        return _REGISTRY[spec]()
    if spec.startswith("top"):
        try:
            fraction = float(spec[3:])
        except ValueError:
            raise ValueError(
                f"unknown compressor spec {spec!r} (top-k needs a fraction, "
                f"e.g. 'top0.1')"
            ) from None
        return TopKCompressor(fraction=fraction)
    raise ValueError(
        f"unknown compressor spec {spec!r}; options: "
        f"{sorted(_REGISTRY)} or 'top<fraction>'"
    )


@dataclasses.dataclass(frozen=True)
class CompressedGossip:
    """Difference-form compressed gossip over the dense ``w``, the sparse
    ``csr`` = (indptr, indices, data, self_w), or the gossip of a collective
    mixer ``base_gossip`` (trees of one rank's own leaves) — exactly one.

    :meth:`__call__` threads an error-feedback residual and a generator
    through the round function; :meth:`stateless` is the generator-free,
    residual-free variant installed as ``MixingOps.gossip``.  Both preserve
    the agent mean exactly, for any ``gamma`` (W is doubly stochastic).

    A quantiser runs the fused kernels over ``w`` and ``csr``; any other
    compressor (top-k) writes ``q`` and mixes it with the same operator's
    plain gossip: ``torch.matmul`` over ``w``, K4 over ``csr``."""

    compressor: Compressor
    w: Optional[torch.Tensor] = None
    csr: Optional[Tuple[torch.Tensor, ...]] = None
    base_gossip: Optional[Callable[[Tree], Tree]] = None
    error_feedback: bool = True
    seed: int = 0
    gamma: float = 1.0
    # collective mixers: this rank's noise stream (its global rank), so that
    # ranks round independently as the reference's agent rows do
    stream: int = 0

    def __post_init__(self):
        if sum(b is not None for b in (self.w, self.csr, self.base_gossip)) != 1:
            raise ValueError("CompressedGossip needs exactly one of w (dense), csr (sparse) "
                             "or base_gossip (collective)")

    def init_ef(self, template: Tree) -> dict:
        """Per-stream residuals (X and Y are mixed separately each round) and
        the noise generator on the state's device, seeded from the spec (and
        over a collective mixer from the rank too, so that ranks round
        independently)."""
        device = tree_leaves(template)[0].device
        seed = self.seed * 65536 + self.stream if self.base_gossip is not None else self.seed
        gen = torch.Generator(device=device).manual_seed(seed)
        return {
            "x": tree_zeros_like(template) if self.error_feedback else (),
            "y": tree_zeros_like(template) if self.error_feedback else (),
            "gen": gen,
        }

    def _gossip_leaf(self, q: torch.Tensor) -> torch.Tensor:
        """``W q`` for one leaf through the operator's plain gossip."""
        if self.w is not None:
            return tree_agent_mix({"leaf": q}, self.w)["leaf"]
        if self.csr is not None:
            return sparse_mix_csr(q.reshape(q.shape[0], -1), *self.csr).reshape(q.shape)
        return self.base_gossip({"leaf": q})["leaf"]

    def _mix_leaf(self, x, residual, gen) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        # a collective mixer's leaf is one rank's own message: one row
        rows = x.reshape(1 if self.base_gossip is not None else x.shape[0], -1)
        res = None if residual is None else residual.reshape(rows.shape)
        if isinstance(self.compressor, StochasticQuantizer):
            noise = None
            if self.compressor.stochastic and gen is not None:
                noise = torch.rand(rows.shape, generator=gen, dtype=torch.float32,
                                   device=rows.device)
            if self.base_gossip is None:
                kw = dict(bits=self.compressor.bits, gamma=self.gamma, noise=noise)
                absmax = row_absmax(rows, res)
                if self.w is not None:
                    out, new_res = compressed_mix(rows, res, self.w, absmax, **kw)
                else:
                    out, new_res = sparse_compressed_mix_csr(rows, res, *self.csr, absmax, **kw)
                return out.reshape(x.shape), (None if new_res is None
                                              else new_res.reshape(x.shape))
            q, new_res = self.compressor.quantize(rows, res, noise)
        else:
            m = rows if res is None else rows + res
            q = self.compressor.compress(m)
            new_res = None if res is None else m - q
        # q crosses the wire: the difference form through the plain gossip
        q = q.reshape(x.shape)
        diff = self._gossip_leaf(q) - q
        out = x + diff if self.gamma == 1.0 else x + self.gamma * diff
        return out, (None if new_res is None else new_res.reshape(x.shape))

    def __call__(self, tree: Tree, residual: Any, gen) -> Tuple[Tree, Any]:
        mixed, new_res = {}, {}
        for k in sorted(tree):
            r = residual[k] if self.error_feedback else None
            mixed[k], new_res[k] = self._mix_leaf(tree[k], r, gen)
        return mixed, (new_res if self.error_feedback else residual)

    def stateless(self, tree: Tree) -> Tree:
        """Deterministic rounding, no error feedback — the baseline form."""
        return {k: self._mix_leaf(tree[k], None, None)[0] for k in sorted(tree)}


def compress_mixing(
    base: MixingOps,
    compressor: Compressor,
    *,
    error_feedback: bool = True,
    seed: int = 0,
    gamma: Optional[float] = None,
) -> MixingOps:
    """Attach a compressor to dense, sparse or collective mixing ops.
    ``global_avg`` (the server round) stays full precision.  ``gamma=None``
    chooses the consensus step as the reference does: 0.5 for top-k (a
    contractive sparsifier diverges undamped under large local steps), 1.0
    for the quantisers."""
    if isinstance(compressor, IdentityCompressor):
        return base
    if gamma is None:
        gamma = 0.5 if isinstance(compressor, TopKCompressor) else 1.0
    if base.w is None and base.csr is None and base.mesh is None:
        raise NotImplementedError(
            f"compressed gossip over {base.name!r} is not ported: only over the "
            "static dense and sparse mixers and the collective mixers"
        )
    cg = CompressedGossip(
        compressor=compressor, w=base.w, csr=base.csr,
        base_gossip=base.gossip if base.w is None and base.csr is None else None,
        error_feedback=error_feedback, seed=seed, gamma=gamma,
        stream=base.mesh.rank if base.mesh is not None else 0,
    )
    return dataclasses.replace(
        base,
        gossip=cg.stateless,
        name=f"{base.name}/{compressor.name}" + ("+ef" if error_feedback else ""),
        compression=cg,
    )


# ---------------------------------------------------------------------------
# Byte-level communication pricing
# ---------------------------------------------------------------------------


def _per_agent_leaf_sizes(template: Tree, n_agents: int):
    for leaf in tree_leaves(template):
        if leaf.shape[0] != n_agents:
            raise ValueError(
                f"leaf {tuple(leaf.shape)} is not agent-stacked over {n_agents} agents"
            )
        yield leaf.numel() // n_agents, leaf.element_size() * 8


def message_bytes(
    compressor: Optional[Compressor], template: Tree, n_agents: int
) -> int:
    """Bytes ONE agent ships per message for the agent-stacked ``template``."""
    comp = compressor or IdentityCompressor()
    bits = sum(
        comp.wire_bits(n, itemsize)
        for n, itemsize in _per_agent_leaf_sizes(template, n_agents)
    )
    return -(-bits // 8)


def _directed_gossip_messages(mixing: MixingOps) -> int:
    if mixing.gossip_messages is not None:
        return mixing.gossip_messages
    return 2 * mixing.gossip_edges


def make_byte_model(
    mixing: MixingOps,
    template: Tree,
    n_agents: int,
    *,
    mixes_per_round: int = 2,
    server_payloads: Optional[int] = None,
) -> RoundByteModel:
    """Closed-form network-wide bytes per round: gossip rounds move
    ``mixes_per_round`` compressed messages per directed edge; server rounds
    move ``server_payloads`` full-precision uploads + downloads per agent."""
    comp = mixing.compression.compressor if mixing.compression is not None else None
    if server_payloads is None:
        server_payloads = mixes_per_round
    gossip_msg = message_bytes(comp, template, n_agents)
    server_msg = message_bytes(None, template, n_agents)
    return RoundByteModel(
        gossip_round_bytes=mixes_per_round
        * _directed_gossip_messages(mixing)
        * gossip_msg,
        server_round_bytes=server_payloads * 2 * n_agents * server_msg,
        gossip_message_bytes=gossip_msg,
        server_message_bytes=server_msg,
        mixes_per_round=mixes_per_round,
        server_payloads=server_payloads,
    )
