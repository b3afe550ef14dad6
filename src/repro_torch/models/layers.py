"""Shared primitive layers of the LM zoo: RMSNorm, linear maps over a batch
of per-slot weights, and initialisers drawing from a ``torch.Generator``.

Parameters are nested dicts of tensors in the reference's layouts.  Their
placements (the ``spec_*`` functions of the model modules, the twins of the
reference's ``PartitionSpec`` trees) are tuples with one entry per dim: a
mesh axis name, a tuple of names, or None (replicated along that dim).  A
*slotted* call gives every parameter a leading axis that matches the
activations' batch axis, one parameter set per row: what ``jax.vmap`` of the
reference's decode over the slot axis lowered to.

Tensor parallelism.  The model functions take ``tp``, a
:class:`repro_torch.launch.mesh.ModelAxis` handle or None (the whole model).
Under a handle a layer reads its local head count or width from its
weights' shapes; a replicated input is passed through ``tp.enter`` where a
region computed on this rank's share begins (identity forward, sum over the
model ranks backward), as is every leaf held whole that the region reads
(its gradient is partial on each rank), and the region's partial output
leaves through ``tp.exit`` (sum forward, identity backward).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

Tensor = torch.Tensor

REMAT_POLICIES = ("full", "dots")
# the reference's ``dots_with_no_batch_dims_saveable``: the outputs of dot
# products without batch dimensions are kept; batched ones (attention's
# scores and values, the MoE's expert products) are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


# float32 elements drawn at once: a larger leaf is drawn in slices along its
# first axis, so the float32 draw never holds more than 8 GiB beside the model
# (a whole Granite-20B stacked FFN leaf is 3.9e9 elements: 29 GiB in float32
# on top of its 52.5 GiB of bf16 weights)
DRAW_CHUNK = 1 << 31


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: the initialisers place
    their tensors on ``gen.device``, so drawing from it gives shapes and
    dtypes only (the counterpart of ``jax.eval_shape`` of an init)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def can_remat(x: Tensor) -> bool:
    """Whether ``torch.utils.checkpoint`` may recompute a block of ``x``'s
    graph: not under a ``torch.func`` transform (the agents' vmapped
    gradients), where it has no vmap rule.  The values are the same either
    way; only the activations kept for the backward pass differ."""
    return not torch._C._functorch.is_functorch_wrapped_tensor(x)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_call(policy: str, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant), the
    reference's ``jax.checkpoint`` with its policy: ``"full"`` recomputes
    the whole call in the backward pass, ``"dots"`` keeps the outputs of
    ``mm`` / ``addmm`` and recomputes everything else.  Either way the
    gradients are those of ``fn`` itself."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


class _HookedGenerator(torch.Generator):
    """A generator whose draws :func:`normal_init` passes through
    ``leaf_hook`` (see :func:`seeded_generator`)."""


def seeded_generator(device: torch.device, seed: int, leaf_hook=None) -> torch.Generator:
    """The initialisers' generator on ``device``, seeded with ``seed``; on
    the meta device (which has no generator) one that allocates nothing.
    With ``leaf_hook``, every leaf :func:`normal_init` draws from it is
    replaced by ``leaf_hook(leaf)`` as soon as it is drawn (an initialiser
    can keep a rank's shard of each leaf and drop the whole one; the draws,
    and so the values, are those without the hook)."""
    if device.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = (torch.Generator if leaf_hook is None else _HookedGenerator)(device=device)
    gen.manual_seed(seed)
    if leaf_hook is not None:
        gen.leaf_hook = leaf_hook
    return gen


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float, dtype,
                device=None) -> Tensor:
    """``scale * N(0, 1)`` drawn in float32 from ``gen``, cast to ``dtype``."""
    shape, dev = tuple(shape), device or gen.device
    lead = shape[0] if shape else 1
    rows = max(1, DRAW_CHUNK // max(1, math.prod(shape[1:])))
    if rows >= lead:  # one slice covers the leaf
        draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        out = draw.mul_(scale).to(dtype)
    else:
        out = torch.empty(shape, dtype=dtype, device=dev)
        for r0 in range(0, lead, rows):
            blk = out[r0:r0 + rows]
            blk.copy_(torch.randn(blk.shape, generator=gen, dtype=torch.float32,
                                  device=dev).mul_(scale))
    hook = getattr(gen, "leaf_hook", None)
    return out if hook is None else hook(out)


def spec_rms_norm() -> dict:
    """The placement of an RMSNorm's parameters (replicated)."""
    return {"scale": (None,)}


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm in float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def linear(x: Tensor, w: Tensor, slotted: bool = False) -> Tensor:
    """``x`` (B, S, d_in) times ``w`` (d_in, *out) -> (B, S, *out).  With
    ``slotted`` the weight is (B, d_in, *out) and row b uses ``w[b]``: one
    batched product over the rows."""
    b, s, d = x.shape
    if slotted:
        return torch.bmm(x, w.reshape(b, d, -1)).reshape(b, s, *w.shape[2:])
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def sharded(tp, local: int, full: int):
    """``tp`` when a leaf's dim of ``full`` entries is split over its model
    ranks (this rank holds ``local`` < ``full`` of them), else None: a leaf
    the placements hold whole is computed whole on every rank, with no
    collective."""
    return tp if tp is not None and local < full else None


def vec(p: Tensor, slotted: bool, ndim: int) -> Tensor:
    """A per-feature parameter ready to broadcast against an activation of
    ``ndim`` dims whose first is the batch: unchanged when shared, with
    singleton axes after the slot axis when slotted."""
    if not slotted:
        return p
    return p.reshape(p.shape[0], *([1] * (ndim - p.ndim)), *p.shape[1:])
