"""K1 — fused PISCO local step, and K8 — the fused (4a) candidate with the
ring-gossip combine (CUDA source ``csrc/gt_update.cu``).

K1 ports the Pallas kernel ``repro.kernels.gt_update.fused_local_step``.  Two
entry points over one kernel:

* :func:`fused_local_step` keeps the reference signature and semantics
  (both outputs from the old y);
* :func:`fused_track_step` is the form the PISCO round runs:
  ``y' = y + (g_new - g_old)`` then ``x' = x - eta_l*y'`` — step t's (3c)
  fused with step t+1's (3a).  After the last local step its ``x'`` is the
  ``x_to - eta_l*y_to`` term of (4a).

K8 ports ``repro.kernels.gt_update.fused_mix_combine``, again in two forms:

* :func:`fused_mix_combine` keeps the reference signature
  ``(x_k, x_to, y_to, left, right)``;
* :func:`mix_combine_half` is the form the collective round runs, from the
  ``x_half = x_to - eta_l*y_to`` that K1's track step leaves; ``right`` may
  be absent (a ring of two ranks has one neighbour).

``left`` and ``right`` are the neighbours' candidates in the wire dtype
(float32 or the state's); the output takes ``x_k``'s dtype.

Tensors on the CPU go through the plain versions in :mod:`.ref`; tensors on
a CUDA device launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, y, g_new, g_old, eta_l: float, track: bool):
    for t in (y, g_new, g_old):
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(
                f"fused local step: operands differ ({t.shape} {t.dtype} "
                f"vs {x.shape} {x.dtype})"
            )
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused local step takes float32/bfloat16, got {x.dtype}")
    if not build.on_cuda(x, y, g_new, g_old):
        fn = ref.fused_track_step_ref if track else ref.fused_local_step_ref
        return fn(x, y, g_new, g_old, eta_l)
    x, y, g_new, g_old = (t.contiguous() for t in (x, y, g_new, g_old))
    x_out, y_out = torch.empty_like(x), torch.empty_like(y)
    err = build.library("gt_update").launch_local_step(
        build.ptr(x), build.ptr(y), build.ptr(g_new), build.ptr(g_old),
        build.ptr(x_out), build.ptr(y_out), x.numel(), float(eta_l),
        int(track), _DTYPES[x.dtype], build.stream_of(x),
    )
    build.check(err, "fused_local_step")
    build.LAUNCHES["fused_local_step"] += 1
    return x_out, y_out


def fused_local_step(
    x: torch.Tensor, y: torch.Tensor, g_new: torch.Tensor, g_old: torch.Tensor,
    eta_l: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x' = x - eta_l*y``, ``y' = (y + g_new) - g_old``; any shape."""
    return _launch(x, y, g_new, g_old, eta_l, track=False)


def fused_track_step(
    x: torch.Tensor, y: torch.Tensor, g_new: torch.Tensor, g_old: torch.Tensor,
    eta_l: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y' = y + (g_new - g_old)``, ``x' = x - eta_l*y'``; any shape."""
    return _launch(x, y, g_new, g_old, eta_l, track=True)


def _launch_mix(x_k, x_to, y_to, left, right, eta_c, eta_l, w_self, w_left, w_right):
    state = [t for t in (x_k, x_to, y_to) if t is not None]
    wire = [t for t in (left, right) if t is not None]
    for t in state + wire:
        if t.shape != x_k.shape:
            raise ValueError(f"fused_mix_combine: operand {tuple(t.shape)} vs {tuple(x_k.shape)}")
    if x_k.dtype not in _DTYPES or any(t.dtype != x_k.dtype for t in state):
        raise TypeError("fused_mix_combine: x_k, x_to, y_to must share one float32/bfloat16 dtype")
    if left.dtype not in _DTYPES or any(t.dtype != left.dtype for t in wire):
        raise TypeError("fused_mix_combine: left and right must share one float32/bfloat16 dtype")
    if not build.on_cuda(*state, *wire):
        return ref.fused_mix_combine_ref(x_k, x_to, y_to, left, right, eta_c, eta_l,
                                         w_self, w_left, w_right)
    x_k, x_to, y_to, left, right = (
        None if t is None else t.contiguous() for t in (x_k, x_to, y_to, left, right)
    )
    out = torch.empty_like(x_k)
    err = build.library("gt_update").launch_mix_combine(
        build.ptr(x_k), build.ptr(x_to), build.ptr(y_to), build.ptr(left), build.ptr(right),
        build.ptr(out), x_k.numel(), 1.0 - eta_c, eta_c, eta_l, w_self, w_left, w_right,
        _DTYPES[x_k.dtype], _DTYPES[left.dtype], build.stream_of(x_k),
    )
    build.check(err, "fused_mix_combine")
    build.LAUNCHES["fused_mix_combine"] += 1
    return out


def fused_mix_combine(
    x_k: torch.Tensor, x_to: torch.Tensor, y_to: torch.Tensor,
    left: torch.Tensor, right: torch.Tensor,
    *, eta_c: float, eta_l: float, w_self: float, w_left: float, w_right: float,
) -> torch.Tensor:
    """``w_self u + w_left left + w_right right`` with the (4a) candidate
    ``u = (1 - eta_c) x_k + eta_c (x_to - eta_l y_to)``; any shape."""
    return _launch_mix(x_k, x_to, y_to, left, right, eta_c, eta_l, w_self, w_left, w_right)


def mix_combine_half(
    x_k: torch.Tensor, x_half: torch.Tensor, left: torch.Tensor,
    right: Optional[torch.Tensor] = None,
    *, eta_c: float, w_self: float, w_left: float, w_right: float = 0.0,
) -> torch.Tensor:
    """The same from ``x_half = x_to - eta_l y_to``:
    ``u = (1 - eta_c) x_k + eta_c x_half``; ``right`` optional."""
    return _launch_mix(x_k, x_half, None, left, right, eta_c, 0.0, w_self, w_left, w_right)
