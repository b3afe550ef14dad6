"""K1 — fused PISCO local step (CUDA source ``csrc/gt_update.cu``).

Port of the Pallas kernel ``repro.kernels.gt_update.fused_local_step``.  Two
entry points over one kernel:

* :func:`fused_local_step` keeps the reference signature and semantics
  (both outputs from the old y);
* :func:`fused_track_step` is the form the PISCO round runs:
  ``y' = y + (g_new - g_old)`` then ``x' = x - eta_l*y'`` — step t's (3c)
  fused with step t+1's (3a).  After the last local step its ``x'`` is the
  ``x_to - eta_l*y_to`` term of (4a).

Tensors on the CPU go through the plain versions in :mod:`.ref`; tensors on
a CUDA device launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Tuple

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
