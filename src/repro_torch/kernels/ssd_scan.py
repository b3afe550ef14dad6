"""K7 — Mamba-2 SSD chunked scan (CUDA source ``csrc/ssd_scan.cu``).

Port of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan_kernel`` with its
signature: x (B, L, H, P), dt (B, L, H), a (H,), B and C (B, L, G, N);
returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N) float32).
Unlike the Pallas kernel, any L is taken: the ragged last chunk is masked,
its missing steps exact no-ops as in the reference's zero padding.  The
kernel walks 64-step chunks whatever ``chunk`` says (the recurrence is the
same for every chunk length; ``chunk`` sets the plain version's).

Tensors on the CPU go through the plain version
:func:`repro_torch.kernels.ref.ssd_scan_ref`; tensors on a CUDA device
launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448  # bytes of shared memory one block may use on the H100


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t ⊗ B_t``,
    ``y_t = C_t · h_t`` from a zero state, computed chunk by chunk."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_mat.dim() != 4:
        raise ValueError(f"ssd_scan: bad ranks {x.shape}, {dt.shape}, {a.shape}, {b_mat.shape}")
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (bsz, l, h) or a.shape != (h,) or b_mat.shape != (bsz, l, g, n)
            or c_mat.shape != b_mat.shape or h % g):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(b_mat.shape)}, C {tuple(c_mat.shape)}")
    if not (x.dtype == b_mat.dtype == c_mat.dtype) or x.dtype not in _DTYPES \
            or dt.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32/bfloat16 x, B, C of one dtype and dt; got "
                        f"{x.dtype}, {b_mat.dtype}, {c_mat.dtype}, {dt.dtype}")
    if not build.on_cuda(x, dt, a, b_mat, c_mat):
        return ref.ssd_scan_ref(x, dt, a, b_mat, c_mat, chunk)
    lib = build.library("ssd_scan")
    if lib.ssd_scan_smem_bytes(p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: P={p}, N={n} need more shared memory than a block has")
    x, dt, b_mat, c_mat = (build.last_dim_contiguous(t) for t in (x, dt, b_mat, c_mat))
    a = a.to(torch.float32).contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    hfin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.launch_ssd_scan(
        build.ptr(x), build.ptr(dt), build.ptr(a), build.ptr(b_mat), build.ptr(c_mat),
        build.ptr(y), build.ptr(hfin), bsz, l, h, g, p, n,
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        b_mat.stride(0), b_mat.stride(1), b_mat.stride(2),
        c_mat.stride(0), c_mat.stride(1), c_mat.stride(2),
        _DTYPES[x.dtype], _DTYPES[dt.dtype], build.stream_of(x),
    )
    build.check(err, "ssd_scan")
    build.LAUNCHES["ssd_scan"] += 1
    return y, hfin
