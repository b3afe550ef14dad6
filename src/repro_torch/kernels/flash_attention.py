"""K6 — causal / sliding-window GQA flash attention (CUDA source
``csrc/flash_attention.cu``).

Port of the Pallas kernel ``repro.kernels.flash_attention.flash_attention``
with its signature: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D).  Unlike the
Pallas kernel, any Sq and Sk are taken (the ragged tail is masked in the
kernel), and strided views are read in place as long as the last dimension
is contiguous.

Tensors on the CPU go through the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`; tensors on a CUDA
device launch the kernel (or raise).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked softmax attention, online, f32 running statistics; returns
    (B, Hq, Sq, D) in ``q``'s dtype.  Query head h reads KV head
    ``h // (Hq // Hkv)``; positions of queries and keys both start at 0."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes 4-D q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32/bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not build.on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in {HEAD_DIMS}")
    q, k, v = (build.last_dim_contiguous(t) for t in (q, k, v))
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    err = build.library("flash_attention").launch_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, hq, hkv, sq, k.shape[2], d,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(d), int(causal),
        0 if window is None else int(window), _DTYPES[q.dtype], build.stream_of(q),
    )
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
