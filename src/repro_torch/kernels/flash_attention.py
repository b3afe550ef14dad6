"""K6 — GQA flash attention, causal (with or without a sliding window) or
bidirectional, with or without the attention logit softcap (CUDA source
``csrc/flash_attention.cu``).

Port of the Pallas kernel ``repro.kernels.flash_attention.flash_attention``
with its signature: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D).  Unlike the
Pallas kernel, any Sq and Sk are taken (the ragged tail is masked in the
kernel; without the causal mask every key up to Sk is live, as in an
encoder's self-attention or a cross-attention, Sq and Sk apart), and strided
views are read in place as long as the last dimension is contiguous.  v may have a smaller head dim Dv than q and k (MLA: q/k 192
= 128 no-RoPE + 64 RoPE against v 128): the scores keep the 1/sqrt(D) scale
and the kernel runs on v zero-padded to D, whose extra output columns are
zero and are sliced off (1.5x the P·V work and one copy of v at MLA's
shapes; a kernel templated on (D, Dv) would save both).

Tensors on the CPU go through the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`; tensors on a CUDA
device launch the kernel (or raise).  The library holds two kernels behind
one entry point: bfloat16 inputs run on the tensor cores (``wgmma`` fed by
TMA, counted also under ``flash_attention_tc``), float32 inputs on the f32
SIMT kernel that their 2e-6 tolerance needs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims each kernel is instantiated for: the f32 SIMT kernel takes
# multiples of 16 (OPT = D / 16 output columns a thread; 48 is the reduced
# MLA's q/k, 192 Nemotron-4's and MLA's); the tensor-core kernel's TMA boxes
# and swizzles need rows of at least 64 bytes, 32 bf16 values, in whole
# boxes (D = 192 is three 128-byte boxes a row)
HEAD_DIMS = {torch.float32: (16, 32, 48, 64, 128, 192), torch.bfloat16: (32, 64, 128, 192)}


def tma_strides(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """The (batch, head, sequence) strides, in elements, through which the
    tensor-core kernel's TMA maps read the bf16 (B, H, S, D) view ``t``.

    TMA needs the base address and every stride but the innermost to be a
    multiple of 16 bytes.  A dimension of size 1 is never stepped over, so
    its stride is replaced by the head dim (always a valid one).  Raises
    ``ValueError`` naming the offending stride; nothing is copied."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name}'s base address is not 16-byte aligned (TMA)")
    out = []
    for dim, what in ((0, "batch"), (1, "head"), (2, "sequence")):
        st = t.stride(dim)
        if t.shape[dim] == 1:
            st = t.shape[3]
        elif (st * t.element_size()) % 16:
            raise ValueError(f"flash_attention: {name}.stride({dim}) ({what}) is {st} elements, "
                             f"{st * t.element_size()} bytes: TMA needs a multiple of 16 bytes")
        out.append(st)
    return out[0], out[1], out[2]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention, online, f32 running statistics; returns
    (B, Hq, Sq, Dv) in ``q``'s dtype.  Query head h reads KV head
    ``h // (Hq // Hkv)``; positions of queries and keys both start at 0.
    ``softcap`` caps the scaled scores to ``softcap * tanh(s / softcap)``
    before the masks (Gemma-2's attention logit softcap)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes 4-D q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    b, hq, sq, d = q.shape
    dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d or not 0 < dv <= d:
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
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if not build.on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if d not in HEAD_DIMS[q.dtype]:
        if q.dtype == torch.bfloat16 and d in HEAD_DIMS[torch.float32]:
            raise ValueError(f"flash_attention kernel: bf16 head dim {d} gives {2 * d}-byte rows; "
                             "the tensor-core kernel's TMA boxes need rows of at least 64 "
                             "bytes in whole boxes (head dim 32, 64, 128 or 192)")
        raise ValueError(f"flash_attention kernel: {q.dtype} head dim {d} not in "
                         f"{HEAD_DIMS[q.dtype]}")
    if dv < d:
        v = torch.nn.functional.pad(v, (0, d - dv))  # a contiguous copy, zeros past Dv
    q, k, v = (build.last_dim_contiguous(t) for t in (q, k, v))
    tc = q.dtype == torch.bfloat16
    if tc:
        qs, ks, vs = (tma_strides(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    else:
        qs, ks, vs = (t.stride()[:3] for t in (q, k, v))
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    err = build.library("flash_attention").launch_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, hq, hkv, sq, k.shape[2], d,
        *qs, *ks, *vs, 1.0 / math.sqrt(d), int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _DTYPES[q.dtype], build.stream_of(q),
    )
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    if tc:
        build.LAUNCHES["flash_attention_tc"] += 1
    return out if dv == d else out[..., :dv]
