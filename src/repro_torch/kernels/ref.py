"""Plain PyTorch versions of every ported kernel.

Each is the kernel's twin: the same function in direct tensor code.  The
wrappers run these for tensors on the CPU (the tests' path), and the chip
check holds each CUDA kernel against its twin on the card.  They repeat the
kernels' arithmetic — float32 math, the same grouping of sums — and are no
yardstick of speed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32)


def fused_local_step_ref(
    x: Tensor, y: Tensor, g_new: Tensor, g_old: Tensor, eta_l: float
) -> Tuple[Tensor, Tensor]:
    """Reference-form PISCO eq. (3a)+(3c): ``x' = x - eta_l*y``,
    ``y' = (y + g_new) - g_old`` — both from the OLD y; f32 math, output in
    the input dtype."""
    xf, yf = _f32(x), _f32(y)
    return (xf - eta_l * yf).to(x.dtype), ((yf + _f32(g_new)) - _f32(g_old)).to(y.dtype)


def fused_track_step_ref(
    x: Tensor, y: Tensor, g_new: Tensor, g_old: Tensor, eta_l: float
) -> Tuple[Tensor, Tensor]:
    """Track-step form: ``y' = y + (g_new - g_old)`` (step t's 3c, PISCO's
    grouping), then ``x' = x - eta_l*y'`` (step t+1's 3a)."""
    yn = _f32(y) + (_f32(g_new) - _f32(g_old))
    return (_f32(x) - eta_l * yn).to(x.dtype), yn.to(y.dtype)


def row_absmax_ref(x: Tensor, residual: Optional[Tensor] = None) -> Tensor:
    """(n, d) -> (n,) float32: ``max_j |x_ij + r_ij|``."""
    m = _f32(x) if residual is None else _f32(x) + _f32(residual)
    return m.abs().amax(dim=1)


def quantize_rows_ref(
    m: Tensor, absmax: Tensor, bits: int, noise: Optional[Tensor] = None
) -> Tensor:
    """The q grid: per-row symmetric int-``bits`` round trip of ``m`` (n, d)
    with the row abs-max ``absmax`` (n,).  Round half to even, or
    ``floor(u + noise)`` when ``noise`` (uniform [0, 1)) is given."""
    qmax = float(2 ** (bits - 1) - 1)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal, which can differ in the last bit
    amax = torch.clamp_min(absmax, 1e-12)
    scale = (amax / torch.full_like(amax, qmax))[:, None]
    u = m / scale
    q = torch.floor(u + noise) if noise is not None else torch.round(u)
    return torch.clamp(q, -qmax, qmax) * scale


def compressed_mix_ref(
    x: Tensor,
    residual: Optional[Tensor],
    w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Mean-preserving compressed gossip with optional error feedback:
    ``m = x + r``; ``out = x + gamma*(W^T q(m) - q(m))`` grouped as
    ``x + (W^T q - q)`` when gamma == 1; ``r' = m - q`` (None without r)."""
    m = x if residual is None else x + residual
    q = quantize_rows_ref(m, absmax, bits, noise)
    diff = w.T @ q - q
    out = x + diff if gamma == 1.0 else x + gamma * diff
    return out, (None if residual is None else m - q)


def sparse_mix_csr_ref(
    x: Tensor, indptr: Tensor, indices: Tensor, data: Tensor, self_w: Tensor
) -> Tensor:
    """``out_i = self_w_i x_i + sum_{e in row i} data_e x_{indices_e}``: the
    row sums accumulate in CSR (edge) order, the self term is added last."""
    xf = _f32(x)
    rows = torch.repeat_interleave(
        torch.arange(x.shape[0], device=x.device), indptr[1:] - indptr[:-1]
    )
    acc = torch.zeros_like(xf).index_add_(0, rows, data[:, None] * xf[indices])
    return (self_w[:, None] * xf + acc).to(x.dtype)


def sparse_compressed_mix_csr_ref(
    x: Tensor,
    residual: Optional[Tensor],
    indptr: Tensor,
    indices: Tensor,
    data: Tensor,
    self_w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Mean-preserving compressed gossip over the CSR W with optional error
    feedback: ``m = x + r``, ``q = q(m)``, ``out = x + gamma*((self_w q +
    sum_row data q[indices]) - q)`` grouped as ``x + (mixed - q)`` when
    gamma == 1; ``r' = m - q`` (None without r)."""
    m = x if residual is None else x + residual
    q = quantize_rows_ref(m, absmax, bits, noise)
    diff = sparse_mix_csr_ref(q, indptr, indices, data, self_w) - q
    out = x + diff if gamma == 1.0 else x + gamma * diff
    return out, (None if residual is None else m - q)


def flash_attention_ref(
    q: Tensor,  # (B, Hq, Sq, D)
    k: Tensor,  # (B, Hkv, Sk, D)
    v: Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tensor:
    """Masked softmax attention with GQA (query head h reads KV head
    ``h // group``), all in float32, output in ``q``'s dtype.  Query and key
    positions both start at 0; the causal mask keeps ``k <= q`` and the
    window ``k > q - window``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = torch.repeat_interleave(_f32(k), group, dim=1)
    vf = torch.repeat_interleave(_f32(v), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", _f32(q), kf) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def _segsum(a: Tensor) -> Tensor:
    """``out[..., i, j] = sum_{k=j+1..i} a[..., k]``, -1e30 for j > i."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(n, device=a.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, torch.full_like(diff, -1e30))


def ssd_chunked_ref(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H), positive
    a: Tensor,  # (H,), negative
    b_mat: Tensor,  # (B, L, G, N)
    c_mat: Tensor,  # (B, L, G, N)
    chunk: int,
    h0: Optional[Tensor] = None,  # (B, H, P, N)
) -> Tuple[Tensor, Tensor]:
    """The chunked SSD of the reference (``repro.models.mamba2.ssd_reference``)
    with its dtype rules: the diagonal term multiplies ``x·dt`` in the input
    dtype, states carry in float32.  L need not divide ``chunk``: padded steps
    have dt = 0 and are exact no-ops.  Returns (y (B,L,H,P), final state
    (B,H,P,N) float32)."""
    bsz, l_orig, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if l_orig % chunk:
        pad = chunk - l_orig % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    rep = h // g
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = torch.repeat_interleave(b_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3)
    cc = torch.repeat_interleave(c_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3)

    a_dt = dtc * a  # (B, nc, cl, H), promoted like the reference
    a_cum = torch.cumsum(a_dt, dim=2)
    # 1) intra-chunk (diagonal blocks)
    l_mat = torch.exp(_segsum(a_dt.movedim(-1, 2)))  # (B, nc, H, cl, cl)
    xdt = xc * dtc[..., None]
    ct = torch.promote_types(torch.promote_types(cc.dtype, l_mat.dtype), xdt.dtype)
    y_diag = torch.einsum("bzlhn,bzshn,bzhls,bzshp->bzlhp",
                          cc.to(ct), bc.to(ct), l_mat.to(ct), xdt.to(ct))
    # 2) per-chunk states carried to the boundary (float32)
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    states = torch.einsum("bzlhn,bzlh,bzlhp->bzhpn", _f32(bc), _f32(decay_states * dtc), _f32(xc))
    # 3) inter-chunk recurrence
    chunk_decay = _f32(torch.exp(a_cum[:, :, -1, :]))  # (B, nc, H)
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else _f32(h0))
    prev = []
    for z in range(nc):
        prev.append(carry)  # the state entering chunk z
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)
    # 4) incoming chunk states' contribution
    y_off = torch.einsum("bzlhn,bzhpn,bzlh->bzlhp", _f32(cc), prev_states,
                         _f32(torch.exp(a_cum))).to(y_diag.dtype)
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :l_orig]
    return y, carry


def ssd_scan_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int = 128
) -> Tuple[Tensor, Tensor]:
    """The SSD kernel's twin: the chunked scan with every operand in float32;
    y in ``x``'s dtype, the final state in float32."""
    y, fin = ssd_chunked_ref(_f32(x), _f32(dt), _f32(a), _f32(b_mat), _f32(c_mat), chunk)
    return y.to(x.dtype), fin
