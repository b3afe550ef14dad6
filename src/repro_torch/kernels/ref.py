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


def fused_mix_combine_ref(
    x_k: Tensor,
    x_to: Tensor,
    y_to: Optional[Tensor],
    left: Tensor,
    right: Optional[Tensor],
    eta_c: float,
    eta_l: float,
    w_self: float,
    w_left: float,
    w_right: float = 0.0,
) -> Tensor:
    """PISCO's (4a) candidate fused with the ring-gossip combine:
    ``u = (1 - eta_c) x_k + eta_c (x_to - eta_l y_to)``, ``out = w_self u +
    w_left left + w_right right``.  Without ``y_to``, ``x_to`` is already
    ``x_to - eta_l y_to`` (the port's round); without ``right`` the ring has
    one neighbour.  f32 math, output in ``x_k``'s dtype."""
    half = _f32(x_to) if y_to is None else _f32(x_to) - eta_l * _f32(y_to)
    cand = (1.0 - eta_c) * _f32(x_k) + eta_c * half
    out = w_self * cand + w_left * _f32(left)
    if right is not None:
        out = out + w_right * _f32(right)
    return out.to(x_k.dtype)


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
    scale = _row_scales(absmax, bits)
    return _codes(m, scale, bits, noise) * scale


def _row_scales(absmax: Tensor, bits: int) -> Tensor:
    """(n, 1): ``s = max(absmax, 1e-12) / qmax``."""
    qmax = float(2 ** (bits - 1) - 1)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal, which can differ in the last bit
    amax = torch.clamp_min(absmax, 1e-12)
    return (amax / torch.full_like(amax, qmax))[:, None]


def _codes(m: Tensor, scale: Tensor, bits: int, noise: Optional[Tensor]) -> Tensor:
    """The integer codes ``clip(round(m / s), -qmax, qmax)`` (or ``floor(m /
    s + noise)``), as float32."""
    qmax = float(2 ** (bits - 1) - 1)
    u = m / scale
    q = torch.floor(u + noise) if noise is not None else torch.round(u)
    return torch.clamp(q, -qmax, qmax)


def quant_codes_ref(
    x: Tensor,
    residual: Optional[Tensor],
    absmax: Tensor,
    bits: int,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """The codes pass of K3 and K5: the int8 codes ``c`` of ``m = x (+ r)``
    (n, d) on each row's grid, ``s = max(absmax, 1e-12) / qmax``, and with a
    residual ``r' = m - c s`` (None without r).  ``c * s`` is
    :func:`quantize_rows_ref`'s q bit for bit."""
    m = x if residual is None else x + residual
    scale = _row_scales(absmax, bits)
    c = _codes(m, scale, bits, noise)
    return c.to(torch.int8), (None if residual is None else m - c * scale)


def rowwise_quant_dequant_ref(
    x: Tensor,
    absmax: Tensor,
    bits: int,
    residual: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """The per-agent-row round trip ``q = q_bits(m)`` of ``m = x (+ r)`` (n, d)
    with the row abs-max ``absmax`` of ``m``, in ``x``'s dtype, and with a
    residual the error-feedback update ``r' = m - q`` (q as sent; None
    without r).  f32 math."""
    m = _f32(x) if residual is None else _f32(x) + _f32(residual)
    q = quantize_rows_ref(m, absmax, bits, noise).to(x.dtype)
    return q, (None if residual is None else (m - _f32(q)).to(x.dtype))


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


def code_mix_ref(
    x: Tensor,
    codes: Tensor,
    w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
    bf16_split: bool = False,
) -> Tensor:
    """K3's second pass: ``out = x + gamma*(W'^T c - q)`` from the codes c of
    the codes pass, with ``W'[j, i] = W[j, i] s_j`` (rounded once to f32) and
    ``q = c s``, grouped as ``x + (W'^T c - q)`` when gamma == 1.  With
    ``bf16_split`` W' is held as the tensor-core kernel holds it: three bf16
    terms, each the rounding of what the ones before leave."""
    scale = _row_scales(absmax, bits)
    c = _f32(codes)
    wp = w * scale
    if bf16_split:
        wp = _bf16_split(wp)
    diff = wp.T @ c - c * scale
    return x + diff if gamma == 1.0 else x + gamma * diff


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


def sparse_code_mix_csr_ref(
    x: Tensor,
    codes: Tensor,
    indptr: Tensor,
    indices: Tensor,
    data: Tensor,
    self_w: Tensor,
    absmax: Tensor,
    bits: int,
    gamma: float = 1.0,
) -> Tensor:
    """K5's second pass: ``out = x + gamma*((self_w q + sum_row data
    q[indices]) - q)`` with ``q = c s`` of the codes pass, grouped as ``x +
    (mixed - q)`` when gamma == 1.  Composed with :func:`quant_codes_ref` it
    is :func:`sparse_compressed_mix_csr_ref` bit for bit."""
    q = _f32(codes) * _row_scales(absmax, bits)
    diff = sparse_mix_csr_ref(q, indptr, indices, data, self_w) - q
    return x + diff if gamma == 1.0 else x + gamma * diff


def flash_attention_ref(
    q: Tensor,  # (B, Hq, Sq, D)
    k: Tensor,  # (B, Hkv, Sk, D)
    v: Tensor,  # (B, Hkv, Sk, Dv), Dv <= D
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    p_dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Masked softmax attention with GQA (query head h reads KV head
    ``h // group``), all in float32, output (B, Hq, Sq, Dv) in ``q``'s
    dtype; scores scaled by 1/sqrt(D), q's head dim, then capped to
    ``softcap * tanh(s / softcap)`` when ``softcap`` is given (before the
    mask, as the reference's ``_sdpa``).  Query and key positions both
    start at 0; the causal mask keeps ``k <= q`` and the window
    ``k > q - window``.

    ``p_dtype`` other than float32 models the tensor-core kernel's rounding:
    the unnormalised probabilities exp(s - max) are rounded to it before
    P·V, while their row sum stays float32 (the kernel rounds against its
    running max, so the model is close, not exact)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = torch.repeat_interleave(_f32(k), group, dim=1)
    vf = torch.repeat_interleave(_f32(v), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", _f32(q), kf) / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    if p_dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", _f32(p.to(p_dtype)), vf)
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


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


# K7's chunk-parallel decomposition (csrc/ssd_scan.cu), one plain function
# per pass, in float32 with the chunk's cumsum in float64 (exponents are
# differences of cums; the kernel forms them so, and carries its sums in
# float64 too).  With ``bf16_split`` the operands the kernel forms in float32
# (G, w∘X and h_in) are rounded as its bf16 tensor-core path rounds them: a
# sum of three bf16 terms, each the rounding of what the ones before leave.


def _bf16_split(v: Tensor) -> Tensor:
    out = torch.zeros_like(v)
    for _ in range(3):
        out = out + (v - out).to(torch.bfloat16).float()
    return out


def _chunks(t: Tensor, chunk: int) -> Tensor:
    """(B, L, ...) float32, zero-padded to a multiple of ``chunk`` and cut
    into (B, nc, chunk, ...)."""
    t = _f32(t)
    pad = -t.shape[1] % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def _chunk_cum(dt: Tensor, a: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """(dt (B, nc, c, H), cum = cumsum(dt·a) within each chunk, float64)."""
    dtc = _chunks(dt, chunk)
    return dtc, torch.cumsum(dtc.double() * a.double(), dim=2)


def _expd(c: Tensor) -> Tensor:
    """exp of a cum or a difference of cums (float64), in float32."""
    return torch.exp(c.float())


def _heads(m: Tensor, chunk: int, h: int) -> Tensor:
    """B or C (B, L, G, N) as (B, nc, c, H, N): head h reads group h / (H/G)."""
    mc = _chunks(m, chunk)
    return torch.repeat_interleave(mc, h // mc.shape[3], dim=3)


def ssd_chunk_states_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, chunk: int, bf16_split: bool = False
) -> Tuple[Tensor, Tensor]:
    """Pass (a): each chunk's local state from a zero state,
    ``S_z = Σ_s dt_s exp(cum_last - cum_s) x_s ⊗ B_s`` (B, nc, H, P, N), and
    its decay ``exp(cum_last)`` (B, nc, H); ``cum = cumsum(dt·a)`` within
    the chunk.  A ragged tail is padded with dt = 0 (exact no-ops)."""
    dtc, cum = _chunk_cum(dt, a, chunk)
    wx = (dtc * _expd(cum[:, :, -1:] - cum))[..., None] * _chunks(x, chunk)
    if bf16_split:
        wx = _bf16_split(wx)
    states = torch.einsum("bzshp,bzshn->bzhpn", wx, _heads(b_mat, chunk, x.shape[2]))
    return states, _expd(cum[:, :, -1])


def ssd_state_scan_ref(states: Tensor, decay: Tensor) -> Tuple[Tensor, Tensor]:
    """Pass (b): the state entering each chunk, ``h_in(z)`` (B, nc, H, P, N),
    from ``h_in(0) = 0``, ``h_in(z+1) = decay_z h_in(z) + S_z``, and the
    final state."""
    carry = torch.zeros_like(states[:, 0])
    prev = []
    for z in range(states.shape[1]):
        prev.append(carry)
        carry = carry * decay[:, z, :, None, None] + states[:, z]
    return torch.stack(prev, dim=1), carry


def ssd_chunk_output_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, h_in: Tensor, chunk: int,
    bf16_split: bool = False,
) -> Tensor:
    """Pass (c): ``y = G·X + exp(cum_l) C_l·h_inᵀ`` (B, L, H, P) float32,
    with ``G_ls = (C_l·B_s) exp(cum_l - cum_s) dt_s`` for s <= l."""
    l, h = x.shape[1], x.shape[2]
    dtc, cum = _chunk_cum(dt, a, chunk)
    cc = _heads(c_mat, chunk, h)
    ch = cum.movedim(-1, 2)  # (B, nc, H, c)
    diff = ch[..., :, None] - ch[..., None, :]  # cum_l - cum_s, never exp(cum_l)·exp(-cum_s)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal, _expd(torch.where(causal, diff, 0.0)), 0.0)
    gm = torch.einsum("bzlhn,bzshn->bzhls", cc, _heads(b_mat, chunk, h)) * seg \
        * dtc.movedim(-1, 2)[..., None, :]
    hs = h_in
    if bf16_split:
        gm, hs = _bf16_split(gm), _bf16_split(h_in)
    y = torch.einsum("bzhls,bzshp->bzlhp", gm, _chunks(x, chunk)) \
        + torch.einsum("bzlhn,bzhpn->bzlhp", cc, hs) * _expd(cum)[..., None]
    return y.reshape(x.shape[0], -1, h, x.shape[3])[:, :l]


def ssd_scan_chunks_ref(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int = 64,
    bf16_split: bool = False,
) -> Tuple[Tensor, Tensor]:
    """The three passes composed, as K7 runs them (its chunk is 64): y in
    ``x``'s dtype and the final state in float32."""
    states, decay = ssd_chunk_states_ref(x, dt, a, b_mat, chunk, bf16_split)
    h_in, final = ssd_state_scan_ref(states, decay)
    y = ssd_chunk_output_ref(x, dt, a, b_mat, c_mat, h_in, chunk, bf16_split)
    return y.to(x.dtype), final
