"""Mamba-2 block with the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060).  The prefill's chunked scan runs through the SSD kernel
(K7, :func:`repro_torch.kernels.ssd_scan.ssd_scan`); :func:`ssd_reference`
is the reference's chunked algorithm in plain PyTorch.  Decode carries the
(conv window, SSM state) caches and costs O(1) per token.

Training (:func:`mamba2_forward`) runs :func:`ssd_reference` under autograd,
as the reference's training forward (``mamba2_forward(use_kernel=False)``)
does: this is the model code of the training path, not a stand-in for a
kernel.  The reference has no gradient kernel for the SSD (its Pallas scan
is forward-only), so none is written here; K7 stays the prefill's kernel.

Layout: heads H = d_inner / head_dim (P), groups G (B/C shared per group),
state size N.  Caches are updated in place.

Tensor parallelism (``tp``) splits the layer by head.  The reference's
``in_proj`` placement cuts contiguous column chunks, which cross the z / x /
B / C / dt boundaries, so the port's shard of ``in_proj`` is this rank's
heads of z, x and dt beside the whole B and C (``conv_w`` / ``conv_b``: its
heads' x channels beside the whole B and C channels; :func:`tp_layout`).  K7
runs on the local heads; the gated RMSNorm's sum of squares is summed over
the model ranks; ``out_proj``'s partial product leaves summed.  The decode
caches hold the local conv channels and SSM heads.

A batch-1 decode over the idle axes (``idle``) splits the SSM state's
heads further, the model rank's heads over its idle ranks.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssd_chunked_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, normal_init, rms_norm, sharded, vec

Tensor = torch.Tensor

# the reference's chunked SSD, dtype rules included (y_diag's x·dt product
# rounds in the input dtype, the states carry in float32)
ssd_reference = ssd_chunked_ref


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_ch


def softplus(x: Tensor) -> Tensor:
    """``log(1 + e^x)`` as ``logaddexp(x, 0)``, the reference's formula."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype, stack: tuple = ()) -> Dict:
    s, d_in, n_heads, conv_ch = _dims(cfg)
    d, sc, dev = cfg.d_model, cfg.init_scale, gen.device
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads
    lo, hi = s.a_init_range
    a = lo + (hi - lo) * torch.rand(stack + (n_heads,), generator=gen, device=dev)
    # dt bias such that softplus(dt_bias) spans [dt_min, dt_max] log-uniformly
    u = torch.rand(stack + (n_heads,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": normal_init(gen, stack + (d, proj_out), sc, dtype),
        "conv_w": normal_init(gen, stack + (s.d_conv, conv_ch), 0.5 / math.sqrt(s.d_conv), dtype),
        "conv_b": torch.zeros(stack + (conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(a),
        "dt_bias": dt_bias,
        "d_skip": torch.ones(stack + (n_heads,), dtype=torch.float32, device=dev),
        "norm": torch.ones(stack + (d_in,), dtype=dtype, device=dev),
        "out_proj": normal_init(gen, stack + (d_in, d), sc / math.sqrt(2 * cfg.n_layers), dtype),
    }


def spec_mamba2(cfg: ModelConfig, model_axis: str = "model") -> Dict:
    """Placements: the inner channels over ``model_axis``."""
    mp = model_axis
    return {"in_proj": (None, mp), "conv_w": (None, mp), "conv_b": (mp,), "a_log": (None,),
            "dt_bias": (None,), "d_skip": (None,), "norm": (mp,), "out_proj": (mp, None)}


def spec_mamba2_cache(cfg: ModelConfig, batch_axes, model_axis: str = "model") -> Dict:
    """The reference's cache placements: the conv window's channels over
    ``model_axis``, the SSM state whole (the port's layout is
    :func:`tp_layout`'s)."""
    return {"conv": (batch_axes, None, model_axis), "ssm": (batch_axes, None, None, None)}


def tp_layout(cfg: ModelConfig, n: int) -> Dict[str, object]:
    """The port's model-axis layout of a Mamba-2 layer's leaves and cache
    over ``n`` ranks, by leaf name (dims counted from the end, so that a
    stacked leaf reads them the same): split by head when the heads divide,
    with B and C whole (:class:`repro_torch.launch.specs.Segments`); every
    leaf whole otherwise.  ``a_log``, ``dt_bias`` and ``d_skip`` stay whole,
    as placed, and each rank reads its heads' entries."""
    from repro_torch.launch.specs import Segments

    s, d_in, n_heads, _ = _dims(cfg)
    names = ("in_proj", "conv_w", "conv_b", "norm", "out_proj", "a_log", "dt_bias", "d_skip",
             "conv", "ssm")
    if n == 1 or n_heads % n:
        return dict.fromkeys(names)
    gn = s.n_groups * s.d_state
    conv = Segments(-1, (d_in, 2 * gn), (True, False))
    return {"in_proj": Segments(-1, (d_in, d_in, 2 * gn, n_heads), (True, True, False, True)),
            "conv_w": conv, "conv_b": conv, "norm": -1, "out_proj": -2, "a_log": None,
            "dt_bias": None, "d_skip": None, "conv": conv, "ssm": -3}


def _local(params: Dict, cfg: ModelConfig, tp):
    """(tp or None, local d_inner, local heads, this rank's head block)."""
    s, d_in, n_heads, _ = _dims(cfg)
    d_loc = params["out_proj"].shape[-2]
    tp = sharded(tp, d_loc, d_in)
    h_loc = d_loc // s.head_dim
    lo = 0 if tp is None else tp.index * h_loc
    return tp, d_loc, h_loc, (lo, lo + h_loc)


def _tp_params(params: Dict, cfg: ModelConfig, tp, heads) -> Dict:
    """Under ``tp``: the whole B / C columns of ``in_proj`` and channels of
    the conv entered (their gradients summed over the ranks), and this
    rank's entries of the whole per-head leaves."""
    if tp is None:
        return params
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    d_loc = params["out_proj"].shape[-2]
    p = dict(params)

    def enter_bc(w, start):
        a, bc, c = w.split([start, 2 * gn, w.shape[-1] - start - 2 * gn], -1)
        return torch.cat([a, tp.enter(bc), c], -1)

    p["in_proj"] = enter_bc(params["in_proj"], 2 * d_loc)
    p["conv_w"] = enter_bc(params["conv_w"], d_loc)
    p["conv_b"] = enter_bc(params["conv_b"], d_loc)
    for k in ("a_log", "dt_bias", "d_skip"):
        p[k] = tp.enter(params[k])[..., heads[0]:heads[1]]
    return p


def _gated_norm(y: Tensor, z: Tensor, scale: Tensor, cfg: ModelConfig, tp) -> Tensor:
    """``rms_norm(y * silu(z))`` over the whole d_inner: under ``tp`` the
    local sum of squares is summed over the ranks."""
    g = y * F.silu(z)
    if tp is None:
        return rms_norm(g, scale, cfg.norm_eps)
    gf = g.to(torch.float32)
    var = tp.enter(tp.exit(torch.sum(gf * gf, dim=-1, keepdim=True))) / _dims(cfg)[1]
    return (gf * torch.rsqrt(var + cfg.norm_eps) * scale.to(torch.float32)).to(g.dtype)


def ssd_decode_step(
    state: Tensor,  # (B, H, P, N) float32
    x_t: Tensor,  # (B, H, P)
    dt_t: Tensor,  # (B, H)
    a: Tensor,  # (H,) or (B, H), negative
    b_t: Tensor,  # (B, G, N)
    c_t: Tensor,  # (B, G, N)
) -> Tuple[Tensor, Tensor]:
    """O(1) recurrent update ``h <- h·exp(dt·A) + dt·x⊗B``, ``y = C·h``."""
    rep = state.shape[1] // b_t.shape[1]
    b_h = torch.repeat_interleave(b_t, rep, dim=1)  # (B, H, N)
    c_h = torch.repeat_interleave(c_t, rep, dim=1)
    decay = torch.exp(dt_t * a)  # (B, H)
    upd = (dt_t[..., None] * x_t)[..., :, None] * b_h[:, :, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_h)
    return y, new_state


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x (B, L, C), w (W, C) depthwise, left-padded causal."""
    width, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    y = sum(pad[:, i:i + l, :] * w[i][None, None, :] for i in range(width))
    return y + b[None, None, :].to(y.dtype)


def conv_decode_step(window: Tensor, x_t: Tensor, w: Tensor, b: Tensor,
                     slotted: bool = False) -> Tuple[Tensor, Tensor]:
    """window (B, W-1, C) previous inputs, x_t (B, 1, C); returns the conv
    output (B, 1, C) and the next window."""
    full = torch.cat([window, x_t], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,bwc->bc" if slotted else "bwc,wc->bc", full, w) + b
    return y[:, None, :], full[:, 1:, :]


def _split_proj(cfg: ModelConfig, zxbcdt: Tensor, d_in: Optional[int] = None):
    s = cfg.ssm
    d_in = _dims(cfg)[1] if d_in is None else d_in
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, zxbcdt.shape[-1] - 2 * d_in - 2 * gn],
                             dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] conv channels


def _split_xbc(cfg: ModelConfig, xbc: Tensor, d_in: Optional[int] = None):
    s = cfg.ssm
    d_in = _dims(cfg)[1] if d_in is None else d_in
    n_heads = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    x, b_mat, c_mat = torch.split(xbc, [d_in, gn, gn], dim=-1)
    bsz, l = x.shape[:2]
    return (x.reshape(bsz, l, n_heads, s.head_dim),
            b_mat.reshape(bsz, l, s.n_groups, s.d_state),
            c_mat.reshape(bsz, l, s.n_groups, s.d_state))


def mamba2_forward(params: Dict, cfg: ModelConfig, u: Tensor, tp=None) -> Tensor:
    """The training forward, u (B, L, d_model) -> (B, L, d_model): the
    chunked SSD through :func:`ssd_reference` (differentiable)."""
    s = cfg.ssm
    tp, d_in, _, heads = _local(params, cfg, tp)
    if tp is not None:
        u_in, params = tp.enter(u), _tp_params(params, cfg, tp, heads)
    else:
        u_in = u
    z, xbc, dt_raw = _split_proj(cfg, linear(u_in, params["in_proj"]), d_in)
    x, b_mat, c_mat = _split_xbc(cfg, F.silu(causal_conv(xbc, params["conv_w"],
                                                         params["conv_b"])), d_in)
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, _ = ssd_reference(x, dt.to(x.dtype), a, b_mat, c_mat, s.chunk)
    y = y.to(u.dtype) + params["d_skip"].to(u.dtype)[None, None, :, None] * x
    y = y.reshape(u.shape[0], u.shape[1], d_in)
    out = linear(_gated_norm(y, z, params["norm"], cfg, tp), params["out_proj"])
    return out if tp is None else tp.exit(out)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device=None, stack: tuple = ()) -> Dict:
    s, d_in, n_heads, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros(stack + (batch, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros(stack + (batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(params: Dict, cfg: ModelConfig, u: Tensor, cache: Dict,
                  slotted: bool = False, tp=None, idle=None) -> Tensor:
    """u (B, 1, d_model) -> (B, 1, d_model); advances ``cache`` in place
    (under ``tp``: this rank's conv channels and SSM heads).  Under ``idle``
    (:class:`repro_torch.launch.mesh.IdleAxis`) the SSM state holds this
    rank's block of the model rank's heads: the recurrence runs on those
    heads and their outputs are gathered over the idle ranks, so that the
    gated norm sees the model rank's whole group; the conv window stays
    whole over the idle ranks."""
    tp, d_in, _, heads = _local(params, cfg, tp)
    if tp is not None:
        u_in, params = tp.enter(u), _tp_params(params, cfg, tp, heads)
    else:
        u_in = u
    z, xbc, dt_raw = _split_proj(cfg, linear(u_in, params["in_proj"], slotted), d_in)
    conv_out, conv_win = conv_decode_step(cache["conv"], xbc, params["conv_w"],
                                          params["conv_b"], slotted)
    x, b_mat, c_mat = _split_xbc(cfg, F.silu(conv_out), d_in)
    dt = softplus(dt_raw.to(torch.float32) + vec(params["dt_bias"], slotted, 3))  # (B, 1, H)
    a = -torch.exp(params["a_log"])
    if idle is None or cache["ssm"].shape[1] == x.shape[2]:  # the heads whole over idle
        y, new_state = ssd_decode_step(
            cache["ssm"], x[:, 0].to(torch.float32), dt[:, 0], a,
            b_mat[:, 0].to(torch.float32), c_mat[:, 0].to(torch.float32),
        )
    else:
        if slotted:
            raise ValueError("a slotted decode runs whole over the idle axes")
        h_sub = cache["ssm"].shape[1]
        lo = idle.index * h_sub
        rep = x.shape[2] // b_mat.shape[2]  # heads per group of the rank's heads
        heads = slice(lo, lo + h_sub)

        def per_head(t: Tensor) -> Tensor:
            return torch.repeat_interleave(t[:, 0].to(torch.float32), rep, dim=1)[:, heads]

        y, new_state = ssd_decode_step(
            cache["ssm"], x[:, 0, heads].to(torch.float32), dt[:, 0, heads], a[heads],
            per_head(b_mat), per_head(c_mat),
        )
        y = idle.gather(y, 1)
    cache["conv"].copy_(conv_win)
    cache["ssm"].copy_(new_state)
    d_skip = params["d_skip"].to(u.dtype)
    d_skip = d_skip[..., :, None]  # (H, 1) or (B, H, 1) against (B, H, P)
    y = y.to(u.dtype) + d_skip * x[:, 0]
    y = y.reshape(u.shape[0], 1, d_in)
    y = _gated_norm(y, z, vec(params["norm"], slotted, 3), cfg, tp)
    out = linear(y, params["out_proj"], slotted)
    return out if tp is None else tp.exit(out)
