"""Mamba-2 block with the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060).  The prefill's chunked scan runs through the SSD kernel
(K7, :func:`repro_torch.kernels.ssd_scan.ssd_scan`); :func:`ssd_reference`
is the reference's chunked algorithm in plain PyTorch.  Decode carries the
(conv window, SSM state) caches and costs O(1) per token.

Layout: heads H = d_inner / head_dim (P), groups G (B/C shared per group),
state size N.  Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssd_chunked_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, normal_init, rms_norm, vec

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


def _split_proj(cfg: ModelConfig, zxbcdt: Tensor):
    s, d_in, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, zxbcdt.shape[-1] - 2 * d_in - 2 * gn],
                             dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] conv channels


def _split_xbc(cfg: ModelConfig, xbc: Tensor):
    s, d_in, n_heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    x, b_mat, c_mat = torch.split(xbc, [d_in, gn, gn], dim=-1)
    bsz, l = x.shape[:2]
    return (x.reshape(bsz, l, n_heads, s.head_dim),
            b_mat.reshape(bsz, l, s.n_groups, s.d_state),
            c_mat.reshape(bsz, l, s.n_groups, s.d_state))


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device=None, stack: tuple = ()) -> Dict:
    s, d_in, n_heads, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros(stack + (batch, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros(stack + (batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(params: Dict, cfg: ModelConfig, u: Tensor, cache: Dict,
                  slotted: bool = False) -> Tensor:
    """u (B, 1, d_model) -> (B, 1, d_model); advances ``cache`` in place."""
    s, d_in, n_heads, _ = _dims(cfg)
    z, xbc, dt_raw = _split_proj(cfg, linear(u, params["in_proj"], slotted))
    conv_out, conv_win = conv_decode_step(cache["conv"], xbc, params["conv_w"],
                                          params["conv_b"], slotted)
    x, b_mat, c_mat = _split_xbc(cfg, F.silu(conv_out))
    dt = softplus(dt_raw.to(torch.float32) + vec(params["dt_bias"], slotted, 3))  # (B, 1, H)
    a = -torch.exp(params["a_log"])
    y, new_state = ssd_decode_step(
        cache["ssm"], x[:, 0].to(torch.float32), dt[:, 0], a,
        b_mat[:, 0].to(torch.float32), c_mat[:, 0].to(torch.float32),
    )
    cache["conv"].copy_(conv_win)
    cache["ssm"].copy_(new_state)
    d_skip = params["d_skip"].to(u.dtype)
    d_skip = d_skip[..., :, None]  # (H, 1) or (B, H, 1) against (B, H, P)
    y = y.to(u.dtype) + d_skip * x[:, 0]
    y = y.reshape(u.shape[0], 1, d_in)
    y = rms_norm(y * F.silu(z), vec(params["norm"], slotted, 3), cfg.norm_eps)
    return linear(y, params["out_proj"], slotted)
