"""The paper's own experimental models (§5): logistic regression with a
nonconvex regularizer, a 1-hidden-layer MLP (32 sigmoid units + softmax), and
the small CIFAR CNN of Fig. 7.

Parameters are plain ``dict[str, Tensor]`` in the reference's layouts: the
MLP's ``w1`` is (hidden, d_in); the CNN takes NHWC images and HWIO kernels at
its public functions and converts to PyTorch's NCHW/OIHW inside.  Every loss
is written for ONE agent; :func:`repro_torch.core.pisco.make_stacked_value_and_grad`
vmaps it over the agent axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# §5.1 logistic regression + nonconvex regularizer
# ---------------------------------------------------------------------------


def logreg_init(d: int, device=None) -> Params:
    return {"w": torch.zeros((d,), dtype=torch.float32, device=device)}


def logreg_loss(params: Params, batch: Tuple, rho: float = 0.01) -> torch.Tensor:
    """log(1 + exp(-y a^T x)) + rho * sum_l x_l^2 / (1 + x_l^2)  [WJZ+19].

    ``log1p(exp(.))`` as the reference writes it (not softplus, whose
    large-argument branch rounds differently)."""
    a, y = batch
    w = params["w"]
    logits = a @ w
    data = torch.mean(torch.log1p(torch.exp(-y * logits)))
    reg = rho * torch.sum(w * w / (1.0 + w * w))
    return data + reg


def logreg_accuracy(params: Params, a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = torch.where(a @ params["w"] > 0, 1.0, -1.0)
    return torch.mean((pred == y).to(torch.float32))


# ---------------------------------------------------------------------------
# §5.2 one-hidden-layer MLP (sigmoid, 32 units, softmax CE)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def mlp_init(
    seed: int = 0, d_in: int = 784, hidden: int = 32, n_classes: int = 10,
    device=None,
) -> Params:
    """Same shapes and scales as the reference init; the draws come from a
    seeded ``torch.Generator`` (JAX's PRNG bits cannot be reproduced — carry
    reference weights across with :func:`repro_torch.weights.from_jax`)."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "w1": 0.1 * _normal(gen, (hidden, d_in), device),
        "c1": torch.zeros((hidden,), device=device),
        "w2": 0.1 * _normal(gen, (n_classes, hidden), device),
        "c2": torch.zeros((n_classes,), device=device),
    }


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.sigmoid(x @ params["w1"].T + params["c1"])
    return h @ params["w2"].T + params["c2"]


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)


def mlp_loss(params: Params, batch: Tuple) -> torch.Tensor:
    x, y = batch
    return _cross_entropy(mlp_logits(params, x), y)


def mlp_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(mlp_logits(params, x), dim=-1) == y).to(torch.float32))


# ---------------------------------------------------------------------------
# Fig. 7 CNN (scaled to the synthetic 16x16 CIFAR stand-in)
# ---------------------------------------------------------------------------


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC, w: (kh, kw, Cin, Cout) HWIO, SAME padding;
    returns NCHW for the pooling that follows."""
    return F.conv2d(
        x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding="same"
    )


def cnn_init(seed: int = 0, hw: int = 16, n_classes: int = 10, device=None) -> Params:
    gen = torch.Generator().manual_seed(seed)
    flat = (hw // 4) * (hw // 4) * 64
    return {
        "c1": 0.2 * _normal(gen, (3, 3, 3, 32), device),
        "c2": 0.2 * _normal(gen, (3, 3, 32, 64), device),
        "w1": 0.1 * _normal(gen, (128, flat), device),
        "b1": torch.zeros((128,), device=device),
        "w2": 0.1 * _normal(gen, (n_classes, 128), device),
        "b2": torch.zeros((n_classes,), device=device),
    }


def cnn_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.max_pool2d(F.relu(_conv_nhwc(x, params["c1"])), 2, 2)
    h = F.conv2d(h, params["c2"].permute(3, 2, 0, 1), padding="same")
    h = F.max_pool2d(F.relu(h), 2, 2)
    # flatten in NHWC order, the layout the reference's w1 expects
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["w1"].T + params["b1"])
    return h @ params["w2"].T + params["b2"]


def cnn_loss(params: Params, batch: Tuple) -> torch.Tensor:
    x, y = batch
    return _cross_entropy(cnn_logits(params, x), y)


def cnn_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(cnn_logits(params, x), dim=-1) == y).to(torch.float32))
