"""Synthetic stand-ins for the paper's datasets — numpy, bit-equal to the
reference ``repro.data.synthetic`` for the same seed.

* :func:`synthetic_a9a`   — binary classification, d=124 binary features
  separable by a planted logistic model plus label noise (§5.1).
* :func:`synthetic_mnist` — 10-class, 784-dim "digit" clusters (§5.2 MLP).
* :func:`synthetic_cifar` — 10-class small images, 16×16×3 (Fig. 7 CNN).
* :func:`synthetic_lm_tokens` — a Zipf token stream with bigrams (LM training).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_a9a(
    n_samples: int = 32560, d: int = 124, seed: int = 0, noise: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features (N, d) float32, labels (N,) in {-1, +1})."""
    rng = np.random.default_rng(seed)
    # one-hot-ish binary features with varying activation rates
    rates = rng.uniform(0.02, 0.5, size=d)
    feats = (rng.random((n_samples, d)) < rates).astype(np.float32)
    w = rng.normal(size=d) / np.sqrt(d)
    logits = feats @ w + 0.3 * rng.normal(size=n_samples)
    labels = np.where(logits + noise * rng.normal(size=n_samples) > np.median(logits), 1.0, -1.0)
    return feats, labels.astype(np.float32)


def synthetic_mnist(
    n_samples: int = 20000, d: int = 784, n_classes: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, 784) float32 in [0,1], labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    templates = rng.random((n_classes, d)) * (rng.random((n_classes, d)) < 0.2)
    labels = rng.integers(0, n_classes, size=n_samples)
    x = templates[labels] + 0.15 * rng.normal(size=(n_samples, d))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return x, labels.astype(np.int32)


def synthetic_cifar(
    n_samples: int = 10000, hw: int = 16, n_classes: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, hw, hw, 3) float32, labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    templates = rng.random((n_classes, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n_samples)
    x = 0.6 * templates[labels] + 0.4 * rng.random((n_samples, hw, hw, 3))
    return x.astype(np.float32), labels.astype(np.int32)


def synthetic_lm_tokens(
    n_tokens: int, vocab_size: int, seed: int = 0, alpha: float = 1.1
) -> np.ndarray:
    """Zipf-distributed token stream with local bigram structure (so a small
    LM has something learnable); int32."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=n_tokens, p=probs)
    # learnable bigrams: token t is often followed by (7 t + 1) mod vocab
    follow = rng.random(n_tokens) < 0.35
    base[1:][follow[1:]] = (base[:-1][follow[1:]] * 7 + 1) % vocab_size
    return base.astype(np.int32)
