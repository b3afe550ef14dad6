"""Federated data partitioning + per-round minibatch sampling.

The paper's heterogeneity protocol (§5): *sort the dataset by label and split
it contiguously* across agents, so each agent sees a disjoint label slice —
extreme non-IID.  ``partition_iid`` is the shuffled control.  Partitioning is
host-side numpy, bit-equal to the reference ``repro.data.federated``.

:class:`RoundSampler` keeps the training split **resident on the device** and
gathers each round's minibatches there: ``local_batches`` with leaves shaped
(T_o, n_agents, b, ...) and a ``comm_batch`` with leaves (n_agents, b, ...).
Only the (T_o + 1, n_agents, b) index array crosses from the host per round.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# Domain-separation tags: every RNG stream in the data path is keyed by
# (tag, seed[, round]) so equal seeds can never alias two different draws.
_PARTITION_TAG = 0x9B1D
_SAMPLER_TAG = 0x5A3D

Array = Union[np.ndarray, torch.Tensor]


def _derive_seed(tag: int, seed: int) -> int:
    """Collapse (tag, seed) into one int for APIs taking a scalar seed."""
    return int(np.random.SeedSequence((int(tag), int(seed))).generate_state(1)[0])


def partition_sorted(
    x: np.ndarray, y: np.ndarray, n_agents: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by label, split contiguously: (n_agents, m, ...), (n_agents, m)."""
    order = np.argsort(y, kind="stable")
    xs, ys = x[order], y[order]
    m = len(y) // n_agents
    xs = xs[: m * n_agents].reshape(n_agents, m, *x.shape[1:])
    ys = ys[: m * n_agents].reshape(n_agents, m)
    return xs, ys


def partition_iid(
    x: np.ndarray, y: np.ndarray, n_agents: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))
    xs, ys = x[order], y[order]
    m = len(y) // n_agents
    xs = xs[: m * n_agents].reshape(n_agents, m, *x.shape[1:])
    ys = ys[: m * n_agents].reshape(n_agents, m)
    return xs, ys


@dataclasses.dataclass
class FederatedDataset:
    """Agent-partitioned dataset with train/test split (numpy arrays, or
    tensors after :meth:`to`)."""

    x_train: Array  # (A, m, ...)
    y_train: Array  # (A, m)
    x_test: Array  # (N_test, ...)
    y_test: Array  # (N_test,)

    @property
    def n_agents(self) -> int:
        return self.x_train.shape[0]

    @property
    def samples_per_agent(self) -> int:
        return self.x_train.shape[1]

    @classmethod
    def from_arrays(
        cls,
        x: np.ndarray,
        y: np.ndarray,
        n_agents: int,
        *,
        heterogeneous: bool = True,
        test_fraction: float = 0.2,
        seed: int = 0,
    ) -> "FederatedDataset":
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(y))
        n_test = int(len(y) * test_fraction)
        test_idx, train_idx = order[:n_test], order[n_test:]
        if heterogeneous:
            xs, ys = partition_sorted(x[train_idx], y[train_idx], n_agents)
        else:
            xs, ys = partition_iid(
                x[train_idx], y[train_idx], n_agents,
                seed=_derive_seed(_PARTITION_TAG, seed),
            )
        return cls(xs, ys, x[test_idx], y[test_idx])

    def to(self, device: DeviceLike = None) -> "FederatedDataset":
        """A copy whose four arrays are tensors resident on ``device`` —
        upload once, then share it across samplers and runs."""
        dev = resolve_device(device)
        return FederatedDataset(
            *(torch.as_tensor(a, device=dev) for a in (
                self.x_train, self.y_train, self.x_test, self.y_test
            ))
        )


class RoundSampler:
    """``sampler(k) -> (local_batches [T_o, A, b, ...], comm_batch [A, b, ...])``.

    Round ``k``'s minibatch indices are a pure function of ``(seed, k)``,
    drawn with numpy exactly as the reference sampler draws them, so every
    driver and block boundary sees bit-identical batches.  The gather runs on
    the device against the resident training split; one round's batches are
    materialised at a time (a block of rounds is never stacked)."""

    def __init__(
        self, data: FederatedDataset, batch_size: int, t_o: int, seed: int = 0,
        *, device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.x_train = torch.as_tensor(data.x_train, device=self.device)
        self.y_train = torch.as_tensor(data.y_train, device=self.device)
        self.b = batch_size
        self.t_o = t_o
        self.seed = seed
        self._agents = torch.arange(
            self.x_train.shape[0], device=self.device
        )[None, :, None]

    def round_indices(self, round_idx: int) -> np.ndarray:
        """(T_o + 1, A, b) sample indices for round ``round_idx``.  Round
        indices are mapped to nonnegative ints (SeedSequence rejects
        negatives); the init probe ``sampler(-1)`` lands on its own round."""
        a, m = self.x_train.shape[0], self.x_train.shape[1]
        return np.random.default_rng(
            (_SAMPLER_TAG, int(self.seed), int(round_idx) % (1 << 63))
        ).integers(0, m, size=(self.t_o + 1, a, self.b))

    def __call__(self, round_idx: int):
        idx = torch.as_tensor(self.round_indices(round_idx), device=self.device)
        xb = self.x_train[self._agents, idx]
        yb = self.y_train[self._agents, idx]
        return (xb[: self.t_o], yb[: self.t_o]), (xb[-1], yb[-1])
