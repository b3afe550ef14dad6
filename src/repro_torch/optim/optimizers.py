"""The optimizer names of the reference's ``repro.optim.optimizers``:
``Optimizer`` *is* :class:`~repro_torch.optim.update_rules.UpdateRule`, and
``sgd`` / ``momentum`` / ``adam`` / ``adamw`` / ``apply_updates`` are the
rules of :mod:`repro_torch.optim.update_rules`."""
from __future__ import annotations

from repro_torch.optim.update_rules import (
    UpdateRule,
    adam,
    adamw,
    apply_updates,
    momentum,
    sgd,
)

Optimizer = UpdateRule

__all__ = ["Optimizer", "UpdateRule", "sgd", "momentum", "adam", "adamw", "apply_updates"]
