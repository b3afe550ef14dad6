"""Architecture registry of the served models (the twin of ``repro.configs``).

``get_config(arch_id)`` / ``get_reduced(arch_id)`` resolve the public
architecture id, e.g. ``--arch qwen3-8b``.  The port covers the two
decoder-only text models that fit one 80 GB card at full width with more
than one decode slot, plus Qwen3-8B's sliding-window variant; every other
id of the reference waits for ROADMAP A14.
"""
from __future__ import annotations

from repro_torch.configs import mamba2_370m, qwen3_8b

_MODULES = {m.ARCH_ID: m for m in (mamba2_370m, qwen3_8b)}

ARCH_IDS = tuple(_MODULES)

_VARIANTS = {
    "qwen3-8b-swa": lambda dtype="bfloat16": qwen3_8b.sliding_window_variant(dtype),
}


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP A14); "
            f"the port serves {sorted(_MODULES) + sorted(_VARIANTS)}"
        ) from None


def get_config(arch_id: str, dtype: str = "bfloat16"):
    if arch_id in _VARIANTS:
        return _VARIANTS[arch_id](dtype)
    return _module(arch_id).config(dtype)


def get_reduced(arch_id: str, dtype: str = "float32"):
    return _module(arch_id.removesuffix("-swa")).reduced(dtype)


__all__ = ["ARCH_IDS", "get_config", "get_reduced"]
