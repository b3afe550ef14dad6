"""Architecture registry of the served models (the twin of ``repro.configs``).

``get_config(arch_id)`` / ``get_reduced(arch_id)`` resolve the public
architecture id, e.g. ``--arch mixtral-8x7b``: the reference's ten models
(dense, MoE, MLA, SSM, hybrid, the encoder-decoder SeamlessM4T and the VLM
Qwen2-VL) and Qwen3-8B's sliding-window variant.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    granite_20b,
    jamba_v01_52b,
    mamba2_370m,
    mixtral_8x7b,
    nemotron_4_340b,
    qwen2_5_14b,
    qwen2_vl_2b,
    qwen3_8b,
    seamless_m4t_medium,
)

_MODULES = {
    m.ARCH_ID: m
    for m in (
        nemotron_4_340b,
        seamless_m4t_medium,
        qwen2_vl_2b,
        jamba_v01_52b,
        deepseek_v2_lite_16b,
        mamba2_370m,
        qwen3_8b,
        qwen2_5_14b,
        mixtral_8x7b,
        granite_20b,
    )
}

ARCH_IDS = tuple(_MODULES)

_VARIANTS = {
    "qwen3-8b-swa": lambda dtype="bfloat16": qwen3_8b.sliding_window_variant(dtype),
}


def get_config(arch_id: str, dtype: str = "bfloat16"):
    if arch_id in _VARIANTS:
        return _VARIANTS[arch_id](dtype)
    return _MODULES[arch_id].config(dtype)


def get_reduced(arch_id: str, dtype: str = "float32"):
    return _MODULES[arch_id.removesuffix("-swa")].reduced(dtype)


__all__ = ["ARCH_IDS", "get_config", "get_reduced"]
