"""Device resolution and float-precision policy for every entry point."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_float_precision() -> None:
    """Full float32 everywhere: no TF32 in matmuls or cuDNN convolutions.

    cuDNN's TF32 default keeps ~3 decimal digits in float32 convolutions,
    which breaks parity with the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  Raises when CUDA is asked for and absent —
    there is no silent CPU continuation; pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    set_float_precision()
    return dev

