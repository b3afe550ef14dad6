from repro_torch.models.config import (
    ModelConfig,
    SSMConfig,
    config_from_dict,
    config_to_dict,
)
from repro_torch.models.registry import ModelBundle, get_bundle

__all__ = [
    "ModelConfig",
    "SSMConfig",
    "ModelBundle",
    "config_from_dict",
    "config_to_dict",
    "get_bundle",
]
