from repro_torch.models.config import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    config_from_dict,
    config_to_dict,
)
from repro_torch.models.registry import ModelBundle, get_bundle

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "ModelBundle",
    "config_from_dict",
    "config_to_dict",
    "get_bundle",
]
