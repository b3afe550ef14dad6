"""Tree checkpoints in the reference's format (npz plus a JSON manifest), so
a checkpoint written by either package loads in the other."""
from repro_torch.checkpoint.checkpoint import (
    latest_checkpoint,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_checkpoint",
    "read_manifest",
]
