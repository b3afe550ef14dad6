"""Public surface of the ported kernels (the twin of ``repro.kernels.ops``).

Every function here dispatches on where its tensors lie: a CUDA tensor
launches the hand-written Hopper kernel (or raises), a CPU tensor runs the
plain PyTorch version of :mod:`repro_torch.kernels.ref`.  There is no
interpret switch and no fallback from one to the other.

``launch_counts()`` reads, and ``reset_launch_counts()`` zeroes, the number
of kernel launches per ported kernel since the last reset.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gt_update import fused_local_step, fused_track_step
from repro_torch.kernels.quantize import compressed_mix, row_absmax
from repro_torch.kernels.sparse_mix import (
    csr_from_edges,
    sparse_compressed_mix,
    sparse_compressed_mix_csr,
    sparse_mix,
    sparse_mix_csr,
    topology_edge_arrays,
)
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = [
    "fused_local_step",
    "fused_track_step",
    "row_absmax",
    "compressed_mix",
    "sparse_mix",
    "sparse_mix_csr",
    "sparse_compressed_mix",
    "sparse_compressed_mix_csr",
    "csr_from_edges",
    "topology_edge_arrays",
    "flash_attention",
    "ssd_scan",
    "launch_counts",
    "reset_launch_counts",
]


def launch_counts() -> Dict[str, int]:
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()
