"""Hand-written Hopper kernels of the port (CUDA sources in ``csrc/``), each
with a plain PyTorch twin in :mod:`.ref`; :mod:`.ops` is the public surface
with the launch counters.  Importing this package builds nothing and needs
no CUDA: a kernel is built on its first launch on a CUDA tensor.

The reference's names, where the port has the same function: ``ops``,
``ref``, ``flash_attention`` (K6), ``fused_local_step`` (K1),
``fused_mix_combine`` (K8), ``rowwise_quant_dequant`` (K9), ``sparse_mix``
(K4), ``sparse_compressed_mix`` (K5) and ``topology_edge_arrays``.  As in the
reference, the functions ``flash_attention`` and ``sparse_mix`` shadow their
modules' names here: import from ``repro_torch.kernels.sparse_mix`` for the
module's other functions.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gt_update import fused_local_step, fused_mix_combine
from repro_torch.kernels.quantize import rowwise_quant_dequant
from repro_torch.kernels.sparse_mix import (
    sparse_compressed_mix,
    sparse_mix,
    topology_edge_arrays,
)

__all__ = [
    "ops", "ref", "flash_attention", "fused_local_step", "fused_mix_combine",
    "rowwise_quant_dequant", "sparse_mix", "sparse_compressed_mix", "topology_edge_arrays",
]
