"""Shapes of every model input (the twin of ``repro.launch.input_specs``).

* train: ``local_batches`` leaves are (T_o, A, b, ...) and ``comm_batch``
  leaves (A, b, ...), where A = n_agents and b = global_batch // A; on a rank
  mesh each rank takes its own slice of the agent axis
  (:func:`repro_torch.launch.mesh.rank_slice`);
* prefill: batch leaves (B, ...) with B = global_batch;
* decode: one token (B, 1) beside the cache.

The frontends are stubs, as in the reference: an audio batch carries
precomputed frame embeddings (b, seq // 4, d_model) beside its tokens; a VLM
batch carries patch embeddings (b, seq // 8, d_model) that prefix seq - seq
// 8 tokens, and M-RoPE position ids (3, b, seq).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import dtype_of


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _per_agent_batch(cfg: ModelConfig, b: int, seq: int) -> Dict[str, TensorSpec]:
    """The loss function's batch of one agent (leaves (b, ...))."""
    if cfg.is_enc_dec:
        return {"frames": TensorSpec((b, seq // 4, cfg.d_model), dtype_of(cfg)),
                "tokens": TensorSpec((b, seq), torch.int32)}
    if cfg.modality == "vlm":
        n_patch = seq // 8
        return {"tokens": TensorSpec((b, seq - n_patch), torch.int32),
                "prefix_embeds": TensorSpec((b, n_patch, cfg.d_model), dtype_of(cfg)),
                "positions": TensorSpec((3, b, seq), torch.int32)}
    return {"tokens": TensorSpec((b, seq), torch.int32)}


def train_inputs(cfg: ModelConfig, shape: InputShape, n_agents: int,
                 t_o: int) -> Tuple[Dict[str, TensorSpec], Dict[str, TensorSpec]]:
    """(local_batches, comm_batch) shapes."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a train shape")
    if shape.global_batch % n_agents:
        raise ValueError(f"global_batch {shape.global_batch} must divide across "
                         f"{n_agents} agents")
    per = _per_agent_batch(cfg, shape.global_batch // n_agents, shape.seq_len)
    comm = {k: TensorSpec((n_agents,) + s.shape, s.dtype) for k, s in per.items()}
    local = {k: TensorSpec((t_o,) + s.shape, s.dtype) for k, s in comm.items()}
    return local, comm


def prefill_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    """The prefill batch (leaves (B, ...))."""
    if shape.kind != "prefill":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a prefill shape")
    return _per_agent_batch(cfg, shape.global_batch, shape.seq_len)


def decode_token_input(shape: InputShape) -> TensorSpec:
    """The decode step's token (B, 1)."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a decode shape")
    return TensorSpec((shape.global_batch, 1), torch.int32)


def materialize(spec, device: torch.device):
    """Empty tensors of a tree of :class:`TensorSpec` on ``device`` (the
    dry run's meta stand-ins)."""
    if isinstance(spec, TensorSpec):
        return torch.empty(spec.shape, dtype=spec.dtype, device=device)
    return {k: materialize(v, device) for k, v in spec.items()}
