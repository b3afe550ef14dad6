"""The gradient call that pod-as-agent made before each period gathered its
own parameters, kept as the oracle of ``test_torch_fsdp_layers`` and of
``tools/fsdp_gather_ab.py``: the agent's whole model shard gathered before
the call (``launch.steps.gather_leaves``), the gradient, then each sharded
leaf's gradient reduce-scattered and each whole one all-reduced, divided by
the data size; the loss the mean over the data ranks.  An MoE layer still
sizes and fills expert capacity over the agent's whole batch and takes its
load-balance loss's statistics from it, through a ``DataAxis`` that shards
no leaf."""
import dataclasses

import numpy as np
import torch

from repro_torch.launch import steps as S
from repro_torch.launch.mesh import DataAxis


def whole_gather_value_and_grad(bundle, mesh, dims):
    """``vg(shards, batch_share) -> (loss, grad shards)`` through the whole
    agent gathered at once; ``data_axis`` counts the MoE layers' collectives."""
    axis = DataAxis(mesh, dict.fromkeys(dims))
    vg = S.flat_value_and_grad(dataclasses.replace(bundle, fsdp=axis))
    n = mesh.shape["data"]

    def call(shards, batch):
        loss, grads = vg(S.gather_leaves(shards, dims, mesh), batch)
        out = {}
        with mesh.clock.span("scatter", mesh.device):
            for k in list(grads):
                g = grads.pop(k)
                red = (mesh.all_reduce_sum(g, ("data",)) if dims[k] is None
                       else mesh.reduce_scatter_sum(g, ("data",), dims[k]))
                out[k] = red / n
                del g, red
            loss = mesh.all_reduce_sum(loss.detach().to(torch.float32).reshape(1), ("data",))
        return (loss / n).reshape(()), out

    call.data_axis = axis
    return call


def reference_kept(flat_expert: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's kept entries of one routing group's flat (T·k,)
    expert ids: each expert's first ``cap`` in a stable sort by expert."""
    order = np.argsort(flat_expert, kind="stable")
    counts = np.bincount(flat_expert, minlength=n_experts)
    place = np.arange(flat_expert.size) - (np.cumsum(counts) - counts)[flat_expert[order]]
    kept = np.zeros(flat_expert.size, bool)
    kept[order] = place < cap
    return kept
