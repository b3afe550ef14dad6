"""The LM training sampler (the twin of ``repro.launch.train.make_lm_sampler``),
for every family: text, audio (frames beside the tokens) and VLM (patch
embeddings and M-RoPE ids).

The command line of the reference's ``launch/train.py`` waits for a later
slice (ROADMAP A17); ranks call :func:`repro_torch.launch.steps.build_train_steps`
directly.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import synthetic_lm_tokens
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import mrope_text_positions
from repro_torch.models.transformer import dtype_of

Batch = Dict[str, torch.Tensor]


def make_lm_sampler(cfg: ModelConfig, n_agents: int, batch: int, seq: int, t_o: int,
                    seed: int = 0) -> Callable[[int], Tuple[Batch, Batch]]:
    """Per-round sampler of ``(local_batches, comm_batch)``: token tensors
    (T_o, A, b, seq) and (A, b, seq), int32 on the CPU, bit-equal to the
    reference's for the same seed.  Each agent reads its own Zipf stream (a
    different seed per agent: the LM analogue of the paper's sorted-label
    split); every round draws all agents' windows from one shared numpy
    generator, so each rank draws them all and keeps its own slice.

    The stub frontends draw from the same generator after the tokens, as
    the reference's: a VLM's ``prefix_embeds`` (T_o, A, b, max(1, seq // 8),
    d_model) and the text-only M-RoPE ``positions`` (T_o, A, 3, b, seq +
    n_patch); an encoder-decoder's ``frames`` (T_o, A, b, max(1, seq // 4),
    d_model); in ``cfg.dtype``.  The comm batch takes the first local set of
    these (the reference's)."""
    streams = [synthetic_lm_tokens(200_000, cfg.vocab_size, seed=seed + 17 * i)
               for i in range(n_agents)]
    rng = np.random.default_rng(seed + 999)

    def batch_for(agent: int, b: int) -> np.ndarray:
        s = streams[agent]
        starts = rng.integers(0, len(s) - seq - 1, size=b)
        return np.stack([s[st:st + seq] for st in starts])

    def per_round(_k: int) -> Tuple[Batch, Batch]:
        toks = np.stack([np.stack([batch_for(a, batch) for a in range(n_agents)])
                         for _ in range(t_o + 1)])  # (T_o + 1, A, b, seq)
        local = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:t_o]))}
        comm = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[-1]))}
        if cfg.modality == "vlm":
            n_patch = max(1, seq // 8)
            local["prefix_embeds"] = embeds(n_patch)
            pos = mrope_text_positions(batch, seq + n_patch)
            local["positions"] = pos.expand((t_o, n_agents) + pos.shape).contiguous()
        if cfg.is_enc_dec:
            local["frames"] = embeds(max(1, seq // 4))
        for k in local.keys() - comm.keys():
            comm[k] = local[k][0]
        return local, comm

    def embeds(n: int) -> torch.Tensor:
        draw = rng.normal(size=(t_o, n_agents, batch, n, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(draw).to(dtype_of(cfg))

    return per_round
