"""The LM training sampler (the twin of ``repro.launch.train.make_lm_sampler``).

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

Batch = Dict[str, torch.Tensor]


def make_lm_sampler(cfg: ModelConfig, n_agents: int, batch: int, seq: int, t_o: int,
                    seed: int = 0) -> Callable[[int], Tuple[Batch, Batch]]:
    """Per-round sampler of ``(local_batches, comm_batch)``: token tensors
    (T_o, A, b, seq) and (A, b, seq), int32 on the CPU, bit-equal to the
    reference's for the same seed.  Each agent reads its own Zipf stream (a
    different seed per agent: the LM analogue of the paper's sorted-label
    split); every round draws all agents' windows from one shared numpy
    generator, so each rank draws them all and keeps its own slice."""
    if cfg.is_enc_dec or cfg.modality != "text":
        raise NotImplementedError(f"{cfg.name}: audio / VLM batches are not ported yet "
                                  "(ROADMAP A14)")
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
        return ({"tokens": torch.from_numpy(np.ascontiguousarray(toks[:t_o]))},
                {"tokens": torch.from_numpy(np.ascontiguousarray(toks[-1]))})

    return per_round
