"""Decode engine: one decode step multiplexed across per-agent deltas (the
twin of ``repro.serve.engine``).

The engine owns the device state of a fixed number of decode **slots**: a
slot-stacked KV/SSM cache (``bundle.init_cache(1, max_seq)`` with a leading
slot axis on every leaf, including the per-slot position counter) and, in
``materialize="admit"`` mode, a slot-stacked parameter buffer.  One
:meth:`step` advances *all* slots by one token.  The slot axis is a batch
dimension written out: every projection of the decode is one batched
product over the slots, each slot under its own agent's weights (what
``jax.vmap`` of the reference's decode over the slots lowered to), and each
slot's cache is written at its own position.

* ``materialize="admit"`` (default) — an agent's parameters are written into
  its slot's buffer once, at admission, leaf by leaf (no second dense copy
  of the model ever exists); decode steps read the buffer.
* ``materialize="step"`` — every decode step gathers the active agents'
  parameters anew; no persistent per-slot copies.

Both modes, and the dense-materialised baseline fleet, run the same gather
and the same decode, so their token streams are bit-identical.

Prefill runs per admitted request at batch 1, straight into the slot's
cache.  It launches the port's Hopper kernels: the flash-attention kernel
(K6) once per attention layer and the SSD scan kernel (K7) once per Mamba
layer — 36 launches per admitted Qwen3-8B request, 48 per Mamba2-370m
request, one K6 and seven K7 per Jamba period.  (The reference's prefill ran
neither of its Pallas kernels.)  Decode is plain PyTorch, as in the
reference; an MoE layer routes each slot's token on its own (capacity per
slot, as the reference's ``jax.vmap`` over the slots) and reads the chosen
experts' weights in place.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.registry import ModelBundle
from repro_torch.serve.delta import DenseFleet, FleetDelta
from repro_torch.utils.pytree import nest_map

Tree = Any

MATERIALIZE_MODES = ("admit", "step")


class DecodeEngine:
    """Fixed-slot continuous-decode engine over a personalised fleet.

    Device state: ``self.cache`` (slot-stacked), ``self.slot_params`` (admit
    mode only), ``self.agent_ids`` (host (S,) ints: slot -> agent).  The
    batcher decides which request occupies which slot and when; the engine
    only moves tensors."""

    def __init__(self, bundle: ModelBundle, fleet, *, n_slots: int = 4, max_seq: int = 128,
                 materialize: str = "admit"):
        cfg = bundle.cfg
        if cfg.is_enc_dec or cfg.modality != "text":
            raise ValueError(
                "DecodeEngine serves decoder-only text models "
                f"(got {cfg.name!r}: enc_dec={cfg.is_enc_dec}, modality={cfg.modality!r})"
            )
        if materialize not in MATERIALIZE_MODES:
            raise ValueError(f"materialize {materialize!r} not in {MATERIALIZE_MODES}")
        if not isinstance(fleet, (FleetDelta, DenseFleet)):
            raise TypeError(f"not a fleet: {type(fleet)}")
        if fleet.device != bundle.device:
            raise ValueError(f"fleet on {fleet.device}, model bundle on {bundle.device}")
        self.bundle = bundle
        self.fleet = fleet
        self.device = bundle.device
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.materialize = materialize

        self.agent_ids = np.zeros(self.n_slots, dtype=np.int64)
        cache1 = bundle.init_cache(1, self.max_seq)
        self.cache = nest_map(
            lambda t: t[None].expand((self.n_slots,) + tuple(t.shape)).clone(), cache1)
        self.slot_params: Optional[Tree] = None
        if self.materialize == "admit":
            # every slot starts on agent 0, as in the reference
            template, skip = ((fleet.base, 0) if isinstance(fleet, FleetDelta)
                              else (fleet.stacked, 1))
            self.slot_params = nest_map(
                lambda t: torch.empty((self.n_slots,) + tuple(t.shape[skip:]), dtype=t.dtype,
                                      device=t.device), template)
            for slot in range(self.n_slots):
                fleet.gather_into(self.slot_params, slot, 0)

    # -- lifecycle ----------------------------------------------------------

    def admit(self, slot: int, agent_id: int, prompt: np.ndarray, *,
              use_kernels: bool = True) -> np.ndarray:
        """Prefill ``prompt`` (1-D ints) for ``agent_id`` into ``slot``.

        Returns the last-position logits (V,) as float32 — the distribution
        the first generated token is drawn from.  ``use_kernels=False`` runs
        the prefill on the kernels' plain versions (for on-card checks)."""
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=self.device).reshape(1, -1)
        if self.materialize == "admit":
            self.fleet.gather_into(self.slot_params, slot, agent_id)
            params1 = nest_map(lambda t: t[slot], self.slot_params)
        else:
            params1 = nest_map(lambda t: t[0], self.fleet.gather([agent_id]))
        cache1 = nest_map(lambda t: t[slot], self.cache)  # views into the slot
        nest_map(lambda t: t.zero_(), cache1)
        logits, _ = self.bundle.prefill(params1, {"tokens": tokens}, cache1,
                                        use_kernels=use_kernels)
        self.agent_ids[slot] = agent_id
        return logits[0, -1].to(torch.float32).cpu().numpy()

    def step(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for all slots; ``tokens`` (S,) are each slot's
        previous token.  Returns float32 logits (S, V)."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device).reshape(self.n_slots, 1)
        if self.materialize == "admit":
            params = self.slot_params
        else:
            params = self.fleet.gather(self.agent_ids)
        logits, _ = self.bundle.decode_slots(params, toks, self.cache)
        return logits[:, 0].to(torch.float32).cpu().numpy()

    def synchronize(self) -> None:
        """Barrier for wall-clock measurement (the load loop's measured mode)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- accounting ---------------------------------------------------------

    def fleet_nbytes(self) -> int:
        return self.fleet.nbytes()

    def naive_fleet_nbytes(self) -> int:
        return self.fleet.naive_nbytes()
