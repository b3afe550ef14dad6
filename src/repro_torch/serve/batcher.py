"""Continuous batching: the request/slot state machine over a DecodeEngine
(the twin of ``repro.serve.batcher``).

The decode batch is **S slots** with independent lifecycles:

    FREE --admit(prefill + first token)--> ACTIVE --EOS / max-gen--> FREE

A slot is refilled the moment it frees up.  The batcher is pure policy: it
owns no device state beyond what the engine exposes, and no clock — the load
loop (:mod:`repro_torch.serve.load`) owns time and stamps the records.

Sampling: greedy argmax by default (exactly the reference's tokens for the
same logits).  With ``temperature > 0`` each request draws from its own
``torch.Generator``, seeded from ``(seed, _SAMPLE_TAG, rid)`` through
numpy's ``SeedSequence`` — domain-separated from every other stream and from
every other request, as the reference's ``fold_in(fold_in(key, tag), rid)``
is — and advanced once per token.  JAX's PRNG bits cannot be reproduced, so
the sampled tokens differ from the reference's; their distribution does not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import DecodeEngine

_SAMPLE_TAG = 0x5A3B1E  # domain tag of the sampling stream


@dataclasses.dataclass
class Request:
    """One generation request plus its recorded lifecycle.

    Timestamps are on the load loop's (simulated) clock, in seconds;
    ``prefill_s`` / ``decode_s`` accumulate the engine time attributed to this
    request, so ``latency = queue_wait + prefill + decode``."""

    rid: int
    agent_id: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_s: float = 0.0
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None  # the decode slot that served it

    @property
    def queue_wait_s(self) -> float:
        return (self.admit_s or 0.0) - self.arrival_s

    @property
    def latency_s(self) -> float:
        return (self.done_s or 0.0) - self.arrival_s

    def breakdown(self) -> dict:
        return {
            "rid": self.rid,
            "agent": self.agent_id,
            "slot": self.slot,
            "tokens": len(self.tokens),
            "queue_wait_s": self.queue_wait_s,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "latency_s": self.latency_s,
        }


def request_generator(seed: int, rid: int) -> torch.Generator:
    """The sampling stream of request ``rid``: pure in (seed, rid)."""
    state = np.random.SeedSequence([seed, _SAMPLE_TAG, rid]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


class ContinuousBatcher:
    """Admit-on-free-slot / evict-on-EOS-or-max-gen over a fixed-slot engine."""

    def __init__(self, engine: DecodeEngine, *, temperature: float = 0.0, seed: int = 0):
        self.engine = engine
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.slots: List[Optional[Request]] = [None] * engine.n_slots
        self._next_tok = np.zeros(engine.n_slots, dtype=np.int64)
        self._gens: Dict[int, torch.Generator] = {}
        self.completed: List[Request] = []

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        gen = self._gens.get(req.rid)
        if gen is None:
            gen = self._gens[req.rid] = request_generator(self.seed, req.rid)
        probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32) / self.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _emit(self, slot: int, req: Request, token: int) -> bool:
        """Record ``token`` for ``req``; evict if done.  Returns finished."""
        req.tokens.append(token)
        self._next_tok[slot] = token
        done = len(req.tokens) >= req.max_new_tokens or (
            req.eos_id is not None and token == req.eos_id)
        if done:
            self.slots[slot] = None
            self._gens.pop(req.rid, None)
            self.completed.append(req)
        return done

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot and emit its first token.  Returns
        True when the request already finished at admission."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("admit() with no free slot — check free_slots()")
        slot = free[0]
        logits = self.engine.admit(slot, req.agent_id, req.prompt)
        self.slots[slot] = req
        req.slot = slot
        return self._emit(slot, req, self._sample(req, logits))

    def step(self) -> List[Request]:
        """One decode step for every occupied slot; returns the requests that
        finished (their slots are already free)."""
        if not self.active:
            return []
        logits = self.engine.step(self._next_tok)
        finished = []
        for slot, req in enumerate(self.slots):
            if req is not None and self._emit(slot, req, self._sample(req, logits[slot])):
                finished.append(req)
        return finished
