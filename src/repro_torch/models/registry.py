"""Model registry: one interface over the ported decoder-only families (the
twin of ``repro.models.registry``).

``ModelBundle`` is what the serving engine consumes: init / init_cache /
prefill / decode bound to one configuration and one device.  Training
(``loss``) is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Tree = Any


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> Tree:
        return T.init_lm(self.cfg, seed=seed, device=self.device)

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        return T.init_cache(self.cfg, batch, max_seq, self.device)

    def prefill(self, params: Tree, batch: Dict, cache: Dict, *,
                use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
        return T.lm_prefill(params, self.cfg, batch["tokens"], cache,
                            prefix_embeds=batch.get("prefix_embeds"),
                            positions=batch.get("positions"), use_kernels=use_kernels)

    def decode(self, params: Tree, token: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        return T.lm_decode(params, self.cfg, token, cache)

    def decode_slots(self, slot_params: Tree, tokens: torch.Tensor,
                     cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """One decode step of every slot, each under its own parameters."""
        return T.lm_decode(slot_params, self.cfg, tokens, cache, slotted=True)

    def loss(self, params: Tree, batch: Dict) -> torch.Tensor:
        raise NotImplementedError("LM training (lm_loss) is not ported yet (ROADMAP A14)")


def get_bundle(cfg: ModelConfig, device: DeviceLike = None) -> ModelBundle:
    """The bundle of a decoder-only configuration on ``device`` (CUDA when
    none is given)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the index tensors report
        dev = torch.device("cuda", torch.cuda.current_device())
    return ModelBundle(cfg=cfg, device=dev)
