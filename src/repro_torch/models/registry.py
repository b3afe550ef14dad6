"""Model registry: one interface over every family (the twin of
``repro.models.registry``).

``ModelBundle`` is what the serving engine and the trainer consume: init /
init_cache / prefill / decode / loss / value_and_grad bound to one
configuration and one device.  The encoder-decoder's (``cfg.is_enc_dec``)
is an :class:`EncDecBundle`: its cache holds the encoder memory, its
prefill runs the encoder and one decode step on the first token (the
reference's), and its batches carry ``frames``.

A bundle made with ``tp`` (an agent's
:class:`repro_torch.launch.mesh.ModelAxis`) runs every entry point on this
rank's model shard of the parameters and cache (tensor parallelism inside
the agent); its logits, losses and gradients are the whole model's, the
gradients each leaf's shard.  One made with ``fsdp`` (pod-as-agent's
:class:`repro_torch.launch.mesh.DataAxis`) takes this rank's data shards in
its loss and gradient, and gathers each period's parameters where the
period starts (training only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.utils.pytree import nest_leaves, nest_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    tp: Any = dataclasses.field(default=None, compare=False)
    idle: Any = dataclasses.field(default=None, compare=False)
    fsdp: Any = dataclasses.field(default=None, compare=False)

    def init(self, seed: int = 0, leaf_hook=None) -> Tree:
        """``leaf_hook``: see :func:`repro_torch.models.layers.seeded_generator`."""
        return T.init_lm(self.cfg, seed=seed, device=self.device, leaf_hook=leaf_hook)

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        return T.init_cache(self.cfg, batch, max_seq, self.device)

    def param_specs(self, model_axis: str = "model") -> Dict[str, tuple]:
        """Each parameter's placement over a mesh, keyed by its path: a
        tuple with one entry per dim (an axis name, a tuple of names, or
        None), the reference's ``PartitionSpec`` entries."""
        return T.lm_param_specs(self.cfg, model_axis)

    def cache_specs(self, batch_axes, model_axis: str = "model") -> Dict[str, tuple]:
        """Each cache leaf's placement, keyed by path: the batch over
        ``batch_axes`` (None: whole), heads or channels over
        ``model_axis``; the reference's ``bundle.cache_specs``."""
        return T.cache_specs(self.cfg, batch_axes, model_axis)

    def prefill(self, params: Tree, batch: Dict, cache: Dict, *,
                use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
        self._whole_sequence("prefill")
        return T.lm_prefill(params, self.cfg, batch["tokens"], cache,
                            prefix_embeds=batch.get("prefix_embeds"),
                            positions=batch.get("positions"), use_kernels=use_kernels,
                            tp=self.tp)

    def _whole_sequence(self, what: str) -> None:
        if self.idle is not None:
            raise ValueError(f"{what} runs on a whole cache: a bundle over idle axes decodes "
                             "only (its cache holds a block of the sequence)")

    def decode(self, params: Tree, token: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        return T.lm_decode(params, self.cfg, token, cache, tp=self.tp, idle=self.idle)

    def decode_slots(self, slot_params: Tree, tokens: torch.Tensor,
                     cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """One decode step of every slot, each under its own parameters."""
        return T.lm_decode(slot_params, self.cfg, tokens, cache, slotted=True)

    def loss(self, params: Tree, batch: Dict) -> torch.Tensor:
        return T.lm_loss(params, self.cfg, batch, tp=self.tp, fsdp=self.fsdp)

    def value_and_grad(self, params: Tree, batch: Dict) -> Tuple[torch.Tensor, Tree]:
        """``(loss, grads)`` of :meth:`loss` at ``params`` (the twin of
        ``jax.value_and_grad(bundle.loss)``): grads in each leaf's dtype, in
        the parameters' tree layout; nothing stays attached to a graph."""
        live = nest_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = self.loss(live, batch)
            grads = iter(torch.autograd.grad(loss, nest_leaves(live)))
        return loss.detach(), nest_map(lambda _: next(grads), params)


@dataclasses.dataclass(frozen=True)
class EncDecBundle(ModelBundle):
    """The encoder-decoder's bundle; batches are ``{"frames": (B, T,
    d_model), "tokens": (B, S)}``."""

    def init(self, seed: int = 0, leaf_hook=None) -> Tree:
        return E.init_encdec(self.cfg, seed=seed, device=self.device, leaf_hook=leaf_hook)

    def init_cache(self, batch: int, max_seq: int, mem_len: Optional[int] = None) -> Dict:
        """``mem_len`` defaults to ``max_seq``, as in the reference."""
        return E.init_encdec_cache(self.cfg, batch, max_seq, mem_len or max_seq, self.device)

    def param_specs(self, model_axis: str = "model") -> Dict[str, tuple]:
        return E.encdec_param_specs(self.cfg, model_axis)

    def cache_specs(self, batch_axes, model_axis: str = "model") -> Dict[str, tuple]:
        return E.encdec_cache_specs(self.cfg, batch_axes, model_axis)

    def prefill(self, params: Tree, batch: Dict, cache: Dict, *,
                use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
        """The encoder over ``batch["frames"]`` (K6 without the causal mask
        on every layer) into the cache's memory, then one decode step on
        ``batch["tokens"][:, :1]``; returns (logits (B, 1, V), cache at
        pos 1)."""
        self._whole_sequence("prefill")
        cache["memory"] = E.encode_prefill(params, self.cfg, batch["frames"],
                                           use_kernels=use_kernels, tp=self.tp)
        return E.encdec_decode_step(params, self.cfg, batch["tokens"][:, :1], cache, tp=self.tp)

    def decode(self, params: Tree, token: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        return E.encdec_decode_step(params, self.cfg, token, cache, tp=self.tp, idle=self.idle)

    def loss(self, params: Tree, batch: Dict) -> torch.Tensor:
        return E.encdec_loss(params, self.cfg, batch, tp=self.tp, fsdp=self.fsdp)


def get_bundle(cfg: ModelConfig, device: DeviceLike = None, tp: Any = None,
               idle: Any = None, fsdp: Any = None) -> ModelBundle:
    """The bundle of a configuration on ``device`` (CUDA when none is
    given): an :class:`EncDecBundle` for an encoder-decoder.  ``tp``: the
    agent's model axis when the bundle runs on a rank's model shard;
    ``idle``: a batch-1 decode's idle axes
    (:class:`repro_torch.launch.mesh.IdleAxis`), when its cache and experts
    are split over them (decode only); ``fsdp``: pod-as-agent's data axis
    (:class:`repro_torch.launch.mesh.DataAxis`), when its loss and gradient
    run on a rank's data shards (training only)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the index tensors report
        dev = torch.device("cuda", torch.cuda.current_device())
    return (EncDecBundle if cfg.is_enc_dec else ModelBundle)(cfg=cfg, device=dev, tp=tp,
                                                             idle=idle, fsdp=fsdp)
