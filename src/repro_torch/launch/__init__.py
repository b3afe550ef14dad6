"""Launching PISCO across ranks: rank meshes over ``torch.distributed``, the
per-rank train step builders, the training inputs and their sampler."""
