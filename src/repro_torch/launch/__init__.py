"""Launching PISCO across ranks: rank meshes over ``torch.distributed``, the
per-rank train step builders, the training inputs and their sampler; and the
serving launcher (``python -m repro_torch.launch.serve``)."""
