"""PyTorch/CUDA port of the PISCO reproduction (the JAX package ``repro`` is
the reference it is held against).

Same module layout as ``repro``: ``core/`` (topologies, schedules, mixing,
compression, the PISCO round, drivers, the experiment API), ``data/``,
``models/`` (the paper's models and the decoder-only LMs), ``configs/``,
``serve/`` (personalised-fleet serving), ``launch/`` (PISCO across ranks of
``torch.distributed``, one agent per rank, and the serving launcher),
``kernels/`` (hand-written Hopper kernels with plain PyTorch twins),
``checkpoint/`` (the reference's file format), ``obs/`` (tracing, metrics,
profiling and the regression gate) and ``utils/``; each package exports the
reference's public names.  Agent-stacked state is a
``dict[str, Tensor]`` whose leaves carry a leading agent axis and are walked
in sorted-key order; a rank's own state has no agent axis.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no GPU they raise (:func:`repro_torch.device.resolve_device`).
"""
