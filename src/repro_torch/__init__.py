"""PyTorch/CUDA port of the PISCO reproduction (the JAX package ``repro`` is
the reference it is held against).

Same module layout as ``repro``: ``core/`` (topologies, schedules, mixing,
compression, the PISCO round, drivers, the experiment API), ``data/``,
``models/`` (the paper's models and the decoder-only LMs), ``configs/``,
``serve/`` (personalised-fleet serving), ``kernels/`` (hand-written Hopper
kernels with plain PyTorch twins) and ``utils/``.  Agent-stacked state is a ``dict[str, Tensor]`` whose
leaves carry a leading agent axis and are walked in sorted-key order.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no GPU they raise (:func:`repro_torch.device.resolve_device`).
"""
