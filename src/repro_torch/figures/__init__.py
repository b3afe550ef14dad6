"""The paper's figures on the port: one module per reference script of
``benchmarks/`` (same name, same cells, same payload keys), driven through
the port's ``Experiment`` on the GPU (``device="cpu"`` to opt out).

    python -m repro_torch.figures.run --full          # paper scale, on the GPU
    python -m repro_torch.figures.run --device cpu    # quick sizes, on the CPU

Payloads go to ``artifacts/torch/<name>.json``, stamped with the device they
ran on (the card's name and power limit on a GPU).
"""
