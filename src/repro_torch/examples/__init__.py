"""Runnable examples of the port (twins of the reference's ``examples/``):

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.semi_decentralized_cnn [--rounds 40] [--device cpu]
    python -m repro_torch.examples.train_federated_lm [--rounds 300] [--ckpt-dir D]
"""
