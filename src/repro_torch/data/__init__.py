from repro_torch.data.federated import (
    FederatedDataset,
    RoundSampler,
    partition_iid,
    partition_sorted,
)
from repro_torch.data.synthetic import (
    synthetic_a9a,
    synthetic_cifar,
    synthetic_lm_tokens,
    synthetic_mnist,
)

__all__ = [
    "synthetic_a9a",
    "synthetic_mnist",
    "synthetic_cifar",
    "synthetic_lm_tokens",
    "partition_sorted",
    "partition_iid",
    "FederatedDataset",
    "RoundSampler",
]
