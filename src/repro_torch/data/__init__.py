from repro_torch.data.federated import FederatedDataset, RoundSampler

__all__ = ["FederatedDataset", "RoundSampler"]
