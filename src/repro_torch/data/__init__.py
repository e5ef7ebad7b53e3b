"""Synthetic federated data (see :mod:`.synthetic`)."""
from repro_torch.data.synthetic import (DataSpec, FederatedDataset, data_spec,
                                        generate, train_split_sizes)

__all__ = ["DataSpec", "FederatedDataset", "data_spec", "generate",
           "train_split_sizes"]
