"""Synthetic federated data (see :mod:`.synthetic`)."""
from repro_torch.data.synthetic import (DataSpec, FederatedDataset,
                                        VirtualDataset, data_spec,
                                        drifted_dataset, generate,
                                        make_client_batch,
                                        materialize_dataset,
                                        train_split_sizes, virtual_dataset)

__all__ = ["DataSpec", "FederatedDataset", "VirtualDataset", "data_spec",
           "drifted_dataset", "generate", "make_client_batch",
           "materialize_dataset", "train_split_sizes", "virtual_dataset"]
