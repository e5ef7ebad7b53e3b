"""Optimizers over dicts of named tensors (the reference's ``optim/``)."""
from repro_torch.optim.optimizers import Optimizer, adamw, get, momentum, sgd

__all__ = ["Optimizer", "adamw", "get", "momentum", "sgd"]
