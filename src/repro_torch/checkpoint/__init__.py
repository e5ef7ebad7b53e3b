"""Tree checkpoints in the reference's manifest-v3 format (see
:mod:`.checkpoint`)."""
from repro_torch.checkpoint.checkpoint import ChecksumError, restore, save

__all__ = ["ChecksumError", "restore", "save"]
