"""Device choice and seeded random streams (see :mod:`.device`)."""
from repro_torch.utils.device import (DATA_STREAM, generator, resolve_device,
                                      stream_seed)

__all__ = ["DATA_STREAM", "generator", "resolve_device", "stream_seed"]
