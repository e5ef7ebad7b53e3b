"""Device choice (:mod:`.device`), JAX's threefry (:mod:`.threefry`) and
device-independent f32 functions (:mod:`.floatmath`)."""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
