"""Device choice of the port's entry points.

Every entry point (``generate``, ``build_problem``, ``make_solver``) takes a
``device``.  Left out, it means the CUDA card; without one the call raises
instead of running on the CPU unnoticed.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU, as the tests do.

The logreg path draws nothing from ``torch.Generator``: its data and its
rounds come from JAX's threefry (:mod:`repro_torch.utils.threefry`), the
same bits on either device.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.  Raises when
    CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
