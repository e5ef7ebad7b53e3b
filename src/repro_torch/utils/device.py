"""Device choice and the seeded random streams of the port.

Every entry point (``generate``, ``build_problem``, ``make_solver``) takes a
``device``.  Left out, it means the CUDA card; without one the call raises
instead of running on the CPU unnoticed.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU, as the tests do.

Random streams are ``torch.Generator`` objects on the device, seeded by
:func:`stream_seed`, a fixed 64-bit mix of ``(seed, stream)``:

* the data sampler draws from ``generator(seed, DATA_STREAM)``;
* round ``r`` of the Trainer draws from ``generator(seed, r)`` — the
  counterpart of the reference's ``fold_in(PRNGKey(seed), r)``.

The numbers differ from JAX's threefry, and a CUDA generator's from a CPU
generator's for the same seed, so tests feed both packages the same draws
instead of relying on the seed.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

#: stream id of the data sampler; round streams use ids 0, 1, 2, ...
DATA_STREAM = (1 << 62) + 0xDA7A

_MASK64 = (1 << 64) - 1


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


def stream_seed(seed: int, stream: int) -> int:
    """SplitMix64 of ``seed`` and ``stream``, folded into the 63 bits that
    ``torch.Generator.manual_seed`` accepts."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, stream: int,
              device: Optional[torch.device] = None) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with
    ``stream_seed(seed, stream)``."""
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(stream_seed(seed, stream))
    return g


def random_permutations(gen: torch.Generator, shape,
                        device: torch.device) -> torch.Tensor:
    """Independent random orders of ``range(shape[-1])``, one per leading
    index: ``argsort`` of uniforms drawn from ``gen`` on its own device,
    moved to ``device``.  int64."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return torch.argsort(u, dim=-1).to(device)
