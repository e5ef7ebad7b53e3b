"""The shared building blocks the port's model stack uses so far: the
initializer and RMSNorm (the reference's ``models/layers.py``; attention,
RoPE, MLPs and the LM-head loss come with the other families and the
training slice, ROADMAP A11)."""
from __future__ import annotations

from typing import Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """normal(shape) · scale/√fan_in with fan_in = shape[0], drawn in f32
    from ``gen`` on its device, then cast to ``dtype``.  Not the
    reference's bits (its threefry normals); weights cross between the
    packages through :mod:`repro_torch.bridge`."""
    std = scale / (shape[0] ** 0.5)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype.  Serving only: no custom backward (the training slice's)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)
