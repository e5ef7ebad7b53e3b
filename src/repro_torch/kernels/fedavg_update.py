"""CUDA wrapper of the fused FedAvg local step (``csrc/fedavg_update.cu``; it
replaces the reference's TPU kernel
``kernels/fedavg_update.py:fedavg_update``):

    w ← (1 − h·λ) · w − h · g

over one (d,) vector or an (R, d) batch of client iterates, with ``h`` a
scalar or one value per row (h = 0 leaves a row bit for bit as it was) and
``λ`` a scalar.  The launch is counted in ``fedavg_update.launches``.
Callers go through :mod:`repro_torch.kernels.ops`, which sends CPU tensors
to the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _args, _build

_NAME = "fedavg_update"


def fedavg_update(w: torch.Tensor, g: torch.Tensor,
                  h: Union[float, torch.Tensor], lam: float, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w, g: (d,) or (R, d), float32 or bfloat16, contiguous; h: a float, a
    one-value f32 tensor, or an (R,) f32 tensor; lam: a float.  Writes to
    ``out`` (which may be ``w``) or to a new tensor, and returns it."""
    R, d = _args.batch(_NAME, w)
    _args.operand(_NAME, g, "g", w, False)
    h_ptr, h_value, h_stride = _args.step_size(_NAME, h, w)
    _args.require(_NAME, not isinstance(lam, torch.Tensor),
                  "lam must be a Python number")
    out = _args.output(_NAME, out, w)

    launch = _build.launcher(_NAME)
    with _args.on_card(w.device):
        err = launch(w.data_ptr(), g.data_ptr(), _args.DTYPES[w.dtype], h_ptr,
                     h_value, float(lam), out.data_ptr(), R, d, h_stride,
                     _args.stream(w))
    _build.check(err, _NAME)
    fedavg_update.launches += 1
    return out


fedavg_update.launches = 0
