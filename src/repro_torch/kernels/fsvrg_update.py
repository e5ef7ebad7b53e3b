"""CUDA wrapper of the fused FSVRG local step (``csrc/fsvrg_update.cu``; it
replaces the reference's TPU kernel ``kernels/fsvrg_update.py:fsvrg_update``):

    w ← w − h · (S ⊙ (g_new − g_old) + ḡ)

over one (d,) vector or an (R, d) batch of client iterates.  ``S``,
``g_old`` and ``ḡ`` may be one (d,) row shared by every row, ``h`` a scalar
or one value per row.  The launch is counted in ``fsvrg_update.launches``.  Callers go
through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to the
plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _args, _build

_NAME = "fsvrg_update"


def fsvrg_update(w: torch.Tensor, s: torch.Tensor, g_new: torch.Tensor,
                 g_old: torch.Tensor, g_bar: torch.Tensor,
                 h: Union[float, torch.Tensor], *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w, g_new: (d,) or (R, d), float32 or bfloat16, contiguous;
    s, g_old, g_bar: the same, or a shared (d,) row; h: a float, a one-value
    f32 tensor, or an (R,) f32 tensor.  Writes to ``out`` (which may be
    ``w``) or to a new tensor, and returns it."""
    R, d = _args.batch(_NAME, w)
    s_stride = _args.operand(_NAME, s, "s", w, True)
    _args.operand(_NAME, g_new, "g_new", w, False)
    go_stride = _args.operand(_NAME, g_old, "g_old", w, True)
    gb_stride = _args.operand(_NAME, g_bar, "g_bar", w, True)
    h_ptr, h_value, h_stride = _args.step_size(_NAME, h, w)
    out = _args.output(_NAME, out, w)

    launch = _build.launcher(_NAME)
    with _args.on_card(w.device):
        err = launch(w.data_ptr(), s.data_ptr(), g_new.data_ptr(),
                     g_old.data_ptr(), g_bar.data_ptr(), _args.DTYPES[w.dtype],
                     h_ptr, h_value, out.data_ptr(), R, d, s_stride,
                     go_stride, gb_stride, h_stride, _args.stream(w))
    _build.check(err, _NAME)
    fsvrg_update.launches += 1
    return out


fsvrg_update.launches = 0
