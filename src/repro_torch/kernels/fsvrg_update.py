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

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fsvrg_update: {msg}")


def _operand(x: torch.Tensor, name: str, w: torch.Tensor,
             may_share_row: bool) -> int:
    """Check one input against w; return its row stride in elements (d, or
    0 for a (d,) row shared by all rows of a 2-D w)."""
    _require(isinstance(x, torch.Tensor) and x.device == w.device,
             f"{name} must be a tensor on {w.device}")
    _require(x.dtype == w.dtype, f"{name} must have w's dtype {w.dtype}")
    _require(x.is_contiguous(), f"{name} must be contiguous")
    if x.shape == w.shape:
        return w.shape[-1]
    _require(may_share_row and w.dim() == 2 and x.shape == w.shape[-1:],
             f"{name} has shape {tuple(x.shape)}, expected {tuple(w.shape)}"
             + (f" or ({w.shape[-1]},)" if may_share_row else ""))
    return 0


def fsvrg_update(w: torch.Tensor, s: torch.Tensor, g_new: torch.Tensor,
                 g_old: torch.Tensor, g_bar: torch.Tensor,
                 h: Union[float, torch.Tensor], *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w, g_new: (d,) or (R, d), float32 or bfloat16, contiguous;
    s, g_old, g_bar: the same, or a shared (d,) row; h: a float, a one-value
    f32 tensor, or an (R,) f32 tensor.  Writes to ``out`` (which may be
    ``w``) or to a new tensor, and returns it."""
    _require(isinstance(w, torch.Tensor) and w.is_cuda,
             "w must be a CUDA tensor")
    _require(w.dtype in _DTYPES,
             f"w must be float32 or bfloat16, got {w.dtype}")
    _require(w.dim() in (1, 2) and w.is_contiguous() and w.numel() > 0,
             "w must be a non-empty contiguous (d,) or (R, d) tensor, got "
             f"{tuple(w.shape)}")
    R = w.shape[0] if w.dim() == 2 else 1
    d = w.shape[-1]
    s_stride = _operand(s, "s", w, True)
    _operand(g_new, "g_new", w, False)
    go_stride = _operand(g_old, "g_old", w, True)
    gb_stride = _operand(g_bar, "g_bar", w, True)
    if isinstance(h, torch.Tensor):
        _require(h.device == w.device and h.dtype == torch.float32
                 and h.is_contiguous(), "a tensor h must be contiguous "
                 "float32 on w's device")
        _require(h.numel() == 1 or (w.dim() == 2 and h.shape == (R,)),
                 f"h must hold one value or one per row ({R},), got "
                 f"{tuple(h.shape)}")
        h_ptr, h_value, h_stride = h.data_ptr(), 0.0, int(h.numel() > 1)
    else:
        h_ptr, h_value, h_stride = None, float(h), 0
    if out is None:
        out = torch.empty_like(w)
    else:
        _require(out.shape == w.shape and out.dtype == w.dtype
                 and out.device == w.device and out.is_contiguous(),
                 "out must be a contiguous tensor like w")

    launch = _build.launcher("fsvrg_update")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = launch(w.data_ptr(), s.data_ptr(), g_new.data_ptr(),
                     g_old.data_ptr(), g_bar.data_ptr(), _DTYPES[w.dtype],
                     h_ptr, h_value, out.data_ptr(), R, d, s_stride,
                     go_stride, gb_stride, h_stride, stream)
    _build.check(err, "fsvrg_update")
    fsvrg_update.launches += 1
    return out


fsvrg_update.launches = 0
