"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in float32, with ordinary
tensor operations.  On a CPU tensor :mod:`repro_torch.kernels.ops` calls
these; on the card ``chip_smoke.py`` holds each kernel against them.  They
mirror the reference's ``kernels/ref.py`` oracles of the same names.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]

_F32 = torch.float32


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F32)


def _row_scalar(h: Scalar, w: torch.Tensor) -> Union[float, torch.Tensor]:
    """``h`` shaped to broadcast against ``w``: a scalar stays a scalar, an
    (R,) tensor becomes an (R, 1) column for an (R, d) ``w``."""
    if isinstance(h, torch.Tensor):
        h = _f32(h)
        return h[:, None] if h.dim() == 1 and w.dim() == 2 else h
    return float(h)


def fsvrg_update_ref(w: torch.Tensor, s: torch.Tensor, g_new: torch.Tensor,
                     g_old: torch.Tensor, g_bar: torch.Tensor, h: Scalar, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w − h (S ⊙ (g_new − g_old) + ḡ), computed in f32, cast to w's dtype.

    ``w``, ``s``, ``g_new`` are (d,) or (R, d); ``g_old`` and ``g_bar`` have
    that shape or are one (d,) row shared by all R rows; ``h`` is a scalar
    or, for an (R, d) ``w``, one step size per row.  With ``out`` the result
    is written there (it may be ``w`` itself)."""
    upd = _f32(s) * (_f32(g_new) - _f32(g_old)) + _f32(g_bar)
    res = (_f32(w) - _row_scalar(h, w) * upd).to(w.dtype)
    if out is None:
        return res
    return out.copy_(res)


def fused_aggregate_ref(w_t: torch.Tensor, deltas: torch.Tensor,
                        weights: torch.Tensor, a_diag: torch.Tensor,
                        scale: Scalar = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (scale · Σ_k weights_k δ_k), in f32."""
    agg = (_f32(deltas) * _f32(weights)[:, None]).sum(dim=0)
    s = _f32(scale) if isinstance(scale, torch.Tensor) else float(scale)
    return _f32(w_t) + _f32(a_diag) * (s * agg)


def fused_accumulate_ref(acc: torch.Tensor, deltas: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """acc + Σ_k weights_k δ_k, in f32 (the accumulate phase alone)."""
    return _f32(acc) + (_f32(deltas) * _f32(weights)[:, None]).sum(dim=0)


def fused_epilogue_ref(w_t: torch.Tensor, acc: torch.Tensor,
                       a_diag: torch.Tensor,
                       scale: Scalar = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (scale · acc), in f32 (the epilogue alone)."""
    s = _f32(scale) if isinstance(scale, torch.Tensor) else float(scale)
    return _f32(w_t) + _f32(a_diag) * (s * _f32(acc))


def scaled_aggregate_ref(w_t: torch.Tensor, w_ks: torch.Tensor,
                         weights: torch.Tensor,
                         a_diag: torch.Tensor) -> torch.Tensor:
    """w^t + A ⊙ Σ_k weights_k (w_k − w^t), in f32 (iterate-consuming)."""
    wt = _f32(w_t)
    delta = ((_f32(w_ks) - wt[None, :]) * _f32(weights)[:, None]).sum(dim=0)
    return wt + _f32(a_diag) * delta
