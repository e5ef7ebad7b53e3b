"""CUDA wrapper of the fused DANE local step (``csrc/dane_update.cu``; it
replaces the reference's TPU kernel ``kernels/dane_update.py:dane_update``):

    w ← (1 − lr(λ+µ)) · w − lr · g + lr · a + lr·µ · w^t

over one (d,) vector or an (R, d) batch of client iterates; ``w^t`` may be
one (d,) row shared by every row, and ``lr``, ``λ``, ``µ`` are scalars.  The
launch is counted in ``dane_update.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain version
in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _args, _build

_NAME = "dane_update"


def dane_update(w: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                w_t: torch.Tensor, lr: float, lam: float, mu: float, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w, g, a: (d,) or (R, d), float32 or bfloat16, contiguous; w_t: the
    same, or a shared (d,) row; lr, lam, mu: floats.  Writes to ``out``
    (which may be ``w``) or to a new tensor, and returns it."""
    R, d = _args.batch(_NAME, w)
    _args.operand(_NAME, g, "g", w, False)
    _args.operand(_NAME, a, "a", w, False)
    wt_stride = _args.operand(_NAME, w_t, "w_t", w, True)
    _args.require(_NAME, not any(isinstance(x, torch.Tensor)
                                 for x in (lr, lam, mu)),
                  "lr, lam and mu must be Python numbers")
    out = _args.output(_NAME, out, w)

    launch = _build.launcher(_NAME)
    with _args.on_card(w.device):
        err = launch(w.data_ptr(), g.data_ptr(), a.data_ptr(), w_t.data_ptr(),
                     _args.DTYPES[w.dtype], float(lr), float(lam), float(mu),
                     out.data_ptr(), R, d, wt_stride, _args.stream(w))
    _build.check(err, _NAME)
    dane_update.launches += 1
    return out


dane_update.launches = 0
