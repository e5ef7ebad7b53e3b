"""CUDA wrapper of CoCoA+'s dual-coordinate solve (``csrc/cocoa_sdca.cu``;
it replaces the reference's TPU kernel
``kernels/cocoa_sdca.py:cocoa_sdca_update``): for each coordinate, a
fixed number of clipped Newton steps on

    m (β − β₀) + c (β − β₀)² + β log β + (1 − β) log(1 − β)

from β = clip(sigmoid(−m)), clipped to [1e-6, 1 − 1e-6].  The launch is
counted in ``cocoa_sdca_update.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain version
in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build

_NAME = "cocoa_sdca_update"


def cocoa_sdca_update(beta0: torch.Tensor, mcoef: torch.Tensor,
                      ccoef: torch.Tensor,
                      newton_iters: int = 12) -> torch.Tensor:
    """beta0, mcoef, ccoef: non-empty contiguous 1-D CUDA tensors of one
    length and one dtype (float32 or bfloat16).  Returns the new β in a new
    tensor like ``beta0``."""
    _args.require(_NAME, isinstance(beta0, torch.Tensor) and beta0.is_cuda,
                  "beta0 must be a CUDA tensor")
    _args.require(_NAME, beta0.dtype in _args.DTYPES,
                  f"beta0 must be float32 or bfloat16, got {beta0.dtype}")
    _args.require(_NAME, beta0.dim() == 1 and beta0.numel() > 0
                  and beta0.is_contiguous(),
                  "beta0 must be a non-empty contiguous 1-D tensor, got "
                  f"{tuple(beta0.shape)}")
    for x, name in ((mcoef, "mcoef"), (ccoef, "ccoef")):
        _args.operand(_NAME, x, name, beta0, False)
    _args.require(_NAME, int(newton_iters) >= 0,
                  "newton_iters must be non-negative")
    out = torch.empty_like(beta0)

    launch = _build.launcher("cocoa_sdca")
    with torch.cuda.device(beta0.device):
        err = launch(beta0.data_ptr(), mcoef.data_ptr(), ccoef.data_ptr(),
                     _args.DTYPES[beta0.dtype], out.data_ptr(), beta0.numel(),
                     int(newton_iters), _args.stream(beta0))
    _build.check(err, _NAME)
    cocoa_sdca_update.launches += 1
    return out


cocoa_sdca_update.launches = 0
