"""CUDA wrapper of the delta-native fused server aggregation
(``csrc/fused_aggregate.cu``; it replaces the reference's TPU kernel
``kernels/scaled_aggregate.py:fused_aggregate``):

    w ← w^t + A ⊙ (s · Σ_k weights_k · δ_k),      δ_k = w_k − w^t

:func:`fused_aggregate` launches the kernel on CUDA tensors and counts its
launches in ``fused_aggregate.launches``.  :func:`fused_accumulate`,
:func:`fused_epilogue` and :func:`scaled_aggregate` are thin wrappers over
it, as in the reference.  Callers go through :mod:`repro_torch.kernels.ops`,
which sends CPU tensors to the plain versions in ``ref.py``.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import _args, _build

COLS = 256            # columns per block (csrc/fused_aggregate.cu)
TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs
MIN_ROWS = 32         # fewest rows of K one split walks


def _require(cond: bool, msg: str) -> None:
    _args.require("fused_aggregate", cond, msg)


def splits_for(K: int, d: int) -> int:
    """How many parts the K axis is cut into: enough that the grid holds
    about TARGET_BLOCKS blocks, but no part shorter than MIN_ROWS rows.
    Depends on the shape only, so the summation order is fixed."""
    col_blocks = -(-d // COLS)
    splits = max(1, min(-(-K // MIN_ROWS), -(-TARGET_BLOCKS // col_blocks)))
    rows = -(-K // splits)
    return -(-K // rows)


def fused_aggregate(w_t: torch.Tensor, deltas: torch.Tensor,
                    weights: torch.Tensor, a_diag: torch.Tensor,
                    scale: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """w_t, a_diag: (d,) f32; deltas: (K, d) f32 or bf16, contiguous;
    weights: (K,) f32; scale: a float or a 0-d f32 tensor on the device.
    Returns a new (d,) f32 tensor."""
    K, d = _args.stack("fused_aggregate", deltas)
    dev = deltas.device
    for x, n, name in ((w_t, d, "w_t"), (a_diag, d, "a_diag"),
                       (weights, K, "weights")):
        _args.vector("fused_aggregate", x, n, name, dev)
    if isinstance(scale, torch.Tensor):
        _require(scale.device == dev and scale.dtype == torch.float32
                 and scale.numel() == 1,
                 "a tensor scale must be one float32 value on the device")
        scale_ptr, scale_value = scale.data_ptr(), 0.0
    else:
        scale_ptr, scale_value = None, float(scale)

    splits = splits_for(K, d)
    rows = -(-K // splits)
    partial = torch.empty((splits, d), dtype=torch.float32, device=dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    launch = _build.launcher("fused_aggregate")
    with torch.cuda.device(dev):
        err = launch(deltas.data_ptr(), _args.DTYPES[deltas.dtype],
                     weights.data_ptr(), w_t.data_ptr(), a_diag.data_ptr(),
                     scale_ptr, scale_value, partial.data_ptr(),
                     out.data_ptr(), K, d, rows, splits, _args.stream(deltas))
    _build.check(err, "fused_aggregate")
    fused_aggregate.launches += 1
    return out


fused_aggregate.launches = 0


def fused_accumulate(acc: torch.Tensor, deltas: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """acc + Σ_k weights_k δ_k: the kernel with an identity epilogue."""
    return fused_aggregate(acc, deltas, weights, torch.ones_like(acc), 1.0)


def fused_epilogue(w_t: torch.Tensor, acc: torch.Tensor, a_diag: torch.Tensor,
                   scale: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (s · acc): the kernel over one pre-reduced row."""
    return fused_aggregate(w_t, acc.reshape(1, -1).contiguous(),
                           torch.ones((1,), dtype=torch.float32,
                                      device=acc.device), a_diag, scale)


def scaled_aggregate(w_t: torch.Tensor, w_ks: torch.Tensor,
                     weights: torch.Tensor,
                     a_diag: torch.Tensor) -> torch.Tensor:
    """w^t + A ⊙ Σ_k weights_k (w_k − w^t): the iterate-consuming entry,
    which forms the deltas and calls the kernel."""
    return fused_aggregate(w_t, (w_ks - w_t[None, :]).contiguous(), weights,
                           a_diag, 1.0)
