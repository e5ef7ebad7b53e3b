"""CUDA wrapper of the coordinate-wise robust server aggregation
(``csrc/robust_aggregate.cu``; it replaces the reference's TPU kernel
``kernels/robust_aggregate.py:robust_aggregate``):

    w ← w^t + A ⊙ robust_agg({δ_k : valid_k})

with ``robust_agg`` the coordinate-wise trimmed mean or median over the
valid rows of the (K, d) delta stack (:func:`ref.robust_window` gives the
rank window).  One call is two launches: the valid rows are compacted on
the device, their count m is read back (the window and the columns a
block depend on it), and then a radix select finds each column's two
window edges among its m keys held in shared memory and sums the window
between them; no column is sorted.  The call is counted
once in ``robust_aggregate.launches``, and its m is kept in
``robust_aggregate.last_m``.  More than :data:`MAX_VALID` valid rows raise:
there is no fallback to the plain version.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build, ref

_NAME = "robust_aggregate"

#: the most valid rows one call takes: a block then holds one column's
#: 32,768 keys (128 KB) in shared memory (csrc/robust_aggregate.cu)
MAX_VALID = 32768


def _require(cond: bool, msg: str) -> None:
    _args.require(_NAME, cond, msg)


def robust_aggregate(w_t: torch.Tensor, deltas: torch.Tensor,
                     valid: torch.Tensor, a_diag: torch.Tensor,
                     trim: float = 0.1,
                     mode: str = "trimmed_mean") -> torch.Tensor:
    """w_t, a_diag: (d,) f32; deltas: (K, d) f32 or bf16, contiguous;
    valid: (K,) bool or {0, 1}, on the card.  Returns a new (d,) f32
    tensor."""
    K, d = _args.stack(_NAME, deltas)
    dev = deltas.device
    _args.vector(_NAME, w_t, d, "w_t", dev)
    _args.vector(_NAME, a_diag, d, "a_diag", dev)
    _require(isinstance(valid, torch.Tensor) and valid.device == dev
             and valid.shape == (K,), f"valid must be a ({K},) tensor on {dev}")
    _require(K < 2 ** 31, "K must fit in an int32 row index")

    # a bool mask is read as its bytes; any other is turned into one
    flags = (valid if valid.dtype == torch.bool and valid.is_contiguous()
             else (valid > 0).to(torch.uint8))
    idx = torch.empty((K,), dtype=torch.int32, device=dev)
    m_dev = torch.empty((1,), dtype=torch.int32, device=dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    stream = _args.stream(deltas)
    with _args.on_card(dev):
        err = _build.launcher(_NAME, "robust_compact_launch")(
            flags.data_ptr(), K, idx.data_ptr(), m_dev.data_ptr(), stream)
        _build.check(err, _NAME)
        m = int(m_dev.item())
        _require(m <= MAX_VALID,
                 f"{m} valid rows exceed the kernel's capacity of "
                 f"{MAX_VALID} (one column's keys in a block's shared "
                 "memory)")
        lo, hi = ref.robust_window(m, trim, mode)
        err = _build.launcher(_NAME)(
            w_t.data_ptr(), deltas.data_ptr(), _args.DTYPES[deltas.dtype],
            a_diag.data_ptr(), idx.data_ptr(), m, K, d, lo, hi,
            out.data_ptr(), stream)
    _build.check(err, _NAME)
    robust_aggregate.launches += 1
    robust_aggregate.last_m = m
    return out


robust_aggregate.launches = 0
robust_aggregate.last_m = None
