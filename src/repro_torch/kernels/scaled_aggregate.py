"""CUDA wrapper of the delta-native fused server aggregation
(``csrc/fused_aggregate.cu``; it replaces the reference's TPU kernel
``kernels/scaled_aggregate.py:fused_aggregate``):

    w ← w^t + A ⊙ (s · Σ_k weights_k · δ_k),      δ_k = w_k − w^t

:func:`fused_aggregate` launches the kernel on CUDA tensors and counts its
launches in ``fused_aggregate.launches``.  :func:`fused_accumulate` is the
same kernel with an identity epilogue (the streamed and cohort rounds'
per-chunk entry) and :func:`fused_epilogue` the epilogue's own one-launch
entry (their rounds' last launch); each counts in its own ``launches``.
:func:`scaled_aggregate`, the iterate-consuming compatibility entry, counts
as the ``fused_aggregate`` launch it makes.
Callers go through :mod:`repro_torch.kernels.ops`, which sends CPU tensors
to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _args, _build

THREADS = 256     # threads a block (csrc/fused_aggregate.cu)
LANES = 32        # a warp: one unit of work is a warp on a strip of columns
MIN_ROWS = 32     # fewest rows of K one split walks

_Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call cuts the (K, d) stack: ``strips`` of LANES·vec columns
    × ``splits`` of at most ``rows`` rows, one warp a (strip, split)."""

    vec: int
    strips: int
    splits: int
    rows: int

    @property
    def units(self) -> int:
        return self.strips * self.splits


def plan(K: int, d: int, vec: int, warp_slots: int) -> Plan:
    """The grid rule: as many splits of K as leave every strip's units in
    one wave of the card's ``warp_slots`` resident warps, but no more than
    ⌈K / MIN_ROWS⌉, and none empty.  Depends on the shape and the card
    only, so the summation order is fixed."""
    strips = -(-(-(-d // vec)) // LANES)
    splits = max(1, min(warp_slots // strips, -(-K // MIN_ROWS)))
    rows = -(-K // splits)
    return Plan(vec, strips, -(-K // rows), rows)


def vec_for(deltas: torch.Tensor) -> int:
    """2 columns a lane when every row starts aligned to two elements (d
    even and an aligned base), else 1."""
    pair = 2 * deltas.element_size()
    aligned = deltas.shape[1] % 2 == 0 and deltas.data_ptr() % pair == 0
    return 2 if aligned else 1


_SLOTS: Dict[Tuple[int, int, int], int] = {}
_SCRATCH: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}


def warp_slots(dev: torch.device, dtype_code: int, vec: int) -> int:
    """Resident warps of the kernel on the whole card: SMs × its blocks a
    SM (the CUDA occupancy calculator) × warps a block; read once."""
    key = (dev.index, dtype_code, vec)
    if key not in _SLOTS:
        blocks = ctypes.c_int(0)
        with _args.on_card(dev):
            err = _build.launcher("fused_aggregate",
                                  "fused_aggregate_occupancy")(
                dtype_code, vec, ctypes.byref(blocks))
        _build.check(err, "fused_aggregate occupancy")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SLOTS[key] = sms * blocks.value * (THREADS // LANES)
    return _SLOTS[key]


def _scratch(dev: torch.device, splits: int, d: int) -> torch.Tensor:
    """The (splits, d) f32 partial sums of one shape, allocated once."""
    key = (dev, splits, d)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((splits, d), dtype=torch.float32,
                                    device=dev)
    return _SCRATCH[key]


def _require(cond: bool, msg: str) -> None:
    _args.require("fused_aggregate", cond, msg)


def _scale(scale: _Scalar, dev: torch.device) -> Tuple[Optional[int], float]:
    """A float, or a one-value f32 tensor on the device: (pointer, value)."""
    if isinstance(scale, torch.Tensor):
        _require(scale.device == dev and scale.dtype == torch.float32
                 and scale.numel() == 1,
                 "a tensor scale must be one float32 value on the device")
        return scale.data_ptr(), 0.0
    return None, float(scale)


def _aggregate(w_t: torch.Tensor, deltas: torch.Tensor, weights: torch.Tensor,
               a_diag: Optional[torch.Tensor], scale: _Scalar) -> torch.Tensor:
    """One launch of the kernel; ``a_diag`` None is the identity epilogue."""
    K, d = _args.stack("fused_aggregate", deltas)
    dev = deltas.device
    for x, n, name in ((w_t, d, "w_t"), (a_diag, d, "a_diag"),
                       (weights, K, "weights")):
        if x is not None:
            _args.vector("fused_aggregate", x, n, name, dev)
    scale_ptr, scale_value = _scale(scale, dev)
    code, vec = _args.DTYPES[deltas.dtype], vec_for(deltas)
    p = plan(K, d, vec, warp_slots(dev, code, vec))
    partial = _scratch(dev, p.splits, d)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    launch = _build.launcher("fused_aggregate")
    with _args.on_card(dev):
        err = launch(deltas.data_ptr(), code, p.vec, weights.data_ptr(),
                     w_t.data_ptr(),
                     None if a_diag is None else a_diag.data_ptr(),
                     scale_ptr, scale_value, partial.data_ptr(),
                     out.data_ptr(), K, d, p.strips, p.splits, p.rows,
                     _args.stream(deltas))
    _build.check(err, "fused_aggregate")
    return out


def fused_aggregate(w_t: torch.Tensor, deltas: torch.Tensor,
                    weights: torch.Tensor, a_diag: torch.Tensor,
                    scale: _Scalar = 1.0) -> torch.Tensor:
    """w_t, a_diag: (d,) f32; deltas: (K, d) f32 or bf16, contiguous;
    weights: (K,) f32; scale: a float or a 0-d f32 tensor on the device.
    Returns a new (d,) f32 tensor."""
    _require(a_diag is not None, "a_diag must be a tensor")
    out = _aggregate(w_t, deltas, weights, a_diag, scale)
    fused_aggregate.launches += 1
    return out


fused_aggregate.launches = 0


def fused_accumulate(acc: torch.Tensor, deltas: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """acc + Σ_k weights_k δ_k: the kernel with an identity epilogue."""
    out = _aggregate(acc, deltas, weights, None, 1.0)
    fused_accumulate.launches += 1
    return out


fused_accumulate.launches = 0


def fused_epilogue(w_t: torch.Tensor, acc: torch.Tensor, a_diag: torch.Tensor,
                   scale: _Scalar = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (s · acc) over a pre-reduced (d,) f32 row: one launch of
    the epilogue entry, one thread a column."""
    _args.require("fused_aggregate", isinstance(acc, torch.Tensor)
                  and acc.is_cuda, "acc must be a CUDA tensor")
    d, dev = acc.shape[-1], acc.device
    for x, name in ((acc, "acc"), (w_t, "w_t"), (a_diag, "a_diag")):
        _args.vector("fused_aggregate", x, d, name, dev)
    scale_ptr, scale_value = _scale(scale, dev)
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    launch = _build.launcher("fused_aggregate", "fused_epilogue_launch")
    with _args.on_card(dev):
        err = launch(w_t.data_ptr(), acc.data_ptr(), a_diag.data_ptr(),
                     scale_ptr, scale_value, out.data_ptr(), d,
                     _args.stream(acc))
    _build.check(err, "fused_epilogue")
    fused_epilogue.launches += 1
    return out


fused_epilogue.launches = 0


def scaled_aggregate(w_t: torch.Tensor, w_ks: torch.Tensor,
                     weights: torch.Tensor,
                     a_diag: torch.Tensor) -> torch.Tensor:
    """w^t + A ⊙ Σ_k weights_k (w_k − w^t): the iterate-consuming entry,
    which forms the deltas and calls the kernel."""
    return fused_aggregate(w_t, (w_ks - w_t[None, :]).contiguous(), weights,
                           a_diag, 1.0)
