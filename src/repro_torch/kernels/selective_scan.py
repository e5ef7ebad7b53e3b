"""CUDA wrapper of Mamba's selective scan (``csrc/selective_scan.cu``; it
replaces no TPU kernel: the reference scans in plain JAX,
``models/mamba.py:46-109``).

Per sequence, channel and state, from a start state h0 or zeros, in f32:

    dt = softplus(dt_pre + dt_bias),   A = −exp(a_log)
    h  = exp(dt·A)·h + (dt·B_t)·x
    y  = Σ_n h·C_t + x·d_skip

(:func:`ref.selective_scan_ref` is the plain version).  dt, a and b are
formed in the kernel, so neither a (B, S, di) dt nor a (B, S, di, N) tensor
is ever allocated: the outputs are y (B, S, di) and the last state (B, di,
N).  A call is counted in ``selective_scan.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
version.  There is no backward kernel yet (ROADMAP A11): a call that
autograd would have to differentiate raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.kernels import _args, _build

_NAME = "selective_scan"
#: the state size the kernel takes (csrc/selective_scan.cu: NS)
D_STATE = 16

_F32 = torch.float32


def _require(cond: bool, msg: Union[str, Callable[[], str]]) -> None:
    _args.require(_NAME, cond, msg)


def selective_scan(x: torch.Tensor, dt_pre: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: a non-empty (B, S, di) CUDA tensor of f32 or bf16 whose channels
    are contiguous (any batch and token strides); dt_pre: (B, S) f32, any
    strides; b, c: (B, S, N) f32 with N = 16 contiguous and one shape and
    strides (the halves of one (B, S, 2N) tensor are); dt_bias, d_skip:
    contiguous (di,) f32; a_log: contiguous (di, N) f32; h0: a contiguous,
    16-byte aligned (B, di, N) f32 start state or None for zeros.  Returns
    new tensors: y (B, S, di) f32 and the last state (B, di, N) f32."""
    _require(isinstance(x, torch.Tensor) and x.is_cuda,
             "x must be a CUDA tensor")
    _require(x.dtype in _args.DTYPES,
             lambda: f"x must be float32 or bfloat16, got {x.dtype}")
    _require(x.dim() == 3 and x.numel() > 0,
             lambda: f"x must be a non-empty (B, S, di) tensor, got "
             f"{tuple(x.shape)}")
    B, S, di = x.shape
    xs = _args.strides(x)
    _require(xs[2] in (0, 1), "x must have its channels contiguous")
    dev = x.device
    _require(isinstance(dt_pre, torch.Tensor) and dt_pre.device == dev
             and dt_pre.dtype == _F32 and dt_pre.shape == (B, S),
             lambda: f"dt_pre must be a ({B}, {S}) float32 tensor on {dev}")
    _require(isinstance(a_log, torch.Tensor) and a_log.device == dev
             and a_log.dtype == _F32 and a_log.shape == (di, D_STATE)
             and a_log.is_contiguous(),
             lambda: f"a_log must be a contiguous ({di}, {D_STATE}) float32 "
             f"tensor on {dev} (the kernel's state size is {D_STATE})")
    _args.vector(_NAME, dt_bias, di, "dt_bias", dev)
    _args.vector(_NAME, d_skip, di, "d_skip", dev)
    bs = _args.strides(b) if isinstance(b, torch.Tensor) else None
    for name, t in (("b", b), ("c", c)):
        _require(isinstance(t, torch.Tensor) and t.device == dev
                 and t.dtype == _F32 and t.shape == (B, S, D_STATE)
                 and _args.strides(t) == bs and bs[2] in (0, 1),
                 lambda name=name: f"{name} must be a ({B}, {S}, {D_STATE}) "
                 f"float32 tensor on {dev} with N contiguous, b and c of "
                 "one strides")
    _require(h0 is None or (isinstance(h0, torch.Tensor) and h0.device == dev
                            and h0.dtype == _F32
                            and h0.shape == (B, di, D_STATE)
                            and h0.is_contiguous()
                            and h0.data_ptr() % 16 == 0),
             lambda: f"h0 must be a contiguous, 16-byte aligned ({B}, {di}, "
             f"{D_STATE}) float32 tensor on {dev} or None")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt_pre, dt_bias, a_log, b, c, d_skip, h0)):
        raise NotImplementedError(
            f"{_NAME}: the backward kernel is not ported yet (ROADMAP A11); "
            "call it under torch.no_grad")
    y = torch.empty((B, S, di), dtype=_F32, device=dev)
    h_last = torch.empty((B, di, D_STATE), dtype=_F32, device=dev)
    dts = _args.strides(dt_pre)
    launch = _build.launcher(_NAME)
    with _args.on_card(dev):
        err = launch(x.data_ptr(), _args.DTYPES[x.dtype], xs[0], xs[1],
                     dt_pre.data_ptr(), dts[0], dts[1], dt_bias.data_ptr(),
                     a_log.data_ptr(), b.data_ptr(), c.data_ptr(), bs[0],
                     bs[1], d_skip.data_ptr(),
                     None if h0 is None else h0.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), B, S, di, D_STATE, _args.stream(x))
    _build.check(err, _NAME)
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
