"""Argument checks shared by the CUDA wrappers.

Each check raises ``ValueError`` naming its kernel on what the kernel does
not take, before any pointer reaches the C launcher.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Optional, Tuple, Union

import torch

#: tensor dtype -> the launchers' dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def require(kernel: str, cond: bool, msg: Union[str, Callable[[], str]]
            ) -> None:
    """Raise ``ValueError`` naming ``kernel`` unless ``cond``.  A message
    that formats tensors is passed as a callable, so a check that passes
    formats nothing (a launch's host cost is most of a small kernel's
    time)."""
    if not cond:
        raise ValueError(f"{kernel}: {msg() if callable(msg) else msg}")


def batch(kernel: str, w: torch.Tensor) -> Tuple[int, int]:
    """Check the iterate ``w``: a non-empty contiguous (d,) or (R, d) CUDA
    tensor of f32 or bf16.  Returns (R, d), R = 1 for a vector."""
    require(kernel, isinstance(w, torch.Tensor) and w.is_cuda,
            "w must be a CUDA tensor")
    require(kernel, w.dtype in DTYPES,
            lambda: f"w must be float32 or bfloat16, got {w.dtype}")
    require(kernel, w.dim() in (1, 2) and w.is_contiguous() and w.numel() > 0,
            lambda: "w must be a non-empty contiguous (d,) or (R, d) tensor, "
            f"got {tuple(w.shape)}")
    return (w.shape[0] if w.dim() == 2 else 1), w.shape[-1]


def operand(kernel: str, x: torch.Tensor, name: str, w: torch.Tensor,
            may_share_row: bool) -> int:
    """Check one input against w; return its row stride in elements (d, or
    0 for a (d,) row shared by all rows of a 2-D w)."""
    require(kernel, isinstance(x, torch.Tensor) and x.device == w.device,
            lambda: f"{name} must be a tensor on {w.device}")
    require(kernel, x.dtype == w.dtype,
            lambda: f"{name} must have w's dtype {w.dtype}")
    require(kernel, x.is_contiguous(), lambda: f"{name} must be contiguous")
    if x.shape == w.shape:
        return w.shape[-1]
    require(kernel, may_share_row and w.dim() == 2
            and x.shape == w.shape[-1:],
            lambda: f"{name} has shape {tuple(x.shape)}, expected "
            f"{tuple(w.shape)}"
            + (f" or ({w.shape[-1]},)" if may_share_row else ""))
    return 0


def stack(kernel: str, deltas: torch.Tensor) -> Tuple[int, int]:
    """Check a stack of client deltas: a non-empty contiguous (K, d) CUDA
    matrix of f32 or bf16.  Returns (K, d)."""
    require(kernel, isinstance(deltas, torch.Tensor) and deltas.is_cuda,
            "deltas must be a CUDA tensor")
    require(kernel, deltas.dim() == 2 and deltas.is_contiguous(),
            lambda: "deltas must be a contiguous (K, d) matrix, got "
            f"{tuple(deltas.shape)}")
    require(kernel, deltas.dtype in DTYPES,
            lambda: f"deltas must be float32 or bfloat16, got {deltas.dtype}")
    K, d = deltas.shape
    require(kernel, K >= 1 and d >= 1, "deltas must be non-empty")
    return K, d


def vector(kernel: str, x: torch.Tensor, n: int, name: str,
           device: torch.device) -> None:
    """Check a contiguous f32 (n,) vector on ``device``."""
    require(kernel, isinstance(x, torch.Tensor) and x.device == device,
            lambda: f"{name} must be a tensor on {device}")
    require(kernel, x.dtype == torch.float32,
            lambda: f"{name} must be float32")
    require(kernel, x.shape == (n,) and x.is_contiguous(),
            lambda: f"{name} must be a contiguous ({n},) vector, got "
            f"{tuple(x.shape)}")


def step_size(kernel: str, h: Union[float, torch.Tensor], w: torch.Tensor
              ) -> Tuple[Optional[int], float, int]:
    """A float, a one-value f32 tensor, or one f32 value per row of a 2-D
    ``w``, as the launchers take it: (pointer or None, value, stride)."""
    if not isinstance(h, torch.Tensor):
        return None, float(h), 0
    require(kernel, h.device == w.device and h.dtype == torch.float32
            and h.is_contiguous(), "a tensor h must be contiguous float32 on "
            "w's device")
    R = w.shape[0] if w.dim() == 2 else 1
    require(kernel, h.numel() == 1 or (w.dim() == 2 and h.shape == (R,)),
            lambda: f"h must hold one value or one per row ({R},), got "
            f"{tuple(h.shape)}")
    return h.data_ptr(), 0.0, int(h.numel() > 1)


def output(kernel: str, out: Optional[torch.Tensor],
           w: torch.Tensor) -> torch.Tensor:
    """``out`` checked to be a contiguous tensor like ``w`` (it may be ``w``
    itself), or a new one."""
    if out is None:
        return torch.empty_like(w)
    require(kernel, out.shape == w.shape and out.dtype == w.dtype
            and out.device == w.device and out.is_contiguous(),
            "out must be a contiguous tensor like w")
    return out


def strides(x: torch.Tensor) -> Tuple[int, ...]:
    """x's strides in elements, 0 along a dimension of size 1 (never
    stepped), as the launchers that take strided views read them."""
    return tuple(st if n > 1 else 0 for n, st in zip(x.shape, x.stride()))


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s card, as the launchers take it
    (the raw handle, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def on_card(dev: torch.device) -> ContextManager:
    """The context a launch on ``dev`` runs in: ``dev`` made the current
    card, and nothing to switch when it already is (a launch's host cost
    is most of a small kernel's time)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
