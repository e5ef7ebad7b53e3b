"""CUDA wrapper of the RWKV-6 chunk-parallel WKV (``csrc/wkv6.cu``; it
replaces the reference's TPU kernel ``kernels/wkv6.py:wkv6``).

From a given start state or zeros, per (batch, head) pair and chunk of
length ``chunk``:

    out = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
    S  ← diag(c_L) (S + k_tᵀ v)

with c = cumprod(w) along the chunk, r_t = r ⊙ c_prev and
k_t = k / max(c, 1e-30) (:func:`ref.wkv6_ref` is the plain version).  Two
layouts, one kernel:

* (BH, S, D) contiguous, u (BH, D), state (BH, D, D) — the TPU kernel's;
* (B, S, Hn, D), the model's, with D contiguous and any batch, token and
  head strides (a slice ``t[:, :n]`` of the projections is read in place),
  u (Hn, D), state (B, Hn, D, D); out is a new contiguous (B, S, Hn, D).

The launch is counted in ``wkv6.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
version.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels.ref import WKV_CHUNK

_NAME = "wkv6"

#: the kernel's limits (csrc/wkv6.cu: DC, LC)
MAX_HEAD_DIM = 64
MAX_CHUNK = 32


def _require(cond: bool, msg: Union[str, Callable[[], str]]) -> None:
    _args.require(_NAME, cond, msg)


def _strides(x: torch.Tensor) -> Tuple[int, ...]:
    """x's strides, 0 along a dimension of size 1 (never stepped)."""
    return tuple(st if n > 1 else 0 for n, st in zip(x.shape, x.stride()))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int = WKV_CHUNK, *,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: CUDA tensors of one dtype (f32 or bf16) and one shape
    and strides, either contiguous (BH, S, D) with u (BH, D) and ``state``
    (BH, D, D), or (B, S, Hn, D) with D contiguous, u (Hn, D) and
    ``state`` (B, Hn, D, D); D ≤ 64.  u: f32 or r's dtype; ``state``: the
    start state, a contiguous f32 tensor, or None for zeros.  S must be a
    multiple of ``chunk`` ≤ 32 (``ValueError``).  Returns new tensors: out
    in r's layout (contiguous) and dtype, and the final state in f32."""
    _require(isinstance(r, torch.Tensor) and r.is_cuda,
             "r must be a CUDA tensor")
    _require(r.dtype in _args.DTYPES,
             lambda: f"r must be float32 or bfloat16, got {r.dtype}")
    _require(r.dim() in (3, 4) and r.numel() > 0,
             lambda: "r must be a non-empty (BH, S, D) or (B, S, Hn, D) "
             f"tensor, got {tuple(r.shape)}")
    if r.dim() == 3:
        _require(r.is_contiguous(),
                 lambda: "a (BH, S, D) r must be contiguous")
        B, S, D = r.shape
        Hn = 1
        u_shape, s_shape = (B, D), (B, D, D)
        sb, ts, sh, u_bstride = S * D, D, D, D
    else:
        B, S, Hn, D = r.shape
        sb, ts, sh, sd = _strides(r)
        _require(sd in (0, 1), "a (B, S, Hn, D) r must have D contiguous")
        u_shape, s_shape = (Hn, D), (B, Hn, D, D)
        u_bstride = 0
    for name, x in (("k", k), ("v", v), ("w", w)):
        _require(isinstance(x, torch.Tensor) and x.device == r.device
                 and x.dtype == r.dtype and x.shape == r.shape
                 and _strides(x) == _strides(r),
                 lambda name=name: f"{name} must be a {r.dtype} tensor of "
                 f"r's shape {tuple(r.shape)} and strides {r.stride()} on "
                 f"{r.device}")
    _require(isinstance(u, torch.Tensor) and u.device == r.device
             and u.dtype in (torch.float32, r.dtype) and u.shape == u_shape,
             lambda: f"u must be a {u_shape} float32 or {r.dtype} tensor "
             f"on {r.device}, got {tuple(u.shape)}")
    _require(state is None
             or (isinstance(state, torch.Tensor) and state.device == r.device
                 and state.dtype == torch.float32
                 and state.shape == s_shape and state.is_contiguous()),
             lambda: f"state must be a contiguous {s_shape} float32 tensor "
             f"on {r.device} or None")
    _require(D <= MAX_HEAD_DIM, f"head dimension {D} exceeds {MAX_HEAD_DIM}")
    _require(1 <= chunk <= MAX_CHUNK, f"chunk must be in [1, {MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")

    u32 = u.to(torch.float32).contiguous()
    out = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    final = torch.empty(s_shape, dtype=torch.float32, device=r.device)
    launch = _build.launcher(_NAME)
    with _args.on_card(r.device):
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u32.data_ptr(), u_bstride,
                     None if state is None else state.data_ptr(),
                     _args.DTYPES[r.dtype], out.data_ptr(), final.data_ptr(),
                     B, Hn, S, D, chunk, sb, ts, sh, _args.stream(r))
    _build.check(err, _NAME)
    wkv6.launches += 1
    return out, final


wkv6.launches = 0
