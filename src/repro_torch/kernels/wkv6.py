"""CUDA wrapper of the RWKV-6 chunk-parallel WKV (``csrc/wkv6.cu``; it
replaces the reference's TPU kernel ``kernels/wkv6.py:wkv6``).

From a given start state or zeros, per (batch·head) pair and chunk of
length ``chunk``:

    out = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
    S  ← diag(c_L) (S + k_tᵀ v)

with c = cumprod(w) along the chunk, r_t = r ⊙ c_prev and
k_t = k / max(c, 1e-30) (:func:`ref.wkv6_ref` is the plain version).  The
launch is counted in ``wkv6.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels.ref import WKV_CHUNK

_NAME = "wkv6"

#: the kernel's limits (csrc/wkv6.cu: MAX_D, MAX_L)
MAX_HEAD_DIM = 64
MAX_CHUNK = 32


def _require(cond: bool, msg: str) -> None:
    _args.require(_NAME, cond, msg)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int = WKV_CHUNK, *,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: contiguous (BH, S, D) CUDA tensors of one dtype, f32 or
    bf16, D ≤ 64; u: (BH, D), f32 or r's dtype; ``state``: the start state,
    a contiguous (BH, D, D) f32 tensor, or None for zeros.  S must be a
    multiple of ``chunk`` ≤ 32 (``ValueError``).  Returns new tensors out
    (BH, S, D) in r's dtype and the final state (BH, D, D) in f32."""
    _require(isinstance(r, torch.Tensor) and r.is_cuda,
             "r must be a CUDA tensor")
    _require(r.dtype in _args.DTYPES,
             f"r must be float32 or bfloat16, got {r.dtype}")
    _require(r.dim() == 3 and r.is_contiguous() and r.numel() > 0,
             f"r must be a non-empty contiguous (BH, S, D) tensor, got "
             f"{tuple(r.shape)}")
    BH, S, D = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        _require(isinstance(x, torch.Tensor) and x.device == r.device
                 and x.dtype == r.dtype and x.shape == r.shape
                 and x.is_contiguous(),
                 f"{name} must be a contiguous {r.dtype} tensor of r's shape "
                 f"{tuple(r.shape)} on {r.device}")
    _require(isinstance(u, torch.Tensor) and u.device == r.device
             and u.dtype in (torch.float32, r.dtype) and u.shape == (BH, D),
             f"u must be a ({BH}, {D}) float32 or {r.dtype} tensor on "
             f"{r.device}, got {tuple(u.shape)}")
    _require(state is None
             or (isinstance(state, torch.Tensor) and state.device == r.device
                 and state.dtype == torch.float32
                 and state.shape == (BH, D, D) and state.is_contiguous()),
             f"state must be a contiguous ({BH}, {D}, {D}) float32 tensor on "
             f"{r.device} or None")
    _require(D <= MAX_HEAD_DIM, f"head dimension {D} exceeds {MAX_HEAD_DIM}")
    _require(1 <= chunk <= MAX_CHUNK, f"chunk must be in [1, {MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")

    u32 = u.to(torch.float32).contiguous()
    out = torch.empty_like(r)
    final = torch.empty((BH, D, D), dtype=torch.float32, device=r.device)
    launch = _build.launcher(_NAME)
    with _args.on_card(r.device):
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u32.data_ptr(), None if state is None else state.data_ptr(),
                     _args.DTYPES[r.dtype], out.data_ptr(), final.data_ptr(),
                     BH, S, D, chunk, _args.stream(r))
    _build.check(err, _NAME)
    wkv6.launches += 1
    return out, final


wkv6.launches = 0
