"""CUDA wrappers of CoCoA+'s local SDCA (``csrc/cocoa_sdca.cu``; they
replace the reference's TPU kernel ``kernels/cocoa_sdca.py:cocoa_sdca_update``
and the ``lax.scan`` that launches it once a step):

* :func:`cocoa_sdca_update` — for each coordinate, a fixed number of
  clipped Newton steps on

      m (β − β₀) + c (β − β₀)² + β log β + (1 − β) log(1 − β)

  from β = clip(sigmoid(−m)), clipped to [1e-6, 1 − 1e-6];
* :func:`cocoa_sdca_pass` — a bucket's whole permutation pass of SDCA in
  one launch, one warp a client, with the same Newton routine.

Each counts its launches in its ``launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build

_NAME = "cocoa_sdca_update"
_PASS = "cocoa_sdca_pass"
#: entries of a row a lane may hold (csrc/cocoa_sdca.cu's EPL), so
#: nnz ≤ 32 · 8
_EPL = (1, 2, 4, 8)


def cocoa_sdca_update(beta0: torch.Tensor, mcoef: torch.Tensor,
                      ccoef: torch.Tensor,
                      newton_iters: int = 12) -> torch.Tensor:
    """beta0, mcoef, ccoef: non-empty contiguous 1-D CUDA tensors of one
    length and one dtype (float32 or bfloat16).  Returns the new β in a new
    tensor like ``beta0``."""
    _args.require(_NAME, isinstance(beta0, torch.Tensor) and beta0.is_cuda,
                  "beta0 must be a CUDA tensor")
    _args.require(_NAME, beta0.dtype in _args.DTYPES,
                  lambda: f"beta0 must be float32 or bfloat16, got "
                  f"{beta0.dtype}")
    _args.require(_NAME, beta0.dim() == 1 and beta0.numel() > 0
                  and beta0.is_contiguous(),
                  lambda: "beta0 must be a non-empty contiguous 1-D tensor, "
                  f"got {tuple(beta0.shape)}")
    for x, name in ((mcoef, "mcoef"), (ccoef, "ccoef")):
        _args.operand(_NAME, x, name, beta0, False)
    _args.require(_NAME, int(newton_iters) >= 0,
                  "newton_iters must be non-negative")
    out = torch.empty_like(beta0)

    launch = _build.launcher("cocoa_sdca")
    with _args.on_card(beta0.device):
        err = launch(beta0.data_ptr(), mcoef.data_ptr(), ccoef.data_ptr(),
                     _args.DTYPES[beta0.dtype], out.data_ptr(), beta0.numel(),
                     int(newton_iters), _args.stream(beta0))
    _build.check(err, _NAME)
    cocoa_sdca_update.launches += 1
    return out


cocoa_sdca_update.launches = 0


def _pass_operand(x: torch.Tensor, name: str, shape: tuple,
                  dtype: torch.dtype, dev: torch.device) -> None:
    _args.require(_PASS, isinstance(x, torch.Tensor) and x.device == dev,
                  lambda: f"{name} must be a tensor on {dev}")
    _args.require(_PASS, x.dtype == dtype,
                  lambda: f"{name} must be {dtype}, got {x.dtype}")
    _args.require(_PASS, tuple(x.shape) == shape and x.is_contiguous(),
                  lambda: f"{name} must be a contiguous {shape} tensor, got "
                  f"{tuple(x.shape)}")


def cocoa_sdca_pass(w: torch.Tensor, alpha: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor, y: torch.Tensor, n_k: torch.Tensor,
                    perms: torch.Tensor, sigma: float, lam: float, n: int,
                    r: torch.Tensor, newton_iters: int = 12) -> torch.Tensor:
    """One permutation pass of SDCA for every client of a bucket, in one
    launch: w (d,) f32; alpha, y (Kb, m_pad) f32; idx (Kb, m_pad, nnz)
    int64 and val of that shape f32; n_k (Kb,) int64; perms (Kb, m_pad)
    int64, each row a permutation of range(m_pad); all contiguous CUDA
    tensors on one card.  Writes r = X_k u (Kb, d) f32 (zeroed by the
    kernel) and returns u (Kb, m_pad), the change of α."""
    _args.require(_PASS, isinstance(w, torch.Tensor) and w.is_cuda,
                  "w must be a CUDA tensor")
    dev = w.device
    _args.require(_PASS, w.dim() == 1 and w.numel() > 0,
                  lambda: "w must be a non-empty (d,) vector, got "
                  f"{tuple(w.shape)}")
    _args.require(_PASS, idx.dim() == 3 and min(idx.shape) > 0,
                  lambda: "idx must be a non-empty (Kb, m_pad, nnz) tensor, "
                  f"got {tuple(idx.shape)}")
    d = w.shape[0]
    Kb, m_pad, nnz = idx.shape
    for x, name, shape, dtype in (
            (w, "w", (d,), torch.float32),
            (alpha, "alpha", (Kb, m_pad), torch.float32),
            (idx, "idx", (Kb, m_pad, nnz), torch.int64),
            (val, "val", (Kb, m_pad, nnz), torch.float32),
            (y, "y", (Kb, m_pad), torch.float32),
            (n_k, "n_k", (Kb,), torch.int64),
            (perms, "perms", (Kb, m_pad), torch.int64),
            (r, "r", (Kb, d), torch.float32)):
        _pass_operand(x, name, shape, dtype, dev)
    epl = next((e for e in _EPL if nnz <= 32 * e), None)
    _args.require(_PASS, epl is not None,
                  f"nnz must be at most {32 * _EPL[-1]}, got {nnz}")
    _args.require(_PASS, d < 2 ** 31 and m_pad < 2 ** 31,
                  "d and m_pad must fit in 32 bits")
    _args.require(_PASS, int(newton_iters) >= 0,
                  "newton_iters must be non-negative")
    u = torch.empty((Kb, m_pad), dtype=torch.float32, device=dev)
    launch = _build.launcher("cocoa_sdca", "cocoa_sdca_pass_launch")
    with _args.on_card(dev):
        err = launch(w.data_ptr(), alpha.data_ptr(), idx.data_ptr(),
                     val.data_ptr(), y.data_ptr(), n_k.data_ptr(),
                     perms.data_ptr(), u.data_ptr(), r.data_ptr(), Kb, m_pad,
                     nnz, d, float(sigma), sigma / (lam * n), 2.0 * lam * n,
                     int(newton_iters), epl, _args.stream(w))
    _build.check(err, _PASS)
    cocoa_sdca_pass.launches += 1
    return u


cocoa_sdca_pass.launches = 0
