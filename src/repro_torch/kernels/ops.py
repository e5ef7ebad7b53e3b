"""The one door to the port's kernels, dispatching on the tensors' device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the hand-written Hopper kernel, which raises on what it does not
take — there is no fallback from the card to the plain version.  Each
kernel counts its launches (:func:`launch_counts`), so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import cocoa_sdca as _cs
from repro_torch.kernels import dane_update as _du
from repro_torch.kernels import fedavg_update as _fa
from repro_torch.kernels import fsvrg_update as _fu
from repro_torch.kernels import ref
from repro_torch.kernels import robust_aggregate as _ra
from repro_torch.kernels import scaled_aggregate as _sa
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import selective_scan as _sc
from repro_torch.kernels import wkv6 as _wk

Scalar = Union[float, torch.Tensor]

#: kernel name -> the CUDA wrapper that carries its ``launches`` count
KERNELS = {
    "fused_aggregate": _sa.fused_aggregate,
    "fused_accumulate": _sa.fused_accumulate,
    "fused_epilogue": _sa.fused_epilogue,
    "fsvrg_update": _fu.fsvrg_update,
    "fedavg_update": _fa.fedavg_update,
    "dane_update": _du.dane_update,
    "cocoa_sdca_update": _cs.cocoa_sdca_update,
    "cocoa_sdca_pass": _cs.cocoa_sdca_pass,
    "robust_aggregate": _ra.robust_aggregate,
    "wkv6": _wk.wkv6,
    "wkv6_bwd": _wk.wkv6_bwd,
    "segment_sum": _ss.segment_sum,
    "selective_scan": _sc.selective_scan,
}


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def fsvrg_update(w: torch.Tensor, s: torch.Tensor, g_new: torch.Tensor,
                 g_old: torch.Tensor, g_bar: torch.Tensor, h: Scalar, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_cpu(w):
        return ref.fsvrg_update_ref(w, s, g_new, g_old, g_bar, h, out=out)
    return _fu.fsvrg_update(w, s, g_new, g_old, g_bar, h, out=out)


def fedavg_update(w: torch.Tensor, g: torch.Tensor, h: Scalar, lam: float, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_cpu(w):
        return ref.fedavg_update_ref(w, g, h, lam, out=out)
    return _fa.fedavg_update(w, g, h, lam, out=out)


def dane_update(w: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                w_t: torch.Tensor, lr: float, lam: float, mu: float, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_cpu(w):
        return ref.dane_update_ref(w, g, a, w_t, lr, lam, mu, out=out)
    return _du.dane_update(w, g, a, w_t, lr, lam, mu, out=out)


def cocoa_sdca_update(beta0: torch.Tensor, mcoef: torch.Tensor,
                      ccoef: torch.Tensor,
                      newton_iters: int = 12) -> torch.Tensor:
    if _on_cpu(beta0):
        return ref.cocoa_sdca_update_ref(beta0, mcoef, ccoef, newton_iters)
    return _cs.cocoa_sdca_update(beta0, mcoef, ccoef, newton_iters)


def cocoa_sdca_pass(w: torch.Tensor, alpha: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor, y: torch.Tensor, n_k: torch.Tensor,
                    perms: torch.Tensor, sigma: float, lam: float, n: int,
                    r: torch.Tensor, newton_iters: int = 12) -> torch.Tensor:
    """One permutation pass of SDCA for every client of a bucket: writes
    r = X_k u into ``r`` (Kb, d) and returns u (Kb, m_pad)."""
    if _on_cpu(w):
        return ref.cocoa_sdca_pass_ref(w, alpha, idx, val, y, n_k, perms,
                                       sigma, lam, n, r, newton_iters)
    return _cs.cocoa_sdca_pass(w, alpha, idx, val, y, n_k, perms, sigma, lam,
                               n, r, newton_iters)


def fused_aggregate(w_t: torch.Tensor, deltas: torch.Tensor,
                    weights: torch.Tensor, a_diag: torch.Tensor,
                    scale: Scalar = 1.0) -> torch.Tensor:
    if _on_cpu(deltas):
        return ref.fused_aggregate_ref(w_t, deltas, weights, a_diag, scale)
    return _sa.fused_aggregate(w_t, deltas, weights, a_diag, scale)


def fused_accumulate(acc: torch.Tensor, deltas: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    if _on_cpu(deltas):
        return ref.fused_accumulate_ref(acc, deltas, weights)
    return _sa.fused_accumulate(acc, deltas, weights)


def fused_epilogue(w_t: torch.Tensor, acc: torch.Tensor, a_diag: torch.Tensor,
                   scale: Scalar = 1.0) -> torch.Tensor:
    if _on_cpu(acc):
        return ref.fused_epilogue_ref(w_t, acc, a_diag, scale)
    return _sa.fused_epilogue(w_t, acc, a_diag, scale)


def scaled_aggregate(w_t: torch.Tensor, w_ks: torch.Tensor,
                     weights: torch.Tensor,
                     a_diag: torch.Tensor) -> torch.Tensor:
    if _on_cpu(w_ks):
        return ref.scaled_aggregate_ref(w_t, w_ks, weights, a_diag)
    return _sa.scaled_aggregate(w_t, w_ks, weights, a_diag)


def robust_aggregate(w_t: torch.Tensor, deltas: torch.Tensor,
                     valid: torch.Tensor, a_diag: torch.Tensor,
                     trim: float = 0.1,
                     mode: str = "trimmed_mean") -> torch.Tensor:
    """w^t + A ⊙ (coordinate-wise trimmed mean or median of the valid
    rows of ``deltas``), in f32."""
    if mode not in ref.ROBUST_MODES:
        raise ValueError(f"mode must be one of {ref.ROBUST_MODES}")
    if not 0.0 <= trim < 0.5:
        raise ValueError("trim must be in [0, 0.5)")
    if _on_cpu(deltas):
        return ref.robust_aggregate_ref(w_t, deltas, valid, a_diag, trim,
                                        mode)
    return _ra.robust_aggregate(w_t, deltas, valid, a_diag, trim, mode)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int = ref.WKV_CHUNK, *,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV over (BH, S, D) r, k, v, w with (BH, D) u and ``state``
    (BH, D, D), or over the model's (B, S, Hn, D) with (Hn, D) u and
    ``state`` (B, Hn, D, D) (read in place on the card: D contiguous, any
    other strides), from ``state`` f32 or zeros: out in r's layout and
    dtype and the final state in f32.  S must be a multiple of ``chunk``
    (``ValueError``).  Differentiable: on the card through the wkv6_bwd
    kernel (:class:`~repro_torch.kernels.wkv6.WKV6`), on the CPU by
    autograd through the plain version."""
    if _on_cpu(r):
        return ref.wkv6_ref(r, k, v, w, u, chunk, state=state)
    return _wk.WKV6.apply(r, k, v, w, u, state, chunk)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, d_out: torch.Tensor,
             chunk: int = ref.WKV_CHUNK, *,
             state: Optional[torch.Tensor] = None,
             d_state: Optional[torch.Tensor] = None):
    """The VJP of :func:`wkv6` at f32 inputs: (dr, dk, dv, dw) in r's
    layout, du in u's shape and the start state's cotangent (None without
    a start state), from the cotangents of out and of the final state
    (None for zero)."""
    if _on_cpu(r):
        return ref.wkv6_bwd_ref(r, k, v, w, u, d_out, chunk, state=state,
                                d_state=d_state)
    return _wk.wkv6_bwd(r, k, v, w, u, d_out, chunk, state=state,
                        d_state=d_state)


def segment_sum(plan: _ss.SegmentPlan, a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """out[s] = Σ over the terms t of slot s of a[t // group] · b[t] (0 for
    a slot with no term), in the order of ``plan``
    (:func:`repro_torch.kernels.segment_sum.segment_plan`): the same bits
    from call to call, on the card and on the CPU alike."""
    if _on_cpu(out):
        return ref.segment_sum_ref(plan, a, b, out)
    return _ss.segment_sum(plan, a, b, out)


def selective_scan(x: torch.Tensor, dt_pre: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan over x (B, S, di) from the state ``h0`` (B,
    di, N) or zeros: y (B, S, di) f32 and the last state (B, di, N) f32
    (:func:`repro_torch.kernels.ref.selective_scan_ref` says what it
    computes).  On the card no (B, S, di, N) tensor is formed; the kernel
    has no backward yet (ROADMAP A11)."""
    if _on_cpu(x):
        return ref.selective_scan_ref(x, dt_pre, dt_bias, a_log, b, c,
                                      d_skip, h0)
    return _sc.selective_scan(x, dt_pre, dt_bias, a_log, b, c, d_skip, h0)
