"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in float32, with ordinary
tensor operations.  On a CPU tensor :mod:`repro_torch.kernels.ops` calls
these; on the card ``chip_smoke.py`` holds each kernel against them.  They
mirror the reference's ``kernels/ref.py`` oracles of the same names.
"""
from __future__ import annotations

import math
import struct
from typing import Optional, Union

import torch

from repro_torch.kernels.segment_sum import LANES

Scalar = Union[float, torch.Tensor]

_F32 = torch.float32


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F32)


def _round_f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (ties to even)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _row_scalar(h: Scalar, w: torch.Tensor) -> Union[float, torch.Tensor]:
    """``h`` shaped to broadcast against ``w``: a scalar stays a scalar, an
    (R,) tensor becomes an (R, 1) column for an (R, d) ``w``."""
    if isinstance(h, torch.Tensor):
        h = _f32(h)
        return h[:, None] if h.dim() == 1 and w.dim() == 2 else h
    return float(h)


def fsvrg_update_ref(w: torch.Tensor, s: torch.Tensor, g_new: torch.Tensor,
                     g_old: torch.Tensor, g_bar: torch.Tensor, h: Scalar, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w − h (S ⊙ (g_new − g_old) + ḡ), computed in f32, cast to w's dtype.

    ``w``, ``s``, ``g_new`` are (d,) or (R, d); ``g_old`` and ``g_bar`` have
    that shape or are one (d,) row shared by all R rows; ``h`` is a scalar
    or, for an (R, d) ``w``, one step size per row.  With ``out`` the result
    is written there (it may be ``w`` itself)."""
    upd = _f32(s) * (_f32(g_new) - _f32(g_old)) + _f32(g_bar)
    res = (_f32(w) - _row_scalar(h, w) * upd).to(w.dtype)
    if out is None:
        return res
    return out.copy_(res)


def _f32_scalar(x: Scalar, w: torch.Tensor) -> torch.Tensor:
    """A step-size scalar as the reference holds it: an f32 value (a 0-d
    tensor for a float), or one f32 value per row as an (R, 1) column for
    an (R, d) ``w``."""
    if isinstance(x, torch.Tensor):
        return _row_scalar(x, w)
    return torch.tensor(float(x), dtype=_F32, device=w.device)


def fedavg_update_ref(w: torch.Tensor, g: torch.Tensor, h: Scalar,
                      lam: Scalar, *,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 − h·λ)·w − h·g, computed in f32, cast to w's dtype.

    ``w``, ``g`` are (d,) or (R, d); ``h`` is a scalar or, for an (R, d)
    ``w``, one step size per row (h = 0 leaves a row as it was); ``λ`` is a
    scalar.  The scalars are f32, as in the reference.  With ``out`` the
    result is written there (it may be ``w`` itself)."""
    h = _f32_scalar(h, w)
    lam = _f32_scalar(lam, w)
    res = ((1.0 - h * lam) * _f32(w) - h * _f32(g)).to(w.dtype)
    if out is None:
        return res
    return out.copy_(res)


def dane_update_ref(w: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                    w_t: torch.Tensor, lr: Scalar, lam: Scalar, mu: Scalar, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 − lr(λ+µ))·w − lr·g + lr·a + lr·µ·w_t, computed in f32, cast to
    w's dtype.

    ``w``, ``g``, ``a`` are (d,) or (R, d); ``w_t`` has that shape or is
    one (d,) row shared by all R rows; ``lr``, ``λ``, ``µ`` are f32
    scalars, as in the reference.  With ``out`` the result is written there
    (it may be ``w`` itself)."""
    lr, lam, mu = (_f32_scalar(x, w) for x in (lr, lam, mu))
    res = ((1.0 - lr * (lam + mu)) * _f32(w) - lr * _f32(g)
           + lr * _f32(a) + lr * mu * _f32(w_t)).to(w.dtype)
    if out is None:
        return res
    return out.copy_(res)


#: the clip of the dual coordinate β to the open box (0, 1)
SDCA_EPS = 1e-6


def cocoa_sdca_update_ref(beta0: torch.Tensor, mcoef: torch.Tensor,
                          ccoef: torch.Tensor,
                          newton_iters: int = 12) -> torch.Tensor:
    """Clipped-Newton solve of the per-coordinate SDCA dual subproblem

        min_β  m(β − β₀) + c(β − β₀)² + β log β + (1 − β) log(1 − β),

    ``newton_iters`` steps from β = clip(sigmoid(−m)), every iterate clipped
    to [1e-6, 1 − 1e-6]; in f32, cast to β₀'s dtype.  All three inputs are
    1-D of one length; padding slots hold β₀ = ½, m = c = 0."""
    eps = SDCA_EPS
    b0, m, c = _f32(beta0), _f32(mcoef), _f32(ccoef)
    b = torch.clamp(torch.sigmoid(-m), eps, 1.0 - eps)
    for _ in range(newton_iters):
        gb = m + 2.0 * c * (b - b0) + torch.log(b / (1.0 - b))
        hb = 2.0 * c + 1.0 / (b * (1.0 - b))
        b = torch.clamp(b - gb / hb, eps, 1.0 - eps)
    return b.to(beta0.dtype)


def cocoa_sdca_pass_ref(w: torch.Tensor, alpha: torch.Tensor,
                        idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor,
                        n_k: torch.Tensor, perms: torch.Tensor, sigma: float,
                        lam: float, n: int, r: torch.Tensor,
                        newton_iters: int = 12) -> torch.Tensor:
    """One permutation pass of SDCA on every client's local dual
    subproblem of a bucket (idx, val (Kb, m_pad, nnz); y, alpha, perms
    (Kb, m_pad); n_k (Kb,)), the clients in lockstep: at step t client k
    updates coordinate i = perms[k, t].  With β_i = y_i α_i ∈ (0, 1),
    coordinate i solves (from eq. 15)

        min_β  m_i (β − β_old) + c_i (β − β_old)² + H(β),
        m_i = y_i x_iᵀ(w + (σ/λn) r),   c_i = σ||x_i||²/(2λn),

    by :func:`cocoa_sdca_update_ref`, where r = X_k u tracks the client's
    own updates within the pass.  r is accumulated in ``r`` (Kb, d), which
    this zeroes first; returns u (Kb, m_pad), the change of α.  The
    counterpart of the reference's ``_sdca_local_pass_keyed``."""
    Kb, m_pad, nnz = idx.shape
    eps = SDCA_EPS
    take = perms[..., None].expand(Kb, m_pad, nnz)
    pidx = idx.gather(1, take).transpose(0, 1).contiguous()
    pval = val.gather(1, take).transpose(0, 1).contiguous()
    py = y.gather(1, perms).t().contiguous()                     # (m_pad, Kb)
    valid = (perms < n_k[:, None]).to(_F32).t()
    beta_old = torch.clamp(py * alpha.gather(1, perms).t(), eps,
                           1.0 - eps).contiguous()
    # the parts of each step's coefficients that r does not change: all at
    # once, with the scalars rounded as the reference rounds them
    zw = (pval * w[pidx]).sum(dim=-1)
    xn2 = (pval * pval).sum(dim=-1)
    ccoef = (sigma * xn2) / torch.full_like(xn2, 2.0 * lam * n)
    shift = sigma / (lam * n)
    u = torch.zeros((Kb, m_pad), device=w.device)
    r.zero_()
    for t in range(m_pad):
        xi, vi, yi = pidx[t], pval[t], py[t]
        mcoef = yi * (zw[t] + shift * (vi * r.gather(1, xi)).sum(dim=1))
        beta = cocoa_sdca_update_ref(beta_old[t], mcoef, ccoef[t],
                                     newton_iters)
        du = valid[t] * yi * (beta - beta_old[t])
        u.scatter_add_(1, perms[:, t:t + 1], du[:, None])
        r.scatter_add_(1, xi, du[:, None] * vi)
    return u


def fused_aggregate_ref(w_t: torch.Tensor, deltas: torch.Tensor,
                        weights: torch.Tensor, a_diag: torch.Tensor,
                        scale: Scalar = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (scale · Σ_k weights_k δ_k), in f32."""
    agg = (_f32(deltas) * _f32(weights)[:, None]).sum(dim=0)
    s = _f32(scale) if isinstance(scale, torch.Tensor) else float(scale)
    return _f32(w_t) + _f32(a_diag) * (s * agg)


def fused_accumulate_ref(acc: torch.Tensor, deltas: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """acc + Σ_k weights_k δ_k, in f32 (the accumulate phase alone)."""
    return _f32(acc) + (_f32(deltas) * _f32(weights)[:, None]).sum(dim=0)


def fused_epilogue_ref(w_t: torch.Tensor, acc: torch.Tensor,
                       a_diag: torch.Tensor,
                       scale: Scalar = 1.0) -> torch.Tensor:
    """w^t + A ⊙ (scale · acc), in f32 (the epilogue alone)."""
    s = _f32(scale) if isinstance(scale, torch.Tensor) else float(scale)
    return _f32(w_t) + _f32(a_diag) * (s * _f32(acc))


def scaled_aggregate_ref(w_t: torch.Tensor, w_ks: torch.Tensor,
                         weights: torch.Tensor,
                         a_diag: torch.Tensor) -> torch.Tensor:
    """w^t + A ⊙ Σ_k weights_k (w_k − w^t), in f32 (iterate-consuming)."""
    wt = _f32(w_t)
    delta = ((_f32(w_ks) - wt[None, :]) * _f32(weights)[:, None]).sum(dim=0)
    return wt + _f32(a_diag) * delta


#: the order-statistic guards robust_aggregate computes
ROBUST_MODES = ("trimmed_mean", "median")


def robust_window(m: int, trim: float, mode: str) -> tuple:
    """The rank window [lo, hi) of the sorted valid values that the
    statistic averages, for ``m`` valid rows: the trimmed mean drops
    lo = ⌊f32(trim)·f32(m)⌋ values on each side (the product rounded in f32,
    as the reference rounds it), the median keeps the one or two middle
    ranks.  (0, 0) for m = 0: no update."""
    if mode not in ROBUST_MODES:
        raise ValueError("mode must be 'trimmed_mean' or 'median'")
    if m <= 0:
        return 0, 0
    if mode == "median":
        return (m - 1) // 2, m // 2 + 1
    # two f32 significands multiply exactly in a double; one rounding to
    # f32 then gives the f32 product (no tensors: the card's wrapper calls
    # this between reading m back and its second launch)
    lo = math.floor(_round_f32(_round_f32(trim) * _round_f32(float(m))))
    return lo, m - lo


def robust_aggregate_ref(w_t: torch.Tensor, deltas: torch.Tensor,
                         valid: torch.Tensor, a_diag: torch.Tensor,
                         trim: float = 0.1,
                         mode: str = "trimmed_mean") -> torch.Tensor:
    """w^t + A ⊙ robust_agg({δ_k : valid_k}), in f32.

    ``robust_agg`` is the coordinate-wise trimmed mean (drop the
    ``trim``-fraction smallest and largest per coordinate, average the
    rest) or median over the valid rows (``valid`` (K,) bool or {0,1}).
    Invalid rows are +inf and sort past the rank window; NaN sorts after
    +inf, as in ``jnp.sort``.  No valid row: no update."""
    x = torch.where(valid.reshape(-1, 1) > 0, _f32(deltas),
                    torch.tensor(float("inf"), dtype=_F32,
                                 device=deltas.device))
    xs = torch.sort(x, dim=0).values
    m = int((valid > 0).sum())
    lo, hi = robust_window(m, trim, mode)
    ranks = torch.arange(xs.shape[0], device=xs.device)[:, None]
    inc = (ranks >= lo) & (ranks < hi)
    agg = torch.where(inc, xs, torch.zeros((), dtype=_F32,
                                           device=xs.device)).sum(dim=0)
    # a tensor divisor: torch multiplies by the reciprocal of a Python one
    agg = agg / torch.full_like(agg, float(max(hi - lo, 1)))
    if m == 0:
        agg = torch.zeros_like(agg)
    return _f32(w_t) + _f32(a_diag) * agg


#: the robust_aggregate kernel's digit widths, most significant first: one
#: select pass a digit over the 32-bit order-preserving keys
RADIX_DIGITS = (8, 8, 8, 8)
_NAN_KEY = 0xFFFFFFFF


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving 32-bit key of each value, as int64:
    the f32 bits with the sign bit set (sign clear) or all flipped (sign
    set), so unsigned key order is value order (−0 before +0); every NaN
    gets the largest key, after +inf's."""
    b = _f32(x).contiguous().view(torch.int32).to(torch.int64) & _NAN_KEY
    k = torch.where(b >= 2 ** 31, b ^ _NAN_KEY, b | 2 ** 31)
    return torch.where(torch.isnan(_f32(x)), torch.full_like(k, _NAN_KEY), k)


def key_values(k: torch.Tensor) -> torch.Tensor:
    """The f32 values of keys from :func:`order_keys` (a NaN for NaN's)."""
    b = torch.where(k >= 2 ** 31, k & 0x7FFFFFFF, k ^ _NAN_KEY)
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(_F32)


def radix_edges(keys: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """The keys at ``ranks`` (E, d) of each column of ``keys`` (m, d), found
    as the kernel finds them: a pass a digit of :data:`RADIX_DIGITS`, each
    counting the digits of the keys that match an edge's prefix so far and
    taking the bin that holds the edge's remaining rank."""
    prefix, rem = torch.zeros_like(ranks), ranks.clone()
    low = 32
    for bits in RADIX_DIGITS:
        low -= bits
        digit = (keys >> low) & ((1 << bits) - 1)
        high = keys >> (low + bits)
        for e in range(ranks.shape[0]):
            match = (high == prefix[e]).to(torch.int64)
            hist = torch.zeros((1 << bits, keys.shape[1]), dtype=torch.int64)
            cum = hist.scatter_add_(0, digit, match).cumsum(0)
            b = (cum <= rem[e]).sum(0)                 # the bin holding it
            below = cum.gather(0, (b - 1).clamp(min=0)[None])[0]
            rem[e] -= torch.where(b > 0, below, torch.zeros_like(below))
            prefix[e] = (prefix[e] << bits) | b
    return prefix


def robust_select_ref(w_t: torch.Tensor, deltas: torch.Tensor,
                      valid: torch.Tensor, a_diag: torch.Tensor,
                      trim: float = 0.1,
                      mode: str = "trimmed_mean") -> torch.Tensor:
    """:func:`robust_aggregate_ref` by the kernel's arithmetic, on the CPU
    (the tests' model of csrc/robust_aggregate.cu): no sort, the window's
    edges e_lo, e_hi by :func:`radix_edges` and its sum from them,

        e_lo = e_hi:  (hi − lo)·v(e)
        otherwise:    Σ v(k) over e_lo < k < e_hi
                      + (#{k ≤ e_lo} − lo)·v(e_lo) + (hi − #{k < e_hi})·v(e_hi)

    over the finite ranks [lo, min(hi, m − n_nan)) of each column; the
    ranks past them are +inf, or NaN from rank K − n_nan on."""
    lo, hi = robust_window(int((valid > 0).sum()), trim, mode)
    x = _f32(deltas)[valid.reshape(-1) > 0]
    m, K = x.shape[0], deltas.shape[0]
    if m == 0:
        return _f32(w_t) + _f32(a_diag) * torch.zeros_like(_f32(w_t))
    keys = order_keys(x)
    n_nan = torch.isnan(x).sum(0)
    hf = (m - n_nan).clamp(max=hi)
    finite = hf > lo
    zero = torch.zeros_like(hf)
    el, eh = radix_edges(keys, torch.stack([
        torch.where(finite, zero + lo, zero),
        torch.where(finite, hf - 1, zero)]))
    vl, vh = key_values(el), key_values(eh)
    inside = (keys > el) & (keys < eh)
    between = torch.where(inside, key_values(keys), 0.0).sum(0)
    le_lo, lt_hi = (keys <= el).sum(0), (keys < eh).sum(0)
    tails = (between + (le_lo - lo).to(_F32) * vl
             + (hf - lt_hi).to(_F32) * vh)
    s = torch.where(el == eh, (hf - lo).to(_F32) * vl, tails)
    s = torch.where(finite, s, 0.0)
    past = torch.where(hi > K - n_nan, float("nan"), float("inf"))
    s = torch.where(hi > hf, s + past, s)
    agg = s / torch.full_like(s, float(hi - lo))
    return _f32(w_t) + _f32(a_diag) * agg


#: the wkv6 kernel's default chunk length (the decay-underflow bound of
#: the reference's models/rwkv.py)
WKV_CHUNK = 32


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, chunk: int = WKV_CHUNK, *,
             state: Optional[torch.Tensor] = None):
    """Chunk-parallel RWKV-6 WKV, in f32: the plain version of the wkv6
    kernel and the port's counterpart of the reference's
    ``models/rwkv._wkv_chunked``.

    r, k, v, w: (BH, S, D) with u (BH, D) and ``state`` (BH, D, D), or the
    model's (B, S, Hn, D) with u (Hn, D) and ``state`` (B, Hn, D, D) (run
    as B·Hn pairs after a transpose).  Per chunk of length L = ``chunk``,
    with the state S (D, D) carried across the chunks of each pair, from
    ``state`` or zeros:

        c     = cumprod(w)                      (along the chunk)
        r_t   = r ⊙ c_prev,   k_t = k / max(c, 1e-30)
        out   = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
        S    ← diag(c_L) (S + k_tᵀ v)

    Returns out in r's layout and dtype and the final state in f32.  S
    must be a multiple of ``chunk`` (``ValueError``)."""
    if r.dim() == 4:
        B, S, Hn, D = r.shape

        def heads(t):
            return t.transpose(1, 2).reshape(B * Hn, S, D)

        out, s = wkv6_ref(*map(heads, (r, k, v, w)), u.repeat(B, 1), chunk,
                          state=None if state is None
                          else state.reshape(B * Hn, D, D))
        return (out.reshape(B, Hn, S, D).transpose(1, 2).contiguous(),
                s.reshape(B, Hn, D, D))
    BH, S, D = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    dtype = r.dtype
    r, k, v, w, u = (_f32(t) for t in (r, k, v, w, u))
    L = chunk
    mask = torch.tril(torch.ones((L, L), dtype=_F32, device=r.device),
                      diagonal=-1)
    s = (torch.zeros((BH, D, D), dtype=_F32, device=r.device)
         if state is None else _f32(state))
    floor = torch.tensor(1e-30, dtype=_F32, device=r.device)
    outs = []
    for c0 in range(0, S, L):
        rb, kb, vb, wb = (t[:, c0:c0 + L] for t in (r, k, v, w))
        c = torch.cumprod(wb, dim=1)
        c_prev = torch.cat([torch.ones_like(c[:, :1]), c[:, :-1]], dim=1)
        r_t = rb * c_prev
        k_t = kb / torch.maximum(c, floor)
        scores = (r_t @ k_t.transpose(1, 2)) * mask
        intra = scores @ vb
        bonus = (rb * u[:, None, :] * kb).sum(-1, keepdim=True) * vb
        inter = r_t @ s
        outs.append(intra + bonus + inter)
        s = c[:, -1, :, None] * (s + k_t.transpose(1, 2) @ vb)
    return torch.cat(outs, dim=1).to(dtype), s


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, d_out: torch.Tensor,
                 chunk: int = WKV_CHUNK, *,
                 state: Optional[torch.Tensor] = None,
                 d_state: Optional[torch.Tensor] = None):
    """The VJP of :func:`wkv6_ref`, in f32: the plain version of the
    wkv6_bwd kernel, written out chunk by chunk in reverse.

    Takes :func:`wkv6_ref`'s inputs in either layout, ``d_out`` (the
    cotangent of out, r's shape) and ``d_state`` (of the final state, or
    None for zero).  Returns (dr, dk, dv, dw) in r's layout, du in u's
    shape and the cotangent of the start state (None when ``state`` is
    None), all f32.  Per chunk, from its start state S0 (recomputed by a
    forward sweep) and the state's cotangent dS at its end, with A the
    masked scores, β_t = r_t·(u ⊙ k_t), dβ_t = dout_t·v_t, dA the masked
    dout vᵀ, G = diag(c_L) dS and Y = v dSᵀ:

        dv   = Aᵀ dout + β ⊙ dout + k_t G
        dr_t = dA k_t + dout S0ᵀ            (the cotangent of r_t)
        dk_t = dAᵀ r_t + Y ⊙ c_L            (of k_t)
        dc_L = rowsum(dS ⊙ S0) + colsum(k_t ⊙ Y)
        dS  ← G + r_tᵀ dout                 (for the chunk before)

    then dr = dr_t ⊙ c_prev + dβ u ⊙ k, dk = dk_t / max(c, 1e-30)
    + dβ u ⊙ r and du = Σ dβ r ⊙ k.  The decay's cotangent reaches c
    through r_t (dr_t ⊙ r, into c_prev), through k_t (−dk_t ⊙ k_t / max(c,
    1e-30), only where c > 1e-30: below it the clamp gives c no gradient,
    and at exactly 1e-30 half, as ``torch.maximum`` splits a tie) and
    through c_L; then dw_i = c_prev_i · q_i with the suffix sum
    q_i = dc_i + w_{i+1} q_{i+1}, so no w_i is divided by (it may be 0)."""
    if r.dim() == 4:
        B, S, Hn, D = r.shape

        def heads(t):
            return t.transpose(1, 2).reshape(B * Hn, S, D)

        def back(t):
            return t.reshape(B, Hn, S, D).transpose(1, 2).contiguous()

        def pairs(s):
            return None if s is None else s.reshape(B * Hn, D, D)

        *grads, du, ds = wkv6_bwd_ref(
            *map(heads, (r, k, v, w)), u.repeat(B, 1), heads(d_out), chunk,
            state=pairs(state), d_state=pairs(d_state))
        return (*map(back, grads), du.reshape(B, Hn, D).sum(0),
                None if ds is None else ds.reshape(B, Hn, D, D))
    BH, S, D = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    r, k, v, w, u, g = (_f32(t) for t in (r, k, v, w, u, d_out))
    L = chunk
    mask = torch.tril(torch.ones((L, L), dtype=_F32, device=r.device),
                      diagonal=-1)
    floor = torch.tensor(1e-30, dtype=_F32, device=r.device)
    s = (torch.zeros((BH, D, D), dtype=_F32, device=r.device)
         if state is None else _f32(state))
    starts = []
    for c0 in range(0, S, L):
        starts.append(s)
        kb, vb, wb = (t[:, c0:c0 + L] for t in (k, v, w))
        c = torch.cumprod(wb, dim=1)
        s = c[:, -1, :, None] * (s + (kb / torch.maximum(c, floor))
                                 .transpose(1, 2) @ vb)
    ds = (torch.zeros((BH, D, D), dtype=_F32, device=r.device)
          if d_state is None else _f32(d_state))
    du = torch.zeros((BH, D), dtype=_F32, device=r.device)
    dr, dk, dv, dw = (torch.empty((BH, S, D), dtype=_F32, device=r.device)
                      for _ in range(4))
    for n in reversed(range(S // L)):
        sl = slice(n * L, (n + 1) * L)
        rb, kb, vb, wb, gb = (t[:, sl] for t in (r, k, v, w, g))
        s0 = starts[n]
        c = torch.cumprod(wb, dim=1)
        c_prev = torch.cat([torch.ones_like(c[:, :1]), c[:, :-1]], dim=1)
        cm = torch.maximum(c, floor)
        r_t, k_t = rb * c_prev, kb / cm
        a = (r_t @ k_t.transpose(1, 2)) * mask
        da = (gb @ vb.transpose(1, 2)) * mask
        beta = (rb * u[:, None, :] * kb).sum(-1, keepdim=True)
        dbeta = (gb * vb).sum(-1, keepdim=True)
        c_l = c[:, -1]
        big_g = c_l[:, :, None] * ds
        dv[:, sl] = a.transpose(1, 2) @ gb + beta * gb + k_t @ big_g
        dr_t = da @ k_t + gb @ s0.transpose(1, 2)
        y = vb @ ds.transpose(1, 2)
        dk_t = da.transpose(1, 2) @ r_t + c_l[:, None, :] * y
        dc_l = (ds * s0).sum(-1) + (k_t * y).sum(1)
        ds = big_g + r_t.transpose(1, 2) @ gb
        dr[:, sl] = dr_t * c_prev + dbeta * u[:, None, :] * kb
        dk[:, sl] = dk_t / cm + dbeta * u[:, None, :] * rb
        du = du + (dbeta * rb * kb).sum(1)
        weight = torch.where(c > floor, 1.0,
                             torch.where(c == floor, 0.5, 0.0))
        dc = -(dk_t * k_t) / cm * weight
        dc[:, :-1] += dr_t[:, 1:] * rb[:, 1:]
        dc[:, -1] += dc_l
        q = dc[:, -1]
        dw[:, n * L + L - 1] = c_prev[:, -1] * q
        for t in reversed(range(L - 1)):
            q = dc[:, t] + wb[:, t + 1] * q
            dw[:, n * L + t] = c_prev[:, t] * q
    return dr, dk, dv, dw, du, None if state is None else ds


def segment_sum_ref(plan, a: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """The plain version of the segment_sum kernel: out[slot of run r] =
    the run's products a[t // group] · b[t] (group = n_terms / a.numel()),
    lane i mod 32 of the run adding its terms i in turn from 0, the 32
    lanes then combined by the butterfly p_l + p_(l xor o) for o = 16, 8,
    4, 2, 1 (lane 0's sums: the halves added, five times); every other
    slot 0.  The kernel's sums, bit for bit."""
    flat_out = out.view(-1)
    flat_out.zero_()
    if plan.n_runs == 0:
        return out
    t, key, bounds = plan.lane_steps
    # every product rounded once, as the kernel's; the summed ones taken
    terms = (a.reshape(-1, 1) * b.reshape(a.numel(), -1)).reshape(-1)[t]
    partial = torch.zeros(LANES * plan.n_runs, dtype=_F32, device=out.device)
    for lo, hi in bounds:        # within a step, a (lane, run) key once
        partial.index_add_(0, key[lo:hi], terms[lo:hi])
    p = partial.view(LANES, plan.n_runs)
    for w in (16, 8, 4, 2, 1):
        p = p[:w] + p[w:2 * w]
    flat_out.index_copy_(0, plan.run_slot.long(), p[0])
    return out
