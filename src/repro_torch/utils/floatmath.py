"""f32 elementary functions that give the same bits on the CPU and on CUDA.

The synthetic data's sampler takes logs, a power and a sigmoid of its
uniforms, and a row's sums.  ``torch.log`` and its kin run different code
on the two devices (and, on the CPU, a vector library whose low-accuracy
mode some threads have been seen to run in: errors of 1e-4 relative on a
part of a large tensor, on some calls and not on others), so a sampler
built on them draws different rows on the card from the CPU's.

Here each function is computed in f64 from additions, subtractions,
multiplications, divisions and bit operations alone — each one a kernel of
its own, so no multiply-add is contracted — and rounded once to f32.  IEEE
arithmetic makes every step the same on both devices, and the f64 error
(≈ 1e-16 relative) leaves the rounded f32 the correctly rounded value but
in the rarest ties.  Sums run left to right in f32, one addition a term.
"""
from __future__ import annotations

import math

import torch

_LN2_HI = 6.93147180369123816490e-01      # fdlibm's split of ln 2: the
_LN2_LO = 1.90821492927058770002e-10      # high part has 21 spare bits
_INV_LN2 = 1.0 / math.log(2.0)
_SQRT2 = math.sqrt(2.0)
_MANTISSA = (1 << 52) - 1
#: atanh(s)/s = Σ s^{2k}/(2k+1); |s| ≤ 3 − 2√2, so 12 terms reach 1e-19
_ATANH_TERMS = 12
#: eˣ on |r| ≤ ln2/2: the Taylor series to degree 13 reaches 5e-18
_EXP_DEGREE = 13


def log64(x: torch.Tensor) -> torch.Tensor:
    """ln x of positive, finite, normal f64 values, in f64: x = 2ᵉ·m with m
    in [√½, √2), ln x = e·ln 2 + 2·atanh((m − 1)/(m + 1))."""
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & _MANTISSA) | (1023 << 52)).view(torch.float64)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int64)).to(torch.float64)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = torch.full_like(s, 1.0 / (2 * _ATANH_TERMS - 1))
    for k in range(_ATANH_TERMS - 2, -1, -1):
        p = p * s2
        p = p + 1.0 / (2 * k + 1)
    log_m = (s + s) * p
    return e * _LN2_HI + (e * _LN2_LO + log_m)


def exp64(x: torch.Tensor) -> torch.Tensor:
    """eˣ of f64 values, in f64: x = k·ln 2 + r with |r| ≤ ln2/2, eʳ by its
    Taylor series, times 2ᵏ.  x is clamped to [−708, 709], where 2ᵏ is a
    normal f64: below, eˣ rounds to 0 in f32 anyway."""
    x = x.clamp(-708.0, 709.0)
    k = torch.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, 1.0 / math.factorial(_EXP_DEGREE))
    for i in range(_EXP_DEGREE - 1, -1, -1):
        p = p * r
        p = p + 1.0 / math.factorial(i)
    scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return p * scale


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """ln x of positive f32 values, rounded once to f32."""
    return log64(x.to(torch.float64)).to(torch.float32)


def pow_f32(x: torch.Tensor, y: float) -> torch.Tensor:
    """xʸ of positive f32 values and an exponent taken as f32 (JAX casts a
    Python exponent to the array's f32), rounded once to f32."""
    y32 = float(torch.tensor(y, dtype=torch.float32))
    return exp64(log64(x.to(torch.float64)) * y32).to(torch.float32)


def sigmoid_f32(z: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^{−z}) of f32 values, rounded once to f32."""
    return (1.0 / (exp64(-z.to(torch.float64)) + 1.0)).to(torch.float32)


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of f32 values, added left to right."""
    acc = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """The running sum over the last axis of f32 values, left to right, as
    XLA's cumsum adds them at the widths the tests hold (torch's CPU
    ``cumsum`` accumulates f32 in f64)."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out
