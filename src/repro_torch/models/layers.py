"""The shared building blocks the port's model stack uses so far: the
initializer, RMSNorm with the reference's custom backward, and the chunked
LM-head loss (the reference's ``models/layers.py``; attention, RoPE and
the MLPs come with the other families, ROADMAP A11)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

_F32 = torch.float32


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """normal(shape) · scale/√fan_in with fan_in = shape[0], drawn in f32
    from ``gen`` on its device, then cast to ``dtype``.  Not the
    reference's bits (its threefry normals); weights cross between the
    packages through :mod:`repro_torch.bridge`."""
    std = scale / (shape[0] ** 0.5)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float) -> torch.Tensor:
    x32 = x.to(_F32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(_F32)).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``_rms_norm_bwd``: the backward in f32, dx cast to
    x's dtype and dw to the weight's, so a bf16 residual stream keeps a
    bf16 cotangent."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        x32, dy32, w32 = x.to(_F32), dy.to(_F32), weight.to(_F32)
        s = torch.rsqrt(x32.square().mean(-1, keepdim=True) + ctx.eps)
        wdy = w32 * dy32
        dx = s * wdy - (s * s * s) * x32 * (x32 * wdy).sum(
            -1, keepdim=True) / x.shape[-1]
        dw = ((x32 * s) * dy32).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype, with the reference's custom backward."""
    return _RMSNorm.apply(x, weight, eps)


def _chunk_ce(xb: torch.Tensor, emb_out: torch.Tensor, lb: torch.Tensor,
              mb: torch.Tensor) -> torch.Tensor:
    logits = (xb @ emb_out).to(_F32)                       # (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb[..., None])[..., 0]
    return ((logz - gold) * mb).sum()


def lm_head_loss(x: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross entropy: x (B, S, d) final hidden states,
    emb_out (d, V), labels (B, S) integer, mask (B, S) {0, 1}.  Softmax CE
    over sequence chunks of min(``chunk``, S) tokens (a ragged S takes one
    chunk), each recomputed in the backward (non-reentrant checkpoint), so
    at most one chunk's (B, chunk, V) f32 logits are alive; the sum over
    max(mask.sum(), 1)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=_F32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_ce, x[:, sl], emb_out, labels[:, sl],
                                   mask[:, sl], use_reentrant=False)
    return total / torch.clamp(mask.sum().to(_F32), min=1.0)
