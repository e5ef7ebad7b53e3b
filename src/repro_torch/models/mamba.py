"""Mamba (S6) selective-state-space block of the Jamba hybrid (the
reference's ``models/mamba.py``).

Plain functions on tensors, as in the reference: ``in_proj`` (d, 2·di),
``conv_w`` (Kc, di), ``x_bc`` (di, 2N), ``x_dt`` (di, 1) and ``out_proj``
(di, d) in the model's dtype; ``dt_bias``, ``a_log`` (di, N) and ``d_skip``
in f32.  The projections are ``torch.matmul`` (the reference leaves them
to XLA, outside any kernel) and the depthwise causal convolution is plain
torch, in the reference's order.  The scan goes through
:func:`repro_torch.kernels.ops.selective_scan`: on the card one launch of
the hand-written ``selective_scan`` kernel a layer and call, prefill and
decode step alike, which forms dt, a = exp(dt·A) and b = (dt·B)·x on the
fly and keeps the states in registers.  The reference materializes a and
b as (B, S, di, N) f32 and runs a chunked associative scan over them; the
port's scan is sequential in t, so ``chunk`` does not change its result
(it is kept for the reference's signature).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

_F32 = torch.float32


def init_mamba(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    """in_proj, conv_w (scale 1), x_bc, x_dt and out_proj drawn in that
    order from ``gen`` in ``dtype``; dt_bias 0, a_log = log(1..N) in each
    row and d_skip 1, in f32 — the reference's leaves, shapes and
    dtypes."""
    d, N = cfg.d_model, cfg.mamba_d_state
    di = cfg.mamba_expand * d
    dev = gen.device
    p = {"in_proj": dense_init(gen, (d, 2 * di), dtype),
         "conv_w": dense_init(gen, (cfg.mamba_d_conv, di), dtype, scale=1.0),
         "x_bc": dense_init(gen, (di, 2 * N), dtype),
         "x_dt": dense_init(gen, (di, 1), dtype)}
    p["dt_bias"] = torch.zeros((di,), dtype=_F32, device=dev)
    p["a_log"] = torch.log(torch.arange(1, N + 1, dtype=_F32, device=dev)
                           ).repeat(di, 1)
    p["d_skip"] = torch.ones((di,), dtype=_F32, device=dev)
    p["out_proj"] = dense_init(gen, (di, d), dtype)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution of x (B, S, di) with w (Kc, di), after
    the Kc − 1 tokens of ``conv_state`` (B, Kc − 1, di) or zeros; the taps
    summed in order in x's dtype.  Returns (out, the last Kc − 1 inputs as
    the new state, a tensor of its own)."""
    B, S, di = x.shape
    Kc = w.shape[0]
    pad = (x.new_zeros((B, Kc - 1, di)) if conv_state is None
           else conv_state)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+Kc-1, di)
    out = xp[:, :S] * w[0]
    for i in range(1, Kc):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, S:].clone() if Kc > 1 else pad
    return out, new_state


def mamba_fwd(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, *,
              ssm_state: Optional[torch.Tensor] = None,
              conv_state: Optional[torch.Tensor] = None, chunk: int = 256
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, (the SSM state (B, di,
    N) f32, the convolution state (B, Kc − 1, di) in x's dtype)), from
    ``ssm_state`` / ``conv_state`` or zeros; S = 1 is a decode step.
    ``chunk`` is the reference's scan chunk; the port's sequential scan
    gives the same result for any value of it."""
    N = cfg.mamba_d_state
    xz = x @ params["in_proj"]
    di = xz.shape[-1] // 2
    xs, new_conv = _causal_conv(xz[..., :di], params["conv_w"], conv_state)
    xs = F.silu(xs)
    bc = (xs @ params["x_bc"]).to(_F32)                      # (B, S, 2N)
    dt_pre = (xs @ params["x_dt"]).to(_F32)[..., 0]          # (B, S)
    y, new_state = ops.selective_scan(xs, dt_pre, params["dt_bias"],
                                      params["a_log"], bc[..., :N],
                                      bc[..., N:], params["d_skip"],
                                      ssm_state)
    y = y.to(x.dtype) * F.silu(xz[..., di:])
    return y @ params["out_proj"], (new_state, new_conv)
