"""RWKV-6 (Finch) block — attention-free time mixing with data-dependent
decay; the port of the reference's ``models/rwkv.py``.

Per head h with head_dim D, the recurrence over the (D, D) state S is

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

where w_t = exp(-exp(decay_t)) is the data-dependent per-channel decay.
Which WKV path a call takes (:func:`rwkv_time_mix`):

* S > 1 (every prefill, from zeros or a given state): the wkv6 kernel
  through :func:`repro_torch.kernels.ops.wkv6` over the whole chunks of
  L = min(32, S) tokens — the reference's ``_wkv_chunked`` — reading the
  projections in their (B, S, Hn, D) layout with no copy, then
  :func:`_wkv_sequential` over a ragged tail of fewer than L tokens, from
  the kernel's final state (the reference runs a ragged S sequentially
  throughout);
* S == 1 (decode): :func:`_wkv_sequential`, the reference's own branch.

Training differentiates the same path: ``ops.wkv6`` is an autograd
function on the card (the wkv6_bwd kernel computes its VJP) and the plain
version on the CPU, and autograd takes the ragged tail's sequential WKV
back into the kernel's final state.

Parameters are dicts (or ``nn.ParameterDict``s) of tensors with the
reference's names and shapes; the simplifications of the reference (one
token-shift interpolation set, a decay LoRA of rank 64) are kept.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import WKV_CHUNK
from repro_torch.models.layers import dense_init

Params = Mapping[str, torch.Tensor]

_F32 = torch.float32
DECAY_LORA = 64


def init_rwkv_time_mix(gen: torch.Generator, cfg,
                       dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The time-mix parameters, drawn from ``gen`` on its device."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=_F32, device=dev)

    return {
        "mix_r": full((d,), 0.5),
        "mix_k": full((d,), 0.5),
        "mix_v": full((d,), 0.5),
        "mix_w": full((d,), 0.5),
        "wr": dense_init(gen, (d, d), dtype),
        "wk": dense_init(gen, (d, d), dtype),
        "wv": dense_init(gen, (d, d), dtype),
        "wo": dense_init(gen, (d, d), dtype),
        # data-dependent decay LoRA: w_t = exp(-exp(decay_base + lora(x)))
        "decay_base": full((d,), -6.0),
        "decay_a": dense_init(gen, (d, DECAY_LORA), dtype),
        "decay_b": dense_init(gen, (DECAY_LORA, d), dtype),
        "bonus_u": full((d // hd, hd), 0.0),
        "ln_x_w": full((d,), 1.0),
    }


def _token_shift(x: torch.Tensor, mix: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d), shifted by one step and mixed with itself; ``last``
    (B, d) seeds position -1 (decode), else zeros (prefill)."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    elif x.shape[1] > 1:
        prev = torch.cat([last[:, None], x[:, :-1]], dim=1)
    else:
        prev = last[:, None]
    return x * mix + prev * (1.0 - mix)


def _wkv_sequential(r, k, v, w, u, state):
    """WKV one step at a time (the oracle, and the O(1)-state decode path).
    r, k, v, w: (B, S, Hn, D) f32; u: (Hn, D); state: (B, Hn, D, D)."""
    s = state
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # (B, Hn, D)
        kv = kt[..., :, None] * vt[..., None, :]                # (B, Hn, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 u[None, :, :, None] * kv + s))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(params: Params, x: torch.Tensor, cfg, *,
                  state: Optional[torch.Tensor] = None,
                  shift_last: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), (final wkv state (B, Hn, D, D) f32,
    shift_last (B, d))."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    Hn = d // hd

    xr = _token_shift(x, params["mix_r"].to(x.dtype), shift_last)
    xk = _token_shift(x, params["mix_k"].to(x.dtype), shift_last)
    xv = _token_shift(x, params["mix_v"].to(x.dtype), shift_last)
    xw = _token_shift(x, params["mix_w"].to(x.dtype), shift_last)

    r = (xr @ params["wr"]).reshape(B, S, Hn, hd).to(_F32)
    k = (xk @ params["wk"]).reshape(B, S, Hn, hd).to(_F32)
    v = (xv @ params["wv"]).reshape(B, S, Hn, hd).to(_F32)

    decay = params["decay_base"] + (
        torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]).to(_F32)
    w = torch.exp(-torch.exp(decay)).reshape(B, S, Hn, hd)    # in (0, 1)

    u = params["bonus_u"]
    if S == 1:
        if state is None:
            state = torch.zeros((B, Hn, hd, hd), dtype=_F32, device=x.device)
        out, state = _wkv_sequential(r, k, v, w, u, state)
    else:
        L = min(WKV_CHUNK, S)
        n = S - S % L
        # the kernel reads the projections' (B, S, Hn, D) storage in place
        # (for a ragged S a strided view) and writes out in that layout
        if state is not None:
            state = state.contiguous()
        out, state = ops.wkv6(r[:, :n], k[:, :n], v[:, :n], w[:, :n], u, L,
                              state=state)
        if n < S:
            tail, state = _wkv_sequential(r[:, n:], k[:, n:], v[:, n:],
                                          w[:, n:], u, state)
            out = torch.cat([out, tail], dim=1)

    # group norm over heads (ln_x in the reference implementation)
    out = out.reshape(B, S, Hn, hd)
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(B, S, d) * params["ln_x_w"]
    return out.to(x.dtype) @ params["wo"], (state, x[:, -1])


def init_rwkv_channel_mix(gen: torch.Generator, cfg,
                          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5, dtype=_F32, device=gen.device),
        "wk": dense_init(gen, (d, f), dtype),
        "wv": dense_init(gen, (f, d), dtype),
    }


def rwkv_channel_mix(params: Params, x: torch.Tensor, *,
                     shift_last: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), shift_last (B, d)."""
    xk = _token_shift(x, params["mix_k"].to(x.dtype), shift_last)
    h = torch.square(torch.relu(xk @ params["wk"]))
    return h @ params["wv"], x[:, -1]
