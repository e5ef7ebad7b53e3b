"""Mixture-of-Experts MLP with top-k routing and per-sequence capacity
dispatch (the reference's ``models/moe.py``).

Plain functions on tensors, as in the reference: the router (d, E) in
f32; the experts stacked on a leading E axis, ``w_gate`` / ``w_up``
(E, d, f) and ``w_down`` (E, f, d) in the model's dtype.  For each
sequence every expert takes its top-C tokens by combine weight, C =
max(1, min(S, int(cf · k · S / E))); tokens past an expert's capacity are
dropped, and an expert that was routed fewer than C tokens fills its slots
with weight-0 tokens.  The expert products are batched matrix products
(``torch.bmm`` over the E experts; the reference leaves them to XLA, no
Pallas kernel computes them), so no custom kernel lies on this path.

Two orders are fixed so that the card, the CPU and the reference agree:

* top-k and top-C come from a stable descending ``torch.sort``, so equal
  values keep the lower index first, as ``jax.lax.top_k`` does (the
  weight-0 fillers above are ties);
* each token's up to k expert outputs are added into the output expert
  by expert, e = 0, …, E − 1: an expert's C tokens of a sequence are
  distinct, so each expert's add is a gather, an add and a plain
  ``index_put_`` that writes each slot once — no atomic order on the card
  (and none of ``index_put_(accumulate=True)``'s sorting).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

_F32 = torch.float32


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    """router (d, E) f32, then w_gate, w_up (E, d, f) and w_down (E, f, d)
    in ``dtype``, drawn in that order from ``gen`` (``dense_init``'s fan-in
    is the leading axis, E for the experts, as in the reference)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {"router": dense_init(gen, (d, E), _F32),
            "w_gate": dense_init(gen, (E, d, f), dtype),
            "w_up": dense_init(gen, (E, d, f), dtype),
            "w_down": dense_init(gen, (E, f, d), dtype)}


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of ``x`` along its last axis and their indices,
    equal values in ascending index order (``jax.lax.top_k``'s rule)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route_topk(gates_logits: torch.Tensor, k: int):
    """gates_logits (..., E) -> (weights, probs, mask), each (..., E) f32:
    the softmax probabilities, the 0/1 mask of each token's top-k experts
    and the combine weights (the masked probabilities renormalized)."""
    probs = torch.softmax(gates_logits.to(_F32), dim=-1)
    _, topi = topk(probs, k)
    mask = torch.zeros_like(probs).scatter_(-1, topi, 1.0)
    weights = probs * mask
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, probs, mask


def load_balance_loss(probs: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """Switch-style auxiliary loss: E · <fraction routed> · <mean prob>."""
    E = probs.shape[-1]
    frac = mask.reshape(-1, E).mean(0)
    mean_p = probs.reshape(-1, E).mean(0)
    return E * (frac * mean_p).sum()


def capacity(S: int, cfg, capacity_factor: float = 2.0) -> int:
    """C, the tokens an expert takes from a sequence of S tokens."""
    k, E = cfg.moe.experts_per_token, cfg.moe.num_experts
    return max(1, min(S, int(capacity_factor * k * S / E)))


def dispatch(weights: torch.Tensor, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert's top-C tokens of each sequence: (top_w, top_idx), both
    (B, E, C), from the (B, S, E) combine weights."""
    return topk(weights.transpose(1, 2), C)


def moe_fwd(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, *,
            capacity_factor: float = 2.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, the load-balance aux loss
    f32): route, dispatch each expert's top-C tokens of each sequence,
    SwiGLU or GELU (tanh form) expert products, each scaled by its combine
    weight and added back expert by expert."""
    B, S, d = x.shape
    E = cfg.moe.num_experts
    logits = x.to(_F32) @ params["router"]                    # (B, S, E)
    weights, probs, mask = route_topk(logits, cfg.moe.experts_per_token)
    aux = load_balance_loss(probs, mask)
    C = capacity(S, cfg, capacity_factor)
    top_w, top_idx = dispatch(weights, C)                      # (B, E, C)

    # the experts' tokens gathered expert-major, (E, B·C, d), so that each
    # expert's products are one matrix product of a bmm over E
    bidx = torch.arange(B, device=x.device)[None, :, None]
    xe = x[bidx, top_idx.transpose(0, 1)].reshape(E, B * C, d)
    if cfg.mlp_style == "swiglu":
        h = F.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["w_up"]), approximate="tanh")
    ye = torch.bmm(h, params["w_down"]).reshape(E, B, C, d)
    ye = ye * top_w.transpose(0, 1)[..., None].to(ye.dtype)

    out = torch.zeros((B, S, d), dtype=ye.dtype, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None]
    for e in range(E):
        # the expert's C tokens of a sequence are distinct: a gather, an
        # add and a plain index_put_ write each once (no sort, no atomics)
        at = (rows, top_idx[:, e])
        out.index_put_(at, out[at] + ye[e])
    return out.to(x.dtype), aux
