"""The decoder stack (the reference's ``models/transformer.py``), for the
families the port runs so far: RWKV-6, the dense attention decoders
(RoPE, grouped-query attention, a SwiGLU or GELU MLP), the MoE decoders
(the same attention, then :mod:`repro_torch.models.moe` in place of the
MLP) and the Jamba hybrid (pattern blocks of P = 8 layers: Mamba mixers,
:mod:`repro_torch.models.mamba`, at positions 0–6 and attention at 7; an
MoE MLP at odd positions, a dense one at even).

The reference stacks each pattern position's parameters on a leading
(num_layers // P) axis and drives the stack with one ``lax.scan``; here
each layer is an :class:`Layer` module in an ``nn.ModuleList`` and a Python
loop walks them in order, layer i of kind ``layer_kind(cfg, i mod P)``.
:func:`require_ported` checks the layer kinds once, when the model is
built; every kind of the reference's decoders is ported.  The hybrid
serves; :func:`require_trainable` refuses to train it, since its
``selective_scan`` kernel has no backward yet (ROADMAP A11).  Every
parameter is trainable (serving runs under ``torch.no_grad``); :func:`stack_forward`'s ``remat``
recomputes each layer in the backward, as the reference's
``jax.checkpoint`` of a pattern block does.  An MoE layer adds its
load-balance loss to the stack's auxiliary loss (the sum over layers, as
the reference's scan sums it); no sharding hints (the reference's
``gather_fsdp`` / ``constrain_activations`` are no-ops on one device).

A decode cache is ``{"len": int, "layers": [per-layer dict]}``; an RWKV
layer's dict holds ``wkv`` (B, Hn, D, D) f32 and ``shift_tm`` /
``shift_cm`` (B, d) in the model's dtype; a Mamba layer's ``ssm`` (B, di,
N) f32 and ``conv`` (B, Kc − 1, di) in the model's dtype; an attention
layer's ``k`` and ``v`` (B, Smax, Hkv, Dh) in the model's dtype, Smax =
``cache_max_len``: slot = position for a full-length cache, position mod
Smax for a sliding window's ring.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A11: the other model families)")


# --------------------------------------------------------------------- #
# layer-kind pattern
# --------------------------------------------------------------------- #


def pattern_period(cfg: ArchConfig) -> int:
    p = 1
    if cfg.attn_period:
        p = math.lcm(p, cfg.attn_period)
    if cfg.moe is not None and cfg.moe_period:
        p = math.lcm(p, cfg.moe_period)
    return p


def layer_kind(cfg: ArchConfig, j: int) -> Tuple[str, str]:
    """Kind of the layer at pattern position j: (mixer, mlp)."""
    if cfg.attention_free:
        return "rwkv", "rwkv_cm"
    mixer = "attn"
    if cfg.attn_period and (j % cfg.attn_period) != cfg.attn_period - 1:
        mixer = "mamba"
    mlp = "dense"
    if cfg.moe is not None and cfg.moe_period and (j % cfg.moe_period) == cfg.moe_period - 1:
        mlp = "moe"
    return mixer, mlp


#: the (mixer, mlp) layer kinds the port has layers for -> their
#: parameter groups' names
PORTED_KINDS = {("rwkv", "rwkv_cm"): ("rwkv_tm", "rwkv_cm"),
                ("attn", "dense"): ("attn", "mlp"),
                ("attn", "moe"): ("attn", "moe"),
                ("mamba", "dense"): ("mamba", "mlp"),
                ("mamba", "moe"): ("mamba", "moe")}


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is of a kind in
    :data:`PORTED_KINDS`."""
    for j in range(pattern_period(cfg)):
        mixer, mlp = layer_kind(cfg, j)
        if (mixer, mlp) not in PORTED_KINDS:
            raise unported(f"a {mixer} / {mlp} layer ({cfg.name})")


def require_trainable(cfg: ArchConfig) -> None:
    """Raise for a config with a Mamba layer: the ``selective_scan``
    kernel has no backward yet, so the hybrid serves but does not train."""
    if any(layer_kind(cfg, j)[0] == "mamba"
           for j in range(pattern_period(cfg))):
        raise unported(f"training the Mamba layers of {cfg.name} (the "
                       "selective_scan backward kernel)")


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #


class Layer(nn.Module):
    """One layer's parameters under the reference's names: ``norm1``,
    ``norm2`` and the groups of its kind (dicts of tensors) — ``rwkv_tm``
    and ``rwkv_cm`` for RWKV, then a mixer (``attn`` or ``mamba``) and an
    MLP (``mlp`` or ``moe``) — each an ``nn.Parameter`` over the given
    tensor (no copy)."""

    def __init__(self, params: Mapping[str, object]):
        super().__init__()
        self.norm1 = nn.Parameter(params["norm1"])
        self.norm2 = nn.Parameter(params["norm2"])
        groups = [g for g in ("rwkv_tm", "rwkv_cm", "attn", "mamba", "mlp",
                              "moe") if g in params]
        if tuple(groups) not in PORTED_KINDS.values():
            raise unported(f"a layer of {sorted(params)}")
        for g in groups:
            setattr(self, g, nn.ParameterDict(dict(params[g])))


def _init_layer(gen: torch.Generator, cfg: ArchConfig, j: int,
                dtype: torch.dtype) -> Layer:
    """The layer at pattern position ``j``: norm1, norm2, then the mixer's
    draws (RWKV time mix, attention or Mamba) and the MLP's (RWKV channel
    mix, dense or MoE), in that order from ``gen``."""
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=gen.device)
    p = {"norm1": ones, "norm2": ones.clone()}
    mixer, mlp = layer_kind(cfg, j)
    if mixer == "rwkv":
        p["rwkv_tm"] = R.init_rwkv_time_mix(gen, cfg, dtype)
        p["rwkv_cm"] = R.init_rwkv_channel_mix(gen, cfg, dtype)
        return Layer(p)
    if mixer == "mamba":
        p["mamba"] = M.init_mamba(gen, cfg, dtype)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype)
    if mlp == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype)
    return Layer(p)


def init_stack(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> nn.ModuleList:
    """cfg.num_layers layers, drawn in order from ``gen``."""
    P = pattern_period(cfg)
    return nn.ModuleList(_init_layer(gen, cfg, i % P, dtype)
                         for i in range(cfg.num_layers))


# --------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------- #


def _mlp_fwd(p: Layer, h: torch.Tensor, cfg: ArchConfig):
    """The layer's MLP on h: (out, the MoE's aux loss or None)."""
    if hasattr(p, "moe"):
        return MOE.moe_fwd(p.moe, h, cfg)
    return L.mlp_fwd(p.mlp, h, cfg), None


def _apply_layer_fwd(p: Layer, x: torch.Tensor, cfg: ArchConfig,
                     positions: torch.Tensor):
    """Returns (x, cache_entry, aux): aux the MoE layer's load-balance loss,
    None for the other kinds."""
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    if cfg.attention_free:
        o, (st, sl) = R.rwkv_time_mix(p.rwkv_tm, h, cfg)
        x = x + o
        h = L.rms_norm(x, p.norm2, cfg.norm_eps)
        o, sl_cm = R.rwkv_channel_mix(p.rwkv_cm, h)
        return x + o, {"wkv": st, "shift_tm": sl, "shift_cm": sl_cm}, None
    if hasattr(p, "mamba"):
        o, (ssm, conv) = M.mamba_fwd(p.mamba, h, cfg)
        entry = {"ssm": ssm, "conv": conv}
    else:
        o, (k, v) = L.attention_fwd(p.attn, h, cfg, positions)
        entry = {"k": k, "v": v}
    x = x + o
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    o, aux = _mlp_fwd(p, h, cfg)
    return x + o, entry, aux


def stack_forward(layers: nn.ModuleList, cfg: ArchConfig, x: torch.Tensor,
                  *, remat: bool = False, collect_cache: bool = True):
    """x: (B, S, d) -> (hidden, the per-layer cache entries ([] without
    ``collect_cache``), the auxiliary loss: the MoE layers' load-balance
    losses summed, 0 without one).  With ``remat`` each layer runs under a
    non-reentrant ``torch.utils.checkpoint``: only its input is kept for
    the backward, which runs the layer's forward again (one more ``wkv6``
    launch a layer on the card, or one more attention call or Mamba scan
    and expert dispatch); the aux loss comes out of the checkpointed layer
    with its hidden state."""
    positions = torch.arange(x.shape[1], device=x.device)
    entries: List[Dict] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        if remat:
            x, entry, a = checkpoint(_apply_layer_fwd, p, x, cfg, positions,
                                     use_reentrant=False)
        else:
            x, entry, a = _apply_layer_fwd(p, x, cfg, positions)
        if a is not None:
            aux = aux + a
        if collect_cache:
            entries.append(entry)
    return x, entries, aux


# --------------------------------------------------------------------- #
# decode (one token, stateful caches)
# --------------------------------------------------------------------- #


def cache_max_len(cfg: ArchConfig, max_seq: int) -> int:
    """Slots of an attention cache for ``max_seq`` tokens: the window's
    ring where there is one."""
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict:
    """An empty cache (RWKV's and Mamba's states do not grow with
    ``max_seq``; an attention layer's K and V hold ``cache_max_len(cfg,
    max_seq)`` slots)."""
    d = cfg.d_model
    P = pattern_period(cfg)
    layers = []
    for i in range(cfg.num_layers):
        mixer = layer_kind(cfg, i % P)[0]
        if mixer == "rwkv":
            hd = cfg.rwkv_head_dim
            layers.append({
                "wkv": torch.zeros((batch, d // hd, hd, hd),
                                   dtype=torch.float32, device=device),
                "shift_tm": torch.zeros((batch, d), dtype=dtype,
                                        device=device),
                "shift_cm": torch.zeros((batch, d), dtype=dtype,
                                        device=device),
            })
        elif mixer == "mamba":
            di = cfg.mamba_expand * d
            layers.append({
                "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                    dtype=dtype, device=device),
            })
        else:
            shp = (batch, cache_max_len(cfg, max_seq), cfg.num_kv_heads,
                   cfg.head_dim)
            layers.append({"k": torch.zeros(shp, dtype=dtype, device=device),
                           "v": torch.zeros(shp, dtype=dtype, device=device)})
    return {"len": 0, "layers": layers}


def _apply_layer_decode(p: Layer, x: torch.Tensor, cfg: ArchConfig,
                        cache_j: Mapping[str, torch.Tensor], cur_len: int):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    if cfg.attention_free:
        o, (st, sl) = R.rwkv_time_mix(p.rwkv_tm, h, cfg,
                                      state=cache_j["wkv"],
                                      shift_last=cache_j["shift_tm"])
        x = x + o
        h = L.rms_norm(x, p.norm2, cfg.norm_eps)
        o, sl_cm = R.rwkv_channel_mix(p.rwkv_cm, h,
                                      shift_last=cache_j["shift_cm"])
        return x + o, {"wkv": st, "shift_tm": sl, "shift_cm": sl_cm}
    if hasattr(p, "mamba"):
        o, (ssm, conv) = M.mamba_fwd(p.mamba, h, cfg,
                                     ssm_state=cache_j["ssm"],
                                     conv_state=cache_j["conv"])
        entry = {"ssm": ssm, "conv": conv}
    else:
        # slot = position, or position mod Smax in a window's ring; the
        # window is not applied again: the ring holds exactly its keys
        smax = cache_j["k"].shape[1]
        slot = cur_len % smax if cfg.sliding_window is not None else cur_len
        o, ck, cv = L.attention_decode(p.attn, h, cfg, cache_j["k"],
                                       cache_j["v"], cur_len, slot=slot,
                                       n_valid=min(cur_len + 1, smax))
        entry = {"k": ck, "v": cv}
    x = x + o
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    # an MoE layer dispatches the one token of each sequence to every
    # expert (C = 1), the unrouted ones at weight 0, as the reference
    return x + _mlp_fwd(p, h, cfg)[0], entry


def stack_decode(layers: nn.ModuleList, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict):
    """x: (B, 1, d).  Returns (x, new_cache).  RWKV and Mamba states are
    new tensors (``cache``'s are left as they are); an attention layer
    writes the token's K and V **in place** into the preallocated ``k`` / ``v``
    (so ``cache`` and ``new_cache`` share them): a functional copy would
    move the whole cache every step (llama3-8b's 2.2 GB at 8 × 2,080
    tokens, beside 16 GB of weights read)."""
    new_layers = []
    for p, cj in zip(layers, cache["layers"]):
        x, nc = _apply_layer_decode(p, x, cfg, cj, cache["len"])
        new_layers.append(nc)
    return x, {"len": cache["len"] + 1, "layers": new_layers}
