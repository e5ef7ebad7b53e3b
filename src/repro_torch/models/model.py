"""Top-level model API (the reference's ``models/model.py``):
``build_model(cfg, dtype, device)`` -> :class:`Model`.

A :class:`Model` is a bundle of functions over an explicit parameter
module, as in the reference:

    init(gen)                          -> params (an :class:`LMParams`)
    loss(params, batch)                -> (scalar, metrics)      # train
    prefill(params, batch)             -> (last_logits, cache)   # inference
    init_cache(batch, max_seq)         -> cache
    grow_cache(cache, max_seq)         -> cache with room for max_seq
    decode_step(params, tokens, cache) -> (logits, cache)        # one token

Only the decoder-only families the port has layers for are built (RWKV-6,
the dense attention decoders, the MoE decoders and the Mamba / attention /
MoE hybrid, which serves but does not train yet); the vision and audio
front-ends and the encoder-decoder wait for ROADMAP A11.
``loss`` returns ce + the config's ``load_balance_weight`` · the MoE
layers' summed load-balance loss (0 without MoE layers), with metrics
``{"ce", "aux"}``, as the reference's does.

``prefill`` returns the reference's cache: an attention layer's K and V of
exactly the prompt's S tokens (the window's last entries as a ring where
S exceeds it), which has no slot left for a decoded token.  The
reference's decode step writes position S at a slot clamped to S − 1 and
so overwrites the last prompt token (and, under a window with S < W, its
ring of size S overwrites token 0).  The port's decode step raises there
instead; :func:`grow_cache` copies a prefill cache into ``init_cache(B,
max_seq)``'s layout, and ``launch/serve.serve`` calls it before the first
decode step.

Batches: ``{tokens, labels, mask}``, tokens and labels int64 (B, S),
mask float (B, S).  ``prefill`` and ``decode_step`` run under
``torch.no_grad``; ``loss`` builds the autograd graph (each layer
rematerialized, as the reference's ``loss`` does).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dtype: torch.dtype
    device: torch.device
    init: Callable
    loss: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable
    grow_cache: Callable


class LMParams(nn.Module):
    """Embedding, output norm, unembedding (unless tied) and the layers;
    every parameter trainable, named as ``named_parameters()`` gives them
    (``embed``, ``out_norm``, ``unembed``, ``layers.{i}.norm1``,
    ``layers.{i}.rwkv_tm.wr``, ...)."""

    def __init__(self, embeddings: Mapping[str, torch.Tensor],
                 layers: nn.ModuleList):
        super().__init__()
        self.embed = nn.Parameter(embeddings["embed"])
        self.out_norm = nn.Parameter(embeddings["out_norm"])
        self.unembed = (nn.Parameter(embeddings["unembed"])
                        if "unembed" in embeddings else None)
        self.layers = layers

    @classmethod
    def from_named(cls, named: Mapping[str, torch.Tensor]) -> "LMParams":
        """The parameters over the tensors of ``named`` (no copy), keyed as
        ``named_parameters()`` keys them."""
        emb = {k: v for k, v in named.items() if "." not in k}
        layers: Dict[int, Dict] = {}
        for key, v in named.items():
            if "." not in key:
                continue
            _, i, *path = key.split(".")
            node = layers.setdefault(int(i), {})
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = v
        return cls(emb, nn.ModuleList(T.Layer(layers[i])
                                      for i in range(len(layers))))


def _init_embeddings(gen: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    dev = gen.device
    p = {"embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                               device=dev) * 0.02).to(dtype),
         "out_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                    generator=gen, device=dev)
                        * 0.02).to(dtype)
    return p


def _unembed(params: LMParams, cfg: ArchConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.unembed


# --------------------------------------------------------------------- #
# decoder-only families
# --------------------------------------------------------------------- #


def _build_decoder_only(cfg: ArchConfig, dtype: torch.dtype,
                        device: torch.device) -> Model:
    def init(gen: torch.Generator) -> LMParams:
        if gen.device.type != device.type:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {device}")
        emb = _init_embeddings(gen, cfg, dtype)
        return LMParams(emb, T.init_stack(gen, cfg, dtype))

    def loss(params: LMParams, batch: Mapping[str, torch.Tensor]):
        x = params.embed[batch["tokens"]]
        h, _, aux = T.stack_forward(params.layers, cfg, x, remat=True,
                                    collect_cache=False)
        h = L.rms_norm(h, params.out_norm, cfg.norm_eps)
        ce = L.lm_head_loss(h, _unembed(params, cfg), batch["labels"],
                            batch["mask"])
        # the reference's ce + 0.0 · aux without MoE layers is ce itself
        total = (ce if cfg.moe is None
                 else ce + cfg.moe.load_balance_weight * aux)
        return total, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(params: LMParams, batch: Mapping[str, torch.Tensor]):
        x = params.embed[batch["tokens"]]
        S = x.shape[1]
        h, entries, _ = T.stack_forward(params.layers, cfg, x)
        h = L.rms_norm(h, params.out_norm, cfg.norm_eps)
        logits = h[:, -1] @ _unembed(params, cfg)
        return logits, _prefill_cache_from_entries(cfg, entries, S)

    def init_cache(batch: int, max_seq: int) -> Dict:
        return T.init_cache(cfg, batch, max_seq, dtype, device)

    @torch.no_grad()
    def decode_step(params: LMParams, tokens: torch.Tensor, cache: Dict):
        x = params.embed[tokens]                                # (B, 1, d)
        h, cache = T.stack_decode(params.layers, cfg, x, cache)
        h = L.rms_norm(h, params.out_norm, cfg.norm_eps)
        logits = h[:, -1] @ _unembed(params, cfg)
        return logits, cache

    return Model(cfg, dtype, device, init, loss, prefill, init_cache,
                 decode_step, functools.partial(grow_cache, cfg))


def _prefill_cache_from_entries(cfg: ArchConfig, entries: List[Dict],
                                seq_len: int) -> Dict:
    """Turn stack_forward's per-layer cache entries into the decode-cache
    layout: recurrent entries (RWKV's, Mamba's ``ssm`` and ``conv``) carry
    their final states; an attention layer's K and V (B, S, Hkv, Dh)
    become the cache, or, under a window
    with S > W, its last W entries rolled by S mod W (position p at slot
    p mod W, the decode ring's layout)."""
    smax = T.cache_max_len(cfg, seq_len)
    layers = []
    for e in entries:
        if "k" in e:
            k, v = e["k"], e["v"]
            if cfg.sliding_window is not None and seq_len > smax:
                k, v = (torch.roll(t[:, -smax:], shifts=seq_len % smax,
                                   dims=1) for t in (k, v))
            layers.append({"k": k, "v": v})
        elif "ssm" in e:
            layers.append({"ssm": e["ssm"], "conv": e["conv"]})
        elif "wkv" in e:
            layers.append({"wkv": e["wkv"], "shift_tm": e["shift_tm"],
                           "shift_cm": e.get("shift_cm", e["shift_tm"])})
        else:
            raise T.unported(f"a {sorted(e)} cache entry ({cfg.name})")
    return {"len": seq_len, "layers": layers}


def grow_cache(cfg: ArchConfig, cache: Dict, max_seq: int) -> Dict:
    """``cache`` (a prefill's, or any with ``len`` tokens) in
    ``init_cache(B, max_seq)``'s layout, so that decoding may continue to
    ``max_seq`` tokens: an attention layer's K and V in
    ``cache_max_len(cfg, max_seq)`` slots, its ``len`` entries at slots
    0..len−1 (a layer that already has that many slots, a full window's
    ring among them, is kept as it is); RWKV and Mamba entries
    unchanged.  Raises for a ring that has wrapped into fewer slots."""
    n = cache["len"]
    if max_seq < n:
        raise ValueError(f"max_seq {max_seq} is below the cache's {n} "
                         "tokens")
    smax = T.cache_max_len(cfg, max_seq)
    layers = []
    for e in cache["layers"]:
        if "k" in e and e["k"].shape[1] != smax:
            if e["k"].shape[1] < n:
                raise ValueError(f"a ring of {e['k'].shape[1]} slots cannot "
                                 f"grow to {smax}")
            grown = {}
            for name in ("k", "v"):
                t = e[name]
                grown[name] = t.new_zeros((t.shape[0], smax, *t.shape[2:]))
                grown[name][:, :n] = t[:, :n]
            e = grown
        layers.append(e)
    return {"len": n, "layers": layers}


# --------------------------------------------------------------------- #


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Model:
    """The model of ``cfg`` in ``dtype`` on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if cfg.family == "encdec_audio":
        raise T.unported(f"the encoder-decoder ({cfg.name})")
    if cfg.family == "vlm":
        raise T.unported(f"the vision front-end ({cfg.name})")
    T.require_ported(cfg)
    return _build_decoder_only(cfg, dtype, dev)


def make_batch(cfg: ArchConfig, shape, gen: Optional[torch.Generator] = None,
               *, device: DeviceLike = None) -> Dict[str, Any]:
    """A random token batch of ``shape`` (an InputShape: global_batch ×
    seq_len) drawn from ``gen`` on its device (default: seed 0 on
    ``device``)."""
    if cfg.family in ("vlm", "encdec_audio"):
        raise T.unported(f"batches of the {cfg.family} family")
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    B, S = shape.global_batch, shape.seq_len

    def tokens():
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=gen.device)

    toks = tokens()
    return {"tokens": toks, "labels": tokens(),
            "mask": torch.ones((B, S), dtype=torch.float32,
                               device=gen.device)}
