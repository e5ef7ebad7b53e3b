"""Serving driver: batched prefill, then a greedy decode loop (the
reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --device cpu

Runs the reduced config in f32, as the reference does, on the CUDA card
unless ``--device cpu``.  :func:`serve` is the loop itself; ``chip_smoke.py``
calls it at full width.  RWKV-6 (``rwkv6-3b``), the dense attention
decoders (``llama3-8b``, ``h2o-danube-1.8b``, ``codeqwen1.5-7b``,
``granite-20b``) and the MoE decoders (``phi3.5-moe-42b-a6.6b``,
``dbrx-132b``) are ported; the other architectures raise
``NotImplementedError`` (ROADMAP A11).

Unlike the reference's serve loop, this one decodes from a cache with room
for the new tokens (``model.grow_cache``): the reference decodes from the
prefill's cache of exactly S slots and overwrites the last prompt token's
K and V at every step.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import LMParams, Model, build_model, make_batch
from repro_torch.utils.device import resolve_device


class Served(NamedTuple):
    tokens: torch.Tensor     # (B, max_new) greedy tokens
    logits: torch.Tensor     # (B, V) logits of the last step
    cache: Dict              # the cache after the last step
    prefill_s: float         # seconds in the prefill, its argmax and
    #                          growing the cache
    decode_s: float          # seconds in the max_new - 1 decode steps


def serve(model: Model, params: LMParams, prompt: torch.Tensor,
          max_new: int) -> Served:
    """Prefill ``prompt`` (B, S) and decode greedily: ``max_new`` tokens,
    the first from the prefill's logits, the rest from ``max_new - 1``
    decode steps from the prefill's cache grown to S + ``max_new`` tokens.
    The tokens are those of decoding the prompt token by token from an
    empty cache, and of the reference's prefill of prompt + generated
    tokens.  Each phase's seconds end in a device synchronize."""
    if max_new < 1:
        raise ValueError("max_new must be at least 1")

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt})
    tok = logits.argmax(-1)[:, None]
    cache = model.grow_cache(cache, prompt.shape[1] + max_new)
    sync()
    prefill_s = time.perf_counter() - t0
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(params, tok, cache)
        tok = logits.argmax(-1)[:, None]
        toks.append(tok)
    sync()
    return Served(torch.cat(toks, dim=1), logits, cache, prefill_s,
                  time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, torch.float32, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, InputShape("serve", args.prompt_len,
                                       args.requests, "prefill"),
                       torch.Generator(device=dev).manual_seed(1))
    res = serve(model, params, batch["tokens"], args.max_new)
    n_done = args.max_new - 1
    print(f"[serve] {cfg.name} on {dev}: prefill {args.requests}x"
          f"{args.prompt_len} in {res.prefill_s:.2f}s; {n_done} decode steps "
          f"in {res.decode_s:.2f}s "
          f"({args.requests * n_done / max(res.decode_s, 1e-9):.1f} tok/s)")


if __name__ == "__main__":
    main()
