"""End-to-end driver: federated training of a ~100M-class language model
with FSVRG rounds (the reference's ``examples/federated_lm.py``).

Clients are synthetic non-IID token streams — each client has a private
token distribution (the LM analogue of the paper's per-author vocabulary)
— and the round applies the per-vocab-row S_k / A scaling of Algorithm 4.

    PYTHONPATH=src python -m repro_torch.examples.federated_lm --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.examples.federated_lm --device cpu --rounds 3
    PYTHONPATH=src python -m repro_torch.examples.federated_lm --arch llama3-8b --device cpu

Trains the reference's reduced "~100M" variant of the architecture (4
layers, d 256, d_ff 1,024, vocab 8,192; an attention decoder's 4 heads of
64 over 2 KV heads) in f32, on the CUDA card unless ``--device cpu``:
RWKV-6, a dense attention decoder or an MoE decoder (the reduced
config's 4 experts).  A family the port has no layers for raises
``NotImplementedError``, as ``build_model`` does, and so does the Jamba
hybrid, whose ``selective_scan`` kernel has no backward yet (ROADMAP
A11).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import neural
from repro_torch.models import build_model
from repro_torch.models.transformer import require_trainable
from repro_torch.utils.device import resolve_device


def synthetic_federated_tokens(rng, num_clients, batch_per_client, seq_len,
                               vocab, steps_per_client):
    """Each client samples from its own zipf-reweighted vocabulary slice."""
    out = []
    base = 1.0 / (np.arange(2, vocab) ** 1.05)
    for _ in range(num_clients):
        own = rng.choice(np.arange(2, vocab), size=max(8, vocab // 50),
                         replace=False)
        p = base.copy()
        p[own - 2] *= 50.0                      # client-specific skew
        p = np.concatenate([[0.02, 0.02], p / p.sum() * 0.96])
        p = p / p.sum()
        toks = rng.choice(vocab, size=(steps_per_client, batch_per_client,
                                       seq_len + 1), p=p)
        out.append(toks)
    return np.stack(out)                        # (C, T, B_c, S+1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--stepsize", type=float, default=0.5)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the CUDA card")
    args = ap.parse_args(argv)

    # ~100M-class variant: reduced depth / width but real vocab structure
    cfg = get_config(args.arch).reduced()
    require_trainable(cfg)
    cfg = dataclasses.replace(cfg, name=cfg.name + "-100m", num_layers=4,
                              d_model=256, d_ff=1024, vocab_size=8192,
                              num_heads=4, num_kv_heads=2, head_dim=64)
    dev = resolve_device(args.device)
    model = build_model(cfg, torch.float32, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"C={args.clients} T={args.local_steps} seq={args.seq} "
          f"device={dev}")

    rng = np.random.default_rng(0)
    rnd = neural.make_fsvrg_round(
        model, neural.FedNeuralConfig(stepsize=args.stepsize,
                                      local_steps=args.local_steps))

    def loss_of(p, batch):
        with torch.no_grad():
            return float(model.loss(p, batch)[0])

    held_out = None
    t0 = time.time()
    for r in range(args.rounds):
        toks = torch.as_tensor(synthetic_federated_tokens(
            rng, args.clients, args.batch_per_client, args.seq,
            cfg.vocab_size, args.local_steps), dtype=torch.int64, device=dev)
        cb = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
              "mask": torch.ones(toks[..., 1:].shape, dtype=torch.float32,
                                 device=dev)}
        if held_out is None:
            held_out = {k: x[0, 0] for k, x in cb.items()}  # client-0 batch
        params, metrics = rnd(params, cb)
        if (r + 1) % args.eval_every == 0 or r == 0:
            print(f"round {r + 1:4d}: held-out loss="
                  f"{loss_of(params, held_out):.4f} "
                  f"|∇f|={float(metrics['full_grad_norm']):.4f} "
                  f"({time.time() - t0:.0f}s)")

    final = loss_of(params, held_out)
    print(f"done: final held-out loss {final:.4f} "
          f"(random-init would be ~{np.log(cfg.vocab_size):.2f})")
    return final


if __name__ == "__main__":
    main()
