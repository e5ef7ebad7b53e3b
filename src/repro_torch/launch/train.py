"""Training driver (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --mode fsvrg
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --mode fsvrg --full
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --device cpu

Modes:
  fsvrg  — the paper's federated rounds (``core/neural.py``)
  fedavg — local-SGD baseline rounds
  adamw  — centralized training steps (the FSVRGR / centralized reference)

Runs the reduced config in f32 by default, as the reference does, and the
full config in bf16 with ``--full``; on the CUDA card unless
``--device cpu``.  RWKV-6 (``rwkv6-3b``), the dense attention decoders
(``llama3-8b``, ``h2o-danube-1.8b``, ``codeqwen1.5-7b``, ``granite-20b``)
and the MoE decoders (``phi3.5-moe-42b-a6.6b``, ``dbrx-132b``) train;
the Jamba hybrid (``jamba-v0.1-52b``) raises ``NotImplementedError``
until its ``selective_scan`` kernel has a backward, and the other
architectures until they are ported (ROADMAP A11).  At full width one
80 GB card trains rwkv6-3b and h2o-danube-1.8b; the 7–20 B decoders need the
sharded mesh.  ``--production-mesh`` (the reference's sharded mesh,
ROADMAP A12) raises ``NotImplementedError``.

``--checkpoint-dir DIR`` saves the final parameters there in the
reference's tree layout and checkpoint format
(:func:`repro_torch.bridge.tensor_tree_from_params`,
:mod:`repro_torch.checkpoint`; bf16 stays bf16), at step ``--rounds`` with
metadata ``{"arch", "mode"}``, as the reference's driver does: either
package restores it, and ``bridge.params_from_tree`` turns the restored
tree back into the port's parameters.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.bridge import tensor_tree_from_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import neural
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.transformer import require_trainable, unported
from repro_torch.optim import adamw
from repro_torch.utils.device import DeviceLike, resolve_device


def synthetic_batch(rng: np.random.Generator, cfg: ArchConfig,
                    num_clients: int, local_steps: int,
                    batch_per_client: int, seq: int,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random next-token batches (C, T, B_c, seq) drawn from ``rng`` as the
    reference draws them: tokens and labels (int64) one position apart,
    mask all ones."""
    if cfg.family in ("vlm", "encdec_audio"):
        raise unported(f"batches of the {cfg.family} family")
    dev = resolve_device(device)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(num_clients, local_steps, batch_per_client,
                              seq + 1))
    return {"tokens": torch.as_tensor(toks[..., :-1], dtype=torch.int64,
                                      device=dev),
            "labels": torch.as_tensor(toks[..., 1:], dtype=torch.int64,
                                      device=dev),
            "mask": torch.ones(toks[..., 1:].shape, dtype=torch.float32,
                               device=dev)}


def main(argv=None) -> List[Tuple[int, float]]:
    """Run the driver; returns the (round or step, loss) pairs it logged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(ARCH_IDS))
    ap.add_argument("--mode", default="fsvrg",
                    choices=["fsvrg", "fedavg", "adamw"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--stepsize", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the CUDA card")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the sharded mesh is not ported yet "
            "(ROADMAP A12)")

    cfg = get_config(args.arch)
    require_trainable(cfg)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    dev = resolve_device(args.device)
    model = build_model(cfg, dtype, dev)
    rng = np.random.default_rng(0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name} mode={args.mode} params={n_params / 1e6:.1f}M "
          f"device={dev}")

    logged = []
    t0 = time.time()
    if args.mode in ("fsvrg", "fedavg"):
        fed = neural.FedNeuralConfig(stepsize=args.stepsize,
                                     local_steps=args.local_steps,
                                     algorithm=args.mode)
        step = steps.make_fsvrg_step(model, fed)
        for r in range(args.rounds):
            batch = synthetic_batch(rng, cfg, args.clients, args.local_steps,
                                    args.batch_per_client, args.seq, dev)
            params, metrics = step(params, batch)
            if (r + 1) % args.log_every == 0 or r == 0:
                flat = {k: x[0, 0] for k, x in batch.items()}
                with torch.no_grad():
                    loss = float(model.loss(params, flat)[0])
                logged.append((r + 1, loss))
                print(f"round {r + 1:4d}: loss={loss:.4f} "
                      f"|∇f|={float(metrics['full_grad_norm']):.4f} "
                      f"({time.time() - t0:.0f}s)")
    else:
        opt = adamw(args.lr)
        opt_state = opt.init(dict(params.named_parameters()))
        opt_step = 0
        step = steps.make_adamw_step(model, opt)
        for r in range(args.rounds):
            b = synthetic_batch(rng, cfg, 1, 1,
                                args.clients * args.batch_per_client,
                                args.seq, dev)
            flat = {k: x[0, 0] for k, x in b.items()}
            params, opt_state, opt_step, loss, _ = step(params, opt_state,
                                                        opt_step, flat)
            if (r + 1) % args.log_every == 0 or r == 0:
                logged.append((r + 1, float(loss)))
                print(f"step {r + 1:4d}: loss={float(loss):.4f} "
                      f"({time.time() - t0:.0f}s)")
    if args.checkpoint_dir:
        t_save = time.perf_counter()
        checkpoint.save(args.checkpoint_dir, tensor_tree_from_params(params),
                        step=args.rounds,
                        metadata={"arch": cfg.name, "mode": args.mode})
        t_save = time.perf_counter() - t_save
        nbytes = sum(os.path.getsize(os.path.join(args.checkpoint_dir, f))
                     for f in os.listdir(args.checkpoint_dir))
        print(f"[train] checkpoint -> {args.checkpoint_dir} ({nbytes} B, "
              f"saved in {t_save:.3f} s)")
    return logged


if __name__ == "__main__":
    main()
