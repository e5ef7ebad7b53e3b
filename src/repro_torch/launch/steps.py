"""The step functions the drivers run (the reference's ``launch/steps.py``):

  * make_fsvrg_step — one federated round of the paper's technique (the
    full gradient, the clients' local variance-reduced steps, the scaled
    aggregation), or of FedAvg;
  * make_adamw_step — one centralized AdamW step (the baseline);
  * make_prefill_step / make_decode_step — the serving entries.

PyTorch runs eagerly, so a step is the function itself (the reference
compiles it with ``jax.jit``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.neural import FedNeuralConfig, make_fsvrg_round
from repro_torch.models.model import LMParams, Model
from repro_torch.optim import Optimizer


def make_fsvrg_step(model: Model, fed_cfg: FedNeuralConfig) -> Callable:
    """step(params, client_batches) -> (new params, metrics)."""
    return make_fsvrg_round(model, fed_cfg)


def make_adamw_step(model: Model, opt: Optimizer) -> Callable:
    """step(params, opt_state, opt_step, batch) -> (new params, new state,
    opt_step + 1, loss, metrics); ``params`` and ``opt_state`` are left as
    they are."""

    def step(params: LMParams, opt_state, opt_step, batch):
        loss, metrics = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new, opt_state = opt.update(dict(zip(names, leaves)),
                                        dict(zip(names, grads)), opt_state,
                                        opt_step)
        return (LMParams.from_named(new), opt_state, opt_step + 1,
                loss.detach(), {k: v.detach() for k, v in metrics.items()})

    return step


def make_prefill_step(model: Model) -> Callable:
    def step(params, batch):
        return model.prefill(params, batch)

    return step


def make_decode_step(model: Model) -> Callable:
    def step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    return step
