"""A minimal optimizer library, the reference's ``optim/optimizers.py``.

Each optimizer is an (init, update) pair of plain functions over a dict of
named tensors (``dict(params.named_parameters())``):

    state = init(params)
    params, state = update(params, grads, state, step)

``update`` returns new tensors and leaves its arguments alone.  The
formulas are the reference's, not ``torch.optim``'s: AdamW keeps f32
moments whatever the parameter's dtype, takes t = step + 1, and applies
p − lr·(m/c1)/(√(v/c2) + eps) − lr·wd·p in f32 before casting back
(``torch.optim.AdamW`` decays first and rounds elsewhere).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Union

import torch

Params = Mapping[str, torch.Tensor]
Step = Union[int, torch.Tensor]

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _zeros(params: Params) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
            for k, p in params.items()}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=like.device)


def sgd(lr: float) -> Optimizer:
    def init(params: Params):
        return ()

    def update(params: Params, grads: Params, state, step: Step):
        del step
        return {k: (p - lr * grads[k].to(_F32)).to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params: Params):
        return _zeros(params)

    def update(params: Params, grads: Params, state, step: Step):
        del step
        new_m = {k: beta * m + grads[k].to(_F32) for k, m in state.items()}
        return {k: (p - lr * new_m[k]).to(p.dtype)
                for k, p in params.items()}, new_m

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params: Params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(params: Params, grads: Params, state, step: Step):
        like = next(iter(params.values()))
        t = torch.as_tensor(step, device=like.device).to(_F32) + 1.0
        c1 = 1.0 - torch.pow(_f32(b1, like), t)
        c2 = 1.0 - torch.pow(_f32(b2, like), t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(_F32)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            step_ = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = p.to(_F32)
            new_p[k] = (p32 - step_ - lr * weight_decay * p32).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


def get(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](lr, **kw)
