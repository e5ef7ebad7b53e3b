"""FSVRG / FedAvg for the neural model stack: the port of the reference's
``core/neural.py``.

One round (:func:`make_fsvrg_round`) is the paper's Algorithm 4 on a
language model's parameters, in the reference's order:

1. the full gradient ∇f(w) of the mean client loss, where a client's loss
   is the mean over its microbatches;
2. the clients one after another, each from w: h_k = h / max(n_k/n · C,
   1e-6), and every local step w_k ← w_k − h_k·S_k ⊙ (g_new − g_old + ∇f)
   (or g_new alone under ``fedavg``);
3. the f32 aggregate Σ_k (n_k/n)(w_k − w), and w + server_lr·A ⊙ aggregate;
4. ``full_grad_norm``, the f32 norm of ∇f(w).

The paper's features are vocabulary rows here: S_k (φ^j / φ_k^j) and A
(C / ω^j) scale only a parameter whose name holds ``embed`` (not
``unembed``) and whose first axis is the vocabulary; every other
parameter gets 1.  Gradients come from autograd (through the wkv6 kernel
and its backward on the card); the updates run leaf by leaf in f32 and
cast back to each parameter's dtype, so only one leaf's f32 temporaries
are alive beside the round's trees.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.models.model import LMParams, Model

_F32 = torch.float32
Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedNeuralConfig:
    stepsize: float = 0.3          # h; per-client h_k = h / (n_k/n · C)
    local_steps: int = 1           # microbatch steps per client per round
    use_S: bool = True             # per-vocab-row stochastic-gradient scaling
    use_A: bool = True             # per-vocab-row aggregation scaling
    algorithm: str = "fsvrg"       # 'fsvrg' | 'fedavg'
    server_lr: float = 1.0         # beyond-paper: server-side step on aggregate


# --------------------------------------------------------------------- #
# vocab-occupancy statistics (the neural analogue of §3.6.1)
# --------------------------------------------------------------------- #


def vocab_histogram(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """tokens: (..., S) -> (vocab,) f32 counts."""
    return torch.bincount(tokens.reshape(-1), minlength=vocab).to(_F32)


def vocab_stats(client_tokens: torch.Tensor, vocab: int):
    """client_tokens: (C, B_c, S).  Returns (phi_global, omega, a_diag):
    the fraction of all tokens equal to j, the number of clients whose
    data holds token j, and a^j = C / ω^j (1 where no client holds j)."""
    C = client_tokens.shape[0]
    per_client = torch.stack([vocab_histogram(t, vocab)
                              for t in client_tokens])            # (C, V)
    total = per_client.sum(dim=0)
    phi_global = total / torch.clamp(total.sum(), min=1.0)
    omega = (per_client > 0).sum(dim=0).to(_F32)
    a_diag = torch.where(omega > 0,
                         torch.full_like(omega, C) / torch.clamp(omega, min=1.0),
                         1.0)
    return phi_global, omega, a_diag


def s_k_vocab(phi_global: torch.Tensor, tokens_k: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """s_k^j = φ^j / φ_k^j over the vocabulary rows of one client (1 where
    the client holds no token j)."""
    hist = vocab_histogram(tokens_k, vocab)
    phi_k = hist / torch.clamp(hist.sum(), min=1.0)
    return torch.where(hist > 0,
                       phi_global / torch.clamp(phi_k, min=1e-12), 1.0)


def _is_vocab_row_param(path: str, vocab: int, shape: Sequence[int]) -> bool:
    return (("embed" in path and "unembed" not in path) and len(shape) >= 1
            and shape[0] == vocab)


# --------------------------------------------------------------------- #
# the round
# --------------------------------------------------------------------- #


def _client(batches: Batch, c: int, t: int) -> Dict[str, torch.Tensor]:
    return {k: x[c, t] for k, x in batches.items()}


def make_fsvrg_round(model: Model, cfg: FedNeuralConfig) -> Callable:
    """Returns round_fn(params, client_batches) -> (new params, metrics).

    ``client_batches``: a dict whose every tensor has leading axes
    (C, local_steps, ...) — C clients × local_steps microbatches of
    (B_c, S) tokens, labels and mask.  ``params`` is left as it is; the
    new :class:`LMParams` holds new tensors.  ``metrics``:
    ``{"full_grad_norm": f32 scalar}``."""
    if cfg.algorithm not in ("fsvrg", "fedavg"):
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}; use "
                         "'fsvrg' or 'fedavg'")
    vocab = model.cfg.vocab_size

    def loss_fn(p: LMParams, batch: Batch) -> torch.Tensor:
        return model.loss(p, batch)[0]

    def grad_fn(p: LMParams, batch: Batch) -> Tuple[torch.Tensor, ...]:
        return torch.autograd.grad(loss_fn(p, batch), list(p.parameters()))

    def vocab_scale(names: List[str], leaves: List[torch.Tensor],
                    on: bool, s_vocab: torch.Tensor) -> List[object]:
        return [s_vocab[:p.shape[0], None]
                if on and _is_vocab_row_param(n, vocab, p.shape) else 1.0
                for n, p in zip(names, leaves)]

    def round_fn(params: LMParams, client_batches: Batch):
        names, leaves = zip(*params.named_parameters())
        all_tokens = client_batches["tokens"]                  # (C, T, B_c, S)
        C, T = all_tokens.shape[:2]
        phi_global, _, a_vocab = vocab_stats(
            all_tokens.reshape(C, -1, all_tokens.shape[-1]), vocab)

        # 1. the full gradient of the mean over clients of each client's
        #    mean microbatch loss
        total = torch.zeros((), dtype=_F32, device=model.device)
        for c in range(C):
            client = torch.stack([loss_fn(params, _client(client_batches,
                                                          c, t))
                                  for t in range(T)])
            total = total + client.mean()
        full_grad = torch.autograd.grad(total / C, leaves)

        # 2. the clients in order, each from w; the aggregate in f32
        n_k = torch.tensor(float(all_tokens[0].numel()), dtype=_F32,
                           device=model.device)
        n_total = n_k * C
        stepsize = torch.tensor(cfg.stepsize, dtype=_F32, device=model.device)
        with torch.no_grad():
            agg = [torch.zeros(p.shape, dtype=_F32, device=p.device)
                   for p in leaves]
            wk_params = LMParams.from_named(
                {n: p.detach().clone() for n, p in zip(names, leaves)})
            wk = list(wk_params.parameters())
        for c in range(C):
            s_vocab = s_k_vocab(phi_global, all_tokens[c].reshape(-1), vocab)
            scale = vocab_scale(names, leaves, cfg.use_S, s_vocab)
            h_k = stepsize / torch.clamp(n_k / n_total * C, min=1e-6)
            with torch.no_grad():
                for w_, p in zip(wk, leaves):
                    w_.copy_(p)
            for t in range(T):
                mb = _client(client_batches, c, t)
                g_new = grad_fn(wk_params, mb)
                g_old = None if cfg.algorithm == "fedavg" else grad_fn(params,
                                                                       mb)
                with torch.no_grad():
                    for i, w_ in enumerate(wk):
                        d = g_new[i].to(_F32)
                        if g_old is not None:
                            d = (d - g_old[i].to(_F32)) + full_grad[i].to(_F32)
                        w_.copy_((w_.to(_F32) - h_k * scale[i] * d)
                                 .to(w_.dtype))
                del g_new, g_old
            wt = n_k / n_total
            with torch.no_grad():
                for a, w_, p in zip(agg, wk, leaves):
                    a.add_(wt * (w_.to(_F32) - p.to(_F32)))
        del wk_params, wk

        # 3. the server step, A-scaled on the vocabulary rows
        with torch.no_grad():
            big_a = vocab_scale(names, leaves, cfg.use_A, a_vocab)
            new = {}
            for i, (n, p) in enumerate(zip(names, leaves)):
                new[n] = (p.to(_F32) + cfg.server_lr * big_a[i] * agg[i]
                          ).to(p.dtype)
                agg[i] = None
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                                   for g in full_grad))
        return LMParams.from_named(new), {"full_grad_norm": gnorm}

    return round_fn


def make_client_batches(batch: Batch, num_clients: int,
                        local_steps: int) -> Dict[str, torch.Tensor]:
    """Reshape a global batch (B, ...) into (C, local_steps, B/(C·T), ...)."""

    def reshape(x):
        B = x.shape[0]
        per = B // (num_clients * local_steps)
        if per * num_clients * local_steps != B:
            raise ValueError(f"a batch of {B} does not split into "
                             f"{num_clients} clients × {local_steps} steps")
        return x.reshape(num_clients, local_steps, per, *x.shape[1:])

    return {k: reshape(x) for k, x in batch.items()}
