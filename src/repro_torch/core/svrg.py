"""Algorithm 1 — single-machine SVRG [43, 47], the paper's §3.2 building
block, ported from the reference's ``core/svrg.py``.  FSVRG reduces to it
when K = 1, and it is the local solver of the Proposition-1 construction.

    for s = 0,1,2,...:
        ḡ = ∇f(w^t)                      # full pass
        w = w^t
        for t = 1..m:
            i ~ U{1..n}
            w ← w − h (∇f_i(w) − ∇f_i(w^t) + ḡ)
        w^{t+1} = w

The samples are the reference's: ``randint(key, (m,), 0, n)`` on JAX's
threefry (:mod:`repro_torch.utils.threefry`), epoch s on
``fold_in(PRNGKey(seed), s)``.  The inner loop is sequential by nature:
one step of a few small tensor operations a sample.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.problem import LogRegProblem
from repro_torch.utils import threefry


def svrg_epoch(problem: LogRegProblem, w_t: torch.Tensor, key: threefry.Key,
               *, stepsize: float, m: int) -> torch.Tensor:
    """One outer iteration of Algorithm 1 on the flat problem."""
    full_grad = problem.grad(w_t)
    lam = problem.lam
    samples = threefry.randint(threefry.as_key(key, problem.device), (m,), 0,
                               problem.n)
    # the anchor's per-example gradient scalars need only x·w^t: all at once
    xs, vs, ys = problem.idx[samples], problem.val[samples], problem.y[samples]
    g_old = -ys * torch.sigmoid(-ys * (vs * w_t[xs]).sum(dim=1))
    w = w_t
    for t in range(m):
        xi, vi, yi = xs[t], vs[t], ys[t]
        g_new = -yi * torch.sigmoid(-yi * (vi * w[xi]).sum())
        diff = (torch.zeros_like(w).index_add_(0, xi, (g_new - g_old[t]) * vi)
                + lam * (w - w_t))
        w = w - stepsize * (diff + full_grad)
    return w


def run_svrg(problem: LogRegProblem, w0: torch.Tensor, *, epochs: int,
             stepsize: float, m: Optional[int] = None,
             seed: int = 0) -> Tuple[torch.Tensor, List[float]]:
    """Algorithm 1 for ``epochs`` outer iterations; m defaults to n (one
    pass, the paper's "small multiple of n" guidance).  Returns the iterate
    and the loss after each epoch."""
    m = m or problem.n
    w = w0
    hist = []
    key = threefry.as_key(threefry.PRNGKey(seed), problem.device)
    for s in range(epochs):
        w = svrg_epoch(problem, w, threefry.fold_in(key, s),
                       stepsize=stepsize, m=m)
        hist.append(float(problem.loss(w)))
    return w, hist
