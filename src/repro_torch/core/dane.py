"""DANE — Distributed Approximate Newton (Algorithm 2) on the round engine,
ported from the reference's ``core/dane.py``.

Local subproblem (eq. 10):

    w_k = argmin_w F_k(w) − (∇F_k(w^t) − η∇f(w^t))ᵀ w + (µ/2)||w − w^t||²

Each round's prelude is the full gradient ∇f(w^t) (Alg. 2 step 1, its own
round of communication); the engine averages the clients' solutions
uniformly (Alg. 2 step 3).  Two inexact local solvers, each run for every
client of a bucket at once:

  * ``local_solver="gd"`` — ``local_steps`` gradient steps on the
    subproblem, each step the ``dane_update`` kernel.  Deterministic.
  * ``local_solver="svrg"`` — the Proposition-1 construction: one epoch of
    generic SVRG on the explicitly materialized subproblem (η = 1, µ = 0),
    over ``svrg_steps`` examples per client sampled with replacement,
    client k of the bucket with key kb from ``randint(take(split(kb, Kb),
    k), (m,), 0, max(n_k, 1))``, the reference's samples, bit for bit.

:class:`DANERidge` is the exact solver for ridge regression on a
:func:`~repro_torch.core.problem.build_dense_problem` layout: each
client's d×d system, one batched ``torch.linalg.solve`` a bucket (the
reference's ``jnp.linalg.solve``; no TPU kernel computes it).
:func:`dane_svrg_round` is the one-call Proposition-1 round.

The scale paths (``client_chunk``, ``cohort``, ``virtual_data``; see
:mod:`repro_torch.core.engine`) run the same local solvers over a chunk,
a gathered cohort or a regenerated bucket with its clients' own keys (the
GD solver draws nothing); the GD solver's scratches are sized to what one
pass gets.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.kernels import ops
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike

_SOLVERS = ("gd", "svrg")


@dataclasses.dataclass(frozen=True)
class DANEConfig:
    """Knobs of Algorithm 2 and its local solvers."""

    eta: float = 1.0               # η: full-gradient weight in a_k (eq. 10)
    mu: float = 0.0                # µ: prox coefficient (eq. 10)
    local_solver: str = "gd"       # "gd" | "svrg" (the Prop.-1 construction)
    local_steps: int = 50          # GD solver: iterations on the subproblem
    local_lr: float = 1.0          # GD solver: stepsize
    svrg_stepsize: float = 0.05    # SVRG solver: stepsize h
    svrg_steps: int = 25           # SVRG solver: samples m per epoch
    participation: float = 1.0     # i.i.d. per-round client participation
    # "dense" (plain tensor code) | "pallas" (the fused_aggregate kernel)
    aggregator: str = "dense"
    # None -> form each bucket's (Kb, d) delta stack; an int streams the
    # client axis in chunks of this size (see EngineConfig.client_chunk)
    client_chunk: Optional[int] = None
    # under partial participation, compute only the sampled cohort (see
    # EngineConfig.cohort and engine.cohort_capacity)
    cohort: Optional[int] = None
    # rows regenerated on demand from a build_virtual_problem layout (see
    # EngineConfig.virtual_data); set by itself for a virtual problem
    virtual_data: bool = False
    # replace the Bernoulli draw with a repro_torch.fleet participation
    # model (trace-driven availability and stragglers)
    participation_model: Optional[Any] = None
    # corrupt returned deltas through a repro_torch.fleet.faults fault model
    fault_model: Optional[Any] = None
    # robust server aggregation: None | "clip" | "trimmed_mean" | "median"
    # (see EngineConfig.aggregator_guard)
    aggregator_guard: Optional[str] = None
    guard_clip_norm: Optional[float] = None
    guard_trim: float = 0.1

    def __post_init__(self):
        if self.local_solver not in _SOLVERS:
            raise ValueError(f"local_solver must be one of {_SOLVERS}")


def ridge_grad(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               lam: float) -> torch.Tensor:
    """∇F(w) of F(w) = 1/(2m) ||Xᵀw − y||² + λ/2 ||w||², X: (d, m)."""
    m = y.shape[0]
    return X @ (X.T @ w - y) / m + lam * w


def data_grad(wk: torch.Tensor, bucket: ClientBucket,
              out: torch.Tensor) -> torch.Tensor:
    """The sparse data part of ∇F_k at every client's iterate, written to
    ``out`` (Kb, d): Σ_i (−y_i σ(−y_i x_iᵀw_k)) x_i / n_k over the client's
    valid rows.  ``wk`` is (Kb, d), or one (d,) iterate shared by all."""
    Kb, m_pad, _ = bucket.idx.shape
    flat_idx = bucket.idx.reshape(Kb, -1)
    wk = wk.expand(Kb, -1)
    nkf = bucket.n_k.to(torch.float32).clamp(min=1.0)
    valid = (torch.arange(m_pad, device=wk.device)[None, :]
             < bucket.n_k[:, None]).to(torch.float32)
    z = bucket.y * (bucket.val * wk.gather(1, flat_idx).reshape(
        bucket.idx.shape)).sum(dim=-1)
    gs = -bucket.y * torch.sigmoid(-bucket.y * z) * valid / nkf[:, None]
    # CUDA's atomic scatter_add_: DANE's local steps take this 26 times a
    # round, where utils.scatter's sorted sum took 8× the round's time, so
    # its rounds do not repeat bit for bit on the card (ROADMAP Queue C)
    return out.zero_().scatter_add_(
        1, flat_idx, (gs[..., None] * bucket.val).reshape(Kb, -1))


def dane_gd_pass(w0: torch.Tensor, full_grad: torch.Tensor,
                 bucket: ClientBucket, lam: float, cfg: DANEConfig,
                 out: torch.Tensor, *, g: Optional[torch.Tensor] = None,
                 a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``local_steps`` GD steps on subproblem (10) for every client of a
    bucket — the counterpart of the reference's ``_dane_gd_pass``.

    The iterates are stepped in place in ``out`` (Kb, d), which ends
    holding the deltas w_k − w0.  ``g`` and ``a`` are optional (≥Kb, d)
    scratches for the data gradient and a_k = ∇F_k(w^t) − η∇f(w^t)."""
    Kb = bucket.num_clients
    d = w0.shape[0]
    g = torch.empty_like(out) if g is None else g[:Kb]
    a = torch.empty_like(out) if a is None else a[:Kb]
    data_grad(w0, bucket, a)
    a += lam * w0
    a -= cfg.eta * full_grad
    wk = out
    wk.copy_(w0.expand(Kb, d))
    for _ in range(cfg.local_steps):
        data_grad(wk, bucket, g)
        ops.dane_update(wk, g, a, w0, cfg.local_lr, lam, cfg.mu, out=wk)
    return wk.sub_(w0)


def dane_svrg_pass_keyed(w0: torch.Tensor, full_grad: torch.Tensor,
                         bucket: ClientBucket, lam: float, cfg: DANEConfig,
                         samples: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """Proposition 1: one epoch of generic SVRG on subproblem (10) *as a
    subproblem* (η = 1, µ = 0), for every client of a bucket over explicit
    sample indices ``samples`` (Kb, m) — the counterpart of the reference's
    ``_dane_svrg_pass_keyed``.  a_k and the linear term are materialized,
    as in the reference.  Writes the deltas w_k − w0 into ``out``."""
    Kb = bucket.num_clients
    d = w0.shape[0]
    rows = torch.arange(Kb, device=w0.device)

    def fk_grad(wk):
        return data_grad(wk, bucket, torch.empty_like(out)) + lam * wk

    f0 = fk_grad(w0)
    a_k = f0 - full_grad                               # η = 1
    anchor = f0 - a_k                                  # = ∇f(w^t), materialized

    def fi_grad(wk, xi, vi, yi):
        z = (vi * wk.expand(Kb, d).gather(1, xi)).sum(dim=1)
        gs = -yi * torch.sigmoid(-yi * z)
        return torch.zeros_like(out).scatter_add_(1, xi,
                                                  gs[:, None] * vi) + lam * wk

    wk = w0.expand(Kb, d)
    for t in range(samples.shape[1]):
        i = samples[:, t]
        xi, vi, yi = bucket.idx[rows, i], bucket.val[rows, i], bucket.y[rows, i]
        gi_new = fi_grad(wk, xi, vi, yi) - a_k
        gi_old = fi_grad(w0, xi, vi, yi) - a_k
        wk = wk - cfg.svrg_stepsize * (gi_new - gi_old + anchor)
    return torch.sub(wk, w0, out=out)


class DANE(FederatedSolver):
    """Algorithm 2 on the :class:`~repro_torch.core.engine.RoundEngine`:
    the full-gradient prelude, the local solver's pass, and uniform 1/K
    averaging ("averages the solutions")."""

    name = "dane"

    def __init__(self, problem: FederatedLogReg,
                 cfg: DANEConfig = DANEConfig(), *,
                 device: DeviceLike = None):
        self._bind(problem, device)
        self.cfg = cfg
        self.engine = RoundEngine(
            problem,
            EngineConfig(participation=cfg.participation, weighting="uniform",
                         aggregator=cfg.aggregator,
                         client_chunk=cfg.client_chunk,
                         cohort=cfg.cohort,
                         virtual_data=(cfg.virtual_data
                                       or problem.virtual is not None),
                         aggregator_guard=cfg.aggregator_guard,
                         guard_clip_norm=cfg.guard_clip_norm,
                         guard_trim=cfg.guard_trim),
            participation_model=cfg.participation_model,
            fault_model=cfg.fault_model,
        )
        if cfg.local_solver == "gd":
            # the steps' scratches (data gradient, a_k), shared by passes
            self._scratch("_g", self.engine.pass_rows())
            self._scratch("_a", self.engine.pass_rows())
        prelude = lambda w: (self.problem.flat.grad(w),)
        self._round_fast = self.engine.compile(
            self._pass, prelude=prelude, chunk_pass=self._chunk_pass)

    def samples(self, kb: threefry.Key, bucket_index: int,
                bucket: ClientBucket) -> torch.Tensor:
        """The SVRG solver's sample indices, uniform over each client's
        rows with replacement, drawn batched from the bucket's key:
        (Kb, m) int64."""
        return self._samples(
            self.engine.client_keys(kb, bucket.num_clients), bucket)

    def _samples(self, keys: threefry.Key,
                 bucket: ClientBucket) -> torch.Tensor:
        return threefry.randint(keys, (self.cfg.svrg_steps,), 0,
                                bucket.n_k.clamp(min=1))

    def _gd(self, w, bucket, out, full_grad):
        Kb = bucket.num_clients
        dane_gd_pass(w, full_grad, bucket, self.problem.flat.lam, self.cfg,
                     out, g=self._scratch("_g", Kb),
                     a=self._scratch("_a", Kb))

    def _pass(self, w, bi, bucket, kb, out, full_grad):
        if self.cfg.local_solver == "gd":
            self._gd(w, bucket, out, full_grad)
        else:
            dane_svrg_pass_keyed(w, full_grad, bucket, self.problem.flat.lam,
                                 self.cfg, self.samples(kb, bi, bucket), out)

    def _chunk_pass(self, w, bi, bucket, keys, out, full_grad):
        """The keyed chunk pass: a chunk, a gathered cohort or a
        regenerated bucket, with its clients' own keys."""
        if self.cfg.local_solver == "gd":
            self._gd(w, bucket, out, full_grad)
        else:
            dane_svrg_pass_keyed(w, full_grad, bucket, self.problem.flat.lam,
                                 self.cfg, self._samples(keys, bucket), out)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key,
                                                round_index=state.round),
                             round=state.round + 1)


def dane_svrg_round(problem: FederatedLogReg, w: torch.Tensor,
                    key: threefry.Key, stepsize: float,
                    m: int) -> torch.Tensor:
    """One Proposition-1 round (DANE with η = 1, µ = 0 and one SVRG epoch
    of ``m`` samples as the local solver) from ``w`` on ``key``, on the
    problem's device."""
    cfg = DANEConfig(eta=1.0, mu=0.0, local_solver="svrg",
                     svrg_stepsize=stepsize, svrg_steps=m)
    solver = DANE(problem, cfg, device=problem.device)
    return solver.round(solver.init(w), key).w


class DANERidge(FederatedSolver):
    """Exact DANE for ridge regression (d×d local solves) on the engine.

    F_k(w) = 1/(2 n_k)||X_kᵀw − y_k||² + (λ/2)||w||²; subproblem (10) is the
    linear system (H_k + µI) w = c_k + a_k + µw^t with H_k = X_kX_kᵀ/n_k + λI
    and c_k = X_k y_k / n_k, solved exactly for every client of a bucket at
    once and averaged uniformly by the engine.  ``problem`` must be a
    :func:`~repro_torch.core.problem.build_dense_problem` layout; λ is read
    from ``problem.flat.lam``.  Deterministic: the round's key is unused."""

    name = "dane_ridge"

    def __init__(self, problem: FederatedLogReg, *, eta: float = 1.0,
                 mu: float = 0.0, aggregator: str = "dense",
                 device: DeviceLike = None):
        self._bind(problem, device)
        self.lam = float(problem.flat.lam)
        self.eta, self.mu = float(eta), float(mu)
        self.engine = RoundEngine(problem,
                                  EngineConfig(weighting="uniform",
                                               aggregator=aggregator))
        self._round_fast = self.engine.compile(
            self._ridge_pass, prelude=lambda w: (self.full_grad(w),))

    @property
    def hyperparams(self):
        return {"eta": self.eta, "mu": self.mu}

    def full_grad(self, w: torch.Tensor) -> torch.Tensor:
        """∇f(w) = (1/n) Σ_k X_k (X_kᵀ w − y_k) + λw, from the buckets."""
        n = self.problem.flat.n
        g = self.lam * w
        for b in self.problem.buckets:
            resid = torch.einsum("kmd,d->km", b.val, w) - b.y
            g = g + torch.einsum("kmd,km->d", b.val, resid) / n
        return g

    def _ridge_pass(self, w, bi, bucket, kb, out, fg):
        lam, eta, mu = self.lam, self.eta, self.mu
        X = bucket.val.transpose(1, 2)                       # (Kb, d, m)
        m = bucket.n_k.clamp(min=1).to(X.dtype)[:, None]     # (Kb, 1)
        resid = torch.einsum("kdm,d->km", X, w) - bucket.y
        grad_k = torch.einsum("kdm,km->kd", X, resid) / m + lam * w
        a_k = grad_k - eta * fg
        eye = torch.eye(w.shape[0], dtype=X.dtype, device=X.device)
        H = X @ bucket.val / m[..., None] + (lam + mu) * eye
        rhs = torch.einsum("kdm,km->kd", X, bucket.y) / m + a_k + mu * w
        torch.sub(torch.linalg.solve(H, rhs), w, out=out)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key),
                             round=state.round + 1)


def _dane_defaults():
    from repro_torch.configs import get_dane_config
    c = get_dane_config()
    return {"eta": c.eta, "mu": c.mu, "local_steps": c.local_steps,
            "local_lr": c.local_lr}


@register("dane", defaults=_dane_defaults,
          description="DANE (Algorithm 2) with inexact GD/SVRG local solvers")
def _make_dane(problem: FederatedLogReg, *, device: DeviceLike = None,
               **kw) -> DANE:
    return DANE(problem, DANEConfig(**kw), device=device)


@register("dane_ridge", layout="dense",
          description="exact DANE for ridge regression (d×d local solves)")
def _make_dane_ridge(problem: FederatedLogReg, *, device: DeviceLike = None,
                     **kw) -> DANERidge:
    return DANERidge(problem, device=device, **kw)
