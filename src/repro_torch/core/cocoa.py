"""CoCoA+ [arXiv:1502.03508] on the round engine, ported from the
reference's ``core/cocoa.py``: γ = 1 (adding) and, by default, the safe
σ′ = γK, on the bucketed sparse logistic-regression problem.

CoCoA+ carries per-client state across rounds — the dual blocks α_k, one
(Kb, m_pad) tensor per bucket in ``SolverState.aux`` — so it runs on the
engine's :meth:`~repro_torch.core.engine.RoundEngine.round_with_state`.
Each client's primal contribution X_k u_k / (λn) is its delta, and the
engine sums them (``weighting="sum"``): w^{t+1} = w^t + (γ/λn) Σ_k X_k u_k.
Under partial participation the engine freezes the dual blocks of the
clients the round's draw left out, so w = (1/λn) Σ_k X_k α_k keeps holding.

The local solver is one permutation pass of SDCA per round.  A bucket's
clients step in lockstep — at step t every client updates the t-th
coordinate of its own permutation — so each step's β-solve is one
``cocoa_sdca_update`` call over a (Kb,) vector.

Not ported yet: ``PrimalMethod`` and ``DualMethod`` (they need
``build_dense_problem``), and the streamed, cohort and virtual options.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.kernels import ops, ref
from repro_torch.utils.device import DeviceLike, random_permutations


@dataclasses.dataclass(frozen=True)
class CoCoAConfig:
    """CoCoA+ knobs (γ is fixed at 1, the "adding" variant)."""

    sigma: Optional[float] = None  # σ′: None -> the safe γK
    participation: float = 1.0     # i.i.d. per-round client participation
    # "dense" (plain tensor code) | "pallas" (the fused_aggregate kernel)
    aggregator: str = "dense"
    # replace the Bernoulli draw with a repro_torch.fleet participation
    # model (trace-driven availability and stragglers)
    participation_model: Optional[Any] = None
    # corrupt returned deltas through a repro_torch.fleet.faults fault
    # model: the primal contribution is corrupted, never the dual blocks
    fault_model: Optional[Any] = None
    # robust server aggregation.  CoCoA+ aggregates with weighting="sum",
    # so only "clip" composes (an order statistic would break
    # w = (1/λn)Xα and is a config error)
    aggregator_guard: Optional[str] = None
    guard_clip_norm: Optional[float] = None
    guard_trim: float = 0.1


def sdca_local_pass_keyed(w: torch.Tensor, alpha: torch.Tensor,
                          bucket: ClientBucket, lam: float, n: int,
                          sigma: float, perms: torch.Tensor,
                          r: torch.Tensor) -> torch.Tensor:
    """One permutation pass of SDCA on every client's local dual
    subproblem, over explicit permutations ``perms`` (Kb, m_pad) — the
    counterpart of the reference's ``_sdca_local_pass_keyed``.

    With β_i = y_i α_i ∈ (0, 1), coordinate i solves (from eq. 15)

        min_β  m_i (β − β_old) + c_i (β − β_old)² + H(β),
        m_i = y_i x_iᵀ(w + (σ/λn) r),   c_i = σ||x_i||²/(2λn),

    where r = X_k u tracks the client's own updates within the round.  r is
    accumulated in ``r`` (Kb, d), which this zeroes first; returns u
    (Kb, m_pad), the change of α."""
    Kb, m_pad, nnz = bucket.idx.shape
    eps = ref.SDCA_EPS
    take = perms[..., None].expand(Kb, m_pad, nnz)
    pidx = bucket.idx.gather(1, take).transpose(0, 1).contiguous()
    pval = bucket.val.gather(1, take).transpose(0, 1).contiguous()
    py = bucket.y.gather(1, perms).t().contiguous()                # (m_pad, Kb)
    valid = (perms < bucket.n_k[:, None]).to(torch.float32).t()
    beta_old = torch.clamp(py * alpha.gather(1, perms).t(), eps,
                           1.0 - eps).contiguous()
    # the parts of each step's coefficients that r does not change: all at
    # once, with the scalars rounded as the reference rounds them
    zw = (pval * w[pidx]).sum(dim=-1)
    xn2 = (pval * pval).sum(dim=-1)
    ccoef = (sigma * xn2) / torch.full_like(xn2, 2.0 * lam * n)
    shift = sigma / (lam * n)
    u = torch.zeros((Kb, m_pad), device=w.device)
    r.zero_()
    for t in range(m_pad):
        xi, vi, yi = pidx[t], pval[t], py[t]
        mcoef = yi * (zw[t] + shift * (vi * r.gather(1, xi)).sum(dim=1))
        beta = ops.cocoa_sdca_update(beta_old[t], mcoef, ccoef[t])
        du = valid[t] * yi * (beta - beta_old[t])
        u.scatter_add_(1, perms[:, t:t + 1], du[:, None])
        r.scatter_add_(1, xi, du[:, None] * vi)
    return u


class CoCoAPlus(FederatedSolver):
    """CoCoA+ with γ = 1 and safe σ′ = γK by default.  ``init()`` starts at
    α = 0 ⇒ w = 0; a nonzero ``w0`` would break w = (1/λn) X α and is
    rejected."""

    name = "cocoa"

    def __init__(self, problem: FederatedLogReg, sigma: Optional[float] = None,
                 cfg: CoCoAConfig = CoCoAConfig(), *,
                 device: DeviceLike = None):
        if sigma is not None:
            cfg = dataclasses.replace(cfg, sigma=sigma)
        self._bind(problem, device)
        self.cfg = cfg
        self.sigma = float(cfg.sigma if cfg.sigma is not None
                           else problem.num_clients)
        self._scale = 1.0 / (problem.flat.lam * problem.flat.n)
        self.engine = RoundEngine(
            problem,
            EngineConfig(weighting="sum", participation=cfg.participation,
                         aggregator=cfg.aggregator,
                         aggregator_guard=cfg.aggregator_guard,
                         guard_clip_norm=cfg.guard_clip_norm,
                         guard_trim=cfg.guard_trim),
            participation_model=cfg.participation_model,
            fault_model=cfg.fault_model,
        )
        self._round_fast = self.engine.compile_with_state(self._pass)

    def init(self, w0: Optional[torch.Tensor] = None) -> SolverState:
        if w0 is not None and bool((w0 != 0).any()):
            raise ValueError("CoCoA+ starts at alpha=0 => w=0; a custom w0 "
                             "would break w = (1/lambda n) X alpha")
        dev = self.problem.device
        return SolverState(
            w=torch.zeros((self.problem.d,), device=dev),
            aux=tuple(torch.zeros((b.num_clients, b.m_pad), device=dev)
                      for b in self.problem.buckets))

    def permutations(self, gen: torch.Generator, bucket_index: int,
                     bucket: ClientBucket) -> torch.Tensor:
        """Every client's random order of its m_pad dual coordinates, drawn
        batched from the round's generator: (Kb, m_pad) int64."""
        return random_permutations(gen, (bucket.num_clients, bucket.m_pad),
                                   bucket.idx.device)

    def _pass(self, w, bi, bucket, alpha, gen, out):
        flat = self.problem.flat
        u = sdca_local_pass_keyed(w, alpha, bucket, flat.lam, flat.n,
                                  self.sigma,
                                  self.permutations(gen, bi, bucket), out)
        out.mul_(self._scale)
        return alpha + u

    def round(self, state: SolverState,
              gen: torch.Generator) -> SolverState:
        w, alphas = self._round_fast(state.w, state.aux, gen,
                                     round_index=state.round)
        return SolverState(w=w, aux=alphas, round=state.round + 1)


def _cocoa_defaults():
    from repro_torch.configs import get_cocoa_config
    return {"sigma": get_cocoa_config().sigma}


@register("cocoa", defaults=_cocoa_defaults,
          description="CoCoA+ (arXiv:1502.03508, γ=1, local SDCA)")
def _make_cocoa(problem: FederatedLogReg, *, device: DeviceLike = None,
                sigma: Optional[float] = None, **kw) -> CoCoAPlus:
    return CoCoAPlus(problem, sigma=sigma, cfg=CoCoAConfig(**kw),
                     device=device)
