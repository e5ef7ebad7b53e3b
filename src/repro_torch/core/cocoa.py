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

The local solver is one permutation pass of SDCA per round, client k of
the bucket with key kb in the order ``permutation(take(split(kb, Kb), k),
m_pad)``, the reference's, bit for bit.  A bucket's
clients are independent, so the whole bucket's pass is one
``cocoa_sdca_pass`` call: on the card one kernel launch that runs every
client's chain of m_pad steps (a warp a client), in place of the
reference's ``lax.scan`` of one β-solve launch a step.

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
from repro_torch.kernels import ops
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike


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
    counterpart of the reference's ``_sdca_local_pass_keyed``: one
    ``cocoa_sdca_pass`` over the bucket (on the card one kernel launch; on
    the CPU the plain step loop, see ``ref.cocoa_sdca_pass_ref``).  r = X_k u
    is written into ``r`` (Kb, d); returns u (Kb, m_pad), the change of
    α."""
    return ops.cocoa_sdca_pass(w, alpha, bucket.idx, bucket.val, bucket.y,
                               bucket.n_k, perms, sigma, lam, n, r)


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

    def permutations(self, kb: threefry.Key, bucket_index: int,
                     bucket: ClientBucket) -> torch.Tensor:
        """Every client's random order of its m_pad dual coordinates, drawn
        batched from the bucket's key: (Kb, m_pad) int64."""
        return threefry.permutation(
            self.engine.client_keys(kb, bucket.num_clients), bucket.m_pad)

    def _pass(self, w, bi, bucket, alpha, kb, out):
        flat = self.problem.flat
        u = sdca_local_pass_keyed(w, alpha, bucket, flat.lam, flat.n,
                                  self.sigma,
                                  self.permutations(kb, bi, bucket), out)
        out.mul_(self._scale)
        return alpha + u

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        w, alphas = self._round_fast(state.w, state.aux, key,
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
