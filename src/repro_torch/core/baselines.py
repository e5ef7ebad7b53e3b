"""Distributed gradient descent — the paper's "trivial benchmark" (teal
diamonds in Fig. 2), ported from the reference's ``core/baselines.py``.

It runs on the shared :class:`~repro_torch.core.engine.RoundEngine` as the
degenerate client pass ``delta_k = −h (∇f_k(w) + λw)``, whose
n_k/n-weighted aggregate is exactly ``−h ∇f(w)`` (Σ_k n_k/n = 1).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike


def gd_round(problem: FederatedLogReg, w: torch.Tensor,
             stepsize: float) -> torch.Tensor:
    """One round of distributed GD on the flat view (the cheap reference
    for :class:`DistributedGD`)."""
    return w - stepsize * problem.flat.grad(w)


def gd_client_pass(w: torch.Tensor, bucket: ClientBucket, lam: float,
                   stepsize: float, out: torch.Tensor) -> torch.Tensor:
    """Every client of a bucket at once: out_k = −h (mean data gradient on
    P_k + λw); padded rows have val 0 and add nothing."""
    Kb = bucket.num_clients
    nkf = bucket.n_k.to(torch.float32).clamp(min=1.0)
    z = (bucket.val * w[bucket.idx]).sum(dim=-1)                 # (Kb, m_pad)
    g_sc = -bucket.y * torch.sigmoid(-bucket.y * z) / nkf[:, None]
    out.zero_().scatter_add_(1, bucket.idx.reshape(Kb, -1),
                             (g_sc[..., None] * bucket.val).reshape(Kb, -1))
    return out.add_(lam * w).mul_(-stepsize)


class DistributedGD(FederatedSolver):
    """Distributed GD on the RoundEngine (client pass = exact local
    gradient, n_k/n aggregation).  Deterministic: the round's key is
    unused."""

    name = "gd"

    def __init__(self, problem: FederatedLogReg, stepsize: float = 2.0,
                 aggregator: str = "dense", *, device: DeviceLike = None,
                 participation_model: Optional[Any] = None,
                 fault_model: Optional[Any] = None,
                 aggregator_guard: Optional[str] = None,
                 guard_clip_norm: Optional[float] = None,
                 guard_trim: float = 0.1):
        self._bind(problem, device)
        self.stepsize = stepsize
        self.engine = RoundEngine(
            problem,
            EngineConfig(aggregator=aggregator,
                         aggregator_guard=aggregator_guard,
                         guard_clip_norm=guard_clip_norm,
                         guard_trim=guard_trim),
            participation_model=participation_model,
            fault_model=fault_model)
        lam = problem.flat.lam
        gd_pass = lambda w, bi, b, kb, out: gd_client_pass(w, b, lam,
                                                           stepsize, out)
        self._round_fast = self.engine.compile(gd_pass)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key,
                                                round_index=state.round),
                             round=state.round + 1)


def _gd_defaults():
    from repro_torch.configs import get_gd_config
    return {"stepsize": get_gd_config().stepsize}


@register("gd", defaults=_gd_defaults,
          description="distributed gradient descent (the trivial benchmark)")
def _make_gd(problem: FederatedLogReg, *, device: DeviceLike = None,
             **kw) -> DistributedGD:
    return DistributedGD(problem, device=device, **kw)
