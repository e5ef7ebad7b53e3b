"""The baselines the paper compares against (§2, §4, Fig. 2), ported from
the reference's ``core/baselines.py``:

  * distributed GD — the "trivial benchmark" (teal diamonds in Fig. 2), on
    the shared :class:`~repro_torch.core.engine.RoundEngine` as the
    degenerate client pass ``delta_k = −h (∇f_k(w) + λw)``, whose
    n_k/n-weighted aggregate is exactly ``−h ∇f(w)`` (Σ_k n_k/n = 1), on
    every round path (streamed, cohort, virtual);
    :func:`run_gd` is the same loop on the flat view;
  * one-shot averaging [107] — each client optimizes locally for many
    epochs, the server averages once (:func:`one_shot_average`);
  * FedAvg-style local SGD [62] in one call (:func:`fedavg_round`);
  * the per-author majority vote (:func:`majority_baseline_error`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.fedavg import FedAvg, FedAvgConfig
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.scatter import scatter_add_rows


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
    scatter_add_rows(out.zero_(), bucket.idx.reshape(Kb, -1),
                     (g_sc[..., None] * bucket.val).reshape(Kb, -1))
    return out.add_(lam * w).mul_(-stepsize)


class DistributedGD(FederatedSolver):
    """Distributed GD on the RoundEngine (client pass = exact local
    gradient, n_k/n aggregation).  Deterministic: the round's key is
    unused."""

    name = "gd"

    def __init__(self, problem: FederatedLogReg, stepsize: float = 2.0,
                 aggregator: str = "dense", *, device: DeviceLike = None,
                 client_chunk: Optional[int] = None,
                 participation: float = 1.0,
                 cohort: Optional[int] = None,
                 virtual_data: bool = False,
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
                         client_chunk=client_chunk,
                         participation=participation,
                         cohort=cohort,
                         virtual_data=(virtual_data
                                       or problem.virtual is not None),
                         aggregator_guard=aggregator_guard,
                         guard_clip_norm=guard_clip_norm,
                         guard_trim=guard_trim),
            participation_model=participation_model,
            fault_model=fault_model)
        lam = problem.flat.lam
        gd_pass = lambda w, bi, b, kb, out: gd_client_pass(w, b, lam,
                                                           stepsize, out)
        # deterministic: the keyed chunk pass leaves its clients' keys
        gd_chunk_pass = lambda w, bi, cb, keys, out: gd_client_pass(
            w, cb, lam, stepsize, out)
        self._round_fast = self.engine.compile(gd_pass,
                                               chunk_pass=gd_chunk_pass)

    @property
    def hyperparams(self):
        return {"stepsize": self.stepsize}

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key,
                                                round_index=state.round),
                             round=state.round + 1)


def run_gd(problem: FederatedLogReg, w0: torch.Tensor, rounds: int,
           stepsize: float,
           callback: Optional[Callable[[torch.Tensor, int], Any]] = None
           ) -> Tuple[torch.Tensor, List[Any]]:
    """The GD round loop on the flat view: one O(nnz) gradient a round.
    The same iterates as :class:`DistributedGD`, which forms every
    client's delta; ``callback(w, r)``'s results make the history."""
    w = w0
    hist = []
    for r in range(rounds):
        w = w - stepsize * problem.flat.grad(w)
        if callback:
            hist.append(callback(w, r))
    return w, hist


def _gd_defaults():
    from repro_torch.configs import get_gd_config
    return {"stepsize": get_gd_config().stepsize}


@register("gd", defaults=_gd_defaults,
          description="distributed gradient descent (the trivial benchmark)")
def _make_gd(problem: FederatedLogReg, *, device: DeviceLike = None,
             **kw) -> DistributedGD:
    return DistributedGD(problem, device=device, **kw)


def fedavg_round(problem: FederatedLogReg, w: torch.Tensor,
                 key: threefry.Key, stepsize: float,
                 epochs: int = 1) -> torch.Tensor:
    """Local SGD + n_k/n-weighted averaging (FedAvg, [62]) for one round
    from ``w`` on ``key``, on the problem's device."""
    solver = FedAvg(problem, FedAvgConfig(stepsize=stepsize,
                                          local_epochs=epochs),
                    device=problem.device)
    return solver.round(solver.init(w), key).w


def one_shot_average(problem: FederatedLogReg, w0: torch.Tensor,
                     key: threefry.Key, stepsize: float,
                     epochs: int = 50) -> torch.Tensor:
    """[107]: clients optimize to (near-)completion locally; average once."""
    return fedavg_round(problem, w0, key, stepsize, epochs=epochs)


def majority_baseline_error(train_y: torch.Tensor,
                            train_client_of: torch.Tensor,
                            test_y: torch.Tensor,
                            test_client_of: torch.Tensor) -> float:
    """Per-client majority-vote error (the paper's 17.14 % analogue).

    Client k predicts +1 when at least half of its training labels are
    positive, else −1; a client without training rows predicts −1 (the
    reference's vote over an empty mean is NaN ≥ 0.5, false).  One
    bincount over the rows, on their device, in place of a loop over K."""
    K = int(max(int(train_client_of.max()), int(test_client_of.max()))) + 1
    count = torch.bincount(train_client_of, minlength=K)
    pos = torch.bincount(train_client_of[train_y > 0], minlength=K)
    maj = torch.where((count > 0) & (2 * pos >= count), 1.0, -1.0)
    wrong = int((maj[test_client_of] != test_y).sum())
    return wrong / int(test_y.shape[0])
