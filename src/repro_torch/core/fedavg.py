"""Federated Averaging (McMahan et al., arXiv:1602.05629) on the round
engine, ported from the reference's ``core/fedavg.py``.

Each client runs ``local_epochs`` permutation passes of plain SGD on its own
data (B = ∞, E = ``local_epochs``, C = ``participation``), and the server
n_k/n-averages the deltas.  One local step on the L2-regularized logistic
objective is

    w ← w − h (∇f_i(w) + λ w)  =  (1 − hλ)·w − h·∇f_i(w),

the ``fedavg_update`` kernel.  A bucket's Kb clients step together: step t
of epoch e is one batched step of every client over its own permutation,
and padded permutation slots are exact no-ops (their step size is
h_eff = valid·h = 0).  Client k of the bucket with key kb runs epoch e over
``permutation(take(split(take(split(kb, Kb), k), E), e), m_pad)``, the
reference's permutation, bit for bit.

The scale paths (``client_chunk``, ``cohort``, ``virtual_data``; see
:mod:`repro_torch.core.engine`) run the same pass over a chunk, a gathered
cohort or a regenerated bucket with its clients' own keys; the gradient
scratch is sized to what one pass gets.
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
class FedAvgConfig:
    stepsize: float = 0.1          # h, the raw per-step local stepsize
    local_epochs: int = 1          # E: permutation passes per client per round
    participation: float = 1.0     # C: i.i.d. client fraction per round
    use_weighted_agg: bool = True  # n_k/n (True) vs uniform 1/K averaging
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


def local_sgd_pass_keyed(w0: torch.Tensor, bucket: ClientBucket, lam: float,
                         stepsize: float, perms: torch.Tensor,
                         out: torch.Tensor, *,
                         g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """E epochs of permutation-order SGD for every client of a bucket at
    once, over explicit permutations ``perms`` (Kb, E, m_pad) — the
    counterpart of the reference's ``_local_sgd_pass_keyed``.

    The iterates w_k are stepped in place in ``out`` (Kb, d), which ends
    holding the deltas w_k − w0.  ``g`` is an optional (≥Kb, d) scratch
    of zeros, so a caller running many buckets allocates it once; it is
    left all zeros.  Per step the sparse gradient's nnz entries are
    scattered into it, the kernel runs, and the same entries are zeroed
    again — never a dense pass to clear it."""
    Kb, m_pad, nnz = bucket.idx.shape
    d = w0.shape[0]
    wk = out
    wk.copy_(w0.expand(Kb, d))
    g = torch.zeros_like(wk) if g is None else g[:Kb]
    for e in range(perms.shape[1]):
        p = perms[:, e]
        # the permuted rows, step-major: row t of client k is its row p[k, t]
        take = p[..., None].expand(Kb, m_pad, nnz)
        pidx = bucket.idx.gather(1, take).transpose(0, 1).contiguous()
        pval = bucket.val.gather(1, take).transpose(0, 1).contiguous()
        py = bucket.y.gather(1, p).t().contiguous()                # (m_pad, Kb)
        valid = (p < bucket.n_k[:, None]).to(torch.float32).t()
        h = (valid * stepsize).contiguous()           # padded slot -> h = 0
        for t in range(m_pad):
            xi, vi, yi = pidx[t], pval[t], py[t]
            z = (vi * wk.gather(1, xi)).sum(dim=1)
            g_sc = -yi * torch.sigmoid(-yi * z)
            g.scatter_add_(1, xi, g_sc[:, None] * vi)
            ops.fedavg_update(wk, g, h[t], lam, out=wk)
            g.scatter_(1, xi, 0.0)
    return wk.sub_(w0)


class FedAvg(FederatedSolver):
    """FedAvg on the :class:`~repro_torch.core.engine.RoundEngine`: the
    engine samples and aggregates, FedAvg supplies the local-SGD pass."""

    name = "fedavg"

    def __init__(self, problem: FederatedLogReg,
                 cfg: FedAvgConfig = FedAvgConfig(), *,
                 device: DeviceLike = None):
        self._bind(problem, device)
        self.cfg = cfg
        self.engine = RoundEngine(
            problem,
            EngineConfig(
                participation=cfg.participation,
                weighting="nk" if cfg.use_weighted_agg else "uniform",
                aggregator=cfg.aggregator,
                client_chunk=cfg.client_chunk,
                cohort=cfg.cohort,
                virtual_data=cfg.virtual_data or problem.virtual is not None,
                aggregator_guard=cfg.aggregator_guard,
                guard_clip_norm=cfg.guard_clip_norm,
                guard_trim=cfg.guard_trim,
            ),
            participation_model=cfg.participation_model,
            fault_model=cfg.fault_model,
        )
        # the step's gradient scratch of zeros, shared by every pass
        self._scratch("_g", self.engine.pass_rows(), zeros=True)
        self._round_fast = self.engine.compile(self._pass,
                                               chunk_pass=self._chunk_pass)

    def permutations(self, kb: threefry.Key, bucket_index: int,
                     bucket: ClientBucket) -> torch.Tensor:
        """Every client's random order of its m_pad slots for each of the
        E epochs, drawn batched from the bucket's key: client k's keys are
        ``split(take(split(kb, Kb), k), E)``, one permutation each:
        (Kb, E, m_pad) int64."""
        return self._permutations(
            self.engine.client_keys(kb, bucket.num_clients), bucket)

    def _permutations(self, keys: threefry.Key,
                      bucket: ClientBucket) -> torch.Tensor:
        return threefry.permutation(
            threefry.split(keys, self.cfg.local_epochs), bucket.m_pad)

    def _run(self, w, bucket, perms, out):
        local_sgd_pass_keyed(
            w, bucket, self.problem.flat.lam, self.cfg.stepsize, perms, out,
            g=self._scratch("_g", bucket.num_clients, zeros=True))

    def _pass(self, w, bi, bucket, kb, out):
        self._run(w, bucket, self.permutations(kb, bi, bucket), out)

    def _chunk_pass(self, w, bi, bucket, keys, out):
        """The keyed chunk pass: a chunk, a gathered cohort or a
        regenerated bucket, with its clients' own keys."""
        self._run(w, bucket, self._permutations(keys, bucket), out)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key,
                                                round_index=state.round),
                             round=state.round + 1)


def _fedavg_defaults():
    from repro_torch.configs import get_fedavg_config
    c = get_fedavg_config()
    return {"stepsize": c.stepsize, "local_epochs": c.local_epochs,
            "participation": c.participation}


@register("fedavg", defaults=_fedavg_defaults,
          description="Federated Averaging (arXiv:1602.05629, B=∞)")
def _make_fedavg(problem: FederatedLogReg, *, device: DeviceLike = None,
                 **kw) -> FedAvg:
    return FedAvg(problem, FedAvgConfig(**kw), device=device)
