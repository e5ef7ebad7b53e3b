"""Federated SVRG — the paper's Algorithm 4 (and the naive Algorithm 3),
ported from the reference's ``core/fsvrg.py``.

One round:
  1. server: compute ∇f(w^t) over all data      — 1 round of communication
  2. each client k, in parallel:
       w_k = w^t;  h_k = h / n_k
       for t over a random permutation of P_k:
         w_k ← w_k − h_k ( S_k [∇f_i(w_k) − ∇f_i(w^t)] + ∇f(w^t) )
  3. server: w ← w^t + A Σ_k (n_k/n)(w_k − w^t)

A bucket's Kb clients step together: step t of the pass is one batched
step of every client, over its own permutation, and padded permutation
slots are exact no-ops (their step size is 0).  The local step itself is
the ``fsvrg_update`` kernel (the reference computes the same step inline).

The naive Algorithm 3 (``naive=True``, registered as ``svrg_naive``) runs
the same pass with S = I, a fixed h, m samples drawn with replacement
(``randint``) and every step valid, averaged uniformly without A.  Client
k of the bucket with key kb draws from ``take(split(kb, Kb), k)``: its
permutation or its samples are the reference's, bit for bit.

The scale paths (``client_chunk``, ``cohort``, ``virtual_data``; see
:mod:`repro_torch.core.engine`) run the keyed chunk pass, which takes its
clients' keys and forms their S_k and h_k from their own rows, as the
reference's ``_client_pass_keyed`` does: only the plain round caches S_k
for every client (K·d floats), and the step's scratch is sized to what
one pass gets (a chunk, a cohort or the largest bucket).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import scaling
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.kernels import ops
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class FSVRGConfig:
    stepsize: float = 1.0          # h; h_k = h/n_k per client
    naive: bool = False            # Algorithm 3: S=I, A=I, h_k=h, uniform agg
    naive_steps: int = 0           # m for Algorithm 3 (0 -> one pass, m=m_pad)
    use_S: bool = True             # ablation switches of the four §3.6.2
    use_A: bool = True             # modifications
    use_local_stepsize: bool = True
    use_weighted_agg: bool = True
    # i.i.d. per-round client participation; aggregation reweights by the
    # realized participating mass so the update stays unbiased
    participation: float = 1.0
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


def client_pass_keyed(w0: torch.Tensor, full_grad: torch.Tensor,
                      bucket: ClientBucket, lam: float, s_diag: torch.Tensor,
                      h_k: torch.Tensor, perms: torch.Tensor,
                      out: torch.Tensor, *,
                      diff: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Algorithm 4, lines 5-9, for every client of a bucket at once, over
    explicit per-client row orders ``perms`` (Kb, m) — the counterpart of
    the reference's ``_client_pass_keyed``.

    ``perms`` are the clients' permutations of their m_pad slots, or
    (Algorithm 3) their m samples; ``valid`` (Kb, m) weights each step,
    by default 1 where the row is one of the client's n_k rows and 0 on a
    padded slot.  ``s_diag`` is S_k, (Kb, d) or one shared (d,) row;
    ``h_k`` (Kb,) the local step sizes.  The iterates w_k are stepped in
    place in ``out`` (Kb, d), which ends holding the deltas w_k − w0.
    ``diff`` is an optional (≥Kb, d) scratch, so a caller running many
    buckets allocates it once.  Per step, in the reference's order of
    operations:

        diff = λ(w_k − w0), then diff[x_i] += (g_new − g_old)·v_i
        w_k  = fsvrg_update(w_k, S, g_new=diff, g_old=0, ḡ=∇f(w0),
                            h=valid·h_k)

    which is the reference's w_k − valid·h_k(S⊙diff + ∇f(w0)).
    """
    Kb, _, nnz = bucket.idx.shape
    m = perms.shape[1]
    d = w0.shape[0]
    # the permuted rows, step-major: row t of client k is its row perms[k, t]
    take = perms[..., None].expand(Kb, m, nnz)
    pidx = bucket.idx.gather(1, take).transpose(0, 1).contiguous()
    pval = bucket.val.gather(1, take).transpose(0, 1).contiguous()
    py = bucket.y.gather(1, perms).t().contiguous()                   # (m, Kb)
    if valid is None:
        valid = (perms < bucket.n_k[:, None]).to(torch.float32)
    h = (valid.t() * h_k[None, :]).contiguous()                       # (m, Kb)
    # the anchor's per-example gradient scalars need only x·w0: all at once
    z_old = (pval * w0[pidx]).sum(dim=-1)
    g_old = -py * torch.sigmoid(-py * z_old)

    wk = out
    wk.copy_(w0.expand(Kb, d))
    diff = torch.empty_like(wk) if diff is None else diff[:Kb]
    zero = torch.zeros_like(w0)
    for t in range(m):
        xi, vi, yi = pidx[t], pval[t], py[t]
        z_new = (vi * wk.gather(1, xi)).sum(dim=1)
        g_new = -yi * torch.sigmoid(-yi * z_new)
        torch.sub(wk, w0, out=diff).mul_(lam)       # L2 part of the difference
        diff.scatter_add_(1, xi, (g_new - g_old[t])[:, None] * vi)
        ops.fsvrg_update(wk, s_diag, diff, zero, full_grad, h[t], out=wk)
    return wk.sub_(w0)


class FSVRG(FederatedSolver):
    """Algorithms 3 and 4 on the :class:`~repro_torch.core.engine.RoundEngine`:
    φ, A and every bucket's S_k are computed once here, then each round is
    the full-gradient prelude plus the engine's round."""

    name = "fsvrg"

    def __init__(self, problem: FederatedLogReg,
                 cfg: FSVRGConfig = FSVRGConfig(), *,
                 device: DeviceLike = None):
        self._bind(problem, device)
        self.cfg = cfg
        self.name = "svrg_naive" if cfg.naive else "fsvrg"
        plain = cfg.naive            # Alg. 3: S = I, fixed h, no A, 1/K
        flat = problem.flat
        dev = problem.device
        d = problem.d
        self.phi = scaling.global_feature_counts(flat) / flat.n
        self.a_diag = (scaling.aggregation_diag(problem) if cfg.use_A
                       else torch.ones((d,), device=dev))
        self.engine = RoundEngine(
            problem,
            EngineConfig(
                participation=cfg.participation,
                weighting=("uniform" if plain or not cfg.use_weighted_agg
                           else "nk"),
                server_scaling="diag" if cfg.use_A and not plain else "none",
                aggregator=cfg.aggregator,
                client_chunk=cfg.client_chunk,
                cohort=cfg.cohort,
                virtual_data=cfg.virtual_data or problem.virtual is not None,
                aggregator_guard=cfg.aggregator_guard,
                guard_clip_norm=cfg.guard_clip_norm,
                guard_trim=cfg.guard_trim,
            ),
            a_diag=self.a_diag,
            participation_model=cfg.participation_model,
            fault_model=cfg.fault_model,
        )
        # the plain round caches S_k (K·d floats) and h_k once per solver
        # instead of recomputing them every round as the reference does;
        # the keyed chunk pass forms them from each chunk's rows
        self.s_diags = self.h_k = None
        if self.engine.round_path() == "plain":
            self.s_diags = [self._s_diag(b) for b in problem.buckets]
            self.h_k = [self._h(b) for b in problem.buckets]
        # the step's scratch, shared by every pass
        self._scratch("_diff", self.engine.pass_rows())
        # the full gradient is the round's own communication (Alg. 4 line 3)
        prelude = lambda w: (self.problem.flat.grad(w),)
        self._round_fast = self.engine.compile(
            self._pass, prelude=prelude, chunk_pass=self._chunk_pass)

    def _s_diag(self, bucket: ClientBucket) -> torch.Tensor:
        """S_k of the bucket's clients, (Kb, d) from their rows; without
        use_S (or under Algorithm 3) one shared row of ones."""
        if self.cfg.use_S and not self.cfg.naive:
            return scaling.s_k_diag(self.phi, bucket.idx, bucket.val,
                                    bucket.n_k)
        return torch.ones((self.problem.d,), device=self.problem.device)

    def _h(self, bucket: ClientBucket) -> torch.Tensor:
        """h_k = h / n_k as a tensor division (torch computes `h / tensor`
        as reciprocal(tensor) · h, which rounds differently); a fixed h
        without use_local_stepsize or under Algorithm 3."""
        h = torch.full((bucket.num_clients,), float(self.cfg.stepsize),
                       device=self.problem.device)
        if self.cfg.use_local_stepsize and not self.cfg.naive:
            h = h / bucket.n_k.to(torch.float32).clamp(min=1.0)
        return h

    def permutations(self, kb: threefry.Key, bucket_index: int,
                     bucket: ClientBucket) -> torch.Tensor:
        """Every client's random order of its m_pad slots (Alg. 4 line 6):
        ``permutation(take(split(kb, Kb), k), m_pad)`` for client k, drawn
        batched from the bucket's key: (Kb, m_pad) int64."""
        return threefry.permutation(
            self.engine.client_keys(kb, bucket.num_clients), bucket.m_pad)

    def samples(self, kb: threefry.Key, bucket_index: int,
                bucket: ClientBucket) -> torch.Tensor:
        """Algorithm 3's m uniform samples with replacement from each
        client's n_k rows (Alg. 3 line 7): ``randint(take(split(kb, Kb),
        k), (m,), 0, max(n_k, 1))`` for client k: (Kb, m) int64."""
        return self._samples(
            self.engine.client_keys(kb, bucket.num_clients), bucket)

    def _samples(self, keys: threefry.Key,
                 bucket: ClientBucket) -> torch.Tensor:
        m = self.cfg.naive_steps if self.cfg.naive_steps > 0 else bucket.m_pad
        return threefry.randint(keys, (m,), 0, bucket.n_k.clamp(min=1))

    def _run(self, w, full_grad, bucket, s_diag, h_k, rows, out):
        valid = None
        if self.cfg.naive:                                  # every step
            valid = torch.ones(rows.shape, device=w.device)
        client_pass_keyed(w, full_grad, bucket, self.problem.flat.lam,
                          s_diag, h_k, rows, out,
                          diff=self._scratch("_diff", bucket.num_clients),
                          valid=valid)

    def _pass(self, w, bi, bucket, kb, out, full_grad):
        rows = (self.samples(kb, bi, bucket) if self.cfg.naive
                else self.permutations(kb, bi, bucket))
        self._run(w, full_grad, bucket, self.s_diags[bi], self.h_k[bi],
                  rows, out)

    def _chunk_pass(self, w, bi, bucket, keys, out, full_grad):
        """The keyed chunk pass: a chunk, a gathered cohort or a
        regenerated bucket, with its clients' own keys."""
        rows = (self._samples(keys, bucket) if self.cfg.naive
                else threefry.permutation(keys, bucket.m_pad))
        self._run(w, full_grad, bucket, self._s_diag(bucket),
                  self._h(bucket), rows, out)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        return state.replace(w=self._round_fast(state.w, key,
                                                round_index=state.round),
                             round=state.round + 1)


def naive_fsvrg_round(problem: FederatedLogReg, w: torch.Tensor,
                      key: threefry.Key, stepsize: float,
                      m: Optional[int] = None) -> torch.Tensor:
    """One round of Algorithm 3 (S = I, A = I, h_k = h, m uniform samples,
    1/K averaging) from ``w`` on ``key``, on the problem's device: a thin
    wrapper over the ``svrg_naive`` solver."""
    cfg = FSVRGConfig(stepsize=stepsize, naive=True, naive_steps=m or 0)
    solver = FSVRG(problem, cfg, device=problem.device)
    return solver.round(solver.init(w), key).w


def _fsvrg_defaults():
    from repro_torch.configs import get_fsvrg_config
    return {"stepsize": get_fsvrg_config().stepsize}


@register("fsvrg", defaults=_fsvrg_defaults,
          description="Federated SVRG (Algorithm 4, all four modifications)")
def _make_fsvrg(problem: FederatedLogReg, *, device: DeviceLike = None,
                **kw) -> FSVRG:
    return FSVRG(problem, FSVRGConfig(**kw), device=device)


@register("svrg_naive",
          defaults=lambda: {"stepsize": 0.01, "naive_steps": 50},
          description="naive distributed SVRG (Algorithm 3: S=I, A=I, "
                      "fixed h, uniform averaging)")
def _make_svrg_naive(problem: FederatedLogReg, *, device: DeviceLike = None,
                     **kw) -> FSVRG:
    return FSVRG(problem, FSVRGConfig(naive=True, **kw), device=device)
