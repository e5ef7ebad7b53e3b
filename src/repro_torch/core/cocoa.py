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

Appendix A's methods for ridge regression run on the same hook, on a
:func:`~repro_torch.core.problem.build_dense_problem` layout with equal
n_k (as the paper assumes "for simplicity"):

  * :class:`PrimalMethod` — Algorithm 5: quadratic perturbation with
    a_k^t = ∇F_k(w^t) − (η∇F_k(w^t) + g_k^t); the state is g_k, closed
    after the round from the aggregated w^{t+1} (step 9);
  * :class:`DualMethod` — Algorithm 6: dual block proximal ascent with
    exact block solves (eq. 19); the state is α_k and the iterate tracks
    w^t = (1/λn) X α^t through the summed deltas.

Theorem 5: for ridge regression the two generate the same iterates under
w = (1/λn) X α.  Their local solves are batched ``torch.linalg.solve``
calls, one a bucket (the reference's ``jnp.linalg.solve``; no TPU kernel
computes them).

CoCoA+ runs the scale paths too (``client_chunk``, ``cohort``,
``virtual_data``; see :mod:`repro_torch.core.engine`): its keyed chunk
pass is one ``cocoa_sdca_pass`` over a chunk's (or a gathered cohort's)
slice of the bucket and of α, with its clients' own keys; the engine puts
the new α back in client order (a cohort's at its clients' slots only),
and a client left out of the round keeps its α bit for bit.  α stays
materialized on the virtual path: it is the algorithm's state, not the
data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.problem import ClientBucket, FederatedLogReg
from repro_torch.core.registry import register
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.kernels import ops
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike


def dual_to_primal(Xs: Sequence[torch.Tensor], alphas: Sequence[torch.Tensor],
                   lam: float) -> torch.Tensor:
    """w = (1/λn) Σ_k X_k α_k for per-client dual blocks (X_k: (d, m_k))."""
    n = sum(int(a.shape[0]) for a in alphas)
    return sum(X @ a for X, a in zip(Xs, alphas)) / (lam * n)


@dataclasses.dataclass(frozen=True)
class CoCoAConfig:
    """CoCoA+ knobs (γ is fixed at 1, the "adding" variant)."""

    sigma: Optional[float] = None  # σ′: None -> the safe γK
    participation: float = 1.0     # i.i.d. per-round client participation
    # "dense" (plain tensor code) | "pallas" (the fused_aggregate kernel)
    aggregator: str = "dense"
    # None -> form each bucket's (Kb, d) delta stack; an int streams the
    # client axis (and α) in chunks of this size (EngineConfig.client_chunk)
    client_chunk: Optional[int] = None
    # under partial participation, compute only the sampled cohort, its α
    # gathered and put back (EngineConfig.cohort, engine.cohort_capacity)
    cohort: Optional[int] = None
    # rows regenerated on demand from a build_virtual_problem layout (see
    # EngineConfig.virtual_data); set by itself for a virtual problem
    virtual_data: bool = False
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
        self._round_fast = self.engine.compile_with_state(
            self._pass, chunk_pass=self._chunk_pass)

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

    def _run(self, w, bucket, alpha, perms, out):
        flat = self.problem.flat
        u = sdca_local_pass_keyed(w, alpha, bucket, flat.lam, flat.n,
                                  self.sigma, perms, out)
        out.mul_(self._scale)
        return alpha + u

    def _pass(self, w, bi, bucket, alpha, kb, out):
        return self._run(w, bucket, alpha,
                         self.permutations(kb, bi, bucket), out)

    def _chunk_pass(self, w, bi, bucket, alpha, keys, out):
        """The keyed chunk pass: a chunk's (or a gathered cohort's) slice
        of a bucket and of its α, with its clients' own keys."""
        return self._run(w, bucket, alpha,
                         threefry.permutation(keys, bucket.m_pad), out)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        w, alphas = self._round_fast(state.w, state.aux, key,
                                     round_index=state.round)
        return SolverState(w=w, aux=alphas, round=state.round + 1)

    @property
    def hyperparams(self):
        hp = dataclasses.asdict(self.cfg)
        hp["sigma"] = self.sigma          # the resolved σ′, not the None default
        return hp


# --------------------------------------------------------------------- #
# Appendix A, ridge regression (equal n_k, dense buckets)
# --------------------------------------------------------------------- #


def _check_equal_sizes(problem: FederatedLogReg) -> None:
    for b in problem.buckets:
        if int(b.n_k.min()) != int(b.n_k.max()):
            raise ValueError("Appendix-A methods assume equal n_k")
    if len(problem.buckets) != 1:
        raise ValueError("Appendix-A methods assume equal n_k (one bucket)")


def _stack_alphas0(problem: FederatedLogReg,
                   alphas0: Optional[Sequence[Any]]) -> torch.Tensor:
    """(K, m) initial dual blocks from a per-client list (zeros default),
    in the data's dtype on its device."""
    b = problem.buckets[0]
    if alphas0 is None:
        return torch.zeros((b.num_clients, b.m_pad), dtype=b.val.dtype,
                           device=b.val.device)
    return torch.stack([torch.as_tensor(a, device=b.val.device)
                        for a in alphas0]).to(b.val.dtype)


class PrimalMethod(FederatedSolver):
    """Algorithm 5 (Primal Method) with exact local solves, on the engine.

    The per-client state g_k (steps 4 and 9) rides through
    ``round_with_state``: the pass returns each exact subproblem solution
    w_k as the bucket's new state (the old g_k stays as it was), the
    engine's uniform weighting forms w^{t+1} = (1/K) Σ w_k, and step 9
    (g_k ← g_k + λη(w_k − w^{t+1})) closes the round with the aggregate.

    ``problem`` must be a :func:`~repro_torch.core.problem.build_dense_problem`
    layout with equal n_k.  ``init()`` runs steps 3–5 (w⁰ and g⁰ follow
    from ``alphas0``), so a custom ``w0`` is rejected."""

    name = "primal"

    def __init__(self, problem: FederatedLogReg, *,
                 sigma: Optional[float] = None, alphas0=None,
                 device: DeviceLike = None):
        _check_equal_sizes(problem)
        self._bind(problem, device)
        K = problem.num_clients
        self.lam = float(problem.flat.lam)
        self.sigma = float(K if sigma is None else sigma)
        self.eta = K / self.sigma
        self.mu = self.lam * (self.eta - 1.0)
        self._alpha0 = _stack_alphas0(problem, alphas0)
        self.engine = RoundEngine(problem, EngineConfig(weighting="uniform"))
        self._round_fast = self.engine.compile_with_state(self._primal_pass)

    @property
    def hyperparams(self):
        return {"sigma": self.sigma, "eta": self.eta, "mu": self.mu}

    def init(self, w0: Optional[torch.Tensor] = None) -> SolverState:
        if w0 is not None:
            raise ValueError("PrimalMethod's w0 is determined by alphas0 "
                             "(steps 3-5 of Algorithm 5)")
        b = self.problem.buckets[0]
        n = self.problem.flat.n
        K = self.problem.num_clients
        # steps 3-5: w^0 = (1/λn) Σ X_k α_k;  g_k^0 = η((K/n) X_k α_k − λw^0)
        xa = torch.einsum("kmd,km->kd", b.val, self._alpha0)     # X_k α_k
        w = xa.sum(dim=0) / (self.lam * n)
        gs = self.eta * ((K / n) * xa - self.lam * w)
        return SolverState(w=w, aux=(gs,))

    def _primal_pass(self, w, bi, bucket, gs, kb, out):
        lam, eta, mu = self.lam, self.eta, self.mu
        c = self.problem.num_clients / self.problem.flat.n      # K/n
        X = bucket.val.transpose(1, 2)                          # (Kb, d, m)
        # argmin F_k(w') − (∇F_k(w^t) − (η∇F_k(w^t) + g_k))ᵀw'
        #        + µ/2||w'−w^t||²,  F_k as in eq. 12 ((K/n)-normalized)
        resid = torch.einsum("kdm,d->km", X, w) - bucket.y
        Fk = c * torch.einsum("kdm,km->kd", X, resid) + lam * w
        b_k = (1.0 - eta) * Fk - gs
        eye = torch.eye(w.shape[0], dtype=X.dtype, device=X.device)
        H = c * (X @ bucket.val) + (lam + mu) * eye
        rhs = c * torch.einsum("kdm,km->kd", X, bucket.y) + b_k + mu * w
        wk = torch.linalg.solve(H, rhs)
        torch.sub(wk, w, out=out)
        return wk

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        # step 9's g update needs the aggregated w^{t+1}, so it closes the
        # round after the engine's; the engine leaves state.aux as it was
        w_next, wks = self._round_fast(state.w, state.aux, key)
        gs = tuple(g + self.lam * self.eta * (wk - w_next)
                   for g, wk in zip(state.aux, wks))
        return SolverState(w=w_next, aux=gs, round=state.round + 1)


class DualMethod(FederatedSolver):
    """Algorithm 6 (Dual Method) with exact block solves, on the engine.

    Block subproblem (19): h_k = argmin (σ/2λn)||X_k h||² + ½||h||²
                                        − (y_k − X_kᵀw^t − α_k)ᵀ h
    The state is the dual block α_k in ``state.aux``; the pass returns
    X_k h_k/(λn) as the delta, so the engine's plain sum tracks
    w^{t+1} = (1/λn) X α^{t+1}.  ``init()`` derives w⁰ from ``alphas0``,
    so a custom ``w0`` is rejected."""

    name = "dual"

    def __init__(self, problem: FederatedLogReg, *,
                 sigma: Optional[float] = None, alphas0=None,
                 device: DeviceLike = None):
        _check_equal_sizes(problem)
        self._bind(problem, device)
        self.lam = float(problem.flat.lam)
        self.sigma = float(problem.num_clients if sigma is None else sigma)
        self._alpha0 = _stack_alphas0(problem, alphas0)
        self.engine = RoundEngine(problem, EngineConfig(weighting="sum"))
        self._round_fast = self.engine.compile_with_state(self._dual_pass)

    @property
    def hyperparams(self):
        return {"sigma": self.sigma}

    def init(self, w0: Optional[torch.Tensor] = None) -> SolverState:
        if w0 is not None:
            raise ValueError("DualMethod's w0 is determined by alphas0 "
                             "(w = (1/lambda n) X alpha)")
        b = self.problem.buckets[0]
        n = self.problem.flat.n
        w = torch.einsum("kmd,km->d", b.val, self._alpha0) / (self.lam * n)
        return SolverState(w=w, aux=(self._alpha0,))

    def _dual_pass(self, w, bi, bucket, alpha, kb, out):
        lam_n = self.lam * self.problem.flat.n
        X = bucket.val.transpose(1, 2)                          # (Kb, d, m)
        c = bucket.y - torch.einsum("kdm,d->km", X, w) - alpha
        eye = torch.eye(alpha.shape[1], dtype=X.dtype, device=X.device)
        M = (self.sigma / lam_n) * (bucket.val @ X) + eye
        h = torch.linalg.solve(M, c)
        torch.div(torch.einsum("kdm,km->kd", X, h), lam_n, out=out)
        return alpha + h

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        w, alphas = self._round_fast(state.w, state.aux, key)
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


@register("primal", layout="dense",
          description="Appendix-A Algorithm 5 (Primal Method, exact solves)")
def _make_primal(problem: FederatedLogReg, *, device: DeviceLike = None,
                 **kw) -> PrimalMethod:
    return PrimalMethod(problem, device=device, **kw)


@register("dual", layout="dense",
          description="Appendix-A Algorithm 6 (Dual Method, exact solves)")
def _make_dual(problem: FederatedLogReg, *, device: DeviceLike = None,
               **kw) -> DualMethod:
    return DualMethod(problem, device=device, **kw)
