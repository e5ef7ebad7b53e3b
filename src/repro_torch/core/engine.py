"""Unified federated round engine — the paper's round template (§1, §3),
ported from the reference's ``core/engine.py`` (its plain round path).

One round:

  1. the algorithm's prelude computes per-round server state (FSVRG's full
     gradient);
  2. each bucket's client pass writes its clients' deltas ``w_k − w`` into
     its rows of one stacked (K, d) buffer;
  3. the server weights the clients (``weighting``) and, under partial
     participation, zeroes the non-participants and reweights by expected
     over realized mass so the update stays unbiased;
  4. the server applies ``w + A ⊙ (s · Σ_k wts_k δ_k)`` (``server_scaling``),
     either as plain tensor code (``aggregator="dense"``) or through the
     fused aggregation kernel over the stacked deltas
     (``aggregator="pallas"``, the reference's name for its kernel path).

Algorithms with per-client state across rounds (CoCoA+'s dual blocks,
Appendix A's g_k and α_k) use :meth:`RoundEngine.round_with_state`: each
bucket's pass also receives its bucket's state and returns a new one (the
old tensor is left as it was), and under partial participation a client
left out of the round keeps its old state.  The weights and the reweight
sums are formed in the iterate's dtype, so the dense ridge methods run in
f64 as the reference's do under x64.

Randomness: a round takes the reference's round key (a
:mod:`repro_torch.utils.threefry` key, the Trainer's
``fold_in(PRNGKey(seed), r)``), and its words are moved to the engine's
device, so every draw of the round runs there.  The bucket whose first
client is ``wi`` gets ``kb = fold_in(key, wi)``: its Bernoulli mask is
``uniform(fold_in(kb, 997), (Kb,)) < participation``, drawn once a round
and shared by every consumer, and its pass receives ``kb`` and draws its
clients' keys ``split(kb, Kb)`` (:meth:`RoundEngine.client_keys`) — the
reference's draws, bit for bit.

Fault tolerance (the reference's fleet layer on the plain round):

  * ``participation_model`` (:mod:`repro_torch.fleet.participation`)
    replaces the Bernoulli draw — e.g. trace-driven availability and
    stragglers, a pure function of ``(trace.seed, round_index)``;
  * ``fault_model`` (:mod:`repro_torch.fleet.faults`) corrupts each
    bucket's returned deltas right after its pass — the wire, not the
    client: CoCoA+'s α is whatever the honest pass computed;
  * ``EngineConfig.aggregator_guard`` is the server's defence: ``"clip"``
    zeroes every delta with a non-finite coordinate (and caps the norms at
    ``guard_clip_norm``) before the weighted sum; ``"trimmed_mean"`` and
    ``"median"`` replace the weighted sum with a coordinate-wise order
    statistic over the returned, all-finite deltas (the
    ``robust_aggregate`` kernel) — no weights, no reweighting.

Ported: the plain round and the state round, for every solver of the
reference's registry (the sparse Fig. 2 solvers and the dense ridge
ones).  Not ported yet: streamed (``client_chunk``), cohort and virtual
rounds.  ``compile`` and ``compile_with_state`` are the same eager rounds
as ``reference`` and ``reference_with_state`` for now.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.problem import FederatedLogReg
from repro_torch.kernels import ops
from repro_torch.utils import threefry

#: client_pass(w, bucket_index, bucket, kb, out, *ctx) writes the bucket's
#: (Kb, d) deltas w_k − w into ``out``; kb is the bucket's key
ClientPassFn = Callable[..., None]

#: state_pass(w, bucket_index, bucket, state, kb, out, *ctx) writes the
#: bucket's deltas into ``out`` and returns its new state, a new tensor
#: whose leading axis is the bucket's client axis (CoCoA+'s α, (Kb, m_pad));
#: the old state is left as it was
StateClientPassFn = Callable[..., torch.Tensor]

_WEIGHTINGS = ("nk", "uniform", "sum")
_SCALINGS = ("none", "diag")
_AGGREGATORS = ("dense", "pallas")
_GUARDS = ("clip", "trimmed_mean", "median")
_ORDER_STAT_GUARDS = ("trimmed_mean", "median")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Round-scheduling knobs shared by every federated algorithm."""

    participation: float = 1.0     # i.i.d. per-round client participation prob
    weighting: str = "nk"          # "nk" (n_k/n) | "uniform" (1/K) | "sum" (1)
    server_scaling: str = "none"   # "none" | "diag" (apply a_diag coordinatewise)
    aggregator: str = "dense"      # "dense" | "pallas" (fused_aggregate kernel)
    # the server's defence against corrupted deltas: None | "clip" (reject
    # non-finite deltas, optionally cap norms at guard_clip_norm) |
    # "trimmed_mean" | "median" (coordinate-wise order statistics over the
    # returned, all-finite deltas; robust_aggregate kernel)
    aggregator_guard: Optional[str] = None
    # L2 norm cap per client delta; requires aggregator_guard="clip"
    guard_clip_norm: Optional[float] = None
    # per-side trim fraction for aggregator_guard="trimmed_mean"
    guard_trim: float = 0.1

    def __post_init__(self):
        if self.weighting not in _WEIGHTINGS:
            raise ValueError(f"weighting must be one of {_WEIGHTINGS}")
        if self.server_scaling not in _SCALINGS:
            raise ValueError(f"server_scaling must be one of {_SCALINGS}")
        if self.aggregator not in _AGGREGATORS:
            raise ValueError(f"aggregator must be one of {_AGGREGATORS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if (self.aggregator_guard is not None
                and self.aggregator_guard not in _GUARDS):
            raise ValueError(f"aggregator_guard must be one of {_GUARDS} "
                             "or None")
        if (self.aggregator_guard in _ORDER_STAT_GUARDS
                and self.weighting == "sum"):
            raise ValueError(
                "order-statistic guards replace the weighted sum with "
                "an unweighted coordinate-wise statistic; "
                "weighting='sum' (dual methods tracking frozen dual "
                "blocks) requires the exact plain sum — use "
                "aggregator_guard='clip'")
        if not 0.0 <= self.guard_trim < 0.5:
            raise ValueError("guard_trim must be in [0, 0.5)")
        if self.guard_clip_norm is not None:
            if (isinstance(self.guard_clip_norm, bool)
                    or not isinstance(self.guard_clip_norm, (int, float))
                    or self.guard_clip_norm <= 0):
                raise ValueError(
                    "guard_clip_norm must be a positive number or None")
            if self.aggregator_guard != "clip":
                raise ValueError(
                    "guard_clip_norm requires aggregator_guard='clip'")


class RoundEngine:
    """Owns client sampling, the per-bucket client passes and server
    aggregation.  Algorithms provide a :data:`ClientPassFn`."""

    def __init__(self, problem: FederatedLogReg,
                 cfg: EngineConfig = EngineConfig(), *,
                 a_diag: Optional[torch.Tensor] = None,
                 participation_model: Optional[Any] = None,
                 fault_model: Optional[Any] = None):
        self.problem = problem
        self.cfg = cfg
        if participation_model is not None and not hasattr(
                participation_model, "masks"):
            raise ValueError(
                "participation_model must implement "
                "masks(key, round_index, offsets, sizes, device) — see "
                "repro_torch.fleet.participation.ParticipationModel")
        self.participation_model = participation_model
        if fault_model is not None and not hasattr(fault_model, "apply"):
            raise ValueError(
                "fault_model must implement "
                "apply(deltas, round_index, client_ids) — see "
                "repro_torch.fleet.faults.FaultModel")
        self.fault_model = fault_model
        if cfg.server_scaling == "diag" and a_diag is None:
            raise ValueError("server_scaling='diag' requires an a_diag")
        self.device = problem.device
        self.a_diag = (torch.ones((problem.d,), device=self.device)
                       if a_diag is None else a_diag)
        # per-bucket first-client index into the stacked client axis
        offsets, wi = [], 0
        for b in problem.buckets:
            offsets.append(wi)
            wi += b.num_clients
        self._offsets = tuple(offsets)
        self._sizes = tuple(b.num_clients for b in problem.buckets)

    def _round_index_arg(self, round_index: Optional[int]) -> int:
        """The round the masks and faults are drawn for.  ``None`` is fine
        for the Bernoulli draw and any round-invariant model, and an error
        for round-dependent ones (traces, faults), whose draws are a
        function of the round by contract."""
        if round_index is None:
            if getattr(self.participation_model, "needs_round_index",
                       False):
                raise ValueError(
                    "this engine's participation model is round-dependent; "
                    "pass round_index (solvers forward state.round)")
            if (self.fault_model is not None and
                    getattr(self.fault_model, "needs_round_index", True)):
                raise ValueError(
                    "this engine has a fault model; fault draws are a "
                    "function of the round by contract — pass round_index "
                    "(solvers forward state.round)")
            return 0
        return int(round_index)

    # -- fault injection & guards ------------------------------------------ #

    def _bucket_ids(self, bi: int) -> torch.Tensor:
        """Global client ids of bucket ``bi`` — the identity fault and
        trace draws fold in."""
        wi = self._offsets[bi]
        return torch.arange(wi, wi + self._sizes[bi], dtype=torch.int64,
                            device=self.device)

    def _faulted(self, deltas: torch.Tensor, r: int, bi: int,
                 live: Optional[torch.Tensor]) -> None:
        """Corrupt, in place, the *returned* clients' deltas of bucket
        ``bi`` through the fault model.  A client left out of the round
        keeps its honest delta: a NaN on a zero-weight row would still
        poison the weighted sum (0·NaN = NaN), so the rows are selected,
        not cancelled by their weight."""
        bad = self.fault_model.apply(deltas, r, self._bucket_ids(bi))
        if live is not None:
            bad = torch.where(live.reshape(-1, 1) > 0, bad, deltas)
        deltas.copy_(bad)

    def _order_stat(self) -> bool:
        return self.cfg.aggregator_guard in _ORDER_STAT_GUARDS

    def _guard_clip(self, deltas: torch.Tensor) -> torch.Tensor:
        """The "clip" guard, per client: zero any delta with a non-finite
        coordinate, then cap the survivors' L2 norms at guard_clip_norm."""
        if self.cfg.aggregator_guard != "clip":
            return deltas
        finite = torch.isfinite(deltas).all(dim=-1, keepdim=True)
        safe = torch.where(finite, deltas, torch.zeros_like(deltas))
        cn = self.cfg.guard_clip_norm
        if cn is not None:
            nrm = (safe.to(torch.float32) ** 2).sum(dim=-1,
                                                    keepdim=True).sqrt()
            # a tensor numerator: torch computes `scalar / tensor` as
            # reciprocal(tensor) · scalar, one rounding more than JAX
            fac = (torch.full_like(nrm, float(cn))
                   / nrm.clamp(min=1e-30)).clamp(max=1.0)
            safe = safe * fac.to(safe.dtype)
        return safe

    def _robust_apply(self, w: torch.Tensor, deltas: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        """The order-statistic server update over the stacked (K, d)
        deltas: rows that are not returned, or carry any non-finite
        coordinate, are left out, and the coordinate-wise trimmed mean or
        median of the rest updates the iterate."""
        valid = valid & torch.isfinite(deltas).all(dim=1)
        a = (self.a_diag if self.cfg.server_scaling == "diag"
             else torch.ones_like(w))
        return ops.robust_aggregate(w, deltas, valid, a, self.cfg.guard_trim,
                                    self.cfg.aggregator_guard).to(w.dtype)

    # -- step 3: sampling & weighting ------------------------------------- #

    def bucket_weights(self, wi: int, num_clients: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Aggregation weights for the bucket whose first client is ``wi``,
        in the iterate's ``dtype``: 1/K and 1 are formed in it (f64 for the
        dense ridge methods, as the reference's under x64), while the n_k/n
        weights keep their f32 values, as the reference's do."""
        if self.cfg.weighting == "uniform":
            return torch.full((num_clients,), 1.0 / self.problem.num_clients,
                              dtype=dtype, device=self.device)
        if self.cfg.weighting == "sum":
            return torch.ones((num_clients,), dtype=dtype, device=self.device)
        return self.problem.client_weights[wi:wi + num_clients].to(dtype)

    def participation_mask(self, bucket_key: threefry.Key,
                           num_clients: int) -> torch.Tensor:
        """i.i.d. Bernoulli(participation) mask of one bucket from its key
        (1.0 = in the round): ``uniform(fold_in(kb, 997), (Kb,)) < p``."""
        u = threefry.uniform(threefry.fold_in(bucket_key, 997),
                             (num_clients,))
        return (u < self.cfg.participation).to(torch.float32)

    def participation_masks(self, key: threefry.Key,
                            round_index: Optional[int] = None
                            ) -> Optional[List[torch.Tensor]]:
        """The round's per-bucket Bernoulli(participation) masks, drawn
        once from the round key's ``fold_in`` chain; ``None`` under full
        participation.  With a ``participation_model`` the draw is the
        model's ``masks(key, round_index, offsets, sizes, device)``."""
        if self.participation_model is not None:
            return self.participation_model.masks(
                key, self._round_index_arg(round_index), self._offsets,
                self._sizes, self.device)
        if self.cfg.participation >= 1.0:
            return None
        key = threefry.as_key(key, self.device)
        return [self.participation_mask(threefry.fold_in(key, wi),
                                        b.num_clients)
                for wi, b in zip(self._offsets, self.problem.buckets)]

    def client_keys(self, bucket_key: threefry.Key,
                    num_clients: int) -> threefry.Key:
        """The bucket's per-client keys, ``split(kb, Kb)``, on the engine's
        device: client k's key is ``threefry.take(keys, k)``."""
        return threefry.split(threefry.as_key(bucket_key, self.device),
                              num_clients)

    @staticmethod
    def _reweight_scale(total_mass, expected_mass):
        """The unbiased-participation reweight scalar."""
        return expected_mass / total_mass.clamp(min=1e-9)

    # -- step 4: aggregation ----------------------------------------------- #

    def aggregate(self, w: torch.Tensor, deltas: torch.Tensor,
                  masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
        """Weight, subsample, reweight, scale and apply the client deltas.

        ``deltas`` is the stacked (K, d) matrix in bucket-concatenated
        client order; ``masks`` are the round's
        :meth:`participation_masks` (``None`` only under full
        participation).  Under an order-statistic guard the masks select
        the rows of the statistic instead of weighting them."""
        cfg = self.cfg
        if (masks is None and cfg.participation < 1.0
                and self.participation_model is None):
            raise ValueError("partial participation needs the round's masks")
        if self._order_stat():
            valid = (torch.cat(list(masks)) > 0 if masks is not None else
                     torch.ones((deltas.shape[0],), dtype=torch.bool,
                                device=deltas.device))
            return self._robust_apply(w, deltas, valid)
        if cfg.aggregator == "pallas":
            deltas = self._guard_clip(deltas)
        reweight = masks is not None and cfg.weighting != "sum"
        agg = torch.zeros_like(w)
        wts_all: List[torch.Tensor] = []
        total_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        expected_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        for i, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            wts = self.bucket_weights(wi, b.num_clients, w.dtype)
            if masks is not None:
                sel = masks[i]
                if reweight:
                    total_mass = total_mass + (wts * sel).sum()
                    expected_mass = expected_mass + wts.sum()
                wts = wts * sel
            if cfg.aggregator == "pallas":
                wts_all.append(wts)
            else:
                agg = agg + (wts[:, None] * self._guard_clip(
                    deltas[wi:wi + b.num_clients])).sum(dim=0)
        scale = (self._reweight_scale(total_mass, expected_mass)
                 if reweight else None)
        diag = cfg.server_scaling == "diag"

        if cfg.aggregator == "pallas":
            # one pass over the stacked deltas with the reweight scalar and
            # the A epilogue folded in
            a = self.a_diag if diag else torch.ones_like(w)
            return ops.fused_aggregate(
                w, deltas, torch.cat(wts_all), a,
                1.0 if scale is None else scale).to(w.dtype)
        if scale is not None:
            agg = agg * scale
        return w + (self.a_diag if diag else 1.0) * agg

    # -- steps 2-4: one full round ----------------------------------------- #

    def round(self, w: torch.Tensor, key: threefry.Key,
              client_pass: ClientPassFn, *ctx,
              round_index: Optional[int] = None) -> torch.Tensor:
        """Draw the masks, run every bucket's client pass into the stacked
        delta buffer, corrupt each bucket's returned deltas through the
        fault model (if any), then aggregate.  Bucket ``bi`` with first
        client ``wi`` gets the key ``fold_in(key, wi)``.  ``round_index``
        feeds round-dependent participation models and the fault draws."""
        key = threefry.as_key(key, self.device)
        masks = self.participation_masks(key, round_index)
        r = (self._round_index_arg(round_index)
             if self.fault_model is not None else None)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            out = deltas[wi:wi + b.num_clients]
            client_pass(w, bi, b, threefry.fold_in(key, wi), out, *ctx)
            if r is not None:
                self._faulted(out, r, bi,
                              masks[bi] if masks is not None else None)
        return self.aggregate(w, deltas, masks)

    def round_with_state(self, w: torch.Tensor,
                         states: Sequence[torch.Tensor], key: threefry.Key,
                         client_pass: StateClientPassFn, *ctx,
                         round_index: Optional[int] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """:meth:`round` for algorithms with per-client state: bucket i's
        pass receives ``states[i]`` and returns its new state.

        The round's masks are drawn once and serve both consumers: a client
        whose aggregation weight they zero also keeps its old state, bit
        for bit, so primal and dual views never diverge.  Faults hit the
        delta only, never the state."""
        key = threefry.as_key(key, self.device)
        masks = self.participation_masks(key, round_index)
        r = (self._round_index_arg(round_index)
             if self.fault_model is not None else None)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        new_states: List[torch.Tensor] = []
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            old = states[bi]
            out = deltas[wi:wi + b.num_clients]
            new = client_pass(w, bi, b, old, threefry.fold_in(key, wi), out,
                              *ctx)
            if r is not None:
                self._faulted(out, r, bi,
                              masks[bi] if masks is not None else None)
            if masks is not None:
                sel = masks[bi].reshape((b.num_clients,)
                                        + (1,) * (new.dim() - 1))
                new = torch.where(sel > 0, new, old)
            new_states.append(new)
        return self.aggregate(w, deltas, masks), new_states

    def reference(self, client_pass: ClientPassFn, *,
                  prelude: Optional[Callable] = None) -> Callable:
        """``round(w, key, round_index=None) -> w_next``: the prelude's
        results are appended to the client pass's arguments."""

        def reference_round(w: torch.Tensor, key: threefry.Key, *,
                            round_index: Optional[int] = None):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            return self.round(w, key, client_pass, *ctx,
                              round_index=round_index)

        return reference_round

    def compile(self, client_pass: ClientPassFn, *,
                prelude: Optional[Callable] = None) -> Callable:
        """The round solvers dispatch.  For now the same eager round as
        :meth:`reference`; capturing it in a CUDA graph is later work."""
        return self.reference(client_pass, prelude=prelude)

    def reference_with_state(self, client_pass: StateClientPassFn, *,
                             prelude: Optional[Callable] = None) -> Callable:
        """``round(w, states, key, round_index=None) -> (w_next,
        new_states)`` over
        :meth:`round_with_state`, the prelude's results appended to the
        client pass's arguments as in :meth:`reference`."""

        def reference_round(w: torch.Tensor, states, key: threefry.Key, *,
                            round_index: Optional[int] = None):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            w2, new_states = self.round_with_state(
                w, list(states), key, client_pass, *ctx,
                round_index=round_index)
            return w2, tuple(new_states)

        return reference_round

    def compile_with_state(self, client_pass: StateClientPassFn, *,
                           prelude: Optional[Callable] = None) -> Callable:
        """The state round solvers dispatch: for now the same eager round
        as :meth:`reference_with_state`, as :meth:`compile` is."""
        return self.reference_with_state(client_pass, prelude=prelude)
