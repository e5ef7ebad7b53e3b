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

The scale paths (the reference's, for every solver that has them) run
over a *keyed chunk pass* ``chunk_pass(w, bi, chunk_bucket, keys, out,
*ctx)``, which receives a slice of a bucket and its clients' own keys —
the matching entries of the whole bucket's ``split(kb, Kb)``, never a new
split over the slice — so every client draws what it draws on the plain
round, and per-client deltas are bit-equal:

  * **streamed** (``client_chunk``, :meth:`RoundEngine.round_streamed`):
    each bucket's clients run ``client_chunk`` at a time, the last chunk
    padded with zero-weight, n_k = 0 clients, and the weighted delta sum
    accumulates chunk by chunk (``fused_accumulate`` under
    ``aggregator="pallas"``), so one (chunk, d) delta block is live, not
    the (K, d) stack; the round ends with one ``fused_epilogue``;
  * **cohort** (``cohort``, :meth:`RoundEngine.round_cohort`): under
    partial participation each bucket gathers only its participants (at
    most ``cap = min(cohort, Kb, cohort_capacity(p, Kb))``, in index
    order, padded to ``cap``), runs their passes and scatters their state
    back; a draw above ``cap`` falls back to the masked bucket, except
    under an order-statistic guard, which drops the participants beyond
    ``cap`` and takes the statistic over the gathered stacks;
  * **virtual** (``virtual_data``, :meth:`RoundEngine.round_virtual`):
    the problem has no rows (:func:`~repro_torch.core.problem.
    build_virtual_problem`), and every path regenerates the rows it is
    about to consume — a chunk, a gathered cohort or one bucket.

Streamed and cohort iterates match the plain round's to float tolerance
(the summation order differs).  ``compile`` dispatches as the reference's
does — cohort, then streamed, then virtual, then plain — and is the eager
round: the CUDA-graph capture is later work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.problem import (ClientBucket, FederatedLogReg,
                                      VirtualBucket)
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

#: chunk_pass(w, bucket_index, chunk_bucket, keys, out, *ctx) writes the
#: chunk's (C, d) deltas into ``out``; keys are its C clients' own keys
ChunkClientPassFn = Callable[..., None]

#: state chunk_pass(w, bucket_index, chunk_bucket, state, keys, out, *ctx)
#: also returns the chunk's new state (C, ...)
StateChunkClientPassFn = Callable[..., torch.Tensor]

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
    # None -> each bucket's (Kb, d) delta stack is formed whole.  An int
    # streams the client axis in chunks of this size: one (chunk, d)
    # delta block live, the weighted sum accumulated chunk by chunk
    client_chunk: Optional[int] = None
    # None -> under partial participation every client's pass runs and
    # the draw zeroes the others' weights.  An int caps the computed
    # cohort: each bucket gathers its participants, up to
    # min(cohort, Kb, cohort_capacity(participation, Kb)); a larger draw
    # falls back to the masked bucket
    cohort: Optional[int] = None
    # True -> the problem was built by build_virtual_problem and every
    # round path regenerates the rows it consumes
    virtual_data: bool = False
    # the server's defence against corrupted deltas: None | "clip" (reject
    # non-finite deltas, optionally cap norms at guard_clip_norm) |
    # "trimmed_mean" | "median" (coordinate-wise order statistics over the
    # returned, all-finite deltas; robust_aggregate kernel — they need the
    # delta stacks, so not with client_chunk or virtual_data)
    aggregator_guard: Optional[str] = None
    # L2 norm cap per client delta; requires aggregator_guard="clip"
    guard_clip_norm: Optional[float] = None
    # per-side trim fraction for aggregator_guard="trimmed_mean"
    guard_trim: float = 0.1

    @staticmethod
    def _check_optional_count(value, name: str):
        # bool is a subclass of int: cohort=True must not mean cohort=1
        if value is not None and (
                isinstance(value, bool) or not isinstance(value, int)
                or value < 1):
            raise ValueError(f"{name} must be a positive int or None")

    def __post_init__(self):
        if self.weighting not in _WEIGHTINGS:
            raise ValueError(f"weighting must be one of {_WEIGHTINGS}")
        if self.server_scaling not in _SCALINGS:
            raise ValueError(f"server_scaling must be one of {_SCALINGS}")
        if self.aggregator not in _AGGREGATORS:
            raise ValueError(f"aggregator must be one of {_AGGREGATORS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        self._check_optional_count(self.client_chunk, "client_chunk")
        self._check_optional_count(self.cohort, "cohort")
        if not isinstance(self.virtual_data, bool):
            raise ValueError("virtual_data must be a bool")
        if (self.aggregator_guard is not None
                and self.aggregator_guard not in _GUARDS):
            raise ValueError(f"aggregator_guard must be one of {_GUARDS} "
                             "or None")
        if self.aggregator_guard in _ORDER_STAT_GUARDS:
            if self.client_chunk is not None:
                raise ValueError(
                    f"aggregator_guard='{self.aggregator_guard}' needs the "
                    "materialized (K, d) delta stacks; the streamed path "
                    "(client_chunk) only ever holds one chunk and a running "
                    "sum, and order statistics cannot be folded "
                    "chunk-by-chunk — use the plain or cohort path, or "
                    "aggregator_guard='clip'")
            if self.virtual_data:
                raise ValueError(
                    f"aggregator_guard='{self.aggregator_guard}' is not "
                    "available with virtual_data (virtual rounds never "
                    "materialize the full delta stacks) — use "
                    "aggregator_guard='clip'")
            if self.weighting == "sum":
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


def cohort_capacity(participation: float, num_clients: int, *,
                    z: float = 6.0) -> int:
    """The static per-bucket cohort capacity for ``EngineConfig.cohort``
    (a copy of the reference's): the draw is Binomial(Kb, participation),
    and mean + z·σ (+1) covers it but with odds of about 1e-9 at z = 6.
    Pass the largest bucket's client count; each bucket sizes its own
    gather to ``min(cohort, Kb, cohort_capacity(participation, Kb))``."""
    if not 0.0 < participation <= 1.0:
        raise ValueError("participation must be in (0, 1]")
    if num_clients < 1:
        raise ValueError("num_clients must be >= 1")
    mean = participation * num_clients
    sd = math.sqrt(participation * (1.0 - participation) * num_clients)
    return max(1, min(num_clients, int(math.ceil(mean + z * sd)) + 1))


def _pad_clients(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero rows appended along the client axis."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _pad_keys(keys: threefry.Key, pad: int, first: threefry.Key
              ) -> threefry.Key:
    """Per-client keys with ``pad`` copies of the key ``first`` appended
    (a pad client's key is never used in a way that matters)."""
    if pad == 0:
        return keys
    return tuple(torch.cat([k, f.reshape(1).expand(pad)])
                 for k, f in zip(keys, first))


def _take_keys(keys: threefry.Key, rows) -> threefry.Key:
    return tuple(k[rows] for k in keys)


class RoundEngine:
    """Owns client sampling, the per-bucket client passes and server
    aggregation.  Algorithms provide a :data:`ClientPassFn` and, for the
    scale paths, a :data:`ChunkClientPassFn`."""

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
        layout = getattr(problem, "virtual", None)
        if cfg.virtual_data and layout is None:
            raise ValueError(
                "virtual_data=True requires a problem built by "
                "build_virtual_problem (problem.virtual is the layout)")
        if layout is not None and not cfg.virtual_data:
            raise ValueError(
                "the problem carries a virtual layout (no materialized "
                "rows); set EngineConfig(virtual_data=True) to run rounds "
                "on it")
        self._virtual = layout if cfg.virtual_data else None
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

    def _fault_round(self, round_index: Optional[int]) -> Optional[int]:
        """The round fault draws are a function of; None without a fault
        model."""
        if self.fault_model is None:
            return None
        return self._round_index_arg(round_index)

    def _realize(self, bucket):
        """A virtual bucket's rows, regenerated; a materialized bucket as
        it is."""
        if self._virtual is not None and isinstance(bucket, VirtualBucket):
            return self._virtual.realize(bucket)
        return bucket

    # -- fault injection & guards ------------------------------------------ #

    def _bucket_ids(self, bi: int) -> torch.Tensor:
        """Global client ids of bucket ``bi`` — the identity fault and
        trace draws fold in."""
        wi = self._offsets[bi]
        return torch.arange(wi, wi + self._sizes[bi], dtype=torch.int64,
                            device=self.device)

    def _faulted(self, deltas: torch.Tensor, r: int, ids: torch.Tensor,
                 live: Optional[torch.Tensor]) -> None:
        """Corrupt, in place, the *returned* clients' deltas through the
        fault model; ``ids`` are their global ids (a bucket's, a chunk's or
        a gathered cohort's), so every path corrupts the same clients the
        same way.  A client left out of the round (``live`` 0: weight,
        mask or validity) keeps its honest delta: a NaN on a zero-weight
        row would still poison the weighted sum (0·NaN = NaN), so the rows
        are selected, not cancelled by their weight."""
        bad = self.fault_model.apply(deltas, r, ids)
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
        """The order-statistic server update over the stacked deltas:
        rows that are not returned, or carry any non-finite coordinate,
        are left out, and the coordinate-wise trimmed mean or median of
        the rest updates the iterate."""
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

    def client_keys(self, bucket_key: threefry.Key, num_clients: int, *,
                    start: int = 0) -> threefry.Key:
        """The bucket's per-client keys, ``split(kb, Kb)``, on the engine's
        device: client k's key is ``threefry.take(keys, k)``.  With
        ``start``, the keys of clients ``[start, start + num_clients)`` —
        the same entries of the whole bucket's split (key k of a split is
        ``fold_in(kb, k)``), drawn without the rest."""
        kb = threefry.as_key(bucket_key, self.device)
        if start == 0:
            return threefry.split(kb, num_clients)
        return self.gathered_keys(kb, torch.arange(
            start, start + num_clients, device=self.device))

    def gathered_keys(self, bucket_key: threefry.Key,
                      rows: torch.Tensor) -> threefry.Key:
        """The keys of the bucket's clients at positions ``rows``: entries
        ``rows`` of ``split(kb, Kb)``."""
        return threefry.fold_in(threefry.as_key(bucket_key, self.device),
                                rows)

    @staticmethod
    def _reweight_scale(total_mass, expected_mass):
        """The unbiased-participation reweight scalar."""
        return expected_mass / total_mass.clamp(min=1e-9)

    def _finish(self, w: torch.Tensor, acc: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
        """w + A ⊙ (s · acc) over the round's accumulated weighted sum:
        one ``fused_epilogue`` under ``aggregator="pallas"``."""
        diag = self.cfg.server_scaling == "diag"
        if self.cfg.aggregator == "pallas":
            a = self.a_diag if diag else torch.ones_like(w)
            return ops.fused_epilogue(
                w, acc, a, 1.0 if scale is None else scale).to(w.dtype)
        if scale is not None:
            acc = acc * scale
        return w + (self.a_diag if diag else 1.0) * acc

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
        r = self._fault_round(round_index)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            out = deltas[wi:wi + b.num_clients]
            client_pass(w, bi, b, threefry.fold_in(key, wi), out, *ctx)
            if r is not None:
                self._faulted(out, r, self._bucket_ids(bi),
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
        r = self._fault_round(round_index)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        new_states: List[torch.Tensor] = []
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            old = states[bi]
            out = deltas[wi:wi + b.num_clients]
            new = client_pass(w, bi, b, old, threefry.fold_in(key, wi), out,
                              *ctx)
            if r is not None:
                self._faulted(out, r, self._bucket_ids(bi),
                              masks[bi] if masks is not None else None)
            if masks is not None:
                new = self._freeze(new, old, masks[bi])
            new_states.append(new)
        return self.aggregate(w, deltas, masks), new_states

    @staticmethod
    def _freeze(new: torch.Tensor, old: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
        """The new state where ``sel`` is 1, the old one, bit for bit,
        where it is 0."""
        keep = sel.reshape((sel.shape[0],) + (1,) * (new.dim() - 1)) > 0
        return torch.where(keep, new, old)

    # -- the streamed round: one (chunk, d) delta block live ---------------- #

    def _accumulate(self, acc: torch.Tensor, deltas: torch.Tensor,
                    wts: torch.Tensor) -> torch.Tensor:
        """acc + Σ_k wts_k δ_k: ``fused_accumulate`` under
        ``aggregator="pallas"``, the plain weighted sum otherwise."""
        if self.cfg.aggregator == "pallas":
            return ops.fused_accumulate(acc, deltas, wts).to(acc.dtype)
        return acc + (wts[:, None] * deltas).sum(dim=0)

    def _stream_bucket(self, w, bi: int, bucket, kb, wts, chunk_pass, ctx,
                       *, state_b=None, sel=None, keys=None, ids=None,
                       r=None):
        """One bucket's weighted delta sum, a (d,) vector, with its clients
        run ``client_chunk`` at a time, and — for state passes — the
        bucket's new state.

        The last chunk is padded to the chunk size with zero-weight,
        n_k = 0 clients (their rows are padding, their key is the
        bucket's first, their id 0, their state zeros), so every chunk
        has one shape; one (chunk, d) delta buffer is reused chunk after
        chunk.  ``keys`` are the bucket's per-client keys when they are
        not the bucket's own split (a gathered cohort's); by default each
        chunk draws its slice of ``split(kb, Kb)``.  A virtual bucket's
        chunk rows are regenerated right before its pass."""
        Kb = bucket.num_clients
        chunk = min(self.cfg.client_chunk, Kb)
        virtual = (self._virtual is not None
                   and isinstance(bucket, VirtualBucket))
        if keys is None:
            first = self.client_keys(kb, 1)
        else:
            first = _take_keys(keys, slice(0, 1))
        out = torch.empty((chunk, w.shape[0]), dtype=w.dtype,
                          device=w.device)
        acc = torch.zeros_like(w)
        new_state = None if state_b is None else state_b.clone()
        for c0 in range(0, Kb, chunk):
            c1 = min(c0 + chunk, Kb)
            pad = chunk - (c1 - c0)

            def part(x):
                return _pad_clients(x[c0:c1], pad)

            if virtual:
                cb = self._virtual.materialize(part(bucket.client_ids),
                                               part(bucket.n_k),
                                               bucket.m_pad)
            else:
                cb = ClientBucket(part(bucket.idx), part(bucket.val),
                                  part(bucket.y), part(bucket.n_k))
            ck = (self.client_keys(kb, c1 - c0, start=c0) if keys is None
                  else _take_keys(keys, slice(c0, c1)))
            ck = _pad_keys(ck, pad, first)
            wts_c = part(wts)
            if state_b is None:
                chunk_pass(w, bi, cb, ck, out, *ctx)
            else:
                old = part(state_b)
                s_new = chunk_pass(w, bi, cb, old, ck, out, *ctx)
                if sel is not None:
                    s_new = self._freeze(s_new, old, part(sel))
                new_state[c0:c1] = s_new[:c1 - c0]
            if r is not None:
                # live = the chunk's (already mask-zeroed) weights: only
                # clients that add to the sum can be faulted
                self._faulted(out, r, part(ids), wts_c)
            acc = self._accumulate(acc, self._guard_clip(out), wts_c)
        return acc, new_state

    def _keyed_pass(self, w, bi: int, bucket, keys, chunk_pass, ctx,
                    state=None):
        """The keyed pass over one whole block of clients (a bucket or a
        gathered cohort, regenerated if virtual): (its (C, d) deltas, its
        new state or None)."""
        cb = self._realize(bucket)
        out = torch.empty((cb.num_clients, w.shape[0]), dtype=w.dtype,
                          device=w.device)
        if state is None:
            chunk_pass(w, bi, cb, keys, out, *ctx)
            return out, None
        return out, chunk_pass(w, bi, cb, state, keys, out, *ctx)

    def _masked_bucket(self, w, bi: int, bucket, kb, wtsz, sel, chunk_pass,
                       ctx, *, state_b=None, keys=None, ids=None, r=None):
        """The masked body over the keyed chunk pass: every client's pass
        runs, zero-weighted non-participants drop out of the sum, and state
        freezes where ``sel`` is 0 — streamed when ``client_chunk`` is set,
        else one block over the (regenerated) bucket.  ``keys`` are the
        clients' keys when they are not the bucket's own split (a gathered
        cohort's).  It is the streamed and virtual rounds' bucket body, and
        the cohort round's body over its gathered bucket and its
        fallback."""
        if self.cfg.client_chunk is not None:
            return self._stream_bucket(w, bi, bucket, kb, wtsz, chunk_pass,
                                       ctx, state_b=state_b, sel=sel,
                                       keys=keys, ids=ids, r=r)
        if keys is None:
            keys = self.client_keys(kb, bucket.num_clients)
        out, s_new = self._keyed_pass(w, bi, bucket, keys, chunk_pass, ctx,
                                      state_b)
        if s_new is not None and sel is not None:
            s_new = self._freeze(s_new, state_b, sel)
        if r is not None:
            self._faulted(out, r, ids, wtsz)
        return (self._accumulate(torch.zeros_like(w), self._guard_clip(out),
                                 wtsz), s_new)

    def _streamed_round(self, w, key, chunk_pass, ctx, states, round_index):
        """The keyed round body of :meth:`round_streamed` and
        :meth:`round_virtual`: the masks, each bucket's weighted sum
        through :meth:`_masked_bucket`, the reweight, one epilogue."""
        key = threefry.as_key(key, self.device)
        masks = self.participation_masks(key, round_index)
        r = self._fault_round(round_index)
        reweight = masks is not None and self.cfg.weighting != "sum"
        acc = torch.zeros_like(w)
        total_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        expected_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        new_states: Optional[List[torch.Tensor]] = (
            [] if states is not None else None)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            wts = self.bucket_weights(wi, b.num_clients, w.dtype)
            sel = masks[bi] if masks is not None else None
            if sel is not None:
                if reweight:
                    total_mass = total_mass + (wts * sel).sum()
                    expected_mass = expected_mass + wts.sum()
                wts = wts * sel
            acc_b, s_b = self._masked_bucket(
                w, bi, b, threefry.fold_in(key, wi), wts, sel, chunk_pass,
                ctx, state_b=states[bi] if states is not None else None,
                ids=self._bucket_ids(bi) if r is not None else None, r=r)
            acc = acc + acc_b
            if new_states is not None:
                new_states.append(s_b)
        scale = (self._reweight_scale(total_mass, expected_mass)
                 if reweight else None)
        return self._finish(w, acc, scale), new_states

    def round_streamed(self, w: torch.Tensor, key: threefry.Key,
                       chunk_pass: ChunkClientPassFn, *ctx,
                       round_index: Optional[int] = None) -> torch.Tensor:
        """:meth:`round` with the client axis streamed in ``client_chunk``
        chunks: the weighted delta sum accumulates chunk by chunk and the
        (K, d) stack is never formed.  The same weighting, participation,
        scaling and per-client keys as :meth:`round`; the iterate agrees
        to float tolerance (summation order)."""
        if self.cfg.client_chunk is None:
            raise ValueError("round_streamed requires cfg.client_chunk")
        return self._streamed_round(w, key, chunk_pass, ctx, None,
                                    round_index)[0]

    def round_streamed_with_state(self, w: torch.Tensor,
                                  states: Sequence[torch.Tensor],
                                  key: threefry.Key,
                                  chunk_pass: StateChunkClientPassFn, *ctx,
                                  round_index: Optional[int] = None
                                  ) -> Tuple[torch.Tensor,
                                             List[torch.Tensor]]:
        """:meth:`round_with_state`, streamed: the pass receives each
        chunk's slice of the state, frozen per chunk by the round's
        masks, and the bucket's new state is put back in client order."""
        if self.cfg.client_chunk is None:
            raise ValueError("round_streamed_with_state requires "
                             "cfg.client_chunk")
        return self._streamed_round(w, key, chunk_pass, ctx, list(states),
                                    round_index)

    # -- the virtual round: rows regenerated as they are consumed ----------- #

    def round_virtual(self, w: torch.Tensor, key: threefry.Key,
                      chunk_pass: ChunkClientPassFn, *ctx,
                      round_index: Optional[int] = None) -> torch.Tensor:
        """:meth:`round` over a virtual problem: each bucket's rows are
        regenerated right before its pass — a chunk at a time when
        ``client_chunk`` is set (O(chunk·m_pad·nnz) rows live whatever K),
        a whole bucket otherwise.  Per-client deltas are bit-equal to the
        materialized problem's (regenerated rows are its rows); iterates
        agree to float tolerance."""
        if not self.cfg.virtual_data:
            raise ValueError("round_virtual requires cfg.virtual_data")
        return self._streamed_round(w, key, chunk_pass, ctx, None,
                                    round_index)[0]

    def round_virtual_with_state(self, w: torch.Tensor,
                                 states: Sequence[torch.Tensor],
                                 key: threefry.Key,
                                 chunk_pass: StateChunkClientPassFn, *ctx,
                                 round_index: Optional[int] = None
                                 ) -> Tuple[torch.Tensor,
                                            List[torch.Tensor]]:
        """:meth:`round_with_state` over a virtual problem; the state
        stays materialized (it is the algorithm's, O(K·m_pad))."""
        if not self.cfg.virtual_data:
            raise ValueError("round_virtual_with_state requires "
                             "cfg.virtual_data")
        return self._streamed_round(w, key, chunk_pass, ctx, list(states),
                                    round_index)

    # -- the cohort round: only the sampled clients' passes ----------------- #

    def _cohort_cap(self, num_clients: int) -> int:
        """The bucket's own gather capacity: ``cfg.cohort`` is a ceiling,
        and a bucket never gathers more than its Binomial draw needs."""
        return min(self.cfg.cohort, num_clients,
                   cohort_capacity(self.cfg.participation, num_clients)
                   if self.cfg.participation < 1.0 else num_clients)

    def _gather(self, bucket, gidx: torch.Tensor, valid: torch.Tensor):
        """The clients at ``gidx`` of a bucket as a bucket of their own;
        slots where ``valid`` is False get n_k = 0 (padding).  A virtual
        bucket gathers identities only — rows are made for the cohort
        alone."""
        n_k = torch.where(valid, bucket.n_k[gidx], 0)
        if self._virtual is not None and isinstance(bucket, VirtualBucket):
            return VirtualBucket(bucket.client_ids[gidx], n_k, bucket.m_pad)
        return ClientBucket(bucket.idx[gidx], bucket.val[gidx],
                            bucket.y[gidx], n_k)

    def _cohort_bucket(self, w, bi: int, bucket, kb, wts, sel, chunk_pass,
                       ctx, *, state_b=None, ids=None, r=None):
        """One bucket's weighted sum with only its participants computed.

        The draw ``sel`` becomes a gather of the first participants in
        index order into a bucket of ``cap`` slots (pad slots: weight 0,
        n_k = 0, the bucket's first client's rows and id), their own keys
        (entries of ``split(kb, Kb)``) and state; after the pass their
        state is put back at their slots, distinct indices only, so every
        other client's state stays as it was, bit for bit.  A draw with
        more than ``cap`` participants takes the masked bucket instead."""
        Kb = bucket.num_clients
        cap = self._cohort_cap(Kb)
        wtsz = wts * sel if sel is not None else wts
        if sel is None or cap >= Kb:
            return self._masked_bucket(w, bi, bucket, kb, wtsz, sel,
                                       chunk_pass, ctx, state_b=state_b,
                                       ids=ids, r=r)
        picked = (sel > 0).nonzero().flatten()
        count = int(picked.shape[0])
        if count > cap:
            return self._masked_bucket(w, bi, bucket, kb, wtsz, sel,
                                       chunk_pass, ctx, state_b=state_b,
                                       ids=ids, r=r)
        gidx = _pad_clients(picked, cap - count)
        valid = torch.arange(cap, device=gidx.device) < count
        acc_b, s_new = self._masked_bucket(
            w, bi, self._gather(bucket, gidx, valid), kb,
            torch.where(valid, wtsz[gidx], 0.0), None, chunk_pass, ctx,
            state_b=None if state_b is None else state_b[gidx],
            keys=self.gathered_keys(kb, gidx),
            ids=ids[gidx] if ids is not None else None, r=r)
        if state_b is None:
            return acc_b, None
        new_state = state_b.clone()
        new_state[picked] = s_new[:count]
        return acc_b, new_state

    def _cohort_round(self, w, key, chunk_pass, ctx, states, round_index):
        """The cohort twin of :meth:`_streamed_round`: the same mass
        reductions over the complete weight and mask vectors (the
        reweighting never sees the gather), each bucket's sum from
        :meth:`_cohort_bucket`."""
        if self._order_stat():
            return self._cohort_round_robust(w, key, chunk_pass, ctx, states,
                                             round_index)
        key = threefry.as_key(key, self.device)
        masks = self.participation_masks(key, round_index)
        r = self._fault_round(round_index)
        reweight = masks is not None and self.cfg.weighting != "sum"
        acc = torch.zeros_like(w)
        total_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        expected_mass = torch.zeros((), dtype=w.dtype, device=self.device)
        new_states: Optional[List[torch.Tensor]] = (
            [] if states is not None else None)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            wts = self.bucket_weights(wi, b.num_clients, w.dtype)
            sel = masks[bi] if masks is not None else None
            if sel is not None and reweight:
                total_mass = total_mass + (wts * sel).sum()
                expected_mass = expected_mass + wts.sum()
            acc_b, s_b = self._cohort_bucket(
                w, bi, b, threefry.fold_in(key, wi), wts, sel, chunk_pass,
                ctx, state_b=states[bi] if states is not None else None,
                ids=self._bucket_ids(bi) if r is not None else None, r=r)
            acc = acc + acc_b
            if new_states is not None:
                new_states.append(s_b)
        scale = (self._reweight_scale(total_mass, expected_mass)
                 if reweight else None)
        return self._finish(w, acc, scale), new_states

    def _cohort_round_robust(self, w, key, chunk_pass, ctx, states,
                             round_index):
        """The cohort body under an order-statistic guard: every bucket
        gives its gathered (cap, d) delta stack and a validity flag a row,
        and one ``robust_aggregate`` takes the statistic over all buckets'
        valid rows — no weights, no reweighting.

        There is no overflow fallback: a draw above ``cap`` drops the
        participants beyond the first ``cap`` (in index order) from the
        round — left out of the statistic, their state frozen — as the
        reference does."""
        key = threefry.as_key(key, self.device)
        masks = self.participation_masks(key, round_index)
        r = self._fault_round(round_index)
        stacks: List[torch.Tensor] = []
        valids: List[torch.Tensor] = []
        new_states: Optional[List[torch.Tensor]] = (
            [] if states is not None else None)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            kb = threefry.fold_in(key, wi)
            Kb = b.num_clients
            sel = masks[bi] if masks is not None else None
            ids = self._bucket_ids(bi) if r is not None else None
            state_b = states[bi] if states is not None else None
            cap = self._cohort_cap(Kb)
            if sel is None or cap >= Kb:
                # the whole bucket's keyed pass and stack
                out, s_new = self._keyed_pass(w, bi, b,
                                              self.client_keys(kb, Kb),
                                              chunk_pass, ctx, state_b)
                if s_new is not None:
                    if sel is not None:
                        s_new = self._freeze(s_new, state_b, sel)
                    new_states.append(s_new)
                if r is not None:
                    self._faulted(out, r, ids, sel)
                stacks.append(out)
                valids.append(sel > 0 if sel is not None else
                              torch.ones((Kb,), dtype=torch.bool,
                                         device=out.device))
                continue
            picked = (sel > 0).nonzero().flatten()[:cap]
            count = int(picked.shape[0])
            gidx = _pad_clients(picked, cap - count)
            valid = torch.arange(cap, device=gidx.device) < count
            out, s_new = self._keyed_pass(
                w, bi, self._gather(b, gidx, valid),
                self.gathered_keys(kb, gidx), chunk_pass, ctx,
                None if state_b is None else state_b[gidx])
            if s_new is not None:
                new_state = state_b.clone()
                new_state[picked] = s_new[:count]
                new_states.append(new_state)
            if r is not None:
                self._faulted(out, r, ids[gidx], valid.to(out.dtype))
            stacks.append(out)
            valids.append(valid)
        w_next = self._robust_apply(w, torch.cat(stacks), torch.cat(valids))
        return w_next, new_states

    def round_cohort(self, w: torch.Tensor, key: threefry.Key,
                     chunk_pass: ChunkClientPassFn, *ctx,
                     round_index: Optional[int] = None) -> torch.Tensor:
        """:meth:`round` computing only the sampled cohort: the same single
        draw, weighting, reweighting, scaling and per-client keys; the
        iterate agrees with the masked round to float tolerance.  At
        participation 1.0 (or cap ≥ Kb) it is the keyed full-bucket
        pass."""
        if self.cfg.cohort is None:
            raise ValueError("round_cohort requires cfg.cohort")
        return self._cohort_round(w, key, chunk_pass, ctx, None,
                                  round_index)[0]

    def round_cohort_with_state(self, w: torch.Tensor,
                                states: Sequence[torch.Tensor],
                                key: threefry.Key,
                                chunk_pass: StateChunkClientPassFn, *ctx,
                                round_index: Optional[int] = None
                                ) -> Tuple[torch.Tensor,
                                           List[torch.Tensor]]:
        """:meth:`round_with_state` computing only the sampled cohort: the
        cohort's state is gathered with it and put back after its pass;
        the other clients' state is not touched, which is the masked
        round's freezing, bit for bit."""
        if self.cfg.cohort is None:
            raise ValueError("round_cohort_with_state requires cfg.cohort")
        return self._cohort_round(w, key, chunk_pass, ctx, list(states),
                                  round_index)

    # -- dispatch ----------------------------------------------------------- #

    def _require_chunk_pass(self, chunk_pass):
        if chunk_pass is None:
            raise ValueError(
                "cfg.client_chunk/cfg.cohort/cfg.virtual_data is set but no "
                "chunk_pass was supplied — streamed, cohort, and virtual "
                "rounds need the per-client-keyed chunk pass "
                "(chunk_pass(w, bi, chunk_bucket, keys, out, *ctx))")
        return chunk_pass

    def _use_cohort(self) -> bool:
        """The gather pays only when the draw drops clients: at
        participation 1.0 ``cohort`` is a no-op, but a participation model
        always counts as partial (``cfg.participation`` is then the
        capacity's rate, not the draw's)."""
        return self.cfg.cohort is not None and (
            self.cfg.participation < 1.0
            or self.participation_model is not None)

    def round_path(self, compiled: bool = True) -> str:
        """The round :meth:`compile` (or, ``compiled=False``,
        :meth:`reference`) runs, in the reference's order: ``"cohort"``,
        ``"streamed"``, ``"virtual"`` (``reference``'s only keyed one) or
        ``"plain"``."""
        if compiled and self._use_cohort():
            return "cohort"
        if compiled and self.cfg.client_chunk is not None:
            return "streamed"
        if self.cfg.virtual_data:
            return "virtual"
        return "plain"

    def pass_rows(self) -> int:
        """The most clients one pass of the compiled round gets: the
        largest bucket on the plain and unchunked virtual rounds, the
        largest gathered cohort on the cohort round, at most a chunk when
        ``client_chunk`` is set.  (The cohort round's rare overflow
        fallback runs a whole bucket.)"""
        rows = max(self._sizes)
        if self.round_path() == "cohort":
            rows = max(self._cohort_cap(k) for k in self._sizes)
        if self.cfg.client_chunk is not None:
            rows = min(rows, self.cfg.client_chunk)
        return rows

    def _dispatch(self, chunk_pass, compiled: bool) -> Optional[str]:
        path = self.round_path(compiled)
        if path == "plain":
            return None
        self._require_chunk_pass(chunk_pass)
        return path

    def _stateless_round(self, client_pass, prelude, chunk_pass,
                         compiled: bool) -> Callable:
        path = self._dispatch(chunk_pass, compiled)
        keyed = {"cohort": self.round_cohort,
                 "streamed": self.round_streamed,
                 "virtual": self.round_virtual}.get(path)

        def one_round(w: torch.Tensor, key: threefry.Key, *,
                      round_index: Optional[int] = None):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            if keyed is None:
                return self.round(w, key, client_pass, *ctx,
                                  round_index=round_index)
            return keyed(w, key, chunk_pass, *ctx, round_index=round_index)

        return one_round

    def _state_round(self, client_pass, prelude, chunk_pass,
                     compiled: bool) -> Callable:
        path = self._dispatch(chunk_pass, compiled)
        keyed = {"cohort": self.round_cohort_with_state,
                 "streamed": self.round_streamed_with_state,
                 "virtual": self.round_virtual_with_state}.get(path)

        def one_round(w: torch.Tensor, states, key: threefry.Key, *,
                      round_index: Optional[int] = None):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            if keyed is None:
                w2, new_states = self.round_with_state(
                    w, list(states), key, client_pass, *ctx,
                    round_index=round_index)
            else:
                w2, new_states = keyed(w, list(states), key, chunk_pass,
                                       *ctx, round_index=round_index)
            return w2, tuple(new_states)

        return one_round

    def reference(self, client_pass: ClientPassFn, *,
                  prelude: Optional[Callable] = None,
                  chunk_pass: Optional[ChunkClientPassFn] = None
                  ) -> Callable:
        """``round(w, key, round_index=None) -> w_next``: the plain
        :meth:`round` (under ``virtual_data`` :meth:`round_virtual`, the
        only round a virtual problem has), the prelude's results appended
        to the pass's arguments."""
        return self._stateless_round(client_pass, prelude, chunk_pass,
                                     compiled=False)

    def compile(self, client_pass: ClientPassFn, *,
                prelude: Optional[Callable] = None,
                chunk_pass: Optional[ChunkClientPassFn] = None
                ) -> Callable:
        """The round solvers dispatch, in the reference's order: the cohort
        round when ``cohort`` is set under partial participation, else the
        streamed round when ``client_chunk`` is set, else the virtual
        round under ``virtual_data``, else the plain round.  For now every
        one is eager; capturing it in a CUDA graph is later work."""
        return self._stateless_round(client_pass, prelude, chunk_pass,
                                     compiled=True)

    def reference_with_state(self, client_pass: StateClientPassFn, *,
                             prelude: Optional[Callable] = None,
                             chunk_pass: Optional[StateChunkClientPassFn]
                             = None) -> Callable:
        """``round(w, states, key, round_index=None) -> (w_next,
        new_states)``: :meth:`reference` for state rounds."""
        return self._state_round(client_pass, prelude, chunk_pass,
                                 compiled=False)

    def compile_with_state(self, client_pass: StateClientPassFn, *,
                           prelude: Optional[Callable] = None,
                           chunk_pass: Optional[StateChunkClientPassFn]
                           = None) -> Callable:
        """The state round solvers dispatch: :meth:`compile`'s order over
        the ``_with_state`` rounds."""
        return self._state_round(client_pass, prelude, chunk_pass,
                                 compiled=True)
