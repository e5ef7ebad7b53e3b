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

Algorithms with per-client state across rounds (CoCoA+'s dual blocks) use
:meth:`RoundEngine.round_with_state`: each bucket's pass also receives and
returns its bucket's state, and under partial participation a client left
out of the round keeps its old state.

Randomness: the round's ``torch.Generator`` is drawn from in a fixed order
— first the participation masks of every bucket (once per round, shared by
every consumer), then whatever the client passes draw, bucket by bucket.

Not ported yet: streamed (``client_chunk``), cohort and virtual rounds,
participation and fault models, and aggregator guards.  ``compile`` and
``compile_with_state`` are the same eager rounds as ``reference`` and
``reference_with_state`` for now.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.problem import FederatedLogReg
from repro_torch.kernels import ops

#: client_pass(w, bucket_index, bucket, gen, out, *ctx) writes the bucket's
#: (Kb, d) deltas w_k − w into ``out``
ClientPassFn = Callable[..., None]

#: state_pass(w, bucket_index, bucket, state, gen, out, *ctx) writes the
#: bucket's deltas into ``out`` and returns its new state, a new tensor
#: whose leading axis is the bucket's client axis (CoCoA+'s α, (Kb, m_pad));
#: the old state is left as it was
StateClientPassFn = Callable[..., torch.Tensor]

_WEIGHTINGS = ("nk", "uniform", "sum")
_SCALINGS = ("none", "diag")
_AGGREGATORS = ("dense", "pallas")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Round-scheduling knobs shared by every federated algorithm."""

    participation: float = 1.0     # i.i.d. per-round client participation prob
    weighting: str = "nk"          # "nk" (n_k/n) | "uniform" (1/K) | "sum" (1)
    server_scaling: str = "none"   # "none" | "diag" (apply a_diag coordinatewise)
    aggregator: str = "dense"      # "dense" | "pallas" (fused_aggregate kernel)

    def __post_init__(self):
        if self.weighting not in _WEIGHTINGS:
            raise ValueError(f"weighting must be one of {_WEIGHTINGS}")
        if self.server_scaling not in _SCALINGS:
            raise ValueError(f"server_scaling must be one of {_SCALINGS}")
        if self.aggregator not in _AGGREGATORS:
            raise ValueError(f"aggregator must be one of {_AGGREGATORS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")


class RoundEngine:
    """Owns client sampling, the per-bucket client passes and server
    aggregation.  Algorithms provide a :data:`ClientPassFn`."""

    def __init__(self, problem: FederatedLogReg,
                 cfg: EngineConfig = EngineConfig(), *,
                 a_diag: Optional[torch.Tensor] = None):
        self.problem = problem
        self.cfg = cfg
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

    # -- step 3: sampling & weighting ------------------------------------- #

    def bucket_weights(self, wi: int, num_clients: int) -> torch.Tensor:
        """Aggregation weights for the bucket whose first client is ``wi``."""
        if self.cfg.weighting == "uniform":
            return torch.full((num_clients,), 1.0 / self.problem.num_clients,
                              device=self.device)
        if self.cfg.weighting == "sum":
            return torch.ones((num_clients,), device=self.device)
        return self.problem.client_weights[wi:wi + num_clients]

    def participation_masks(self, gen: torch.Generator
                            ) -> Optional[List[torch.Tensor]]:
        """The round's per-bucket Bernoulli(participation) masks (1.0 = in
        the round), drawn once from the round's generator; ``None`` under
        full participation."""
        if self.cfg.participation >= 1.0:
            return None
        return [(torch.rand((b.num_clients,), generator=gen,
                            device=self.device)
                 < self.cfg.participation).to(torch.float32)
                for b in self.problem.buckets]

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
        participation)."""
        cfg = self.cfg
        if masks is None and cfg.participation < 1.0:
            raise ValueError("partial participation needs the round's masks")
        reweight = masks is not None and cfg.weighting != "sum"
        agg = torch.zeros_like(w)
        wts_all: List[torch.Tensor] = []
        total_mass = torch.zeros((), device=self.device)
        expected_mass = torch.zeros((), device=self.device)
        for i, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            wts = self.bucket_weights(wi, b.num_clients)
            if masks is not None:
                sel = masks[i]
                if reweight:
                    total_mass = total_mass + (wts * sel).sum()
                    expected_mass = expected_mass + wts.sum()
                wts = wts * sel
            if cfg.aggregator == "pallas":
                wts_all.append(wts)
            else:
                agg = agg + (wts[:, None]
                             * deltas[wi:wi + b.num_clients]).sum(dim=0)
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

    def round(self, w: torch.Tensor, gen: torch.Generator,
              client_pass: ClientPassFn, *ctx) -> torch.Tensor:
        """Draw the masks, run every bucket's client pass into the stacked
        delta buffer, then aggregate."""
        masks = self.participation_masks(gen)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            client_pass(w, bi, b, gen, deltas[wi:wi + b.num_clients], *ctx)
        return self.aggregate(w, deltas, masks)

    def round_with_state(self, w: torch.Tensor,
                         states: Sequence[torch.Tensor], gen: torch.Generator,
                         client_pass: StateClientPassFn, *ctx
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """:meth:`round` for algorithms with per-client state: bucket i's
        pass receives ``states[i]`` and returns its new state.

        The round's masks are drawn once and serve both consumers: a client
        whose aggregation weight they zero also keeps its old state, bit
        for bit, so primal and dual views never diverge."""
        masks = self.participation_masks(gen)
        deltas = torch.empty((self.problem.num_clients, self.problem.d),
                             dtype=w.dtype, device=w.device)
        new_states: List[torch.Tensor] = []
        for bi, (wi, b) in enumerate(zip(self._offsets, self.problem.buckets)):
            old = states[bi]
            new = client_pass(w, bi, b, old, gen,
                              deltas[wi:wi + b.num_clients], *ctx)
            if masks is not None:
                sel = masks[bi].reshape((b.num_clients,)
                                        + (1,) * (new.dim() - 1))
                new = torch.where(sel > 0, new, old)
            new_states.append(new)
        return self.aggregate(w, deltas, masks), new_states

    def reference(self, client_pass: ClientPassFn, *,
                  prelude: Optional[Callable] = None) -> Callable:
        """``round(w, gen) -> w_next``: the prelude's results are appended
        to the client pass's arguments."""

        def reference_round(w: torch.Tensor, gen: torch.Generator):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            return self.round(w, gen, client_pass, *ctx)

        return reference_round

    def compile(self, client_pass: ClientPassFn, *,
                prelude: Optional[Callable] = None) -> Callable:
        """The round solvers dispatch.  For now the same eager round as
        :meth:`reference`; capturing it in a CUDA graph is later work."""
        return self.reference(client_pass, prelude=prelude)

    def reference_with_state(self, client_pass: StateClientPassFn, *,
                             prelude: Optional[Callable] = None) -> Callable:
        """``round(w, states, gen) -> (w_next, new_states)`` over
        :meth:`round_with_state`, the prelude's results appended to the
        client pass's arguments as in :meth:`reference`."""

        def reference_round(w: torch.Tensor, states, gen: torch.Generator):
            ctx = tuple(prelude(w)) if prelude is not None else ()
            w2, new_states = self.round_with_state(w, list(states), gen,
                                                   client_pass, *ctx)
            return w2, tuple(new_states)

        return reference_round

    def compile_with_state(self, client_pass: StateClientPassFn, *,
                           prelude: Optional[Callable] = None) -> Callable:
        """The state round solvers dispatch: for now the same eager round
        as :meth:`reference_with_state`, as :meth:`compile` is."""
        return self.reference_with_state(client_pass, prelude=prelude)
