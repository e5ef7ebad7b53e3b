"""Participation models — the engine's sampling step as a pluggable draw,
ported from the reference's ``fleet/participation.py``.

Contract (:class:`ParticipationModel`):

  * ``masks(key, round_index, offsets, sizes, device)`` returns the round's
    per-bucket float {0,1} mask list on ``device`` (1.0 = this client's
    delta enters the aggregate), or ``None`` for full participation.
    ``key`` is the round's threefry key (the one the client passes draw
    from), ``round_index`` the absolute round, ``offsets``/``sizes``
    the engine's per-bucket first client index and client count — a
    client's *global* id is ``offset + position``, which is what trace
    draws fold in;
  * ``mask_components(...)`` splits the draw into ``(available,
    returned)`` lists for telemetry, without a second source of
    randomness;
  * ``needs_round_index`` declares the model round-dependent: the engine
    then refuses mask requests that do not carry the round.

The Bernoulli model draws from the round's threefry key through the
reference's chain, ``uniform(fold_in(fold_in(key, wi), 997), (Kb,))``, as
``RoundEngine.participation_masks`` does: it is bit-identical to the
engine's own draw and to the reference's.  The trace and fixed models
ignore the key: the fleet's state is a pure function of
``(trace.seed, r)`` and matches the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.fleet.traces import FleetTrace, fleet_masks
from repro_torch.utils import threefry

MaskList = List[torch.Tensor]


class ParticipationModel:
    """Protocol base — subclasses override :meth:`masks` (and
    :meth:`mask_components` when "sampled" and "returned" differ)."""

    #: round-dependent models set this so the engine rejects round-less
    #: mask requests instead of silently drawing round 0
    needs_round_index: bool = False

    def masks(self, key: threefry.Key, round_index: int,
              offsets: Sequence[int], sizes: Sequence[int],
              device: torch.device) -> Optional[MaskList]:
        raise NotImplementedError

    def mask_components(self, key: threefry.Key, round_index: int,
                        offsets: Sequence[int], sizes: Sequence[int],
                        device: torch.device
                        ) -> Optional[Tuple[MaskList, MaskList]]:
        """(available, returned) mask lists — identical for models
        without stragglers, where every sampled client reports."""
        m = self.masks(key, round_index, offsets, sizes, device)
        return None if m is None else (m, m)


@dataclasses.dataclass(frozen=True)
class BernoulliParticipation(ParticipationModel):
    """The engine's i.i.d. draw as a model: bucket ``wi``'s mask is
    ``uniform(fold_in(fold_in(key, wi), 997), (Kb,)) < participation`` —
    bit-identical to ``RoundEngine.participation_masks`` without a model
    and to the reference's draw."""

    participation: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")

    def masks(self, key, round_index, offsets, sizes, device):
        if self.participation >= 1.0:
            return None
        key = threefry.as_key(key, device)
        return [(threefry.uniform(threefry.fold_in(threefry.fold_in(key, wi),
                                                   997), (kb,))
                 < self.participation).to(torch.float32)
                for wi, kb in zip(offsets, sizes)]


@dataclasses.dataclass(frozen=True)
class TraceParticipation(ParticipationModel):
    """Trace-driven availability + stragglers.

    The mask handed to the engine is the trace's ``returned`` mask
    (available AND reported): a straggler's delta is zeroed and its dual
    state frozen, exactly like a never-sampled client.  The draw ignores
    ``key``: the fleet is a pure function of ``(trace.seed, r)``,
    independent of the solver seed.  All buckets are drawn in one pass
    over the global ids and then split, which gives the same bits as a
    draw per bucket.
    """

    trace: FleetTrace = dataclasses.field(default_factory=FleetTrace)
    needs_round_index = True

    def _split(self, fm_field: torch.Tensor,
               sizes: Sequence[int]) -> MaskList:
        return list(torch.split(fm_field, list(sizes)))

    def _draw(self, round_index, offsets, sizes, device):
        ids = torch.cat([torch.arange(wi, wi + kb, dtype=torch.int64,
                                      device=device)
                         for wi, kb in zip(offsets, sizes)])
        return fleet_masks(self.trace, round_index, ids)

    def masks(self, key, round_index, offsets, sizes, device):
        return self._split(self._draw(round_index, offsets, sizes,
                                      device).returned, sizes)

    def mask_components(self, key, round_index, offsets, sizes, device):
        fm = self._draw(round_index, offsets, sizes, device)
        return self._split(fm.available, sizes), self._split(fm.returned,
                                                             sizes)


@dataclasses.dataclass(frozen=True)
class FixedParticipation(ParticipationModel):
    """Replay a fixed mask list every round — the tests' tool for proving
    mask-consumer identities (e.g. "a straggler behaves exactly like a
    never-sampled client")."""

    fixed: Tuple[torch.Tensor, ...]

    def masks(self, key, round_index, offsets, sizes, device):
        if len(self.fixed) != len(sizes):
            raise ValueError("fixed mask list does not match bucket count")
        return [m.to(device) for m in self.fixed]
