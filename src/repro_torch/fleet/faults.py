"""Deterministic delta-corruption faults — what misbehaving clients send —
ported from the reference's ``fleet/faults.py``.

A :class:`FaultModel` corrupts the per-client deltas after the client pass
and before aggregation: the wire, not the client.  A faulted client's own
state (CoCoA+'s dual block) is whatever its honest pass computed.

Every draw is a pure function of ``(seed, round_index, client_id)`` on the
model's own threefry chain (:mod:`repro_torch.utils.threefry`, JAX's
bits), folding in the *global* client id: the same clients are corrupted
identically in the port and in the reference, on any batch shape.

:class:`DeltaFaults` draws **one** uniform per (round, client) and
partitions it into disjoint intervals, so each kind's rate is exact and at
most one fault hits a client per round:

  ====  ============  ====================================================
  kind  knob          corruption of the returned delta δ
  ====  ============  ====================================================
  1     nan_rate      NaN / +Inf / −Inf poisoning (every coordinate)
  2     sign_rate     sign flip: δ ← −δ
  3     scale_rate    gradient-scaling attack: δ ← scale_factor · δ
  4     replay_rate   stale-delta replay: δ ← v_k(⌊r / replay_window⌋)
  ====  ============  ====================================================

``v_k(window)`` is a per-(client, window) uniform vector in
[−replay_scale, replay_scale]^d.  The reference draws it for every client
and then selects; the port draws only the rows whose kind is replay — the
same bits, since each row is a pure function of (window, client id).

Faults only fire for rounds in ``[start_round, stop_round)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.fleet.traces import _per_client_uniform
from repro_torch.utils import threefry

# tags folded off PRNGKey(seed) — one sub-chain per draw family
_KIND_TAG = 0     # per-(r, k) fault-kind selector uniform
_POISON_TAG = 1   # per-(r, k) NaN / +Inf / -Inf selector
_REPLAY_TAG = 2   # per-(window, k) replayed pseudo-delta

#: fault-kind codes returned by :meth:`FaultModel.kinds`
KIND_NONE, KIND_POISON, KIND_SIGN, KIND_SCALE, KIND_REPLAY = 0, 1, 2, 3, 4


class FaultModel:
    """Protocol base — subclasses override :meth:`kinds` and :meth:`apply`.

    ``kinds(round_index, client_ids)`` returns an int32 fault-kind vector
    (0 = honest) as a pure function of ``(seed, round_index, global id)``;
    ``apply(deltas, round_index, client_ids)`` returns the corrupted
    (K, d) delta block as a new tensor.
    """

    #: fault draws are a function of the round by contract; the engine
    #: rejects round-less calls instead of silently faulting round 0
    needs_round_index: bool = True

    def kinds(self, round_index: int,
              client_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, deltas: torch.Tensor, round_index: int,
              client_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DeltaFaults(FaultModel):
    """The standard fault mix — see the module docstring for the kinds."""

    seed: int = 0
    nan_rate: float = 0.0      # NaN/Inf poisoning
    sign_rate: float = 0.0     # sign-flip
    scale_rate: float = 0.0    # gradient-scaling attack
    scale_factor: float = 100.0
    replay_rate: float = 0.0   # stale-delta replay
    replay_window: int = 5     # rounds a replayed delta stays cached
    replay_scale: float = 1.0  # magnitude of the replayed pseudo-delta
    start_round: int = 0       # faults fire for start_round <= r ...
    stop_round: Optional[int] = None   # ... < stop_round (None = forever)

    def __post_init__(self):
        for name in ("nan_rate", "sign_rate", "scale_rate", "replay_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")
        if (self.nan_rate + self.sign_rate + self.scale_rate
                + self.replay_rate) > 1.0:
            raise ValueError("fault rates must sum to <= 1 (one uniform is "
                             "partitioned into disjoint kind intervals)")
        if self.replay_window < 1:
            raise ValueError("replay_window must be >= 1")
        if self.stop_round is not None and self.stop_round <= self.start_round:
            raise ValueError("stop_round must be > start_round")

    #: CLI spec knob -> field (the reference's ``--faults`` and
    #: ``--fault-model`` spec)
    _SPEC_KEYS = {
        "nan": "nan_rate", "sign": "sign_rate", "scale": "scale_rate",
        "replay": "replay_rate", "scale-factor": "scale_factor",
        "window": "replay_window", "start": "start_round",
        "stop": "stop_round", "seed": "seed",
    }
    _INT_FIELDS = ("seed", "replay_window", "start_round", "stop_round")

    @classmethod
    def from_spec(cls, spec: str) -> "DeltaFaults":
        """Parse a ``'nan=0.01,sign=0.05,start=10,stop=12'`` CLI spec."""
        kw = {}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            if k not in cls._SPEC_KEYS:
                raise ValueError(f"unknown fault knob {k!r} "
                                 f"(known: {sorted(cls._SPEC_KEYS)})")
            field = cls._SPEC_KEYS[k]
            kw[field] = int(v) if field in cls._INT_FIELDS else float(v)
        return cls(**kw)

    def total_rate(self) -> float:
        return (self.nan_rate + self.sign_rate + self.scale_rate
                + self.replay_rate)

    def _key(self) -> threefry.Key:
        return threefry.PRNGKey(self.seed)

    def _active(self, r: int) -> bool:
        return r >= self.start_round and (self.stop_round is None
                                          or r < self.stop_round)

    def _chain(self, tag: int, data: int) -> threefry.Key:
        return threefry.fold_in(threefry.fold_in(self._key(), tag), data)

    def edges(self) -> torch.Tensor:
        """The kind intervals' upper edges: the rates' running sum, added
        in f32 one at a time as XLA's cumsum adds them (torch's CPU cumsum
        accumulates in f64 and can round the last edge differently)."""
        acc = torch.zeros((), dtype=torch.float32)
        out = []
        for rate in (self.nan_rate, self.sign_rate, self.scale_rate,
                     self.replay_rate):
            acc = acc + torch.tensor(rate, dtype=torch.float32)
            out.append(acc)
        return torch.stack(out)

    def kinds(self, round_index, client_ids):
        """int32 fault kind per client for this round (0 = honest) — one
        uniform per (r, k), partitioned into disjoint rate intervals."""
        r = int(round_index)
        if self.total_rate() <= 0.0 or not self._active(r):
            return torch.zeros(client_ids.shape, dtype=torch.int32,
                               device=client_ids.device)
        u = _per_client_uniform(self._chain(_KIND_TAG, r), client_ids)
        edges = self.edges().to(u.device)
        kind = torch.full(u.shape, KIND_NONE, dtype=torch.int32,
                          device=u.device)
        # from the last interval to the first, so the lowest edge wins
        for code, edge in ((KIND_REPLAY, edges[3]), (KIND_SCALE, edges[2]),
                           (KIND_SIGN, edges[1]), (KIND_POISON, edges[0])):
            kind = torch.where(u < edge, torch.full_like(kind, code), kind)
        return kind

    def _poison_values(self, r: int, client_ids: torch.Tensor
                       ) -> torch.Tensor:
        """Per-client poison payload: NaN, +Inf or −Inf (uniform thirds)."""
        u = _per_client_uniform(self._chain(_POISON_TAG, r), client_ids)
        third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=u.device)
        two_thirds = torch.tensor(2.0 / 3.0, dtype=torch.float32,
                                  device=u.device)
        inf = torch.full_like(u, float("inf"))
        return torch.where(u < third, torch.full_like(u, float("nan")),
                           torch.where(u < two_thirds, inf, -inf))

    def _replay_deltas(self, r: int, client_ids: torch.Tensor,
                       d: int) -> torch.Tensor:
        """v_k(window) for the given clients: per-(client, window) uniform
        in [−replay_scale, replay_scale]^d, constant across the window."""
        key = self._chain(_REPLAY_TAG, r // self.replay_window)
        return threefry.uniform(threefry.fold_in(key, client_ids), (d,),
                                -self.replay_scale, self.replay_scale)

    def apply(self, deltas, round_index, client_ids):
        if self.total_rate() <= 0.0:
            return deltas
        r = int(round_index)
        kind = self.kinds(r, client_ids)[:, None]
        out = torch.where(kind == KIND_SIGN, -deltas, deltas)
        factor = torch.tensor(self.scale_factor, dtype=deltas.dtype,
                              device=deltas.device)
        out = torch.where(kind == KIND_SCALE, factor * deltas, out)
        if self.replay_rate > 0.0:
            rows = (kind[:, 0] == KIND_REPLAY).nonzero().flatten()
            if rows.numel():
                if deltas.dtype != torch.float32:
                    raise NotImplementedError(
                        "replay faults draw float32 pseudo-deltas; the "
                        f"deltas are {deltas.dtype}")
                out[rows] = self._replay_deltas(r, client_ids[rows],
                                                deltas.shape[1])
        if self.nan_rate > 0.0:
            out = torch.where(kind == KIND_POISON,
                              self._poison_values(r, client_ids)[:, None]
                              .to(deltas.dtype), out)
        return out


def fault_counts(model: Optional[FaultModel], round_index,
                 client_ids: torch.Tensor, returned_mask: torch.Tensor
                 ) -> Tuple[int, int]:
    """(faults_injected, poisoned) over the *returned* clients: a client
    that never reports cannot deliver a corrupted delta.  ``poisoned``
    counts the non-finite kind: exactly the deltas a non-finite-rejecting
    guard discards."""
    if model is None:
        return 0, 0
    kind = model.kinds(round_index, client_ids)
    live = returned_mask > 0
    injected = int((live & (kind != KIND_NONE)).sum())
    poisoned = int((live & (kind == KIND_POISON)).sum())
    return injected, poisoned
