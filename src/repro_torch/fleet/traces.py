"""Deterministic fleet availability traces — who is reachable, round by
round — ported from the reference's ``fleet/traces.py``.

The paper's deployment (§1.2) is a fleet of phones that participate only
when charging and on wi-fi: availability is *diurnal*, *correlated* (a
network event takes a cohort of devices out together) and *unreliable
mid-round* (a sampled device may compute its update and never return it:
a straggler).  All three are pure functions of ``(trace, r, client_ids)``
with no state carried between rounds.

Every draw comes from the trace's own threefry chain
``fold_in(fold_in(PRNGKey(trace.seed), TAG), ...)`` and folds in the
*global* client id, with :mod:`repro_torch.utils.threefry` giving JAX's
bits: a round's masks are the reference's, bit for bit, for any subset of
clients in any batch shape.

The availability rate of client k at round r is

    p_k(r) = clip(base + amplitude · sin(2π(r/period + phase_k)), 0, 1)

with ``phase_k`` a per-client uniform phase; a round-level burst
(probability ``burst_prob``) forces a random ``burst_frac`` of clients to
rate 0.  The availability mask draws one uniform per (r, k) against
p_k(r); stragglers are an independent per-(r, k) Bernoulli
(``straggler_rate``) over the available clients.

Client ids are integer tensors; every result lies on their device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.utils import threefry

# tags folded off PRNGKey(trace.seed) — one sub-chain per draw family
_PHASE_TAG = 0      # per-client diurnal phase (round-invariant)
_AVAIL_TAG = 1      # per-(r, k) availability uniform
_BURST_TAG = 2      # per-round burst indicator
_BURST_HIT_TAG = 3  # per-(r, k) burst membership
_STRAGGLER_TAG = 4  # per-(r, k) straggler indicator


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """A deterministic availability/straggler process for a whole fleet.

    ``seed`` roots the trace's own key chain; ``base``/``amplitude``/
    ``period`` give each client a sinusoidal diurnal rate with its own
    phase; ``burst_prob`` rounds suffer a correlated dropout hitting
    ``burst_frac`` of clients; available clients straggle (compute but
    never report) i.i.d. with ``straggler_rate``.
    """

    seed: int = 0
    base: float = 0.4          # mean availability rate
    amplitude: float = 0.25    # diurnal swing around base
    period: float = 24.0       # rounds per diurnal cycle
    burst_prob: float = 0.05   # P[a round has a correlated dropout burst]
    burst_frac: float = 0.3    # fraction of clients a burst takes out
    straggler_rate: float = 0.02  # P[an available client never reports]

    def __post_init__(self):
        if not 0.0 < self.base <= 1.0:
            raise ValueError("base must be in (0, 1]")
        if self.amplitude < 0.0:
            raise ValueError("amplitude must be >= 0")
        if self.base - self.amplitude <= 0.0:
            raise ValueError("base - amplitude must stay positive, or whole "
                             "diurnal troughs have an empty cohort")
        if self.period <= 0.0:
            raise ValueError("period must be positive")
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError("burst_prob must be in [0, 1]")
        if not 0.0 <= self.burst_frac <= 1.0:
            raise ValueError("burst_frac must be in [0, 1]")
        if not 0.0 <= self.straggler_rate < 1.0:
            raise ValueError("straggler_rate must be in [0, 1)")

    def max_rate(self) -> float:
        """An upper bound on any client's availability rate in any
        round."""
        return min(1.0, self.base + self.amplitude)

    def _key(self) -> threefry.Key:
        return threefry.PRNGKey(self.seed)


class FleetMasks(NamedTuple):
    """One round's fleet state over a set of clients (float {0,1}
    vectors): ``available`` — sampled into the round; ``returned`` —
    available AND not a straggler (the clients whose deltas arrive)."""

    available: torch.Tensor
    returned: torch.Tensor


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _per_client_uniform(key: threefry.Key,
                        client_ids: torch.Tensor) -> torch.Tensor:
    """One uniform per client, folded in by *global* id: any subset, in
    any batch shape, draws the same bits."""
    return threefry.uniform(threefry.fold_in(key, client_ids))


def _chain(trace_key: threefry.Key, tag: int, r: int) -> threefry.Key:
    return threefry.fold_in(threefry.fold_in(trace_key, tag), r)


def availability_rate(trace: FleetTrace, r: int,
                      client_ids: torch.Tensor) -> torch.Tensor:
    """p_k(r) — each client's availability probability this round, after
    the diurnal curve and any round-level burst."""
    r = int(r)
    base_key = trace._key()
    phase = _per_client_uniform(threefry.fold_in(base_key, _PHASE_TAG),
                                client_ids)
    t = _f32(float(r), phase) / _f32(trace.period, phase)
    # 2π is rounded to f32 before the product, as JAX rounds a Python
    # scalar against an f32 array
    rate = (_f32(trace.base, phase) + _f32(trace.amplitude, phase)
            * torch.sin(_f32(2.0 * math.pi, phase) * (t + phase)))
    rate = rate.clamp(0.0, 1.0)
    if trace.burst_prob > 0.0 and trace.burst_frac > 0.0:
        rk = _chain(base_key, _BURST_TAG, r)
        burst = (threefry.uniform(rk, device=phase.device)
                 < _f32(trace.burst_prob, phase))
        hit = (_per_client_uniform(_chain(base_key, _BURST_HIT_TAG, r),
                                   client_ids)
               < _f32(trace.burst_frac, phase))
        rate = torch.where(burst & hit, torch.zeros_like(rate), rate)
    return rate


def availability_mask(trace: FleetTrace, r: int,
                      client_ids: torch.Tensor) -> torch.Tensor:
    """1.0 where client k is sampled into round r."""
    u = _per_client_uniform(_chain(trace._key(), _AVAIL_TAG, int(r)),
                            client_ids)
    return (u < availability_rate(trace, r, client_ids)).to(torch.float32)


def straggler_flags(trace: FleetTrace, r: int,
                    client_ids: torch.Tensor) -> torch.Tensor:
    """1.0 where client k *would* straggle this round if sampled —
    independent of the availability draw (a separate tag chain)."""
    if trace.straggler_rate <= 0.0:
        return torch.zeros(client_ids.shape, dtype=torch.float32,
                           device=client_ids.device)
    u = _per_client_uniform(_chain(trace._key(), _STRAGGLER_TAG, int(r)),
                            client_ids)
    return (u < _f32(trace.straggler_rate, u)).to(torch.float32)


def fleet_masks(trace: FleetTrace, r: int,
                client_ids: torch.Tensor) -> FleetMasks:
    """The round's (available, returned) masks over ``client_ids``:
    ``returned = available · (1 − straggler)``, a straggler being a sampled
    client whose delta is dropped after its pass."""
    avail = availability_mask(trace, r, client_ids)
    returned = avail * (1.0 - straggler_flags(trace, r, client_ids))
    return FleetMasks(available=avail, returned=returned)
