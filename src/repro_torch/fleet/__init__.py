"""Fleet simulation on the port: what the engine's Bernoulli draw
abstracts away (the reference's ``fleet`` package, its round-path parts).

  traces.py        — bit-stable availability/straggler masks: any round's
                     fleet is a pure function of ``(trace.seed, round)``,
                     on JAX's threefry bits (:mod:`repro_torch.utils.threefry`)
  participation.py — :class:`ParticipationModel`: traces (or a fixed list,
                     or the Bernoulli draw) in place of the engine's draw
  faults.py        — :class:`FaultModel`: deterministic delta corruptions
                     (NaN poisoning, sign flips, scaling, stale replay)
                     between the client pass and aggregation

Not ported yet: ``metrics.py`` and ``campaign.py`` (telemetry and the
checkpointed campaign runner).
"""
from repro_torch.fleet.faults import (KIND_NONE, KIND_POISON, KIND_REPLAY,
                                      KIND_SCALE, KIND_SIGN, DeltaFaults,
                                      FaultModel, fault_counts)
from repro_torch.fleet.participation import (BernoulliParticipation,
                                             FixedParticipation,
                                             ParticipationModel,
                                             TraceParticipation)
from repro_torch.fleet.traces import (FleetMasks, FleetTrace,
                                      availability_mask, availability_rate,
                                      fleet_masks, straggler_flags)

__all__ = [
    "DeltaFaults", "FaultModel", "fault_counts", "KIND_NONE", "KIND_POISON",
    "KIND_SIGN", "KIND_SCALE", "KIND_REPLAY",
    "BernoulliParticipation", "FixedParticipation", "ParticipationModel",
    "TraceParticipation",
    "FleetMasks", "FleetTrace", "availability_mask", "availability_rate",
    "fleet_masks", "straggler_flags",
]
