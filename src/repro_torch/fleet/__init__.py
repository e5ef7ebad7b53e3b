"""Fleet simulation on the port: what the engine's Bernoulli draw
abstracts away (the reference's ``fleet`` package).

  traces.py        — bit-stable availability/straggler masks: any round's
                     fleet is a pure function of ``(trace.seed, round)``,
                     on JAX's threefry bits (:mod:`repro_torch.utils.threefry`)
  participation.py — :class:`ParticipationModel`: traces (or a fixed list,
                     or the Bernoulli draw) in place of the engine's draw
  faults.py        — :class:`FaultModel`: deterministic delta corruptions
                     (NaN poisoning, sign flips, scaling, stale replay)
                     between the client pass and aggregation
  metrics.py       — structured JSONL round telemetry (drawn against
                     realized cohort, stragglers, objective, wall/RSS)
  campaign.py      — the checkpointed, kill-resumable campaign runner over
                     the Fig.-2 solver grid, with drift and the rollback
                     rail (``python -m repro_torch.experiments.campaign``)
"""
from repro_torch.fleet.campaign import (CampaignDiverged,
                                        CampaignInterrupted, CampaignSpec,
                                        run_campaign, run_cell)
from repro_torch.fleet.faults import (KIND_NONE, KIND_POISON, KIND_REPLAY,
                                      KIND_SCALE, KIND_SIGN, DeltaFaults,
                                      FaultModel, fault_counts)
from repro_torch.fleet.metrics import (TIMING_KEYS, EventLog, RoundEvent,
                                       deterministic_view, peak_rss_mb,
                                       summarize_events)
from repro_torch.fleet.participation import (BernoulliParticipation,
                                             FixedParticipation,
                                             ParticipationModel,
                                             TraceParticipation)
from repro_torch.fleet.traces import (FleetMasks, FleetTrace,
                                      availability_mask, availability_rate,
                                      fleet_masks, straggler_flags)

__all__ = [
    "CampaignDiverged", "CampaignInterrupted", "CampaignSpec",
    "run_campaign", "run_cell",
    "TIMING_KEYS", "EventLog", "RoundEvent", "deterministic_view",
    "peak_rss_mb", "summarize_events",
    "DeltaFaults", "FaultModel", "fault_counts", "KIND_NONE", "KIND_POISON",
    "KIND_SIGN", "KIND_SCALE", "KIND_REPLAY",
    "BernoulliParticipation", "FixedParticipation", "ParticipationModel",
    "TraceParticipation",
    "FleetMasks", "FleetTrace", "availability_mask", "availability_rate",
    "fleet_masks", "straggler_flags",
]
