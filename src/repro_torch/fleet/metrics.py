"""Campaign telemetry: structured JSONL round events — the port's own
copy of the reference's ``fleet/metrics.py`` (it needs no torch), so that
both packages write and read the same event log.

One line per (cell, round), appended as the campaign runs:

    {"cell": "fedavg", "round": 12, "drawn": 981, "realized": 963,
     "stragglers": 18, "f": 0.5123, "err": 0.241,
     "wall_s": 0.184, "peak_rss_mb": 412.0}

``drawn`` is the round's sampled cohort (availability mask), ``realized``
the deltas that actually arrived (after stragglers), ``f``/``err`` are
``null`` off eval rounds.  Fault-tolerance fields (schema v2, all
defaulting to 0 so pre-fault logs still load): ``faults_injected`` is the
fault model's corrupted-delta count over returned clients,
``clients_rejected`` the deltas a non-finite-rejecting aggregator guard
discarded, and ``rollbacks`` flags a quarantined (rolled-back-and-skipped)
round.  Every field except the ``TIMING_KEYS``
(``wall_s``, ``peak_rss_mb``) is deterministic — a pure function of
(config, seed, round) — which is what makes the kill-and-resume
acceptance check meaningful: :func:`deterministic_view` strips the timing
fields and the remaining event stream must be byte-identical between an
interrupted+resumed campaign and an uninterrupted one.

The log is resume-aware: on restart, :meth:`EventLog.truncate` atomically
rewrites the file without the events a cell will re-emit (rounds at or
after its restored checkpoint), so re-run rounds never duplicate lines.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
from typing import Dict, List, Optional

#: non-deterministic (machine/load-dependent) event fields
TIMING_KEYS = ("wall_s", "peak_rss_mb")


@dataclasses.dataclass
class RoundEvent:
    """One row of campaign telemetry — see the module docstring."""

    cell: str
    round: int
    drawn: int
    realized: int
    stragglers: int
    f: Optional[float] = None
    err: Optional[float] = None
    #: corrupted deltas delivered this round (fault model's recomputable
    #: count over returned clients; 0 when no fault model is installed)
    faults_injected: int = 0
    #: deltas a non-finite-rejecting aggregator guard discarded
    clients_rejected: int = 0
    #: 1 when this round is quarantined (skipped after a guard-rail
    #: rollback), 0 otherwise — deterministic because the quarantine set
    #: is persisted in the cell's guard.json
    rollbacks: int = 0
    wall_s: float = 0.0
    peak_rss_mb: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


def peak_rss_mb() -> float:
    """The process's high-water RSS in MB — ru_maxrss is KB on Linux,
    bytes on macOS."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss / 1024.0 if sys.platform != "darwin" else rss / (1024.0 ** 2)


def deterministic_view(event: Dict) -> Dict:
    """The event minus its timing fields — the bit-identity comparand."""
    return {k: v for k, v in event.items() if k not in TIMING_KEYS}


class EventLog:
    """Append-only JSONL writer with atomic resume truncation."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, event: RoundEvent) -> None:
        # line-buffered append + flush: a kill mid-write can at worst leave
        # one torn trailing line, which truncate() discards on resume
        with open(self.path, "a") as f:
            f.write(event.to_json() + "\n")
            f.flush()
            os.fsync(f.fileno())

    def load(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        events = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    break  # torn tail from a mid-write kill; drop the rest
        return events

    def truncate(self, cell: str, first_rerun_round: int) -> None:
        """Drop ``cell``'s events for rounds >= ``first_rerun_round`` (the
        restored checkpoint's round) — those rounds are about to re-run and
        re-emit.  Atomic rewrite (temp + ``os.replace``), so a kill during
        resume bookkeeping never loses the surviving history."""
        events = self.load()
        keep = [e for e in events
                if not (e.get("cell") == cell
                        and e.get("round", 0) >= first_rerun_round)]
        if len(keep) == len(events):
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for e in keep:
                f.write(json.dumps(e, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


def summarize_events(events: List[Dict]) -> Dict[str, Dict]:
    """Per-cell rollup of an event stream: convergence series (eval rounds
    only), realized-cohort statistics, straggler totals, and wall-time /
    memory aggregates (the latter excluded from bit-identity checks)."""
    cells: Dict[str, Dict] = {}
    for e in events:
        c = cells.setdefault(e["cell"], {
            "rounds": 0, "drawn_total": 0, "realized_total": 0,
            "straggler_total": 0, "faults_injected_total": 0,
            "clients_rejected_total": 0, "rollbacks": 0, "convergence": [],
            "wall_total_s": 0.0, "peak_rss_mb": 0.0,
        })
        c["rounds"] += 1
        c["drawn_total"] += e["drawn"]
        c["realized_total"] += e["realized"]
        c["straggler_total"] += e["stragglers"]
        # .get(): pre-fault-tolerance logs have no fault/rollback fields
        c["faults_injected_total"] += e.get("faults_injected", 0)
        c["clients_rejected_total"] += e.get("clients_rejected", 0)
        c["rollbacks"] += e.get("rollbacks", 0)
        c["wall_total_s"] += e.get("wall_s", 0.0)
        c["peak_rss_mb"] = max(c["peak_rss_mb"], e.get("peak_rss_mb", 0.0))
        if e.get("f") is not None:
            point = {"round": e["round"], "f": e["f"]}
            if e.get("err") is not None:
                point["err"] = e["err"]
            c["convergence"].append(point)
    for c in cells.values():
        n = max(c["rounds"], 1)
        c["drawn_mean"] = c["drawn_total"] / n
        c["realized_mean"] = c["realized_total"] / n
        if c["convergence"]:
            c["final_f"] = c["convergence"][-1]["f"]
            if "err" in c["convergence"][-1]:
                c["final_err"] = c["convergence"][-1]["err"]
    return cells
