"""Resumable fleet campaigns: the Fig.-2 grid under a simulated fleet —
the port of the reference's ``fleet/campaign.py``.

A campaign runs a set of registry solvers ("cells") on one dataset for a
fixed round budget, each under a participation model (trace-driven
availability and stragglers, plain Bernoulli, or full participation), and
emits one JSONL :class:`~repro_torch.fleet.metrics.RoundEvent` per (cell,
round).  It is built to resume:

  * each cell checkpoints through :mod:`repro_torch.checkpoint` (atomic,
    manifest last, the reference's format) every ``checkpoint_every``
    rounds;
  * the Trainer's absolute-round keys ``fold_in(PRNGKey(seed), r)`` and the
    trace's ``(seed, round)``-pure masks make a round's computation
    independent of where the process last died;
  * on restart a cell restores its newest checkpoint, the event log drops
    the rounds about to re-run (:meth:`EventLog.truncate`), and the
    re-emitted events equal, but for ``TIMING_KEYS``, what an
    uninterrupted run writes.

So a kill at any instant and a re-invocation give the uninterrupted run's
final iterates and deterministic event stream bit for bit.

**Drift** (§1.2's non-stationary clients): every ``drift_every`` rounds the
data is rebuilt through :func:`repro_torch.data.synthetic.drifted_dataset`
and the solver is rebuilt on it with the carried state; the epoch is a
pure function of the absolute round, so a resume lands in its segment.

**The divergence rail** (``spec.guard != "none"``): a round that leaves the
iterate non-finite (the Trainer's
:class:`~repro_torch.core.trainer.NonFiniteIterateError`) or with
``||w|| > explode_norm`` (checked before the event is logged) rolls the
cell back to its last checkpoint, adds the round to the cell's
``guard.json`` quarantine set (an atomic write), drops the events about to
re-run, and the re-run *skips* the quarantined round (the round counter
advances; iterate and per-client state stay).  Quarantined rounds log
``rollbacks=1``.  More than ``max_rollbacks`` consecutive rollbacks without
a finished segment raise :class:`CampaignDiverged`.  ``"clip"``,
``"trimmed_mean"`` and ``"median"`` arm the rail and also install that
``EngineConfig.aggregator_guard`` in every cell.

The device (``run_cell`` / ``run_campaign``'s ``device``, default the CUDA
card) is not part of :class:`CampaignSpec`, so ``summary.json``'s ``spec``
is the reference's for the same campaign.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.fleet.faults import FaultModel, fault_counts
from repro_torch.fleet.metrics import (EventLog, RoundEvent, peak_rss_mb,
                                       summarize_events)
from repro_torch.fleet.participation import (BernoulliParticipation,
                                             TraceParticipation)
from repro_torch.fleet.traces import FleetTrace
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike, resolve_device

#: guard spellings that install an engine-level aggregator guard
_ENGINE_GUARDS = ("clip", "trimmed_mean", "median")
_GUARD_CHOICES = ("none", "rollback") + _ENGINE_GUARDS


class CampaignDiverged(RuntimeError):
    """The rail gave up: more than ``max_rollbacks`` consecutive rollbacks
    without completing a segment."""

    def __init__(self, cell: str, round_index: int, rollbacks: int):
        super().__init__(
            f"cell '{cell}' keeps diverging (round {round_index}, "
            f"{rollbacks} rollbacks so far) — quarantine is not restoring "
            "progress; raise max_rollbacks or install an aggregator guard")
        self.cell = cell
        self.round_index = int(round_index)
        self.rollbacks = int(rollbacks)


class CampaignInterrupted(Exception):
    """Raised by the ``stop_after`` hook to simulate a crash mid-campaign
    (no final checkpoint): the resume path's stand-in for ``kill -9``."""

    def __init__(self, rounds_done: int):
        super().__init__(f"campaign stopped after {rounds_done} rounds")
        self.rounds_done = rounds_done


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One campaign = (dataset, fleet, grid, budget): everything a resumed
    invocation needs to recompute the same run."""

    algos: Tuple[str, ...] = ("gd", "fedavg")
    rounds: int = 30
    seed: int = 0
    #: None -> PAPER_K_CONFIG (K = 10,000 clients, d and n_k cut); a float
    #: runs get_logreg_config().scaled(scale)
    scale: Optional[float] = None
    #: "trace" | "bernoulli" | "full"
    model: str = "trace"
    #: the Bernoulli rate; ignored for "trace" and "full"
    participation: float = 0.3
    trace: FleetTrace = dataclasses.field(default_factory=FleetTrace)
    cohort: Optional[int] = None
    client_chunk: Optional[int] = None
    eval_every: int = 1
    checkpoint_every: int = 5
    #: rounds per drift epoch; 0 disables drift
    drift_every: int = 0
    drift_w_scale: float = 1.0
    drift_resample: bool = False
    #: per-algo solver overrides, e.g. {"fedavg": {"stepsize": 0.3}}
    overrides: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    #: fault model corrupting client deltas (None = an honest fleet)
    faults: Optional[FaultModel] = None
    #: "none" | "rollback" | "clip" | "trimmed_mean" | "median"
    guard: str = "none"
    guard_clip_norm: Optional[float] = None
    guard_trim: float = 0.1
    #: consecutive rollbacks tolerated before CampaignDiverged
    max_rollbacks: int = 3
    #: the rail's threshold for a finite but exploding iterate
    explode_norm: float = 1e8

    def __post_init__(self):
        if self.model not in ("trace", "bernoulli", "full"):
            raise ValueError("model must be 'trace', 'bernoulli', or 'full'")
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if self.guard not in _GUARD_CHOICES:
            raise ValueError(f"guard must be one of {_GUARD_CHOICES}")
        if self.max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        if self.explode_norm <= 0:
            raise ValueError("explode_norm must be > 0")

    def engine_guard(self) -> Optional[str]:
        """The EngineConfig.aggregator_guard this spec installs (None for
        "none" and "rollback")."""
        return self.guard if self.guard in _ENGINE_GUARDS else None

    def participation_model(self):
        """(model or None, capacity rate) for the engine: the model owns
        the draw, the rate bounds the cohort capacity."""
        if self.model == "trace":
            return TraceParticipation(self.trace), self.trace.max_rate()
        if self.model == "bernoulli" and self.participation < 1.0:
            return (BernoulliParticipation(self.participation),
                    self.participation)
        return None, 1.0

    def to_jsonable(self) -> Dict:
        return dataclasses.asdict(self)


def _epoch_of(spec: CampaignSpec, r: int) -> int:
    return r // spec.drift_every if spec.drift_every > 0 else 0


def _segment_end(spec: CampaignSpec, r: int) -> int:
    if spec.drift_every <= 0:
        return spec.rounds
    return min(((r // spec.drift_every) + 1) * spec.drift_every, spec.rounds)


def _build_epoch(spec: CampaignSpec, epoch: int, device: torch.device):
    """(problem, test problem) of a drift epoch on ``device`` — a pure
    function of (spec, epoch), which makes a resume into a segment
    exact."""
    from repro_torch.configs import get_logreg_config
    from repro_torch.configs.gplus_logreg import PAPER_K_CONFIG
    from repro_torch.core import build_problem, build_test_problem
    from repro_torch.data.synthetic import (drifted_dataset,
                                            materialize_dataset,
                                            virtual_dataset)

    cfg = (PAPER_K_CONFIG if spec.scale is None
           else get_logreg_config().scaled(spec.scale))
    vds = virtual_dataset(cfg, seed=spec.seed, device=device)
    if spec.drift_every > 0:
        vds = drifted_dataset(vds, epoch, w_true_scale=spec.drift_w_scale,
                              resample_clients=spec.drift_resample)
    ds = materialize_dataset(vds)
    return (build_problem(ds, device=device),
            build_test_problem(ds, device=device))


def _make_solver_for(spec: CampaignSpec, algo: str, problem,
                     device: torch.device):
    from repro_torch.core import make_solver
    model, rate = spec.participation_model()
    kw = dict(participation=rate, participation_model=model,
              client_chunk=spec.client_chunk, cohort=spec.cohort)
    if spec.faults is not None:
        kw["fault_model"] = spec.faults
    eg = spec.engine_guard()
    if eg is not None:
        kw["aggregator_guard"] = eg
        if eg == "clip":
            if spec.guard_clip_norm is not None:
                kw["guard_clip_norm"] = spec.guard_clip_norm
        else:
            kw["guard_trim"] = spec.guard_trim
    kw.update(spec.overrides.get(algo, {}))
    return make_solver(algo, problem, device=device, **kw)


def _count_fn(model, fmodel, offsets, sizes, device: torch.device):
    """(key, r) -> (drawn, realized, stragglers, faults_injected, poisoned)
    as ints, from exactly the masks the engine drew and the fault kinds
    it injected in round r: the same keys, one source of randomness."""
    total = int(sum(sizes))
    if model is None and fmodel is None:
        return lambda key, r: (total, total, 0, 0, 0)
    # global client ids in bucket order, as the engine assigns them
    all_ids = (torch.cat([torch.arange(int(o), int(o) + int(s),
                                       dtype=torch.int64, device=device)
                          for o, s in zip(offsets, sizes)])
               if fmodel is not None else None)

    def counts(key, r):
        comp = (model.mask_components(key, r, offsets, sizes, device)
                if model is not None else None)
        if comp is None:
            drawn, realized = total, total
            ret = torch.ones((total,), dtype=torch.float32, device=device)
        else:
            avail, returned = comp
            ret = torch.cat(returned)
            drawn, realized = (int(v) for v in torch.stack(
                [torch.cat(avail).sum(), ret.sum()]).tolist())
        injected, poisoned = fault_counts(fmodel, r, all_ids, ret)
        return drawn, realized, drawn - realized, injected, poisoned

    return counts


def _load_guard(path: str) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"quarantined": [], "consecutive": 0, "total": 0}


def _save_guard(path: str, guard: Dict) -> None:
    """Atomic write: the quarantine decision survives a kill at any
    instant between detection and the rolled-back re-run."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(guard, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _QuarantinedSolver:
    """A solver that *skips* quarantined rounds: the round counter
    advances, the iterate and per-client state stay, as if every client
    was dropped.  Keys are indexed by the absolute round, so a skip never
    shifts a later round's keys."""

    def __init__(self, solver, quarantined):
        self._solver = solver
        self._quarantined = frozenset(int(q) for q in quarantined)

    def round(self, state, key):
        if int(state.round) in self._quarantined:
            return state.replace(round=state.round + 1)
        return self._solver.round(state, key)

    def __getattr__(self, name):
        return getattr(self._solver, name)


def run_cell(spec: CampaignSpec, algo: str, out_dir: str, log: EventLog,
             budget: Optional[Dict] = None, verbose: bool = True,
             device: DeviceLike = None) -> Dict:
    """Run (or resume) one campaign cell to its round budget on ``device``
    (default: the CUDA card).

    ``budget`` is the cross-cell ``stop_after`` countdown: ``{"left": n}``
    falls by one a completed round and raises :class:`CampaignInterrupted`
    at zero.  Returns ``{"w": final iterate, "round": rounds}``, plus the
    rail's tally when it is armed.
    """
    from repro_torch.core import NonFiniteIterateError, Trainer

    dev = resolve_device(device)
    ckpt_dir = os.path.join(out_dir, "cells", algo)
    guard_path = os.path.join(ckpt_dir, "guard.json")
    rail = spec.guard != "none"
    guard = _load_guard(guard_path) if rail else _load_guard("")

    state = None
    if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        state = Trainer.restore(ckpt_dir, dev)
        if verbose:
            print(f"[{algo}] resuming from round {int(state.round)}")
    start = 0 if state is None else int(state.round)
    # the rounds >= start are about to re-run and re-emit
    log.truncate(algo, start)

    model, _ = spec.participation_model()
    rejects = spec.engine_guard() is not None
    explode = float(spec.explode_norm)
    base = threefry.as_key(threefry.PRNGKey(spec.seed), dev)
    r = start
    while r < spec.rounds:
        epoch = _epoch_of(spec, r)
        seg_end = _segment_end(spec, r)
        problem, test = _build_epoch(spec, epoch, dev)
        solver = _make_solver_for(spec, algo, problem, dev)
        if state is None:
            state = solver.init(torch.zeros((problem.d,), device=dev))
        quarantined = frozenset(int(q) for q in guard["quarantined"])
        run_solver = (_QuarantinedSolver(solver, quarantined)
                      if rail and quarantined else solver)
        counts = _count_fn(model, spec.faults, solver.engine._offsets,
                           solver.engine._sizes, dev)
        t_mark = [time.perf_counter()]

        def callback(st, rr, counts=counts, problem=problem, test=test,
                     t_mark=t_mark, quarantined=quarantined):
            # the rail's explosion check comes before anything is logged,
            # so a diverging round never leaves an event to claw back
            if rail and not bool(torch.linalg.norm(st.w) <= explode):
                raise NonFiniteIterateError(algo, rr)
            drawn, realized, stragglers, injected, poisoned = counts(
                threefry.fold_in(base, rr), rr)
            is_eval = ((rr + 1) % spec.eval_every == 0
                       or rr == spec.rounds - 1)
            f_v = float(problem.flat.loss(st.w)) if is_eval else None
            e_v = float(test.error_rate(st.w)) if is_eval else None
            now = time.perf_counter()
            log.append(RoundEvent(
                cell=algo, round=rr, drawn=drawn, realized=realized,
                stragglers=stragglers, f=f_v, err=e_v,
                faults_injected=injected,
                clients_rejected=poisoned if rejects else 0,
                rollbacks=1 if rr in quarantined else 0,
                wall_s=now - t_mark[0], peak_rss_mb=peak_rss_mb()))
            t_mark[0] = now
            if verbose and (is_eval or stragglers):
                msg = f"[{algo}] r{rr}: drawn={drawn} realized={realized}"
                if injected:
                    msg += f" faults={injected}"
                if rr in quarantined:
                    msg += " (quarantined)"
                if f_v is not None:
                    msg += f" f={f_v:.5f} err={e_v:.4f}"
                print(msg)
            if budget is not None:
                budget["left"] -= 1
                if budget["left"] <= 0:
                    raise CampaignInterrupted(rr + 1)

        trainer = Trainer(run_solver, rounds=seg_end, seed=spec.seed,
                          callback=callback, checkpoint_dir=ckpt_dir,
                          checkpoint_every=spec.checkpoint_every)
        try:
            res = trainer.fit(state=state)
        except NonFiniteIterateError as e:
            if not rail:
                raise
            bad = int(e.round_index)
            guard["quarantined"] = sorted(set(guard["quarantined"]) | {bad})
            guard["consecutive"] += 1
            guard["total"] += 1
            # quarantine first, atomically: a kill after this resumes with
            # the round condemned; a kill before it re-runs into the same
            # deterministic divergence and condemns it again
            _save_guard(guard_path, guard)
            if verbose:
                print(f"[{algo}] r{bad}: diverged — rolling back "
                      f"(quarantined, {guard['total']} total)")
            if guard["consecutive"] > spec.max_rollbacks:
                raise CampaignDiverged(algo, bad, guard["total"]) from e
            # back to the last atomic checkpoint (a fresh start if the
            # divergence came before the first save)
            if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
                state = Trainer.restore(ckpt_dir, dev)
                r = int(state.round)
            else:
                state = None
                r = 0
            log.truncate(algo, r)
            continue
        # a completed segment is progress: the consecutive streak resets
        if rail and guard["consecutive"]:
            guard["consecutive"] = 0
            _save_guard(guard_path, guard)
        state = res.state
        r = seg_end
    out = {"w": state.w, "round": int(state.round)}
    if rail:
        out["rollbacks"] = guard["total"]
        out["quarantined"] = list(guard["quarantined"])
    return out


def run_campaign(spec: CampaignSpec, out_dir: str,
                 stop_after: Optional[int] = None,
                 verbose: bool = True, device: DeviceLike = None) -> Dict:
    """Run (or resume) every cell of a campaign on ``device`` (default: the
    CUDA card); write ``events.jsonl`` and, on completion, an atomic
    ``summary.json``.

    ``stop_after`` aborts the invocation after that many rounds *of this
    invocation* (a simulated crash); the return value is then
    ``{"interrupted": True, "rounds_done": n}``, and a re-invocation
    without it resumes and completes.
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    log = EventLog(os.path.join(out_dir, "events.jsonl"))
    budget = {"left": stop_after} if stop_after is not None else None
    finals = {}
    try:
        for algo in spec.algos:
            finals[algo] = run_cell(spec, algo, out_dir, log, budget=budget,
                                    verbose=verbose, device=dev)
    except CampaignInterrupted as e:
        if verbose:
            print(f"campaign interrupted after {e.rounds_done} rounds "
                  f"(this invocation)")
        return {"interrupted": True, "rounds_done": e.rounds_done}

    cells = summarize_events(log.load())
    summary = {"spec": spec.to_jsonable(), "cells": cells,
               "events": os.path.basename(log.path)}
    path = os.path.join(out_dir, "summary.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    summary["finals"] = finals
    return summary
