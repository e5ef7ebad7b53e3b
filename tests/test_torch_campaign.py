"""The port's fleet campaign (``repro_torch.fleet.campaign`` and
``fleet.metrics``) against the reference's.

* The telemetry: the reference's event-log and roll-up cases
  (``tests/test_campaign.py``) on the port's copy, and the same events
  written and summarized identically by both packages.
* The spec: every check of ``CampaignSpec`` and its JSON form, which
  equals the reference's for the same campaign.
* Against the live reference on the CPU, at ``tests/test_campaign.py``'s
  ``SPEC`` (GD and FedAvg under a trace, 3 rounds, scale 0.002) and its
  ``FAULTY`` spec (a NaN burst in round 4 under the rollback rail):
  every event's counts equal exactly (drawn, realized, stragglers,
  faults, rejected, rollbacks), ``f`` and ``err`` at rtol 1e-5 (ROADMAP
  C1), the same quarantined rounds, the same ``summary.json`` spec.
* Inside the port: interrupt and resume bit-identical, also across a drift
  epoch and across a rollback; the clip guard preventing rollbacks; an
  unguarded burst diverging; persistent faults raising
  ``CampaignDiverged``.
"""
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro import fleet as rfleet  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.bridge import faults_from_config, trace_from_config  # noqa: E402
from repro_torch.core import NonFiniteIterateError  # noqa: E402
from repro_torch.fleet import (CampaignDiverged, CampaignSpec,  # noqa: E402
                               DeltaFaults, EventLog, FleetTrace, RoundEvent,
                               deterministic_view, run_campaign,
                               summarize_events)

# --------------------------------------------------------------------- #
# the telemetry (tests/test_campaign.py :124-160, :274-300)
# --------------------------------------------------------------------- #


def _ev(cell, r, f=None, mod=fleet):
    return mod.RoundEvent(cell=cell, round=r, drawn=10, realized=9,
                          stragglers=1, f=f, wall_s=0.5)


def test_eventlog_truncate_drops_only_rerun_rounds(tmp_path):
    log = EventLog(str(tmp_path / "ev.jsonl"))
    for r in range(4):
        log.append(_ev("a", r))
    log.append(_ev("b", 0))
    log.truncate("a", 2)
    events = log.load()
    assert [(e["cell"], e["round"]) for e in events] == [
        ("a", 0), ("a", 1), ("b", 0)]


def test_eventlog_drops_torn_tail(tmp_path):
    log = EventLog(str(tmp_path / "ev.jsonl"))
    log.append(_ev("a", 0))
    log.append(_ev("a", 1))
    with open(log.path, "a") as f:
        f.write('{"cell": "a", "round": 2, "drawn"')   # killed mid-write
    assert [e["round"] for e in log.load()] == [0, 1]
    log.truncate("a", 1)   # the rewrite also discards the torn tail
    assert [e["round"] for e in log.load()] == [0]


def test_deterministic_view_strips_timing_only():
    e = json.loads(_ev("a", 1, f=0.5).to_json())
    v = deterministic_view(e)
    assert "wall_s" not in v and "peak_rss_mb" not in v
    assert v["f"] == 0.5 and v["round"] == 1
    assert fleet.TIMING_KEYS == rfleet.TIMING_KEYS


def test_summarize_events_rollup():
    events = [json.loads(_ev("a", r, f=(1.0 - 0.1 * r) if r % 2 else None)
                         .to_json()) for r in range(4)]
    s = summarize_events(events)["a"]
    assert s["rounds"] == 4 and s["straggler_total"] == 4
    assert [p["round"] for p in s["convergence"]] == [1, 3]
    assert s["final_f"] == pytest.approx(0.7)


def test_round_event_fault_fields_roundtrip_and_rollup():
    e = RoundEvent(cell="a", round=0, drawn=5, realized=5, stragglers=0,
                   faults_injected=3, clients_rejected=2, rollbacks=1,
                   f=1.0, wall_s=0.1)
    d = json.loads(e.to_json())
    assert (d["faults_injected"], d["clients_rejected"],
            d["rollbacks"]) == (3, 2, 1)
    events = [d, json.loads(_ev("a", 1).to_json())]
    s = summarize_events(events)["a"]
    assert s["faults_injected_total"] == 3
    assert s["clients_rejected_total"] == 2
    assert s["rollbacks"] == 1


def test_summarize_handles_pre_fault_schema():
    events = [json.loads(_ev("a", r).to_json()) for r in range(2)]
    for e in events:
        for k in ("faults_injected", "clients_rejected", "rollbacks"):
            e.pop(k)
    s = summarize_events(events)["a"]
    assert s["faults_injected_total"] == 0 and s["rollbacks"] == 0


def test_telemetry_is_the_references(tmp_path):
    """The same events give the same JSON lines, the same log file and the
    same roll-up in both packages."""
    ours, theirs = [], []
    for r in range(5):
        f = 0.9 - 0.1 * r if r % 2 else None
        kw = dict(cell="c", round=r, drawn=7 + r, realized=6 + r,
                  stragglers=1, f=f, err=None if f is None else 0.3,
                  faults_injected=r, clients_rejected=r // 2,
                  rollbacks=int(r == 3), wall_s=0.1, peak_rss_mb=5.0)
        ours.append(fleet.RoundEvent(**kw))
        theirs.append(rfleet.RoundEvent(**kw))
    assert [e.to_json() for e in ours] == [e.to_json() for e in theirs]
    for mod, events in ((fleet, ours), (rfleet, theirs)):
        log = mod.EventLog(str(tmp_path / mod.__name__ / "ev.jsonl"))
        for e in events:
            log.append(e)
        log.truncate("c", 4)
    a = EventLog(str(tmp_path / fleet.__name__ / "ev.jsonl")).load()
    b = rfleet.EventLog(str(tmp_path / rfleet.__name__ / "ev.jsonl")).load()
    assert a == b and len(a) == 4
    assert summarize_events(a) == rfleet.summarize_events(b)
    assert fleet.peak_rss_mb() > 0


# --------------------------------------------------------------------- #
# the spec
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kw,match", [
    (dict(model="poisson"), "model"),
    (dict(rounds=0), "rounds"),
    (dict(guard="sometimes"), "guard"),
    (dict(max_rollbacks=0), "max_rollbacks"),
    (dict(explode_norm=0.0), "explode_norm"),
])
def test_spec_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        CampaignSpec(**kw)
    with pytest.raises(ValueError, match=match):
        rfleet.CampaignSpec(**kw)


def test_spec_guards_and_participation():
    assert CampaignSpec(guard="rollback").engine_guard() is None
    assert CampaignSpec(guard="median").engine_guard() == "median"
    model, rate = CampaignSpec().participation_model()
    assert isinstance(model, fleet.TraceParticipation)
    assert rate == FleetTrace().max_rate() == 0.65
    model, rate = CampaignSpec(model="bernoulli",
                               participation=0.3).participation_model()
    assert isinstance(model, fleet.BernoulliParticipation) and rate == 0.3
    assert CampaignSpec(model="bernoulli",
                        participation=1.0).participation_model() == (None,
                                                                     1.0)
    assert CampaignSpec(model="full").participation_model() == (None, 1.0)


def _port_spec(spec):
    """The reference's spec as the port's (trace and faults converted)."""
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    kw["trace"] = trace_from_config(spec.trace)
    kw["faults"] = (None if spec.faults is None
                    else faults_from_config(spec.faults))
    return CampaignSpec(**kw)


SPEC = rfleet.CampaignSpec(
    algos=("gd", "fedavg"), rounds=3, seed=0, scale=0.002, model="trace",
    trace=rfleet.FleetTrace(seed=5, base=0.5, amplitude=0.3, period=7.0,
                            burst_prob=0.3, burst_frac=0.5,
                            straggler_rate=0.25),
    eval_every=2, checkpoint_every=1)
FAULTY = rfleet.CampaignSpec(
    algos=("gd",), rounds=14, seed=0, scale=0.002, model="full",
    eval_every=1, checkpoint_every=2,
    faults=rfleet.DeltaFaults(seed=1, nan_rate=0.35, start_round=4,
                              stop_round=5),
    guard="rollback")


def test_spec_json_is_the_references():
    for spec in (SPEC, FAULTY, rfleet.CampaignSpec(),
                 dataclasses.replace(FAULTY, guard="clip",
                                     guard_clip_norm=2.0,
                                     overrides={"gd": {"stepsize": 0.5}})):
        assert _port_spec(spec).to_jsonable() == spec.to_jsonable()


# --------------------------------------------------------------------- #
# against the live reference
# --------------------------------------------------------------------- #

COUNTS = ("cell", "round", "drawn", "realized", "stragglers",
          "faults_injected", "clients_rejected", "rollbacks")


def _events(d, mod=fleet):
    return [deterministic_view(e)
            for e in mod.EventLog(os.path.join(d, "events.jsonl")).load()]


def _summary(d):
    with open(os.path.join(d, "summary.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=["SPEC", "FAULTY"])
def both(request, tmp_path_factory):
    """(reference spec, reference dir, port dir) after one run of each."""
    spec = {"SPEC": SPEC, "FAULTY": FAULTY}[request.param]
    root = tmp_path_factory.mktemp(request.param)
    d_ref, d_port = str(root / "ref"), str(root / "port")
    rfleet.run_campaign(spec, d_ref, verbose=False)
    run_campaign(_port_spec(spec), d_port, verbose=False, device="cpu")
    return spec, d_ref, d_port


def test_campaign_events_match_the_reference(both):
    """Observed (CPU): counts equal; f within 9.8e-8 (SPEC) and 2.4e-7
    (FAULTY) relative, err within 7.4e-8 (an ulp of a mean of 0/1)."""
    spec, d_ref, d_port = both
    ref, got = _events(d_ref, rfleet), _events(d_port)
    assert len(got) == len(ref) == len(spec.algos) * spec.rounds
    for e_ref, e_got in zip(ref, got):
        assert {k: e_got[k] for k in COUNTS} == {k: e_ref[k]
                                                 for k in COUNTS}
        for k in ("f", "err"):
            if e_ref[k] is None:
                assert e_got[k] is None
            else:
                assert e_got[k] == pytest.approx(e_ref[k], rel=1e-5), (
                    e_ref["cell"], e_ref["round"], k)


def test_campaign_summary_and_guard_match_the_reference(both):
    spec, d_ref, d_port = both
    s_ref, s_got = _summary(d_ref), _summary(d_port)
    assert s_got["spec"] == s_ref["spec"]
    assert s_got["events"] == s_ref["events"] == "events.jsonl"
    for cell, c_ref in s_ref["cells"].items():
        c_got = s_got["cells"][cell]
        for k in ("rounds", "drawn_total", "realized_total",
                  "straggler_total", "faults_injected_total",
                  "clients_rejected_total", "rollbacks"):
            assert c_got[k] == c_ref[k], (cell, k)
        assert c_got["final_f"] == pytest.approx(c_ref["final_f"], rel=1e-5)
    for algo in spec.algos:
        paths = [os.path.join(d, "cells", algo, "guard.json")
                 for d in (d_ref, d_port)]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1])
        if os.path.exists(paths[0]):
            guards = []
            for p in paths:
                with open(p) as f:
                    guards.append(json.load(f))
            assert guards[1] == guards[0]
    if spec is FAULTY:
        with open(os.path.join(d_port, "cells", "gd", "guard.json")) as f:
            assert json.load(f)["quarantined"] == [4]


# --------------------------------------------------------------------- #
# inside the port
# --------------------------------------------------------------------- #


def _run_pair(spec, tmp_path, stop_after):
    d_ref = str(tmp_path / "ref")
    d_run = str(tmp_path / "run")
    s_ref = run_campaign(spec, d_ref, verbose=False, device="cpu")
    r = run_campaign(spec, d_run, stop_after=stop_after, verbose=False,
                     device="cpu")
    assert r.get("interrupted")
    s_run = run_campaign(spec, d_run, verbose=False, device="cpu")
    return s_ref, s_run, _events(d_ref), _events(d_run)


def test_campaign_interrupt_resume_bit_identical(tmp_path):
    """A crash after the first cell and one round of the second: the resume
    skips the finished cell and lands mid-cell on the other."""
    spec = _port_spec(SPEC)
    s_ref, s_run, ev_ref, ev_run = _run_pair(spec, tmp_path,
                                             stop_after=spec.rounds + 1)
    assert ev_ref == ev_run
    assert len(ev_ref) == len(spec.algos) * spec.rounds
    for a in spec.algos:
        assert torch.equal(s_ref["finals"][a]["w"], s_run["finals"][a]["w"])


def test_campaign_resume_across_drift_epoch(tmp_path):
    """The interruption lands on a drift-epoch boundary; the resume rebuilds
    the epoch's data from the absolute round."""
    spec = CampaignSpec(
        algos=("gd",), rounds=4, seed=0, scale=0.002, model="trace",
        trace=_port_spec(SPEC).trace, drift_every=2, drift_w_scale=0.8,
        drift_resample=True, eval_every=4, checkpoint_every=1)
    s_ref, s_run, ev_ref, ev_run = _run_pair(spec, tmp_path, stop_after=2)
    assert ev_ref == ev_run
    assert torch.equal(s_ref["finals"]["gd"]["w"], s_run["finals"]["gd"]["w"])


def test_campaign_resume_across_rollback_bit_identical(tmp_path):
    s_ref, s_run, ev_ref, ev_run = _run_pair(_port_spec(FAULTY), tmp_path,
                                             stop_after=7)
    assert ev_ref == ev_run
    assert torch.equal(s_ref["finals"]["gd"]["w"], s_run["finals"]["gd"]["w"])
    assert s_run["finals"]["gd"]["quarantined"] == [4]


def test_campaign_summary_written_and_events_counted(tmp_path):
    d = str(tmp_path / "c")
    spec = CampaignSpec(algos=("gd",), rounds=2, seed=0, scale=0.002,
                        model="bernoulli", participation=0.5,
                        eval_every=1, checkpoint_every=1)
    run_campaign(spec, d, verbose=False, device="cpu")
    summary = _summary(d)
    cell = summary["cells"]["gd"]
    assert cell["rounds"] == 2
    assert cell["straggler_total"] == 0          # bernoulli: no stragglers
    assert len(cell["convergence"]) == 2
    assert summary["spec"]["model"] == "bernoulli"


def test_campaign_unguarded_nan_faults_diverge(tmp_path):
    spec = dataclasses.replace(_port_spec(FAULTY), guard="none")
    with pytest.raises(NonFiniteIterateError):
        run_campaign(spec, str(tmp_path / "c"), verbose=False, device="cpu")


def test_campaign_clip_guard_prevents_rollbacks(tmp_path):
    spec = dataclasses.replace(_port_spec(FAULTY), guard="clip")
    s = run_campaign(spec, str(tmp_path / "c"), verbose=False, device="cpu")
    cell = s["cells"]["gd"]
    assert cell["rollbacks"] == 0
    assert cell["clients_rejected_total"] >= 1
    assert np.isfinite(cell["final_f"])


def test_campaign_persistent_faults_abort(tmp_path):
    spec = dataclasses.replace(
        _port_spec(FAULTY), rounds=8, max_rollbacks=1,
        faults=DeltaFaults(seed=1, nan_rate=0.5, start_round=2))
    with pytest.raises(CampaignDiverged) as ei:
        run_campaign(spec, str(tmp_path / "c"), verbose=False, device="cpu")
    assert ei.value.cell == "gd" and ei.value.rollbacks >= 2


def test_paper_k_fleet_counts_are_the_live_references():
    """The paper-K campaign's fleet (K = 10,000, ``FleetTrace(seed=0)``, 30
    rounds): the port's drawn / realized / straggler totals equal the live
    reference's.  ``CAMPAIGN_fig2.json`` records other totals: it was
    written under ``jax_threefry_partitionable=False`` (JAX's default
    before 0.5), under which the reference reproduces them."""
    ids = torch.arange(10_000)
    trace = FleetTrace(seed=0)
    got = np.zeros(2, np.int64)
    for r in range(30):
        fm = fleet.fleet_masks(trace, r, ids)
        got += [int(fm.available.sum()), int(fm.returned.sum())]

    def reference():
        rids = jnp.arange(10_000, dtype=jnp.uint32)
        out = np.zeros(2, np.int64)
        for r in range(30):
            fm = rfleet.fleet_masks(rfleet.FleetTrace(seed=0), r, rids)
            out += [int(fm.available.sum()), int(fm.returned.sum())]
        return out

    np.testing.assert_array_equal(got, reference())
    assert tuple(got) == (119_695, 117_305)
    with open(Path(__file__).resolve().parents[1] / "CAMPAIGN_fig2.json") as f:
        cells = json.load(f)["cells"]
    with jax.threefry_partitionable(False):
        old = reference()
    for c in cells.values():
        assert (c["drawn_total"], c["realized_total"]) == tuple(old)
        assert c["straggler_total"] == old[0] - old[1] == 2_379


def test_campaign_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(_port_spec(SPEC), str(tmp_path / "c"), verbose=False)
