"""Fleet campaign command — resumable runs under a simulated fleet, the
twin of the reference's ``benchmarks/campaign.py`` on the port.

Runs a :class:`repro_torch.fleet.CampaignSpec` (Fig.-2 solver cells × one
dataset × one participation model) to its round budget, checkpointing
every cell, so a ``kill -9`` at any instant costs at most
``--checkpoint-every`` rounds: re-invoking the same command resumes from
the newest atomic checkpoint and reproduces the uninterrupted run bit for
bit (final iterates and the deterministic view of the JSONL events).

    # the paper-K run (K = 10,000 clients, trace-driven fleet), on the card
    python -m repro_torch.experiments.campaign --out runs/fig2_fleet \\
        --rounds 30 --algos gd,fedavg,fsvrg --eval-every 3 --verify-resume

    # 2 cells x 3 rounds at a small scale, a forced crash, resume and
    # bit-identity check (exit 1 on a mismatch), on the CPU
    python -m repro_torch.experiments.campaign --smoke --device cpu \\
        --out /tmp/campaign_smoke

It takes every flag of the reference's command plus ``--device`` (default:
the CUDA card), has its ``--smoke``, ``--fault-smoke`` and
``--verify-resume`` modes with the same exit codes, and writes its JSON
only where ``--json`` says.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from repro_torch.fleet import (CampaignSpec, DeltaFaults, EventLog,
                               FleetTrace, deterministic_view, run_campaign)


def _faults_from_args(args):
    """``--faults nan=0.01,sign=0.05,start=10,stop=12`` -> DeltaFaults."""
    if not args.faults:
        return None
    try:
        return DeltaFaults.from_spec(args.faults)
    except ValueError as e:
        raise SystemExit(f"--faults: {e}")


def _spec_from_args(args) -> CampaignSpec:
    trace = FleetTrace(seed=args.trace_seed, base=args.base,
                       amplitude=args.amplitude, period=args.period,
                       burst_prob=args.burst_prob, burst_frac=args.burst_frac,
                       straggler_rate=args.straggler_rate)
    return CampaignSpec(
        algos=tuple(args.algos.split(",")),
        rounds=args.rounds, seed=args.seed,
        scale=None if args.scale in (None, "paper") else float(args.scale),
        model=args.model, participation=args.participation, trace=trace,
        cohort=args.cohort, client_chunk=args.client_chunk,
        eval_every=args.eval_every, checkpoint_every=args.checkpoint_every,
        drift_every=args.drift_every, drift_w_scale=args.drift_w_scale,
        drift_resample=args.drift_resample,
        faults=_faults_from_args(args), guard=args.guard,
        guard_clip_norm=args.guard_clip_norm, guard_trim=args.guard_trim,
        max_rollbacks=args.max_rollbacks)


def _final_arrays(out_dir: str, algos) -> dict:
    """Each cell's checkpointed final state, read raw from its payload."""
    out = {}
    for a in algos:
        ckpt = os.path.join(out_dir, "cells", a)
        with open(os.path.join(ckpt, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(ckpt, manifest["arrays_file"])) as z:
            out[a] = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    return out


def verify_resume(spec: CampaignSpec, out_dir: str, stop_after: int,
                  verbose: bool = True, device=None) -> bool:
    """Uninterrupted against crashed and resumed: the deterministic event
    views and the final checkpoint arrays (``torch.equal``) must match."""
    ref_dir = os.path.join(out_dir, "verify_ref")
    run_dir = os.path.join(out_dir, "verify_run")
    for d in (ref_dir, run_dir):
        shutil.rmtree(d, ignore_errors=True)
    run_campaign(spec, ref_dir, verbose=False, device=device)
    r = run_campaign(spec, run_dir, stop_after=stop_after, verbose=False,
                     device=device)
    if not r.get("interrupted"):
        print(f"verify-resume: stop_after={stop_after} >= total rounds; "
              "nothing was interrupted", file=sys.stderr)
        return False
    run_campaign(spec, run_dir, verbose=False, device=device)

    ev_ref = [deterministic_view(e)
              for e in EventLog(os.path.join(ref_dir, "events.jsonl")).load()]
    ev_run = [deterministic_view(e)
              for e in EventLog(os.path.join(run_dir, "events.jsonl")).load()]
    ok = ev_ref == ev_run
    if verbose:
        print(f"verify-resume: events {'MATCH' if ok else 'MISMATCH'} "
              f"({len(ev_ref)} vs {len(ev_run)} rounds)")
    ref_w = _final_arrays(ref_dir, spec.algos)
    run_w = _final_arrays(run_dir, spec.algos)
    for a in spec.algos:
        same = (set(ref_w[a]) == set(run_w[a]) and
                all(torch.equal(ref_w[a][k], run_w[a][k])
                    for k in ref_w[a]))
        ok = ok and same
        if verbose:
            print(f"verify-resume: {a} final state "
                  f"{'bit-identical' if same else 'MISMATCH'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="resumable fleet-simulation campaign over the Fig.-2 grid")
    ap.add_argument("--out", default="runs/campaign")
    ap.add_argument("--algos", default="gd,fedavg")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", default="paper",
                    help="'paper' -> PAPER_K_CONFIG (K=10,000); a float "
                         "runs the scaled gplus config instead")
    ap.add_argument("--participation-model", dest="model", default="trace",
                    choices=("trace", "bernoulli", "full"))
    ap.add_argument("--participation", type=float, default=0.3,
                    help="Bernoulli rate (model=bernoulli)")
    # fleet trace knobs
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--base", type=float, default=0.4)
    ap.add_argument("--amplitude", type=float, default=0.25)
    ap.add_argument("--period", type=float, default=24.0)
    ap.add_argument("--burst-prob", type=float, default=0.05)
    ap.add_argument("--burst-frac", type=float, default=0.3)
    ap.add_argument("--straggler-rate", type=float, default=0.02)
    # engine shape knobs
    ap.add_argument("--cohort", type=int, default=None)
    ap.add_argument("--client-chunk", type=int, default=None)
    # cadence
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    # drift
    ap.add_argument("--drift-every", type=int, default=0)
    ap.add_argument("--drift-w-scale", type=float, default=1.0)
    ap.add_argument("--drift-resample", action="store_true")
    # fault injection + guard-rails
    ap.add_argument("--faults", default=None,
                    help="delta-corruption spec, e.g. "
                         "'nan=0.01,start=10,stop=12' "
                         "(knobs: nan/sign/scale/replay rates, "
                         "scale-factor, window, start/stop rounds, seed)")
    ap.add_argument("--guard", default="none",
                    choices=("none", "rollback", "clip", "trimmed_mean",
                             "median"),
                    help="divergence guard-rail; clip/trimmed_mean/median "
                         "also install the engine aggregator guard")
    ap.add_argument("--guard-clip-norm", type=float, default=None)
    ap.add_argument("--guard-trim", type=float, default=0.1)
    ap.add_argument("--max-rollbacks", type=int, default=3)
    # modes
    ap.add_argument("--stop-after", type=int, default=None,
                    help="abort this invocation after N rounds (crash "
                         "simulation; re-invoke to resume)")
    ap.add_argument("--verify-resume", action="store_true",
                    help="run twice (uninterrupted vs crashed+resumed) and "
                         "require bit-identity; exit 1 on mismatch")
    ap.add_argument("--smoke", action="store_true",
                    help="small mode: tiny scale, 2 cells x 3 rounds, "
                         "forced mid-run resume + verification")
    ap.add_argument("--fault-smoke", action="store_true",
                    help="small mode: tiny NaN-poisoned campaign under the "
                         "rollback rail; exit 1 unless >= 1 rollback is "
                         "recorded and the final iterate converged")
    ap.add_argument("--json", default=None,
                    help="also write the summary (+ verification result) here")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.smoke:
        args.algos = "gd,fedavg"
        args.rounds = 3
        args.scale = 0.004
        args.eval_every = 2
        args.checkpoint_every = 1
    if args.fault_smoke:
        # one cell, a NaN-poisoning burst mid-run, the rollback rail armed:
        # the guard must quarantine the poisoned round and still converge
        args.algos = "gd"
        args.rounds = 8
        args.scale = 0.004
        args.model = "full"
        args.checkpoint_every = 2
        args.faults = args.faults or "nan=0.4,seed=1,start=3,stop=4"
        if args.guard == "none":
            args.guard = "rollback"
    spec = _spec_from_args(args)
    dev = args.device

    if args.fault_smoke:
        shutil.rmtree(args.out, ignore_errors=True)
        summary = run_campaign(spec, args.out, verbose=False, device=dev)
        cell = summary["cells"][spec.algos[0]]
        final_f = cell.get("final_f")
        ok = (cell["rollbacks"] >= 1 and final_f is not None
              and np.isfinite(final_f))
        print(f"fault-smoke: rollbacks={cell['rollbacks']} "
              f"faults={cell['faults_injected_total']} "
              f"final_f={final_f} -> {'PASS' if ok else 'FAIL'}")
        if args.json:
            with open(args.json, "w") as f:
                json.dump({k: v for k, v in summary.items()
                           if k != "finals"}, f, indent=1, sort_keys=True)
        return 0 if ok else 1

    verified = None
    if args.smoke or args.verify_resume:
        # crash after all of cell 1 and one round of cell 2: both the
        # resume into a cell and the skip of a completed cell run
        stop = spec.rounds + 1 if len(spec.algos) > 1 else spec.rounds // 2 + 1
        verified = verify_resume(spec, args.out, stop_after=stop, device=dev)
        if not verified:
            print("RESUME VERIFICATION FAILED", file=sys.stderr)
            return 1

    summary = run_campaign(spec, args.out, stop_after=args.stop_after,
                           device=dev)
    if summary.get("interrupted"):
        print(f"stopped after {summary['rounds_done']} rounds; re-invoke "
              f"with the same --out to resume")
        return 0

    for algo, cell in summary["cells"].items():
        line = (f"{algo:7s}: rounds={cell['rounds']} "
                f"realized/drawn={cell['realized_mean']:.1f}/"
                f"{cell['drawn_mean']:.1f} "
                f"stragglers={cell['straggler_total']} ")
        if cell.get("faults_injected_total") or cell.get("rollbacks"):
            line += (f"faults={cell['faults_injected_total']} "
                     f"rejected={cell['clients_rejected_total']} "
                     f"rollbacks={cell['rollbacks']} ")
        line += (f"final_f={cell.get('final_f', float('nan')):.5f} "
                 f"final_err={cell.get('final_err', float('nan')):.4f} "
                 f"[{cell['wall_total_s']:.0f}s]")
        print(line)
    if verified is not None:
        print(f"resume verification: {'PASS' if verified else 'FAIL'}")

    if args.json:
        payload = {k: v for k, v in summary.items() if k != "finals"}
        if verified is not None:
            payload["resume_verified"] = verified
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
