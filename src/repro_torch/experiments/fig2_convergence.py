"""Fig. 2 on the port: rounds of communication against objective and test
error, from one command — the twin of the reference's
``benchmarks/fig2_convergence.py``, with its flags, its curves, its printed
lines and its JSON keys.

    python -m repro_torch.experiments.fig2_convergence --scale 1.0 \\
        --rounds 30 --json fig2.json              # on the CUDA card
    python -m repro_torch.experiments.fig2_convergence --device cpu \\
        --scale 0.001 --rounds 2 --opt-iters 100  # plain versions, CPU

It compares OPT (the offline optimum), GD (best stepsize), CoCoA+, DANE,
FSVRG, FSVRGR (the same algorithm on randomly reshuffled rows), FedAvg
(local SGD) and one-shot averaging, beside the constant and per-author
majority predictions.  Every round-based curve is a row of ``CURVES``: the
solver comes from the registry (``make_solver``), the round loop and key
schedule from the shared :class:`~repro_torch.core.Trainer` (all derived
from ``--seed``), the retrospective stepsize sweep from
:func:`~repro_torch.core.sweep`.  The data is drawn on ``--device`` (the
CUDA card unless ``cpu``) and every curve runs there; the kernels of its
local steps count their launches, which the JSON records per curve beside
the curve's wall seconds.

``--scale`` 1.0 is the paper's setting: K = 10,000, n = 2,166,693,
d = 20,002.  OPT is plain GD on the flat view whose best iterate is looked
at every 500 iterations, as in the reference: with ``--opt-iters`` below
500 it is w* = 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (get_dane_config, get_fedavg_config,
                                 get_fsvrg_config, get_gd_config,
                                 get_logreg_config)
from repro_torch.core import (Trainer, build_problem, build_test_problem,
                              make_solver, sweep)
from repro_torch.core.baselines import (majority_baseline_error,
                                        one_shot_average)
from repro_torch.data import generate
from repro_torch.kernels import ops
from repro_torch.utils import threefry
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Curve:
    """One comparison curve: a registry solver + its retrospective sweep."""

    solver: str                                  # registry name
    sweep_param: Optional[str] = None            # hyperparam swept (None: none)
    sweep: Tuple[float, ...] = ()
    reshuffle: bool = False                      # FSVRGR: same algo, shuffled data


def _curves():
    return {
        "fsvrg": Curve("fsvrg", "stepsize", get_fsvrg_config().stepsize_sweep),
        "fsvrgr": Curve("fsvrg", "stepsize", get_fsvrg_config().stepsize_sweep,
                        reshuffle=True),
        "gd": Curve("gd", "stepsize", get_gd_config().stepsize_sweep),
        "dane": Curve("dane", "local_lr", get_dane_config().local_lr_sweep),
        "cocoa": Curve("cocoa"),
        "fedavg": Curve("fedavg", "stepsize",
                        get_fedavg_config().stepsize_sweep),
    }


ALGOS = ("fsvrg", "fsvrgr", "gd", "dane", "cocoa", "fedavg", "oneshot")
#: the curves of the rounds-to-10 %-gap table, in its order
GAP_TABLE = ("fsvrg", "fsvrgr", "gd", "dane", "cocoa", "fedavg")


def optimum(prob, iters: int = 6000, lr: float = 2.0) -> torch.Tensor:
    """The offline optimum: GD on the flat view, keeping the best iterate
    of those looked at every 500 iterations (w = 0 below 500)."""
    w = torch.zeros((prob.d,), device=prob.device)
    best, best_f = w, float(prob.flat.loss(w))
    for i in range(iters):
        w = w - lr * prob.flat.grad(w)
        if i % 500 == 499:
            f = float(prob.flat.loss(w))
            if f < best_f:
                best, best_f = w, f
    return best


def _launches_since(before):
    return {k: v - before[k] for k, v in ops.launch_counts().items()
            if v != before[k]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.005)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0,
                    help="drives the data generator AND every curve's "
                         "per-round key schedule (via the Trainer)")
    ap.add_argument("--opt-iters", type=int, default=6000,
                    help="GD iterations for the offline OPT reference "
                         "(lower it for smoke runs)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--algo", default="all", choices=("all",) + ALGOS,
                    help="run a single comparison curve instead of all of them")
    ap.add_argument("--participation-model", default="none",
                    choices=("none", "bernoulli", "trace"),
                    help="run every curve under partial participation: "
                         "'bernoulli' uses --participation as the i.i.d. "
                         "rate, 'trace' a repro_torch.fleet diurnal "
                         "availability/straggler trace (seeded from --seed)")
    ap.add_argument("--participation", type=float, default=0.3,
                    help="client participation rate for "
                         "--participation-model=bernoulli")
    ap.add_argument("--fault-model", default=None,
                    help="inject deterministic delta corruptions into every "
                         "curve, e.g. 'nan=0.01,sign=0.05,start=3' (knobs: "
                         "nan/sign/scale/replay rates, scale-factor, window, "
                         "start/stop rounds, seed) — "
                         "repro_torch.fleet.DeltaFaults; unguarded "
                         "NaN-poisoned candidates diverge and lose their "
                         "sweeps, so pair with --aggregator-guard")
    ap.add_argument("--aggregator-guard", default="none",
                    choices=("none", "clip", "trimmed_mean", "median"),
                    help="robust-aggregation guard installed in every "
                         "curve's engine (trimmed_mean/median reject the "
                         "cocoa curve: order-stat guards don't compose with "
                         "its sum-weighted dual aggregation)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions on the CPU; "
                         "default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def want(name):
        return args.algo in ("all", name)

    # extra solver kwargs shared by every curve (merged into make_solver)
    fleet_kw = {}
    if args.participation_model == "bernoulli":
        fleet_kw = {"participation": args.participation}
    elif args.participation_model == "trace":
        from repro_torch.fleet import FleetTrace, TraceParticipation
        trace = FleetTrace(seed=args.seed)
        fleet_kw = {"participation": trace.max_rate(),
                    "participation_model": TraceParticipation(trace)}
    if args.fault_model:
        from repro_torch.fleet import DeltaFaults
        fleet_kw["fault_model"] = DeltaFaults.from_spec(args.fault_model)
    if args.aggregator_guard != "none":
        fleet_kw["aggregator_guard"] = args.aggregator_guard

    cfg = get_logreg_config().scaled(args.scale)
    ds = generate(cfg, seed=args.seed, device=dev)
    prob = build_problem(ds, device=dev)
    te = build_test_problem(ds, device=dev)
    print(f"# K={ds.num_clients} n={ds.num_examples} d={ds.num_features} "
          f"n_k in [{ds.client_sizes.min()},{ds.client_sizes.max()}]")

    w_star = optimum(prob, iters=args.opt_iters)
    f_star = float(prob.flat.loss(w_star))
    err_star = float(te.error_rate(w_star))

    # naive prediction properties (§4.1 analogues)
    err_const = min(float((te.y == 1).to(torch.float32).mean()),
                    float((te.y == -1).to(torch.float32).mean()))
    err_majority = majority_baseline_error(ds.y, ds.client_of, ds.test_y,
                                           ds.test_client_of)
    print(f"# OPT f*={f_star:.5f} err*={err_star:.4f} | "
          f"const-pred err={err_const:.4f} | per-author-majority err={err_majority:.4f}")

    results = {"opt": {"f": f_star, "err": err_star},
               "const_err": err_const, "majority_err": err_majority,
               "config": dataclasses.asdict(cfg)}

    # FSVRGR's reshuffled problem (built lazily, derived from --seed too):
    # the rows move, each client keeps its size and its place
    prob_r = None

    def reshuffled():
        nonlocal prob_r
        if prob_r is None:
            rng = np.random.default_rng(args.seed)
            perm = torch.as_tensor(rng.permutation(ds.num_examples),
                                   device=dev)
            ds_r = dataclasses.replace(ds, idx=ds.idx[perm],
                                       val=ds.val[perm], y=ds.y[perm])
            prob_r = build_problem(ds_r, device=dev)
        return prob_r

    # ---- every round-based curve: one registry-driven sweep ---- #
    for name, c in _curves().items():
        if not want(name):
            continue
        problem = reshuffled() if c.reshuffle else prob

        def eval_w(w, problem=problem):
            return {"f": problem.flat.loss(w), "err": te.error_rate(w)}

        t0 = time.perf_counter()
        before = ops.launch_counts()
        if c.sweep_param is not None:
            res, best = sweep(
                lambda v: make_solver(c.solver, problem, device=dev,
                                      **{c.sweep_param: v, **fleet_kw}),
                c.sweep, rounds=args.rounds, seed=args.seed, eval_fn=eval_w)
            if res is None:
                print(f"{name}: every candidate in {c.sweep} diverged")
                continue
            swept = {c.sweep_param: best}
        else:
            res = Trainer(make_solver(c.solver, problem, device=dev,
                                      **fleet_kw),
                          rounds=args.rounds,
                          seed=args.seed, eval_fn=eval_w).fit()
            swept = {}
        seconds = time.perf_counter() - t0
        hist = res.history
        results[name] = {
            "solver": c.solver, "swept": swept, "hist": hist,
            # JSON-friendly hyperparams of the (best) run
            "hyperparams": {
                k: v for k, v in res.solver.hyperparams.items()
                if isinstance(v, (int, float, str, bool, type(None)))},
            "seconds": seconds, "launches": _launches_since(before)}
        tag = ",".join(f"{k}={v}" for k, v in swept.items()) or "defaults"
        print(f"{name:7s} ({tag}): " + " ".join(
            f"r{r+1}={p['f']:.4f}"
            for r, p in list(enumerate(hist))[::max(1, args.rounds // 6)])
            + f"  err={hist[-1]['err']:.4f}  [{seconds:.0f}s]")

    # ---- one-shot averaging (not round-based: single communication) ---- #
    if want("oneshot"):
        t0 = time.perf_counter()
        before = ops.launch_counts()
        key_os = threefry.fold_in(threefry.PRNGKey(args.seed), 10_000)
        w_os = one_shot_average(prob, torch.zeros((prob.d,), device=dev),
                                key_os, stepsize=0.5, epochs=20)
        results["oneshot"] = {"f": float(prob.flat.loss(w_os)),
                              "err": float(te.error_rate(w_os)),
                              "seconds": time.perf_counter() - t0,
                              "launches": _launches_since(before)}
        print(f"oneshot: f={results['oneshot']['f']:.4f} "
              f"err={results['oneshot']['err']:.4f}")

    # rounds-to-within-10%-of-optimal-gap table
    f0 = float(prob.flat.loss(torch.zeros((prob.d,), device=dev)))
    target = f_star + 0.1 * (f0 - f_star)
    print("\nname,rounds_to_10pct_gap,final_f,final_err")
    for name in GAP_TABLE:
        if name not in results:
            continue
        hist_n = results[name]["hist"]
        rto = next((r + 1 for r, p in enumerate(hist_n) if p["f"] <= target),
                   None)
        results[name]["rounds_to_10pct_gap"] = rto
        print(f"{name},{rto},{hist_n[-1]['f']:.5f},{hist_n[-1]['err']:.4f}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
