#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. record the machine: torch and CUDA versions, ``nvcc --version``, whether
   ``import triton`` works, the card's name and power limit;
2. build the kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once) and print the build seconds and register report;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged small ones, with the stated tolerance;
4. run the main path at the paper's full width — ``generate`` of the §4
   config (K = 10,000 clients, d = 20,002 features, n = 2,166,693
   examples) → ``build_problem`` → ``make_solver("fsvrg",
   aggregator="pallas")`` → ``Trainer`` for 3 rounds — with the launch
   counts set to 0 just before and read just after; then the same FSVRG on
   a small problem on the card and on the CPU (plain versions) with the
   same data and draws, which must agree;
5. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events at the main path's shapes, beside the bound (the least time the
   card could take), and break one full-width round into its parts;
6. print the ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ROUNDS = 3
SEED = 0
# the card's published peaks (H100 SXM data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TPU_KERNELS = {
    "fused_aggregate": "src/repro/kernels/scaled_aggregate.py:66",
    "fsvrg_update": "src/repro/kernels/fsvrg_update.py:36",
}
SOURCES = {
    "fused_aggregate": "src/repro_torch/kernels/csrc/fused_aggregate.cu",
    "fsvrg_update": "src/repro_torch/kernels/csrc/fsvrg_update.cu",
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def log(*parts) -> None:
    print(*parts, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_logreg_config
    from repro_torch.core import (FSVRG, FSVRGConfig, Trainer, build_problem,
                                  make_solver)
    from repro_torch.data import generate
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 yardsticks
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # -- 1. the machine ---------------------------------------------------- #
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    log(f"[machine] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  torch.version.cuda {torch.version.cuda}")
    log(f"[machine] nvcc: {run([_build.nvcc_path(), '--version']).splitlines()[-1]}")
    log(f"[machine] import triton: {has_triton}")
    log(f"[machine] card: {smi}  (device_count {torch.cuda.device_count()})")

    # -- 2. build ---------------------------------------------------------- #
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s in all; per library "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------- #
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {}

    def compare(name, label, got, expect, rtol, atol):
        err = (got.float() - expect.float()).abs()
        bound = atol + rtol * expect.float().abs()
        worst = float(err.max())
        log(f"[check] {name} {label}: max_abs_err {worst:.3e} "
            f"(tolerance {atol:g} + {rtol:g}·|plain|)")
        require(bool((err <= bound).all()), f"{name} {label} disagrees")
        return worst

    K, d = 10_000, 20_002
    # summation order: the kernel adds K in splits of fused multiply-adds,
    # the plain version reduces in torch's order
    for KK, dd, dt in [(K, d, torch.float32), (33, 999, torch.float32),
                       (K, d, torch.bfloat16)]:
        deltas = (torch.randn((KK, dd), device=dev, generator=g) * 0.01).to(dt)
        wts = torch.rand(KK, device=dev, generator=g)
        wts /= wts.sum()
        w_t = torch.randn(dd, device=dev, generator=g)
        a = torch.rand(dd, device=dev, generator=g) * 3 + 1
        s = torch.tensor(1.25, device=dev)
        err = compare("fused_aggregate", f"K={KK} d={dd} {dt}",
                      ops.fused_aggregate(w_t, deltas, wts, a, s),
                      ref.fused_aggregate_ref(w_t, deltas, wts, a, s),
                      1e-5, 1e-6)
        if (KK, dd, dt) == (K, d, torch.float32):
            max_err["fused_aggregate"] = err
        del deltas
    # FMA contraction in the kernel vs separate roundings in the plain
    # version: a few ulp of the f32 operands (|S·diff| reaches ~20); bf16
    # outputs may round apart by one bf16 ulp (2^-8 relative)
    R = 6_478                            # the largest bucket's clients
    for label, shape, shared, dt, tol in [
            ("1-D d=20002 scalar h", (d,), False, torch.float32, 1e-5),
            ("batched R=6478 per-row h", (R, d), False, torch.float32, 1e-5),
            ("broadcast R=6478 (main-path form)", (R, d), True,
             torch.float32, 1e-5),
            ("broadcast R=33 d=999 bf16", (33, 999), True, torch.bfloat16,
             1e-2)]:
        w, S, gn = (torch.randn(shape, device=dev, generator=g).to(dt)
                    for _ in range(3))
        row = shape[-1:] if shared else shape
        go, gb = (torch.randn(row, device=dev, generator=g).to(dt)
                  for _ in range(2))
        h = (torch.rand(shape[0], device=dev, generator=g) if len(shape) == 2
             else 0.37)
        if len(shape) == 2:
            h[::5] = 0.0                 # masked slots are exact no-ops
        got = ops.fsvrg_update(w, S, gn, go, gb, h)
        err = compare("fsvrg_update", label, got,
                      ref.fsvrg_update_ref(w, S, gn, go, gb, h), tol, tol)
        if len(shape) == 2:
            require(torch.equal(got[::5], w[::5]), "h = 0 rows changed")
        if label.startswith("broadcast R=6478"):
            max_err["fsvrg_update"] = err
        del w, S, gn, got
    torch.cuda.empty_cache()

    # -- 4. the main path at full width ------------------------------------ #
    cfg = get_logreg_config()
    log(f"[main] config {cfg.name}: K={cfg.num_clients} d={cfg.num_features}"
        f" n={cfg.num_examples} nnz={cfg.nnz_per_example}")
    sync()
    t0 = time.perf_counter()
    ds = generate(cfg, seed=SEED)
    sync()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = build_problem(ds)
    sync()
    t_build = time.perf_counter() - t0
    m_pads = [b.m_pad for b in prob.buckets]
    log(f"[main] generate {t_gen:.2f} s ({ds.num_examples} train rows);"
        f" build_problem {t_build:.2f} s: {len(prob.buckets)} buckets,"
        " Kb×m_pad " + ", ".join(f"{b.num_clients}×{b.m_pad}"
                                  for b in prob.buckets)
        + f"; Σ m_pad {sum(m_pads)}")
    t0 = time.perf_counter()
    solver = make_solver("fsvrg", prob, aggregator="pallas")
    sync()
    log(f"[main] make_solver {time.perf_counter() - t0:.2f} s")
    f0 = float(prob.flat.loss(torch.zeros(prob.d, device=dev)))

    eval_s, round_end = [], [0.0]

    def eval_fn(w):
        sync()
        t = time.perf_counter()
        f = float(prob.flat.loss(w))
        eval_s.append(time.perf_counter() - t)
        return {"f": f}

    round_s = []

    def callback(state, r):
        sync()
        now = time.perf_counter()
        round_s.append(now - round_end[0] - eval_s[-1])
        round_end[0] = now

    torch.cuda.reset_peak_memory_stats()
    sync()
    ops.reset_launch_counts()
    round_end[0] = time.perf_counter()
    res = Trainer(solver, rounds=ROUNDS, seed=SEED, eval_fn=eval_fn,
                  callback=callback).fit()
    sync()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = [h["f"] for h in res.history]
    log(f"[main] loss: round 0 {f0:.6f} -> " + " -> ".join(
        f"{f:.6f}" for f in hist))
    log("[main] seconds per round: " + ", ".join(f"{s:.3f}" for s in round_s)
        + f"; peak device memory {peak_gb:.2f} GB")
    log(f"[main] launches: {launches} (expected fsvrg_update "
        f"{ROUNDS}×Σ m_pad = {ROUNDS * sum(m_pads)}, fused_aggregate {ROUNDS})")
    require(all(f == f and abs(f) != float("inf") for f in hist),
            "non-finite loss")
    require(hist[-1] < f0 and all(f < f0 for f in hist),
            "the loss did not fall below round 0's")
    require(res.w.shape == (prob.d,) and bool(torch.isfinite(res.w).all()),
            "bad iterate")
    require(launches["fsvrg_update"] == ROUNDS * sum(m_pads),
            "fsvrg_update was not launched once per local step")
    require(launches["fused_aggregate"] == ROUNDS,
            "fused_aggregate was not launched once per round")

    # the same FSVRG on a small problem, kernels on the card vs plain
    # versions on the CPU, same data and same permutations (drawn on the
    # CPU from one generator per round and bucket)
    class SharedDraws(FSVRG):
        def round(self, state, gen):
            self._r = state.round
            return super().round(state, gen)

        def permutations(self, gen, bucket_index, bucket):
            cpu = torch.Generator().manual_seed(1000 * self._r + bucket_index)
            u = torch.rand((bucket.num_clients, bucket.m_pad), generator=cpu)
            return torch.argsort(u, dim=1).to(bucket.idx.device)

    small = generate(get_logreg_config().scaled(0.002), seed=SEED,
                     device="cpu")
    ws = []
    for device in ("cpu", "cuda"):
        p = build_problem(small, device=device)
        sv = SharedDraws(p, FSVRGConfig(aggregator="pallas"), device=device)
        ws.append(Trainer(sv, rounds=ROUNDS, seed=SEED).fit().w.cpu())
    scale = float(ws[0].abs().max())
    err = float((ws[1] - ws[0]).abs().max())
    log(f"[main] small problem (scale 0.002) card vs CPU after {ROUNDS} "
        f"rounds: max_abs_err {err:.3e}, max |w| {scale:.3e} "
        "(tolerance 1e-4·max|w|: summation order and FMA contraction)")
    require(err <= 1e-4 * scale, "card and CPU runs disagree")

    # -- 5. timing ----------------------------------------------------------- #
    def cuda_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    rows = []
    # fused_aggregate at the main path's shape: this run's own deltas
    w = res.w
    fg = prob.flat.grad(w)
    deltas = torch.empty((prob.num_clients, prob.d), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    eng = solver.engine
    wts = torch.cat([eng.bucket_weights(wi, b.num_clients)
                     for wi, b in zip(eng._offsets, prob.buckets)])
    sync()
    pass_s = []
    for bi, (wi, b) in enumerate(zip(eng._offsets, prob.buckets)):
        t = time.perf_counter()
        solver._pass(w, bi, b, gen, deltas[wi:wi + b.num_clients], fg)
        sync()
        pass_s.append(time.perf_counter() - t)
    a = solver.a_diag
    K, d = prob.num_clients, prob.d
    nb, flops = (K * d * 4 + K * 4 + 3 * d * 4), 2 * K * d + 3 * d
    b_ms, b_by = bound(nb, flops)
    rows.append(dict(
        name="fused_aggregate", route="cuda", source=SOURCES["fused_aggregate"],
        replaces=TPU_KERNELS["fused_aggregate"],
        launches=launches["fused_aggregate"],
        max_abs_err=max_err["fused_aggregate"],
        ms=cuda_ms(lambda: ops.fused_aggregate(w, deltas, wts, a, 1.0)),
        plain_ms=cuda_ms(lambda: ref.fused_aggregate_ref(w, deltas, wts, a,
                                                         1.0)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.addcmul(
            w, a, torch.mv(deltas.t(), wts), value=1.0))))
    t = time.perf_counter()
    eng.aggregate(w, deltas)
    sync()
    agg_s = time.perf_counter() - t
    del deltas
    torch.cuda.empty_cache()

    # fsvrg_update in the main path's form at the largest bucket's shape
    big = max(range(len(prob.buckets)),
              key=lambda i: prob.buckets[i].num_clients)
    Kb = prob.buckets[big].num_clients
    wk = w.expand(Kb, d).contiguous()
    S = solver.s_diags[big]
    diff = torch.randn((Kb, d), device=dev, generator=g) * 1e-3
    zero = torch.zeros(d, device=dev)
    hk = solver.h_k[big] * 1e-3
    nb = 16 * Kb * d + 2 * 4 * d + 4 * Kb
    b_ms, b_by = bound(nb, 5 * Kb * d)
    rows.append(dict(
        name="fsvrg_update", route="cuda", source=SOURCES["fsvrg_update"],
        replaces=TPU_KERNELS["fsvrg_update"],
        launches=launches["fsvrg_update"],
        max_abs_err=max_err["fsvrg_update"],
        ms=cuda_ms(lambda: ops.fsvrg_update(wk, S, diff, zero, fg, hk,
                                            out=wk)),
        plain_ms=cuda_ms(lambda: ref.fsvrg_update_ref(wk, S, diff, zero, fg,
                                                      hk, out=wk)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        log(f"[time] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            + ("n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")

    sync()
    t = time.perf_counter()
    prob.flat.grad(w)
    sync()
    prelude_s = time.perf_counter() - t
    steps = sum(m_pads)
    log("[time] one full-width round, in parts: prelude (full gradient) "
        f"{prelude_s:.4f} s, client passes {sum(pass_s):.3f} s over {steps} "
        f"local steps ({sum(pass_s) / steps * 1e6:.1f} µs a step; by bucket "
        + ", ".join(f"{s:.3f}" for s in pass_s) + " s), aggregation "
        f"{agg_s:.4f} s, loss eval {sum(eval_s) / len(eval_s):.4f} s")
    log(f"[time] fsvrg_update at the largest bucket × its {m_pads[big]} steps "
        f"= {rows[1]['ms'] * m_pads[big] / 1e3:.3f} s of that bucket's "
        f"{pass_s[big]:.3f} s")

    # the device's busy share of a round: the device's kernel times for one
    # more full-width round, traced by the profiler (device activity only:
    # tracing the host's ~200k operator calls too takes minutes), over the
    # unprofiled rounds' wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.round(res.state, torch.Generator(device=dev).manual_seed(SEED))
        sync()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    wall_s = sum(round_s) / len(round_s)
    if events:
        log(f"[profile] one round under the profiler "
            f"({time.perf_counter() - t:.1f} s to trace): device busy "
            f"{busy_s:.3f} s of the unprofiled {wall_s:.3f} s round -> "
            f"device idle share {1 - busy_s / wall_s:.1%}")
    else:
        log("[profile] device idle share: not measured (the profiler saw no "
            "device time)")
    for e in events[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}× {e.key[:90]}")

    # -- 6. the result -------------------------------------------------------- #
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
