#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. record the machine: torch and CUDA versions, ``nvcc --version``, whether
   ``import triton`` works, the card's name and power limit;
2. build the nine kernel libraries from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds and
   each library's register and spill report, and ``wkv6``'s, each
   ``wkv6_bwd`` launch's and the robust select's registers, shared
   memory, blocks an SM and spills;
3. hold each kernel, and the three aggregation wrappers, against its plain
   PyTorch version on the card, at the main paths' shapes and at ragged
   small ones, with the stated tolerance (``fused_aggregate`` also at
   K = d = 1, odd d, d ≡ 2 (mod 4), f32 and bf16, a tensor scale, and bit
   for bit from call to call; ``robust_aggregate`` also with 2 % of the
   rows scaled ×100, bit for bit from call to call, at m = 0, 1, 2, heavy
   ties, the f32 floor of trim·m, bf16 deltas and non-finite valid rows;
   ``wkv6`` at the serving prefill's shape in
   both entries — (B·Hn, S, D) and the model's (B, S, Hn, D), whole and
   as a ragged prompt's strided 2,016 tokens, from zeros and a given
   state, f32 and bf16 — at small shapes, with strong decays, and
   refusing a ragged S); then the card's threefry draws, fleet masks and
   fault kinds against the CPU's, bit for bit, and its ``split``,
   ``randint`` (spans on both sides of 2¹⁶), ``permutation`` (n = 1,625,
   1,626 and 8,192), ``gumbel`` and ``floatmath``'s log, pow, sigmoid and
   sums, bit for bit;
4. run the solvers of Fig. 2 at the paper's full width from the seed —
   ``generate`` of the §4 config (K = 10,000 clients, d = 20,002
   features, n = 2,166,693 examples) and ``build_problem`` once; the
   data at scale 0.01, card against CPU (every array equal but on counted
   clients, each a Gumbel pair within 4 ulp), and the engine's Bernoulli
   masks at the full-width layout, card against CPU bit for bit;
   then ``make_solver("fsvrg" | "fedavg" | "dane" | "cocoa" |
   "svrg_naive", aggregator="pallas")`` → ``Trainer`` for 3 rounds each,
   every round on the key ``fold_in(PRNGKey(0), r)`` from which the
   solver draws its masks, permutations and samples on the card — with
   the launch counts set to 0 just before each solver and read just after
   (CoCoA+: one ``cocoa_sdca_pass`` launch a bucket, no
   ``cocoa_sdca_update``; its dual objective must rise every round and
   stay below the primal loss), and the seconds a round's draws take
   beside the round's; CoCoA+'s pass kernel against the plain step loop
   on the card at every full-width bucket and at one with repeated
   features in a row, and a CoCoA+ round through the plain loop, which
   must agree;
   then each solver on a small problem on the card and on the CPU (plain
   versions) from the same seed, each device drawing for itself, which
   must agree; DANE's launches include ``segment_sum`` (its local
   gradient in a fixed order) once a GD step and once for a_k, a bucket;
5. the fault-tolerant rounds at full width: a fleet trace, delta faults
   (NaN / sign / scale / replay) and a guard — FSVRG with the trimmed
   mean, FedAvg with the median (both through ``robust_aggregate``),
   CoCoA+ with the clip guard — 3 rounds each, counts set to 0 just before
   each and read just after, the robust kernel's m checked against the
   realized cohort minus the poisoned clients every round, CoCoA+ + clip's
   first round again through the plain pass, which must agree; the same
   faults unguarded must stop FSVRG in round 0; then the three on a small
   problem on the card and on the CPU, which must agree;
6. the engine's scale paths at the paper's width: FSVRG and FedAvg
   streamed (``client_chunk`` 1,024) beside their plain rounds from the
   same keys, with ``fused_accumulate`` once a chunk and ``fused_epilogue``
   once a round counted and both runs' peak memory; FedAvg and FSVRG
   cohorts at p = 0.1 against the masked rounds, FSVRG + trimmed mean on
   the cohort (``robust_aggregate``'s m = the gathered valid rows), FedAvg's
   cohort under the fleet trace, a forced overflow (``cohort=1``) card
   against CPU; FedAvg over virtual data at K = 10⁴ (per-client deltas
   bit-equal to the materialized data's), 10⁵ and 10⁶ (the peak's growth a
   client against a client's materialized rows); then the fleet campaign
   (``repro_torch.fleet.run_campaign``) at the same width (``[campaign]``):
   FSVRG and GD under the fleet trace killed after 3 rounds and resumed
   (final iterates ``torch.equal``, deterministic events identical; the
   checkpoint's bytes and seconds), GD under NaN faults with the rollback
   rail (round 1 quarantined), FedAvg under them with the trimmed mean
   (``robust_aggregate`` a round, no rollback), GD with an epoch of drift
   a round (and epoch 2's rows at scale 0.002 card against CPU), and the
   reduced rwkv6-3b's bf16 parameters saved and restored on the card;
7. reproduce Fig. 2 at the paper's width from its command
   (``repro_torch.experiments.fig2_convergence`` with FIG2_ARGS: OPT, every
   curve's stepsize sweep for 1 round, FSVRGR, one-shot, the constant and
   majority errors), counts set to 0 just before and read just after, each
   curve's launches against sweep size × rounds × batched steps, its wall
   seconds and the rounds-to-10 %-gap table; the command at scale 0.003 on
   the card against the CPU; then the dense ridge methods in f64
   (Theorem 5: PrimalMethod against DualMethod at K = 1,000, m = 64,
   d = 256, and DANERidge, card against CPU) and Proposition 1 on the card
   in f32;
8. serve rwkv6-3b at full width (32 layers, d 2,560, vocab 65,536, bf16,
   seeded random weights): ``build_model`` → ``launch.serve.serve`` of 8
   prompts of 2,048 tokens and 32 greedy decode steps, counts set to 0
   just before and read just after (``wkv6`` once a layer in the prefill,
   never in decode), logits, states and tokens checked; a second timed
   run; one prompt's prefill against 256 decode steps from an empty cache
   (kernel against the sequential WKV); the reduced config on the card
   against the CPU with the same weights;
9. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events at the main paths' shapes, beside the bound (the least time the
   card could take) — ``segment_sum`` at every bucket of the §4 problem
   against its plain version bit for bit and against the atomic
   ``scatter_add_`` it replaced, then DANE's round from one state with
   either sum, in turns (the fixed-order rounds ``torch.equal``) —
   ``robust_aggregate``'s trimmed mean and median at the faulted cells' m
   and at m = K, ``cocoa_sdca_pass`` at every bucket of a round, the
   host-bound wrappers also by the profiler's device time — ``wkv6`` in
   both entries and the layout copies it no longer needs; break one
   full-width round of each plain solver into its parts; trace one plain
   round of DANE, CoCoA+ and svrg_naive, and a sample of FSVRG's and
   FedAvg's (the prelude and every bucket's first PROFILE_ROWS rows, each
   bucket's device time weighed by its m_pad) over the unprofiled round,
   for the device's idle share, and one full-width prefill for its busy
   share and top operations;
10. train rwkv6-3b, the serving weights and the earlier phases' tensors
   freed first: ``wkv6_bwd`` against autograd through the plain forward
   (the training path's (2, 128, 40, 64) from zeros and from a given
   state with the final state's cotangent, the serving shape, the
   (B·Hn, S, D) entry, a strided slice, one chunk, chunk 16; strong
   decays against the plain backward; two calls bit-equal); the reduced
   config's FSVRG and FedAvg rounds on the card against the CPU; at full
   width in bf16
   (``launch/train.py``'s defaults: 4 clients × 1 step × 2 × 128 tokens)
   2 FSVRG rounds, a FedAvg round and 3 AdamW steps through
   ``launch.steps``, counts set to 0 just before each and read just after
   (2 ``wkv6`` launches and 1 ``wkv6_bwd`` a layer and pass: each layer
   is recomputed in the backward), with seconds, peak memory, finite
   losses and |∇f|, and one more FSVRG round traced for the device's idle
   share and top kernels; ``wkv6_bwd``'s device time (a CUDA graph of
   calls, so without the host's cost) at the training and the serving
   shape beside its bound and autograd through the plain forward, each of
   its three launches (terms, scan, chunk backward) timed apart the same
   way, a call back to back from the host and the host's enqueue alone;
   ``wkv6``'s forward at the training shape;
11. the dense attention family, no custom kernel on its path (every
    kernel's count must stay 0): ``[serve-dense]`` serves llama3-8b
    (8 × 2,048 tokens, 32 decode steps), h2o-danube-1.8b (4 × 8,192:
    twice its window, so the prefill takes the banded path and the decode
    ring wraps; 32 steps), codeqwen1.5-7b and granite-20b (8 × 2,048, 8
    steps) at full width in bf16 through ``launch.serve.serve``, each
    after three checks — ``flash_attention`` (SDPA on a named backend)
    against ``flash_attention_ref`` at one layer's full-width shape, bf16
    and f32, causal and with a binding window; at full width cut to 2
    layers in f32, prefill + ``grow_cache`` + 4 decode steps against the
    longer prefills and 64 decode steps from an empty cache against their
    prefill; the reduced config card against CPU — with init, prefill and
    decode seconds, peak memory and the SDPA calls by backend (checked
    against the path each call must take); ``[train-dense]`` trains
    h2o-danube-1.8b: the loss and gradients at full width cut to 2 layers
    in f32 card against CPU, then at full width in bf16 with
    ``launch/train.py``'s defaults 2 FSVRG rounds, a FedAvg round and 3
    AdamW steps with seconds, peak memory and finite losses;
12. the MoE family, no custom kernel on its path: ``[serve-moe]`` serves
    phi3.5-moe (full width, 24 of its 32 layers: 8 × 2,048 tokens, 32
    decode steps) and dbrx-132b (full width, 4 of 40 layers: 4 × 2,048
    tokens, 8 steps) in bf16 through ``launch.serve.serve``, each after
    ``moe_fwd`` at full width card against CPU (f32 and bf16, the same
    dispatch) and the reduced config's serve card against CPU — init,
    prefill (routed and dispatched TFLOP/s) and decode seconds, peak
    memory, the prefill's tokens an expert and the pairs capacity dropped,
    the decode's idle share; ``[train-moe]`` trains phi3.5-moe at full
    width cut to 2 layers as ``[train-dense]`` trains danube;
13. print the ``kernels`` JSON line, the ``nvidia-smi`` line, and as the
    last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
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
BF16_FLOP_PER_S = 989e12
#: the kernels line: a row for each of the reference's seven TPU kernels,
#: named for the kernel that runs it on the main path (the SDCA solve's:
#: the pass entry, one launch a bucket; the coordinate entry is timed
#: apart), one for wkv6's backward and one for DANE's fixed-order local
#: gradient sum
TPU_KERNELS = {
    "fused_aggregate": "src/repro/kernels/scaled_aggregate.py:66",
    # the same TPU kernel's entries the streamed and cohort rounds launch
    "fused_accumulate": "src/repro/kernels/scaled_aggregate.py:100",
    "fused_epilogue": "src/repro/kernels/scaled_aggregate.py:111",
    "fsvrg_update": "src/repro/kernels/fsvrg_update.py:36",
    "fedavg_update": "src/repro/kernels/fedavg_update.py:39",
    "dane_update": "src/repro/kernels/dane_update.py:51",
    "cocoa_sdca_pass": "src/repro/kernels/cocoa_sdca.py:55",
    "robust_aggregate": "src/repro/kernels/robust_aggregate.py:67",
    "wkv6": "src/repro/kernels/wkv6.py:71",
    # the backward of the same TPU kernel (which has none: the reference
    # differentiates its jnp _wkv_chunked, src/repro/models/rwkv.py:73)
    "wkv6_bwd": "src/repro/kernels/wkv6.py:71",
    # no TPU kernel: DANE's local gradient, an XLA scatter-add in the
    # reference (its data grad's .at[idx].add), summed in a fixed order
    "segment_sum": "src/repro/core/dane.py:114",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "fused_aggregate": CSRC + "fused_aggregate.cu",
    "fused_accumulate": CSRC + "fused_aggregate.cu",
    "fused_epilogue": CSRC + "fused_aggregate.cu",
    "fsvrg_update": CSRC + "fsvrg_update.cu",
    "fedavg_update": CSRC + "fedavg_update.cu",
    "dane_update": CSRC + "dane_update.cu",
    "cocoa_sdca_pass": CSRC + "cocoa_sdca.cu",
    "robust_aggregate": CSRC + "robust_aggregate.cu",
    "wkv6": CSRC + "wkv6.cu",
    "wkv6_bwd": CSRC + "wkv6_bwd.cu",
    "segment_sum": CSRC + "segment_sum.cu",
}
#: solver -> the kernel its client pass launches
STEP_KERNEL = {"fsvrg": "fsvrg_update", "fedavg": "fedavg_update",
               "dane": "dane_update", "cocoa": "cocoa_sdca_pass",
               "svrg_naive": "fsvrg_update"}
#: the solvers whose round starts with the full gradient (the prelude)
PRELUDE = ("fsvrg", "dane", "svrg_naive")
# about 20 f32 operations a Newton step (log and divisions counted as one)
# and 5 for the start: the SDCA solve's work per coordinate at 12 steps
SDCA_OPS_PER_COORD = 5 + 12 * 20
#: the fault-tolerant runs: solver -> its guard; all share one fleet trace
#: and one fault mix (the reference's campaign defaults, scaled up)
GUARDED = {"fsvrg": dict(aggregator_guard="trimmed_mean", guard_trim=0.1),
           "fedavg": dict(aggregator_guard="median"),
           "cocoa": dict(aggregator_guard="clip")}
FAULT_RATES = dict(nan_rate=0.01, sign_rate=0.05, scale_rate=0.02,
                   replay_rate=0.02)
#: the serving cell: rwkv6-3b at full width in bf16, REQUESTS prompts of
#: PROMPT_LEN tokens, then DECODE_STEPS greedy decode steps
ARCH = "rwkv6-3b"
REQUESTS, PROMPT_LEN, DECODE_STEPS = 8, 2048, 32
#: a ragged prompt length: wkv6 over 2,016 tokens, the sequential WKV over
#: the tail of 31 from the kernel's state
RAGGED_LEN = 2047
#: the full-width prefill-vs-decode check: one prompt of this length, and
#: of one token less (ragged: wkv6 over 224, a sequential tail of 31)
CONSISTENCY_LEN = 256
#: decode steps traced for the device's idle share
DECODE_PROFILED = 8
#: FSVRG's and FedAvg's traced sample of a round: the prelude and, of
#: every bucket, a pass over its first PROFILE_ROWS rows (of its m_pad)
PROFILE_ROWS = 128
#: the training cell: rwkv6-3b at full width in bf16 with launch/train.py's
#: defaults (TRAIN_CLIENTS clients, 1 local step, 2 sequences of TRAIN_SEQ
#: tokens a client, stepsize 0.5, AdamW lr 3e-4): FSVRG_ROUNDS FSVRG
#: rounds, a FedAvg round, then ADAMW_STEPS AdamW steps
TRAIN_CLIENTS, TRAIN_LOCAL_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 1, 2, 128
TRAIN_STEPSIZE, TRAIN_LR = 0.5, 3e-4
FSVRG_ROUNDS, ADAMW_STEPS = 2, 3
#: (B, S, Hn, D) of wkv6_bwd on the training path, and at the serving shape
TRAIN_WKV = (TRAIN_BATCH, TRAIN_SEQ, 40, 64)
SERVE_WKV = (REQUESTS, PROMPT_LEN, 40, 64)
#: Fig. 2 from its command at the paper's width (one round of each curve,
#: which keeps the whole script near half its time limit), and a small run
#: of it on the card and on the CPU
FIG2_ARGS = ["--scale", "1.0", "--rounds", "1", "--opt-iters", "500",
             "--algo", "all"]
FIG2_SMALL = ["--scale", "0.003", "--rounds", "2"]
#: Theorem 5 on the card: (K, m, d) equal-size dense clients, f64
DENSE_SHAPE = (1_000, 64, 256)
DENSE_ROUNDS = 5
#: the engine's scale paths: the §4 problem streamed SCALE_CHUNK clients at
#: a time for SCALE_ROUNDS rounds, a cohort at participation SCALE_P, and
#: FedAvg over virtual data at VIRTUAL_KS clients in chunks of
#: VIRTUAL_CHUNK (bit-equal deltas against the materialized data at
#: VIRTUAL_SMALL_K).  The chunk is below the smallest bucket at K = 10⁵
#: (16,077 clients), so both K run chunks of one shape and the peak's
#: growth between them is what grows with K
SCALE_CHUNK, SCALE_ROUNDS, SCALE_P = 1_024, 2, 0.1
VIRTUAL_KS, VIRTUAL_CHUNK, VIRTUAL_SMALL_K = (100_000, 1_000_000), 8_192, 10_000
#: the fleet campaign at the §4 width (``CampaignSpec.scale`` 1.0: K =
#: 10,000, d = 20,002): kill and resume over CAMPAIGN_ROUNDS rounds, the
#: rollback rail and the engine's trimmed mean under CAMPAIGN_FAULTS (NaN
#: poisoning in round 1), drift epochs, and the drift rows at DRIFT_SMALL
#: card against CPU; its files go to CAMPAIGN_DIR (gitignored) and are
#: removed after
CAMPAIGN_SCALE, CAMPAIGN_ROUNDS = 1.0, 4
CAMPAIGN_FAULTS = "nan=0.4,seed=1,start=1,stop=2"
DRIFT_SMALL = 0.002
CAMPAIGN_DIR = ROOT / "build" / "campaign"
#: the dense attention family at full width in bf16, seeded random
#: weights: arch -> (prompts, prompt tokens, decode steps).  danube's
#: prompts are twice its 4,096-token window: the prefill takes the banded
#: path and the decode ring wraps
DENSE_SERVE = {"llama3-8b": (8, 2048, 32), "h2o-danube-1.8b": (4, 8192, 32),
               "codeqwen1.5-7b": (8, 2048, 8), "granite-20b": (8, 2048, 8)}
#: the continuation check (full width, 2 layers, f32, 2 prompts of the
#: serving length): DENSE_CONT_STEPS tokens decoded from the grown prefill
#: cache against the prefill of the longer prompt; decode of
#: DENSE_EMPTY_LEN tokens from an empty cache against their prefill
DENSE_CONT_STEPS, DENSE_EMPTY_LEN = 4, 64
#: the attention check's window where the config has none: a quarter of
#: the prompt, so that it binds
DENSE_CHECK_WINDOW = 512
#: flash_attention and decode_attention against their plain versions:
#: (atol, rtol), tolerance atol + rtol·|plain| element by element.  f32:
#: the same f32 terms summed in other orders.  bf16: both round the output
#: to bf16, which may differ by an ulp (≤ 2^-7 of |x|, so rtol 2^-6 is two);
#: the probabilities rounded to bf16 with other maxima add an absolute
#: error (atol: the largest that the served shapes needed beside that rtol
#: on an H100, 1.3e-3, a little over doubled); a typical output over
#: 2,048 keys is 2e-2 to 5e-2, so a few keys too many or too few show
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-3, 2 ** -6)}
#: decode_attention's check: the cache's slots past n_valid hold keys of
#: DECODE_POISON and values of 10·DECODE_POISON, so that one of them
#: counted would move the output far past the tolerance
DECODE_POISON = 30.0
#: the dense training cell: h2o-danube-1.8b at full width in bf16, with
#: launch/train.py's defaults (the training constants above)
DENSE_TRAIN_ARCH = "h2o-danube-1.8b"
#: the MoE family at full width in bf16, seeded random weights, depth cut
#: to fit one 80 GB card: arch -> (layers, prompts, prompt tokens, decode
#: steps).  phi3.5-moe's 32 layers are 83.7 GB of bf16 weights, more than
#: the card holds beside a cache and the dispatch buffers: 24 layers are
#: 62.9 GB; dbrx-132b's 4 of 40 layers (28.5 GB) check the top-4 dispatch
MOE_SERVE = {"phi3.5-moe-42b-a6.6b": (24, 8, 2048, 32),
             "dbrx-132b": (4, 4, 2048, 8)}
#: moe_fwd card against CPU at a config's full width: one layer's weights,
#: MOE_CHECK_SEQ tokens; tolerance on max |card − CPU| over max |CPU| by
#: dtype.  f32: the same f32 sums in other orders, 7.8e-7 (phi3.5) and
#: 7.1e-7 (dbrx) on an H100, so 1e-5; bf16: the products and the
#: weighted combine rounded to bf16 at other points, 5.2e-3 and 6.3e-3
#: (an ulp is 3.9e-3 of a value), so 1.5e-2
MOE_CHECK_SEQ = 32
MOE_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
#: the MoE training cell: phi3.5-moe at full width cut to 2 layers
#: (2.87 B parameters) in bf16 with launch/train.py's defaults
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "phi3.5-moe-42b-a6.6b", 2


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def log(*parts) -> None:
    print(*parts, flush=True)


def wkv6_inputs(dev, gen, BH, S, D, dtype=None, spread=1.0, heads=None):
    """r, k, v ~ N(0, 1), RWKV-like decays w = exp(−exp(−6 + spread·N(0, 1)))
    and a nonzero bonus u ~ 0.1·N(0, 1) (a fresh model's u is 0): (BH, S,
    D) and (BH, D), or with ``heads`` the model's (BH, S, heads, D) and
    (heads, D)."""
    import torch
    shape = (BH, S, D) if heads is None else (BH, S, heads, D)
    r, k, v = (torch.randn(shape, device=dev, generator=gen)
               for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + spread * torch.randn(
        shape, device=dev, generator=gen)))
    u = torch.randn((shape[0] if heads is None else heads, D), device=dev,
                    generator=gen) * 0.1
    if dtype is not None:
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    return r, k, v, w, u


def check_wkv6(dev, gen, compare) -> float:
    """wkv6 against its plain version on the card, from a zero and from a
    given start state, in both entries ((B·Hn, S, D) and the model's
    (B, S, Hn, D)); returns the max abs error at the serving shape in f32.

    Tolerance |kernel − plain| ≤ 1e-6·max|plain| + rtol·|plain|: both add
    the same f32 terms, the kernel in FMAs and its own order (atol scales
    with the largest term summed, not with the element); rtol 1e-5 in f32,
    1e-2 for a bf16 out (one bf16 ulp is 2^-8 relative).  The state is f32
    in both."""
    import torch
    from repro_torch.kernels import ops, ref
    serving = (REQUESTS * 40, PROMPT_LEN, 64)
    worst = 0.0
    for (BH, S, D), chunk, dt, spread, given in [
            (serving, 32, torch.float32, 1.0, False),
            (serving, 32, torch.float32, 1.0, True),
            ((8, 64, 64), 32, torch.float32, 1.0, True),
            ((8, 16, 64), 16, torch.float32, 1.0, True),
            ((8, 128, 64), 32, torch.bfloat16, 1.0, True),
            ((2, 32, 8), 32, torch.float32, 1.0, False),
            ((2, 64, 8), 32, torch.float32, 1.0, False),
            ((3, 96, 8), 32, torch.float32, 1.0, False),
            ((2, 32, 64), 32, torch.float32, 1.0, False),
            ((3, 64, 64), 32, torch.float32, 1.0, False),
            ((2, 96, 64), 32, torch.float32, 1.0, False),
            ((2, 16, 64), 16, torch.float32, 1.0, False),
            ((4, 128, 64), 32, torch.bfloat16, 1.0, False),
            ((4, 128, 64), 32, torch.float32, 3.0, False)]:
        x = wkv6_inputs(dev, gen, BH, S, D, dt, spread)
        s0 = (0.5 * torch.randn((BH, D, D), device=dev, generator=gen)
              if given else None)
        out, st = ops.wkv6(*x, chunk, state=s0)
        torch.cuda.synchronize()
        p_out, p_st = ref.wkv6_ref(*x, chunk, state=s0)
        label = (f"BH={BH} S={S} D={D} chunk={chunk} {dt} decay spread "
                 f"{spread}, {'a given' if given else 'zero'} start state")
        require(out.dtype == dt and st.dtype == torch.float32,
                f"wkv6 {label}: wrong output dtypes")
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
        err = compare("wkv6", label + " out", out, p_out, rtol,
                      1e-6 * float(p_out.float().abs().max()))
        compare("wkv6", label + " state", st, p_st, 1e-5,
                1e-6 * float(p_st.abs().max()))
        if (BH, S, D) == serving:
            worst = max(worst, err)
        del x, s0, out, st, p_out, p_st
    # the entry the model calls: its (B, S, Hn, D) projections read in
    # place, whole or as a ragged prompt's whole chunks (the first 2,016 of
    # 2,047 tokens: a view with the batch stride of 2,047)
    B, Hn, D = REQUESTS, 40, 64
    for S, n in ((PROMPT_LEN, PROMPT_LEN),
                 (RAGGED_LEN, RAGGED_LEN - RAGGED_LEN % 32)):
        for dt in (torch.float32, torch.bfloat16):
            for given in (False, True):
                *x, u = wkv6_inputs(dev, gen, B, S, D, dt, heads=Hn)
                views = [t[:, :n] for t in x]
                s0 = (0.5 * torch.randn((B, Hn, D, D), device=dev,
                                        generator=gen) if given else None)
                out, st = ops.wkv6(*views, u, state=s0)
                torch.cuda.synchronize()
                p_out, p_st = ref.wkv6_ref(*views, u, state=s0)
                label = (f"(B, S, Hn, D) = ({B}, {n}, {Hn}, {D})"
                         + (f" of {S} tokens" if n < S else "")
                         + f" {dt}, {'a given' if given else 'zero'} start "
                         "state")
                require(out.shape == (B, n, Hn, D) and out.is_contiguous()
                        and out.dtype == dt and st.shape == (B, Hn, D, D)
                        and st.dtype == torch.float32,
                        f"wkv6 {label}: wrong output shapes or dtypes")
                rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
                err = compare("wkv6", label + " out", out, p_out, rtol,
                              1e-6 * float(p_out.float().abs().max()))
                compare("wkv6", label + " state", st, p_st, 1e-5,
                        1e-6 * float(p_st.abs().max()))
                if dt == torch.float32:
                    worst = max(worst, err)
                del x, views, s0, out, st, p_out, p_st
    r = torch.zeros((1, 33, 8), device=dev)
    try:
        ops.wkv6(r, r, r, r, torch.zeros((1, 8), device=dev))
    except ValueError:
        log("[check] wkv6 S=33 chunk=32: raises ValueError, as the TPU "
            "kernel does")
    else:
        raise RuntimeError("chip_smoke: wkv6 took a ragged S")
    return worst


def serve_phase(dev, sync) -> dict:
    """Serve rwkv6-3b at full width and check it: the main path's run with
    its launch counts, a second timed run, a run of ragged prompts with its
    launch counts, the full-width prefill-vs-decode check and the small
    card-vs-CPU check.  Returns what the timing and
    profile phases need."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(ARCH)
    Hn, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    log(f"[serve] {cfg.name} ({cfg.citation}): {cfg.num_layers} layers, "
        f"d {cfg.d_model}, {Hn} heads of {hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B parameters, "
        "bf16")
    model = build_model(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    sync()
    log(f"[serve] init {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (REQUESTS, PROMPT_LEN),
                           generator=gen, device=dev)
    V = cfg.vocab_size
    runs = []
    sync()
    # what the earlier phases and the weights hold, apart from serving
    held = torch.cuda.memory_allocated() / 1e9
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[serve] weights {weights / 1e9:.3f} GB; {held:.2f} GB allocated "
        "before the runs (weights and the earlier phases' tensors)")
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sync()
        ops.reset_launch_counts()
        res = serve(model, params, prompt, DECODE_STEPS + 1)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        runs.append((res, launches, peak))
        n_tok = REQUESTS * PROMPT_LEN
        log(f"[serve] run {i + 1}: prefill {REQUESTS} × {PROMPT_LEN} tokens "
            f"in {res.prefill_s:.4f} s ({n_tok / res.prefill_s:.0f} tok/s); "
            f"{DECODE_STEPS} decode steps in {res.decode_s:.4f} s "
            f"({res.decode_s / DECODE_STEPS * 1e3:.2f} ms a step, "
            f"{REQUESTS * DECODE_STEPS / res.decode_s:.1f} tok/s); peak "
            f"{peak:.2f} GB allocated, {peak - held:.2f} GB above what was "
            f"held before; launches {launches}")
    res, launches, _ = runs[0]
    # the main path: one wkv6 launch a layer in the prefill, none in decode
    require(launches["wkv6"] == cfg.num_layers,
            f"wkv6 launched {launches['wkv6']} times, not once a layer")
    require(all(n == 0 for k, n in launches.items() if k != "wkv6"),
            "serving launched another kernel")
    require(res.tokens.shape == (REQUESTS, DECODE_STEPS + 1)
            and bool(((res.tokens >= 0) & (res.tokens < V)).all()),
            "generated tokens out of range")
    require(res.logits.shape == (REQUESTS, V)
            and bool(torch.isfinite(res.logits.float()).all()),
            "non-finite logits")
    require(res.cache["len"] == PROMPT_LEN + DECODE_STEPS, "cache length")
    for j, layer in enumerate(res.cache["layers"]):
        require(layer["wkv"].shape == (REQUESTS, Hn, hd, hd)
                and bool(torch.isfinite(layer["wkv"]).all()),
                f"layer {j}: non-finite wkv state")
    require(torch.equal(runs[1][0].tokens, res.tokens),
            "two runs generated different tokens")
    log(f"[serve] launches in the main path's run: wkv6 "
        f"{launches['wkv6']} (one a layer in the prefill; decode runs the "
        "sequential WKV), every other kernel 0; tokens in [0, V), logits and all "
        f"{cfg.num_layers} wkv states finite; first tokens "
        f"{res.tokens[0, :8].tolist()}")

    # a ragged prompt: the same requests cut to RAGGED_LEN tokens; the
    # prefill still launches wkv6 once a layer (over the whole chunks) and
    # runs the sequential WKV over the tail only
    ragged = prompt[:, :RAGGED_LEN]
    sync()
    ops.reset_launch_counts()
    res_r = serve(model, params, ragged, DECODE_STEPS + 1)
    launches_r = ops.launch_counts()
    n_tok = REQUESTS * RAGGED_LEN
    log(f"[serve] ragged run: prefill {REQUESTS} × {RAGGED_LEN} tokens in "
        f"{res_r.prefill_s:.4f} s ({n_tok / res_r.prefill_s:.0f} tok/s); "
        f"{DECODE_STEPS} decode steps in {res_r.decode_s:.4f} s "
        f"({res_r.decode_s / DECODE_STEPS * 1e3:.2f} ms a step); launches "
        f"{launches_r}")
    require(launches_r["wkv6"] == cfg.num_layers
            and all(n == 0 for k, n in launches_r.items() if k != "wkv6"),
            f"ragged prompt: launches {launches_r}, not one wkv6 a layer")
    require(bool(((res_r.tokens >= 0) & (res_r.tokens < V)).all())
            and bool(torch.isfinite(res_r.logits.float()).all())
            and all(bool(torch.isfinite(layer["wkv"]).all())
                    for layer in res_r.cache["layers"]),
            "ragged prompt: non-finite logits or states, or tokens out of "
            "range")
    del res_r

    # full width: the prefill (wkv6 kernel) against token-by-token decode
    # from an empty cache (sequential WKV, no kernel), same weights, in f32
    # (the bf16 weights cast up), for CONSISTENCY_LEN tokens and for one
    # token less (ragged: wkv6 then a sequential tail).  The two paths add
    # the same terms in other orders, an error that grows with depth: held
    # at 5e-4 of each quantity's max, which a bf16 computation (≈ 5e-2)
    # fails.
    one = prompt[:1, :CONSISTENCY_LEN]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    m32 = build_model(cfg, torch.float32)
    p32 = copy.deepcopy(params).float()
    cut = CONSISTENCY_LEN - 1
    ops.reset_launch_counts()
    prefilled = {n: m32.prefill(p32, {"tokens": one[:, :n]})
                 for n in (CONSISTENCY_LEN, cut)}
    sync()
    n_prefill = ops.launch_counts()["wkv6"]
    ops.reset_launch_counts()
    decoded = {}
    cache_d = m32.init_cache(1, CONSISTENCY_LEN)
    for t in range(CONSISTENCY_LEN):
        logits_d, cache_d = m32.decode_step(p32, one[:, t:t + 1], cache_d)
        if t + 1 in prefilled:
            decoded[t + 1] = (logits_d, cache_d)
    sync()
    n_decode = ops.launch_counts()["wkv6"]
    require(n_prefill == 2 * cfg.num_layers and n_decode == 0,
            f"wkv6 launches: prefill {n_prefill}, decode {n_decode}")
    worst = 0.0
    for n, (logits_p, cache_p) in prefilled.items():
        logits_d, cache_d = decoded[n]
        gaps = [rel(logits_p, logits_d)] + [
            rel(a["wkv"], b["wkv"])
            for a, b in zip(cache_p["layers"], cache_d["layers"])]
        worst = max(worst, *gaps)
        log(f"[serve] f32 prefill of {n} tokens vs {n} decode steps "
            f"(1 request, full width): logits max abs err {gaps[0]:.3e} of "
            f"max |logit| {float(logits_d.abs().max()):.3f}; wkv states "
            f"worst {max(gaps[1:]):.3e} (layer "
            f"{gaps[1:].index(max(gaps[1:]))}) of each layer's max")
    log(f"[serve] wkv6 launches: {n_prefill} in the two prefills, "
        f"{n_decode} in the decode steps")
    require(worst <= 5e-4,
            "full-width f32 prefill and decode disagree (tolerance 5e-4)")
    del m32, p32, prefilled, decoded, cache_d
    torch.cuda.empty_cache()

    # the reduced config in f32, the same weights on the card and the CPU;
    # decode feeds both the CPU's greedy token.  f32 sums in other orders
    # (cuBLAS, the kernel): 1e-4 of each quantity's max.
    small = cfg.reduced()
    m_cpu = build_model(small, torch.float32, "cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SEED))
    m_dev = build_model(small, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(dev)
    all_toks = torch.randint(0, small.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(SEED))
    for S in (64, 47):                     # 47: a ragged tail of 15 tokens
        toks = all_toks[:, :S]
        lc, cc = m_cpu.prefill(p_cpu, {"tokens": toks})
        ld, cd = m_dev.prefill(p_dev, {"tokens": toks.to(dev)})
        errs = [rel(ld.cpu(), lc)]
        errs += [rel(b[k].cpu(), a[k])
                 for a, b in zip(cc["layers"], cd["layers"]) for k in a]
        for _ in range(4):
            tok = lc.argmax(-1)[:, None]
            lc, cc = m_cpu.decode_step(p_cpu, tok, cc)
            ld, cd = m_dev.decode_step(p_dev, tok.to(dev), cd)
            errs.append(rel(ld.cpu(), lc))
        log(f"[serve] {small.name} f32 card vs CPU, prefill 2 × {S} and 4 "
            f"decode steps: worst error {max(errs):.3e} of the quantity's "
            "max (tolerance 1e-4)")
        require(max(errs) <= 1e-4, "card and CPU serving disagree")
    return dict(model=model, params=params, prompt=prompt,
                launches=launches, runs=runs)


def _rel(a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _attn_err(err, ref, atol, rtol) -> str:
    """max_abs_err, the output's typical size, and the least atol that the
    reading needs beside ``rtol``."""
    a = ref.float().abs()
    need = float((err - rtol * a).max())
    return (f"max_abs_err {float(err.max()):.3e}, median |plain| "
            f"{float(a.median()):.3e}, needs atol {max(need, 0.0):.3e} "
            f"beside rtol {rtol:.3g} (tolerance {atol:g} + {rtol:.3g}·"
            "|plain|)")


def plain_decode_attention(q, k_cache, v_cache, n_valid):
    """The reference's ``decode_attention`` in torch operations: f32 scores
    over every cache slot, those at or past ``n_valid`` masked, softmax in
    f32, probabilities cast to v's dtype, P·V in f32, out in q's dtype."""
    import torch
    B, _, H, Dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * Dh ** -0.5
    mask = torch.arange(Smax, device=q.device) < n_valid
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def check_decode_attention(cfg, dev, B, slots, n_served) -> None:
    """``decode_attention`` (SDPA, the path every served decode step takes)
    against :func:`plain_decode_attention` on the card, at the served
    cache's full-width shape (B, slots, Hkv, Dh), q, k, v ~ N(0, 1), in
    bf16 and f32: with the ``n_served`` valid slots of the served steps and
    with a third of the slots, the rest poisoned (DECODE_POISON)."""
    import torch
    from repro_torch.models import layers as L

    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        atol, rtol = ATTN_TOL[name]
        q = torch.randn((B, 1, H, Dh), generator=g, device=dev).to(dtype)
        kc, vc = (torch.randn((B, slots, Hkv, Dh), generator=g, device=dev)
                  .to(dtype) for _ in range(2))
        for n in sorted({*n_served, slots // 3 + 1}):
            k, v = kc.clone(), vc.clone()
            k[:, n:], v[:, n:] = DECODE_POISON, 10 * DECODE_POISON
            L.reset_sdpa_backends()
            got = L.decode_attention(q, k, v, n)
            used = dict(L.SDPA_BACKENDS)
            ref = plain_decode_attention(q, k, v, n)
            err = (got.float() - ref.float()).abs()
            log(f"[serve-dense] {cfg.name} decode attention {B} × 1 × "
                f"{H}/{Hkv} heads × {Dh} over {n} of {slots} slots, {name}:"
                f" SDPA {used} vs the plain softmax, "
                + _attn_err(err, ref, atol, rtol))
            require(got.dtype == dtype and got.shape == q.shape,
                    "decode_attention's output dtype or shape")
            require(used == {"decode:" + L._dense_backend(dtype): 1},
                    f"{cfg.name}: decode attention took {used}")
            require(bool((err <= atol + rtol * ref.float().abs()).all()),
                    f"{cfg.name}: decode_attention disagrees with its plain "
                    "version")
        del q, kc, vc, k, v, got, ref, err
    torch.cuda.empty_cache()


def dense_prefill_flops(cfg, B, S) -> int:
    """The operations that a dense config's prefill of B × S tokens needs:
    each layer's weight products for every token, causal attention
    (QK^T and P·V over each query's min(q + 1, window) keys) and the
    unembedding of the last token of each prompt, two a multiply-add."""
    d, H, Hkv, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    mats = 3 if cfg.mlp_style == "swiglu" else 2
    weights = 2 * d * H * Dh + 2 * d * Hkv * Dh + mats * d * cfg.d_ff
    W = cfg.sliding_window or S
    keys = sum(min(i + 1, W) for i in range(S))
    per_layer = 2 * weights * B * S + 4 * B * H * Dh * keys
    return cfg.num_layers * per_layer + 2 * B * d * cfg.vocab_size


def check_attention(cfg, dev, B, S) -> None:
    """``flash_attention`` (SDPA) against ``flash_attention_ref`` (the
    reference's blocked online softmax) on the card at one layer of
    ``cfg``'s full width, q, k, v ~ N(0, 1) of (B, S, H or Hkv, Dh): bf16
    and f32, causal and with a binding window (the config's, or
    DENSE_CHECK_WINDOW)."""
    import torch
    from repro_torch.models import layers as L

    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    window = cfg.sliding_window or DENSE_CHECK_WINDOW
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, S, H, Dh), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        for win in (None, window):
            L.reset_sdpa_backends()
            got = L.flash_attention(q, k, v, causal=True, window=win)
            used = dict(L.SDPA_BACKENDS)
            ref = L.flash_attention_ref(q, k, v, causal=True, window=win)
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            err = (got.float() - ref.float()).abs()
            log(f"[serve-dense] {cfg.name} attention {B} × {S} × {H}/{Hkv} "
                f"heads × {Dh}, {str(dtype).split('.')[-1]}, "
                + ("causal" if win is None else f"window {win}")
                + f": SDPA {used} vs the blocked softmax, "
                + _attn_err(err, ref, atol, rtol))
            require(got.dtype == dtype and got.shape == q.shape,
                    "flash_attention's output dtype or shape")
            require(bool((err <= atol + rtol * ref.float().abs()).all()),
                    f"{cfg.name}: flash_attention disagrees with its plain "
                    "version")
            require(not any(k.startswith("cpu") for k in used),
                    "attention ran on the CPU")
        del q, k, v, got, ref, err
    torch.cuda.empty_cache()


def check_dense_decode(cfg, dev, S) -> None:
    """At ``cfg``'s full width cut to 2 layers, in f32: prefill(S) +
    ``grow_cache`` + DENSE_CONT_STEPS decode steps against prefill(S + k)
    for each k, and DENSE_EMPTY_LEN decode steps from an empty cache
    against their prefill (2 prompts); tolerance 1e-3 of max |logit|
    (f32 sums in other orders; the reference's overwrite of the last
    prompt token moves them by about 1e-1)."""
    import torch
    from repro_torch.models import build_model

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    m = build_model(cfg2, torch.float32)
    p = m.init(torch.Generator(device=dev).manual_seed(SEED))
    K = DENSE_CONT_STEPS
    toks = torch.randint(0, cfg.vocab_size, (2, S + K), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 2))
    _, cache = m.prefill(p, {"tokens": toks[:, :S]})
    cache = m.grow_cache(cache, S + K)
    errs = []
    for t in range(K):
        logits, cache = m.decode_step(p, toks[:, S + t:S + t + 1], cache)
        want, _ = m.prefill(p, {"tokens": toks[:, :S + t + 1]})
        errs.append(_rel(logits, want))
    ring = cache["layers"][0]["k"].shape[1]
    log(f"[serve-dense] {cfg.name} 2 layers f32: prefill 2 × {S}, grow_cache "
        f"to {ring} slots, {K} decode steps vs prefill of {S + 1}..{S + K} "
        f"tokens: logits error {max(errs):.3e} of max |logit| (tolerance "
        "1e-3)")
    require(max(errs) <= 1e-3, f"{cfg.name}: the decode continuation "
            "disagrees with the longer prefill")
    n = DENSE_EMPTY_LEN
    want, _ = m.prefill(p, {"tokens": toks[:, :n]})
    cache = m.init_cache(2, n)
    for t in range(n):
        logits, cache = m.decode_step(p, toks[:, t:t + 1], cache)
    err = _rel(logits, want)
    log(f"[serve-dense] {cfg.name} 2 layers f32: {n} decode steps from an "
        f"empty cache vs prefill of {n}: logits error {err:.3e} of max "
        "|logit| (tolerance 1e-3)")
    require(err <= 1e-3, f"{cfg.name}: decode from an empty cache "
            "disagrees with prefill")
    del m, p, cache, logits, want
    torch.cuda.empty_cache()


def check_dense_small(cfg, dev, tag="serve-dense") -> None:
    """The reduced config in f32, the same weights on the card and the
    CPU: prefill of 2 × 128 tokens (past the reduced window of 64, where
    there is one), the cache grown, 4 decode steps fed the CPU's greedy
    token; 1e-4 of each quantity's max."""
    import copy

    import torch
    from repro_torch.models import build_model

    small = cfg.reduced()
    m_cpu = build_model(small, torch.float32, "cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SEED))
    m_dev = build_model(small, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(dev)
    toks = torch.randint(0, small.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(SEED))
    lc, cc = m_cpu.prefill(p_cpu, {"tokens": toks})
    ld, cd = m_dev.prefill(p_dev, {"tokens": toks.to(dev)})
    errs = [_rel(ld.cpu(), lc)]
    errs += [_rel(b[k].cpu(), a[k])
             for a, b in zip(cc["layers"], cd["layers"]) for k in a]
    cc, cd = m_cpu.grow_cache(cc, 132), m_dev.grow_cache(cd, 132)
    for _ in range(4):
        tok = lc.argmax(-1)[:, None]
        lc, cc = m_cpu.decode_step(p_cpu, tok, cc)
        ld, cd = m_dev.decode_step(p_dev, tok.to(dev), cd)
        errs.append(_rel(ld.cpu(), lc))
    log(f"[{tag}] {small.name} f32 card vs CPU, prefill 2 × 128, "
        f"4 decode steps: worst error {max(errs):.3e} of the quantity's "
        "max (tolerance 1e-4)")
    require(max(errs) <= 1e-4, f"{small.name}: card and CPU disagree")


def profile_decode(label, model, params, res, sync) -> None:
    """DECODE_PROFILED more decode steps after a ``serve`` run ``res``,
    traced on the device alone: busy time and kernels a step against the
    unprofiled run's wall time a step (the device's idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, n = res.tokens.shape
    steps = n - 1
    cache = model.grow_cache(res.cache, res.cache["len"] + 1 + DECODE_PROFILED)
    tok = res.tokens[:, -1:]
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(DECODE_PROFILED):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits.argmax(-1)[:, None]
        sync()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_step = sum(e.self_device_time_total
                    for e in events) / 1e3 / DECODE_PROFILED
    step_ms = res.decode_s / steps * 1e3
    n_kernels = sum(e.count for e in events) / DECODE_PROFILED
    log(f"[profile] {label} decode, {DECODE_PROFILED} steps of {B} tokens: "
        f"device busy {busy_step:.3f} ms a step of the unprofiled "
        f"{step_ms:.3f} ms -> device idle share "
        + (f"{1 - busy_step / step_ms:.1%}" if events else "not measured")
        + f"; {n_kernels:.0f} device kernels a step; top: "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                    for e in sorted(events, key=lambda e:
                                    -e.self_device_time_total)[:4]))


def serve_dense_phase(dev, sync) -> dict:
    """Serve each dense attention config at full width in bf16 through
    ``launch.serve.serve`` (DENSE_SERVE), after its attention, continuation
    and card-vs-CPU checks, then trace DECODE_PROFILED more decode steps
    for the device's idle share; each model freed before the next.
    Returns arch -> the run's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    out = {}
    for arch, (B, S, steps) in DENSE_SERVE.items():
        cfg = get_config(arch)
        W = cfg.sliding_window
        log(f"[serve-dense] {cfg.name} ({cfg.citation}): {cfg.num_layers} "
            f"layers, d {cfg.d_model}, {cfg.num_heads} query / "
            f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, {cfg.mlp_style} "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window {W}, θ "
            f"{cfg.rope_theta:g}, {cfg.param_count() / 1e9:.3f} B "
            "parameters, bf16")
        slots = min(S + steps + 1, W) if W is not None else S + steps + 1
        check_attention(cfg, dev, B, S)
        check_decode_attention(cfg, dev, B, slots,
                               {min(S + 1, slots), min(S + steps, slots)})
        check_dense_decode(cfg, dev, S)
        check_dense_small(cfg, dev)

        sync()
        t0 = time.perf_counter()
        model = build_model(cfg, torch.bfloat16)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        sync()
        init_s = time.perf_counter() - t0
        weights = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        prompt = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(SEED + 1))
        torch.cuda.reset_peak_memory_stats()
        sync()
        ops.reset_launch_counts()
        L.reset_sdpa_backends()
        res = serve(model, params, prompt, steps + 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        used = dict(L.SDPA_BACKENDS)
        launches = ops.launch_counts()
        n_tok = B * S
        flops = dense_prefill_flops(cfg, B, S)
        log(f"[serve-dense] {cfg.name} full width: init {init_s:.2f} s "
            f"(weights {weights / 1e9:.3f} GB); prefill {B} × {S} tokens in "
            f"{res.prefill_s:.4f} s ({n_tok / res.prefill_s:.0f} tok/s; "
            f"{flops / 1e12:.2f} TFLOP, {flops / res.prefill_s / 1e12:.1f} "
            f"TFLOP/s, {flops / res.prefill_s / BF16_FLOP_PER_S:.1%} of the "
            "bf16 peak); "
            f"{steps} decode steps in {res.decode_s:.4f} s "
            f"({res.decode_s / steps * 1e3:.2f} ms a step, "
            f"{B * steps / res.decode_s:.1f} tok/s); peak {peak:.2f} GB "
            f"allocated; SDPA calls by backend {used}")
        nl = cfg.num_layers
        if W is not None and S > W:
            blocks = -(-S // min(L.BAND_Q_BLOCK, W))
            want = {"efficient+band": nl * blocks}
        else:
            want = {"flash": nl}
        want["decode:flash"] = nl * steps
        require(used == want, f"{cfg.name}: SDPA calls {used}, expected "
                f"{want}")
        require(all(n == 0 for n in launches.values()),
                f"{cfg.name}: a custom kernel was launched: {launches}")
        require(res.tokens.shape == (B, steps + 1)
                and bool(((res.tokens >= 0)
                          & (res.tokens < cfg.vocab_size)).all()),
                f"{cfg.name}: tokens out of range")
        require(res.logits.shape == (B, cfg.vocab_size)
                and bool(torch.isfinite(res.logits.float()).all()),
                f"{cfg.name}: non-finite logits")
        require(res.cache["len"] == S + steps, f"{cfg.name}: cache length")
        for j, layer in enumerate(res.cache["layers"]):
            require(layer["k"].shape == (B, slots, cfg.num_kv_heads,
                                         cfg.head_dim)
                    and bool(torch.isfinite(layer["k"].float()).all())
                    and bool(torch.isfinite(layer["v"].float()).all()),
                    f"{cfg.name} layer {j}: cache shape or non-finite K/V")
        if W is not None and S > W:
            log(f"[serve-dense] {cfg.name}: the {S}-token prompts wrap the "
                f"{W}-token window: the prefill took the banded path and "
                f"the decode ring of {slots} slots wrapped at slot "
                f"{S % W}..{(S + steps - 1) % W}")
        log(f"[serve-dense] {cfg.name}: logits finite, tokens in [0, V), all "
            f"{nl} layers' K/V finite; first tokens "
            f"{res.tokens[0, :8].tolist()}")

        profile_decode(cfg.name, model, params, res, sync)
        out[arch] = dict(init_s=init_s, prefill_s=res.prefill_s,
                         decode_s=res.decode_s, peak_gb=peak, sdpa=used)
        del model, params, res, prompt
        torch.cuda.empty_cache()
    return out


def train_dense_phase(dev, sync, cfg=None, tag="train-dense") -> None:
    """Train ``cfg`` (default h2o-danube-1.8b): at its width cut to 2
    layers in f32, the loss and its gradients card against CPU with the
    same weights; then ``cfg`` in bf16 with launch/train.py's defaults,
    FSVRG_ROUNDS FSVRG rounds, a FedAvg round and ADAMW_STEPS AdamW steps,
    each with seconds, peak memory and finite losses (an MoE config's loss
    is ce + 0.01 · its load-balance loss, printed beside)."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import neural
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = cfg or get_config(DENSE_TRAIN_ARCH)
    C, T, Bc, SQ = TRAIN_CLIENTS, TRAIN_LOCAL_STEPS, TRAIN_BATCH, TRAIN_SEQ
    rng = np.random.default_rng(SEED)

    # 2 layers, f32: the loss and every gradient leaf, card vs CPU
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    m_cpu = build_model(cfg2, torch.float32, "cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SEED))
    m_dev = build_model(cfg2, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(dev)
    b = train.synthetic_batch(rng, cfg, 1, 1, Bc, SQ, "cpu")
    flat = {k: x[0, 0] for k, x in b.items()}

    def loss_and_grads(m, p, batch):
        # a function, so that the loss's graph (which holds the weights)
        # goes with its frame
        loss, _ = m.loss(p, batch)
        names, leaves = zip(*p.named_parameters())
        return (float(loss.detach()),
                dict(zip(names, torch.autograd.grad(loss, leaves))))

    losses, grads = zip(
        loss_and_grads(m_cpu, p_cpu, flat),
        loss_and_grads(m_dev, p_dev, {k: x.to(dev) for k, x in flat.items()}))
    worst = max(_rel(grads[1][n].cpu(), grads[0][n]) for n in grads[0])
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    log(f"[{tag}] {cfg2.name} (full width, 2 layers) f32 loss on "
        f"{Bc} × {SQ} tokens card vs CPU: {losses[1]:.6f} vs {losses[0]:.6f} "
        f"({loss_err:.2e}); gradients' worst leaf error {worst:.3e} of its "
        f"max over {len(grads[0])} leaves (tolerance 1e-5 for the loss, "
        "1e-3 for the gradients)")
    require(loss_err <= 1e-5 and worst <= 1e-3,
            "the card's and the CPU's loss or gradients disagree")
    del m_cpu, p_cpu, m_dev, p_dev, grads
    torch.cuda.empty_cache()

    model = build_model(cfg, torch.bfloat16)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    sync()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"[{tag}] {cfg.name} at full width in bf16: "
        f"{cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters; {C} clients × {T} "
        f"step × {Bc} × {SQ} tokens; {held:.2f} GB allocated with the "
        "weights")

    def run(fn):
        torch.cuda.reset_peak_memory_stats()
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        require(all(n == 0 for n in launches.values()),
                f"a custom kernel was launched: {launches}")
        return res, secs, torch.cuda.max_memory_allocated() / 1e9

    for alg, rounds in (("fsvrg", FSVRG_ROUNDS), ("fedavg", 1)):
        step = steps.make_fsvrg_step(model, neural.FedNeuralConfig(
            stepsize=TRAIN_STEPSIZE, local_steps=T, algorithm=alg))
        for r in range(rounds):
            batch = train.synthetic_batch(rng, cfg, C, T, Bc, SQ, dev)
            (params, met), secs, peak = run(lambda: step(params, batch))
            with torch.no_grad():
                loss = float(model.loss(params, {k: x[0, 0] for k, x
                                                 in batch.items()})[0])
            gn = float(met["full_grad_norm"])
            log(f"[{tag}] {alg} round {r + 1}: {secs:.3f} s, peak "
                f"{peak:.2f} GB allocated; loss after {loss:.4f}, |∇f| "
                f"{gn:.4f}")
            require(np.isfinite(loss) and np.isfinite(gn),
                    f"{alg} round {r + 1}: non-finite loss or |∇f|")
            del batch, met
    opt = adamw(TRAIN_LR)
    opt_state = opt.init(dict(params.named_parameters()))
    adamw_step = steps.make_adamw_step(model, opt)
    opt_step = 0
    for i in range(ADAMW_STEPS):
        b = train.synthetic_batch(rng, cfg, 1, 1, C * Bc, SQ, dev)
        flat = {k: x[0, 0] for k, x in b.items()}
        (params, opt_state, opt_step, loss, _), secs, peak = run(
            lambda: adamw_step(params, opt_state, opt_step, flat))
        log(f"[{tag}] adamw step {i + 1}: {secs:.3f} s, peak "
            f"{peak:.2f} GB allocated; loss {float(loss):.4f}")
        require(np.isfinite(float(loss)), f"adamw step {i + 1}: non-finite "
                "loss")
    del model, params, opt_state, b, flat
    torch.cuda.empty_cache()


def release(tag: str) -> None:
    """Collect what earlier phases left in reference cycles (solvers and
    step closures hold their models) and return the cache to the card;
    log what stays allocated."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "before the phase (earlier phases' tensors)")


def moe_prefill_flops(cfg, B, S, C):
    """The operations of an MoE config's prefill of B × S tokens, two a
    multiply-add: (routed, dispatched).  Both count each layer's attention
    and router products for every token, causal attention and one
    unembedding a prompt; the expert products count k · S token-expert
    pairs a sequence (routed: the work the routing asks for) or the E · C
    slots the capacity dispatch computes, weight-0 fillers included."""
    d, H, Hkv, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    mats = 3 if cfg.mlp_style == "swiglu" else 2
    dense = 2 * d * H * Dh + 2 * d * Hkv * Dh + d * E
    keys = S * (S + 1) // 2
    common = cfg.num_layers * (2 * dense * B * S + 4 * B * H * Dh * keys)
    expert = 2 * mats * d * cfg.d_ff
    head = 2 * B * d * cfg.vocab_size
    return (common + cfg.num_layers * expert * k * B * S + head,
            common + cfg.num_layers * expert * E * C * B + head)


def check_moe_fwd(cfg, dev) -> None:
    """``moe_fwd`` at ``cfg``'s full width on the card against the CPU
    with the same weights (one layer's, drawn on the card) and input (1 ×
    MOE_CHECK_SEQ tokens), f32 and bf16: the same dispatch (every expert's
    token indices equal), the output within MOE_TOL of its max, the aux
    loss within 1e-5."""
    import torch
    from repro_torch.models import moe

    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    S = MOE_CHECK_SEQ
    C = moe.capacity(S, cfg)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        p = moe.init_moe(g, cfg, dtype)
        x = torch.randn((1, S, cfg.d_model), generator=g,
                        device=dev).to(dtype)
        t = time.perf_counter()
        od, ad = moe.moe_fwd(p, x, cfg)
        pc = {n: v.cpu() for n, v in p.items()}
        oc, ac = moe.moe_fwd(pc, x.cpu(), cfg)
        idx = [moe.dispatch(moe.route_topk(xx.float() @ pp["router"], k)[0],
                            C)[1].cpu() for xx, pp in ((x, p),
                                                       (x.cpu(), pc))]
        err = _rel(od.cpu(), oc)
        aerr = abs(float(ad) - float(ac)) / abs(float(ac))
        log(f"[serve-moe] {cfg.name} moe_fwd at full width (d "
            f"{cfg.d_model}, {E} experts of d_ff {cfg.d_ff}, top-{k}), 1 × "
            f"{S} tokens, C = {C}, {name}: card vs CPU output error "
            f"{err:.3e} of max |out| (tolerance {MOE_TOL[name]:g}), aux "
            f"{float(ad):.6f} vs {float(ac):.6f} ({aerr:.1e}); dispatch "
            f"indices equal {torch.equal(idx[0], idx[1])} "
            f"({time.perf_counter() - t:.1f} s)")
        require(od.dtype == dtype and od.shape == x.shape,
                f"{cfg.name}: moe_fwd's output dtype or shape")
        require(torch.equal(idx[0], idx[1]),
                f"{cfg.name}: the card and the CPU dispatch other tokens")
        require(err <= MOE_TOL[name] and aerr <= 1e-5,
                f"{cfg.name}: moe_fwd on the card disagrees with the CPU")
        del p, pc, x, od, oc
    torch.cuda.empty_cache()


def serve_moe_phase(dev, sync) -> dict:
    """Serve each MoE config at full width in bf16, depth cut as
    MOE_SERVE says, through ``launch.serve.serve``, after ``moe_fwd``'s
    card-vs-CPU check at full width and the reduced config's card-vs-CPU
    serve; prints init, prefill (routed and dispatched TFLOP/s) and decode
    numbers, peak memory, the prefill's per-expert token counts and the
    tokens capacity dropped, and traces DECODE_PROFILED more decode steps
    for the device's idle share.  Every custom kernel's count must stay 0.
    Returns arch -> the run's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.scaling import expert_occupancy
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, moe

    release("serve-moe")
    out = {}
    for arch, (layers, B, S, steps) in MOE_SERVE.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
        C = moe.capacity(S, cfg)
        log(f"[serve-moe] {full.name} ({full.citation}): {full.num_layers} "
            f"layers, d {full.d_model}, {full.num_heads} query / "
            f"{full.num_kv_heads} KV heads of {full.head_dim}, {E} experts "
            f"top-{k} of d_ff {full.d_ff}, vocab {full.vocab_size}; "
            f"{full.param_count() / 1e9:.2f} B parameters, "
            f"{full.param_count() * 2 / 1e9:.1f} GB in bf16, "
            f"{full.active_param_count() / 1e9:.2f} B active a token.  Cut "
            f"to {layers} of {full.num_layers} layers (reduced: depth): "
            f"{cfg.param_count() / 1e9:.2f} B parameters, "
            f"{cfg.param_count() * 2 / 1e9:.1f} GB in bf16, beside the "
            f"cache of {B} × {S + steps} tokens "
            f"({2 * layers * B * (S + steps) * cfg.num_kv_heads * cfg.head_dim * 2 / 1e9:.2f} GB)"
            f" and the prefill's dispatch buffers ((B, E, C, d) at C = {C}: "
            f"{B * E * C * cfg.d_model * 2 / 1e9:.2f} GB; each (B, E, C, "
            f"d_ff) product {B * E * C * cfg.d_ff * 2 / 1e9:.2f} GB)")
        check_moe_fwd(cfg, dev)
        check_dense_small(full, dev, tag="serve-moe")

        sync()
        t0 = time.perf_counter()
        model = build_model(cfg, torch.bfloat16)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        sync()
        init_s = time.perf_counter() - t0
        weights = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        prompt = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(SEED + 1))
        torch.cuda.reset_peak_memory_stats()
        sync()
        ops.reset_launch_counts()
        res = serve(model, params, prompt, steps + 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = ops.launch_counts()
        routed, dispatched = moe_prefill_flops(cfg, B, S, C)
        log(f"[serve-moe] {cfg.name} full width, {layers} layers: init "
            f"{init_s:.2f} s (weights {weights / 1e9:.3f} GB); prefill {B} × "
            f"{S} tokens in {res.prefill_s:.4f} s ({B * S / res.prefill_s:.0f}"
            f" tok/s; routed {routed / 1e12:.2f} TFLOP, "
            f"{routed / res.prefill_s / 1e12:.1f} TFLOP/s, "
            f"{routed / res.prefill_s / BF16_FLOP_PER_S:.1%} of the bf16 "
            f"peak; dispatched {dispatched / 1e12:.2f} TFLOP, "
            f"{dispatched / res.prefill_s / 1e12:.1f} TFLOP/s, "
            f"{dispatched / res.prefill_s / BF16_FLOP_PER_S:.1%}); {steps} "
            f"decode steps in {res.decode_s:.4f} s "
            f"({res.decode_s / steps * 1e3:.2f} ms a step, "
            f"{B * steps / res.decode_s:.1f} tok/s); peak {peak:.2f} GB "
            "allocated")
        require(all(n == 0 for n in launches.values()),
                f"{cfg.name}: a custom kernel was launched: {launches}")
        require(res.tokens.shape == (B, steps + 1)
                and bool(((res.tokens >= 0)
                          & (res.tokens < cfg.vocab_size)).all()),
                f"{cfg.name}: tokens out of range")
        require(res.logits.shape == (B, cfg.vocab_size)
                and bool(torch.isfinite(res.logits.float()).all()),
                f"{cfg.name}: non-finite logits")
        require(res.cache["len"] == S + steps, f"{cfg.name}: cache length")
        for j, layer in enumerate(res.cache["layers"]):
            require(layer["k"].shape == (B, S + steps + 1, cfg.num_kv_heads,
                                         cfg.head_dim)
                    and bool(torch.isfinite(layer["k"].float()).all())
                    and bool(torch.isfinite(layer["v"].float()).all()),
                    f"{cfg.name} layer {j}: cache shape or non-finite K/V")
        log(f"[serve-moe] {cfg.name}: logits finite, tokens in [0, V), all "
            f"{layers} layers' K/V finite; first tokens "
            f"{res.tokens[0, :8].tolist()}")

        # the prefill's routing, once more with each layer's router read
        # (untimed): tokens a layer routes to each expert, summed over the
        # layers, and those past an expert's C slots of a sequence
        real = moe.moe_fwd
        counts = torch.zeros(E, device=dev)
        dropped = [0]

        def counted(p, x, cfg_, **kw):
            logits = x.float() @ p["router"]
            _, probs, mask = moe.route_topk(logits, k)
            counts.add_(expert_occupancy(probs.reshape(-1, E), k))
            cap = moe.capacity(x.shape[1], cfg_, **kw)
            dropped[0] += int((mask.sum(1) - cap).clamp(min=0).sum())
            return real(p, x, cfg_, **kw)

        moe.moe_fwd = counted
        try:
            model.prefill(params, {"tokens": prompt})
        finally:
            moe.moe_fwd = real
        routed_pairs = layers * B * S * k
        log(f"[serve-moe] {cfg.name} prefill routing over {layers} layers: "
            f"tokens routed to each expert " + str(
                [int(c) for c in counts.tolist()])
            + f" (Σ {int(counts.sum())} = layers × {B * S} tokens × top-{k});"
            f" {dropped[0]} token-expert pairs dropped by capacity ("
            f"{dropped[0] / routed_pairs:.2%} of {routed_pairs})")
        require(int(counts.sum()) == routed_pairs,
                f"{cfg.name}: expert counts do not sum to the routed pairs")

        profile_decode(f"{cfg.name} ({layers} layers)", model, params, res,
                       sync)
        out[arch] = dict(init_s=init_s, prefill_s=res.prefill_s,
                         decode_s=res.decode_s, peak_gb=peak)
        del model, params, res, prompt
        torch.cuda.empty_cache()
    return out


def train_moe_phase(dev, sync) -> None:
    """Train phi3.5-moe at full width cut to MOE_TRAIN_LAYERS layers:
    ``train_dense_phase``'s steps (the f32 loss and gradients card vs CPU,
    then FSVRG, FedAvg and AdamW in bf16) on that config."""
    from repro_torch.configs import get_config
    release("train-moe")
    full = get_config(MOE_TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    log(f"[train-moe] {cfg.name} cut to {MOE_TRAIN_LAYERS} of "
        f"{full.num_layers} layers "
        f"(reduced: depth): {cfg.param_count() / 1e9:.3f} B parameters")
    train_dense_phase(dev, sync, cfg=cfg, tag="train-moe")


def fig2_phase(dev, sync, steps: int, n_buckets: int) -> dict:
    """Reproduce Fig. 2 at the paper's width through its command,
    ``repro_torch.experiments.fig2_convergence.main`` (FIG2_ARGS): every
    curve's history finite, its JSON written and read back, each curve's
    kernel launches against sweep size × rounds × batched steps (``steps``
    = Σ m_pad of the §4 buckets, ``n_buckets`` of them), with the counts set
    to 0 just before and read just after; its wall seconds and the
    rounds-to-10 %-gap table printed.  Then the command at FIG2_SMALL on the
    card and on the CPU: every curve's f within rtol 1e-4, its error within
    one test example, the swept values equal.  Returns the full run's
    launches by kernel."""
    import torch
    from repro_torch.configs import (get_dane_config, get_fedavg_config,
                                     get_fsvrg_config, get_gd_config)
    from repro_torch.experiments import fig2_convergence as fig2
    from repro_torch.kernels import ops

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "fig2_smoke.json"
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    fig2.main(FIG2_ARGS + ["--json", str(path)])
    sync()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    res = json.loads(path.read_text())
    rounds = int(FIG2_ARGS[FIG2_ARGS.index("--rounds") + 1])
    fsvrg = len(get_fsvrg_config().stepsize_sweep) * rounds * steps
    fedavg_cfg = get_fedavg_config()
    expected = {
        "fsvrg": {"fsvrg_update": fsvrg},
        "fsvrgr": {"fsvrg_update": fsvrg},
        "gd": {},
        "dane": {"dane_update": len(get_dane_config().local_lr_sweep)
                 * rounds * get_dane_config().local_steps * n_buckets,
                 "segment_sum": len(get_dane_config().local_lr_sweep)
                 * rounds * (get_dane_config().local_steps + 1)
                 * n_buckets},
        "cocoa": {"cocoa_sdca_pass": rounds * n_buckets},
        "fedavg": {"fedavg_update": len(fedavg_cfg.stepsize_sweep) * rounds
                   * fedavg_cfg.local_epochs * steps},
        "oneshot": {"fedavg_update": 20 * steps},
    }
    log(f"[fig2] {' '.join(FIG2_ARGS)}: {wall:.1f} s in all; OPT f* "
        f"{res['opt']['f']:.6f} err* {res['opt']['err']:.4f}; constant "
        f"err {res['const_err']:.4f}; majority err "
        f"{res['majority_err']:.4f}; K = {res['config']['num_clients']}, "
        f"d = {res['config']['num_features']}")
    from repro_torch.configs import get_logreg_config
    from repro_torch.data import generate
    scale = float(FIG2_ARGS[FIG2_ARGS.index("--scale") + 1])
    cfg = get_logreg_config().scaled(scale)
    require(res["config"]["num_clients"] == cfg.num_clients
            and res["config"]["num_features"] == cfg.num_features,
            f"fig2: not the width of scale {scale}")
    total = {}
    for name, want in expected.items():
        cur = res[name]
        hist = cur.get("hist", [cur])
        require(all(math.isfinite(p["f"]) and math.isfinite(p["err"])
                    for p in hist), f"fig2 {name}: a non-finite history")
        require(len(hist) == (1 if name == "oneshot" else rounds),
                f"fig2 {name}: {len(hist)} rounds recorded")
        log(f"[fig2] {name}: {cur['seconds']:.2f} s; swept "
            f"{cur.get('swept', {})}; f " + " -> ".join(
                f"{p['f']:.6f}" for p in hist) + f"; err {hist[-1]['err']:.4f}"
            f"; rounds to the 10 % gap {cur.get('rounds_to_10pct_gap')}; "
            f"launches {cur['launches']} (expected {want})")
        require(cur["launches"] == want,
                f"fig2 {name}: launches {cur['launches']}, expected {want}")
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
    require(launches == total,
            f"fig2: the run launched {launches}, its curves {total}")
    log("[fig2] name,rounds_to_10pct_gap,final_f,final_err")
    for name in fig2.GAP_TABLE:
        h = res[name]["hist"][-1]
        log(f"[fig2] {name},{res[name]['rounds_to_10pct_gap']},"
            f"{h['f']:.5f},{h['err']:.4f}")

    # the small run on the card and on the CPU
    small = []
    for device in (dev.type, "cpu"):
        t = time.perf_counter()
        small.append(fig2.main(FIG2_SMALL + ["--device", device]))
        sync()
        log(f"[fig2] {' '.join(FIG2_SMALL)} on {device}: "
            f"{time.perf_counter() - t:.1f} s")
    card, cpu = small
    scale = float(FIG2_SMALL[FIG2_SMALL.index("--scale") + 1])
    one = 1.0 / int(generate(get_logreg_config().scaled(scale), SEED,
                             device="cpu").test_y.shape[0])
    worst_f, worst_err = 0.0, 0.0
    pairs = [("opt", card["opt"], cpu["opt"]),
             ("oneshot", card["oneshot"], cpu["oneshot"])]
    for name in fig2.GAP_TABLE:
        require(card[name]["swept"] == cpu[name]["swept"],
                f"fig2 small {name}: swept {card[name]['swept']} on the "
                f"card, {cpu[name]['swept']} on the CPU")
        pairs += [(f"{name} r{r + 1}", a, b) for r, (a, b) in enumerate(
            zip(card[name]["hist"], cpu[name]["hist"]))]
    for label, a, b in pairs:
        rel = abs(a["f"] - b["f"]) / abs(b["f"])
        worst_f, worst_err = max(worst_f, rel), max(
            worst_err, abs(a["err"] - b["err"]))
        require(rel <= 1e-4 and abs(a["err"] - b["err"]) <= one + 1e-12,
                f"fig2 small {label}: card {a}, CPU {b}")
    require(card["const_err"] == cpu["const_err"]
            and card["majority_err"] == cpu["majority_err"],
            "fig2 small: the constant or majority error differs")
    log(f"[fig2] small run card vs CPU: swept values equal, f within "
        f"{worst_f:.2e} relative (tolerance 1e-4), err within "
        f"{worst_err:.4f} (one test example {one:.4f}); constant and "
        "majority errors equal")
    return launches


def dense_phase(dev, sync) -> None:
    """Theorem 5 on the card in f64: PrimalMethod and DualMethod from the
    same α⁰ on DENSE_SHAPE equal-size clients, DENSE_ROUNDS rounds, the
    iterates equal and w = (1/λn) X α of the dual's blocks every round;
    DANERidge for 3 rounds; each held against the CPU's run of the same
    inputs.  Then Proposition 1 on the card in f32: dane_svrg_round against
    naive_fsvrg_round on a small sparse problem.  Counts set to 0 just
    before the ridge runs and read just after: none of the port's kernels
    runs there (the solves are torch.linalg.solve, as the reference's are
    jnp.linalg.solve)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_logreg_config
    from repro_torch.core import (DANERidge, DualMethod, PrimalMethod,
                                  build_dense_problem, build_problem,
                                  dane_svrg_round, naive_fsvrg_round)
    from repro_torch.data import generate
    from repro_torch.kernels import ops
    from repro_torch.utils import threefry

    K, m, d = DENSE_SHAPE
    lam, sigma = 0.1, K / 4.0
    rng = np.random.default_rng(SEED)
    Xs = [rng.standard_normal((d, m)) for _ in range(K)]
    ys = [rng.standard_normal(m) for _ in range(K)]
    a0 = [rng.standard_normal(m) for _ in range(K)]
    key = threefry.PRNGKey(SEED)
    runs = []
    ops.reset_launch_counts()
    for device in (dev, torch.device("cpu")):
        prob = build_dense_problem(Xs, ys, lam, device=device)
        X = prob.buckets[0].val                               # (K, m, d)
        primal = PrimalMethod(prob, sigma=sigma, alphas0=a0, device=device)
        dual = DualMethod(prob, sigma=sigma, alphas0=a0, device=device)
        sp, sd = primal.init(), dual.init()
        gap, drift, secs = 0.0, 0.0, []
        for _ in range(DENSE_ROUNDS):
            sync()
            t = time.perf_counter()
            sp = primal.round(sp, key)
            sd = dual.round(sd, key)
            sync()
            secs.append(time.perf_counter() - t)
            scale = float(sd.w.abs().max())
            gap = max(gap, float((sp.w - sd.w).abs().max()) / scale)
            w_alpha = torch.einsum("kmd,km->d", X, sd.aux[0]) / (
                lam * prob.flat.n)
            drift = max(drift, float((sd.w - w_alpha).abs().max()) / scale)
        ridge = DANERidge(prob, eta=1.0, mu=0.5, device=device)
        sr = ridge.init(torch.zeros(d, dtype=torch.float64, device=device))
        sync()
        t = time.perf_counter()
        for r in range(3):
            sr = ridge.round(sr, key)
        sync()
        ridge_s = time.perf_counter() - t
        runs.append(dict(primal=sp, dual=sd, ridge=sr))
        log(f"[dense] {device.type}: K = {K}, m = {m}, d = {d}, f64, σ = "
            f"{sigma:g}: primal + dual rounds "
            + ", ".join(f"{x:.3f}" for x in secs) + f" s; |w_primal − "
            f"w_dual| ≤ {gap:.2e} and |w − (1/λn)Xα| ≤ {drift:.2e} of max "
            f"|w| over {DENSE_ROUNDS} rounds (tolerance 1e-9); DANERidge 3 "
            f"rounds {ridge_s:.3f} s")
        require(gap <= 1e-9 and drift <= 1e-9,
                f"dense {device.type}: Theorem 5 does not hold")
    launches = ops.launch_counts()
    require(not any(launches.values()),
            f"dense: the ridge methods launched {launches}")
    worst = 0.0
    for name in ("primal", "dual", "ridge"):
        a, b = runs[0][name], runs[1][name]
        pairs = [(a.w, b.w)] + list(zip(a.aux, b.aux))
        for got, expect in pairs:
            err = float((got.cpu() - expect).abs().max()) / float(
                expect.abs().max())
            worst = max(worst, err)
            require(err <= 1e-9, f"dense {name}: card and CPU disagree "
                    f"({err:.2e} of max |x|)")
    log(f"[dense] card vs CPU (w, g_k and α_k): ≤ {worst:.2e} of max |x| "
        "(tolerance 1e-9: cuSOLVER's and LAPACK's f64 solves)")
    del runs
    torch.cuda.empty_cache()

    prob = build_problem(generate(get_logreg_config().scaled(0.002), SEED,
                                  device=dev), device=dev)
    w = 0.2 * torch.as_tensor(np.random.default_rng(7).standard_normal(
        prob.d), dtype=torch.float32, device=dev)
    for stepsize, steps in ((0.05, 10), (0.2, 25)):
        w3 = naive_fsvrg_round(prob, w, threefry.PRNGKey(11), stepsize,
                               steps)
        wd = dane_svrg_round(prob, w, threefry.PRNGKey(11), stepsize, steps)
        scale = float(w3.abs().max())
        err = float((w3 - wd).abs().max())
        log(f"[dense] Proposition 1 on the card (f32, scale 0.002, h = "
            f"{stepsize}, m = {steps}): |DANE-SVRG − Algorithm 3| "
            f"{err:.3e} of max |w| {scale:.3e} (tolerance 1e-5·max|w|)")
        require(err <= 1e-5 * scale, "dense: Proposition 1 does not hold")


def check_draws(dev) -> None:
    """The card's split, randint, permutation and gumbel on a batch of 256
    keys, and the f32 functions the data sampler takes of them, against
    the CPU's: bit for bit."""
    import torch
    from repro_torch.utils import floatmath, threefry
    kc = threefry.split(threefry.fold_in(threefry.PRNGKey(SEED), 23), 256)
    kg = threefry.as_key(kc, dev)
    require(all(torch.equal(x.cpu(), y) for x, y in
                zip(threefry.split(kg, 7), threefry.split(kc, 7))),
            "split on the card differs from the CPU")
    spans = (1, 2, 97, 6_750, 65_536, 65_537, 2 ** 31 - 1)
    for span in spans:
        require(torch.equal(threefry.randint(kg, (64,), 0, span).cpu(),
                            threefry.randint(kc, (64,), 0, span)),
                f"randint up to {span} on the card differs from the CPU")
    per_key = torch.tensor(spans * 37, dtype=torch.int64)[:256]
    require(torch.equal(
        threefry.randint(kg, (50,), 0, per_key.to(dev)).cpu(),
        threefry.randint(kc, (50,), 0, per_key)),
        "randint with a maxval a key on the card differs from the CPU")
    for n in (1_625, 1_626, 8_192):
        require(torch.equal(threefry.permutation(kg, n).cpu(),
                            threefry.permutation(kc, n)),
                f"permutation of {n} on the card differs from the CPU")
    n = 20_000
    require(torch.equal(threefry.gumbel(kg, (n,)).cpu(),
                        threefry.gumbel(kc, (n,))),
            "gumbel on the card differs from the CPU")
    x = torch.rand(1_000_000, generator=torch.Generator().manual_seed(SEED))
    for label, fn, arg in (
            ("log", floatmath.log_f32, x * 50 + 2.0 ** -126),
            ("pow", lambda v: floatmath.pow_f32(v, 1.0 / 0.3), x * 50),
            ("sigmoid", floatmath.sigmoid_f32, x * 40 - 20),
            ("sum", floatmath.sum_f32, x.reshape(2_500, 400)),
            ("cumsum", floatmath.cumsum_f32, x.reshape(2_500, 400))):
        require(torch.equal(fn(arg.to(dev)).cpu(), fn(arg)),
                f"floatmath {label} on the card differs from the CPU")
    log(f"[check] threefry split, randint (spans {spans}, and one a key), "
        "permutation (n = 1,625, 1,626, 8,192) and gumbel (256 × "
        f"{n}) on 256 keys, and floatmath's log, pow, sigmoid, sum and "
        "cumsum on 10⁶ values: card == CPU bit for bit")


def check_data(dev) -> None:
    """``generate`` of the §4 config at scale 0.01 on the card against the
    CPU: every array equal but on counted clients, and each counted client
    explained — its vocabulary order differs, and the first swapped pair of
    its Gumbel scores lies within 4 ulp."""
    import torch
    from repro_torch.configs import get_logreg_config
    from repro_torch.data import generate, synthetic
    from repro_torch.utils import threefry
    cfg = get_logreg_config().scaled(0.01)
    dc = generate(cfg, SEED, device="cpu")
    dg = generate(cfg, SEED, device=dev)
    counted = set()
    for name in ("idx", "val", "y", "client_of", "test_idx", "test_val",
                 "test_y", "test_client_of"):
        a, b = getattr(dc, name), getattr(dg, name).cpu()
        require(a.shape == b.shape, f"generate's {name} has another shape "
                "on the card")
        rows = (a != b).reshape(a.shape[0], -1).any(dim=1)
        owner = dc.test_client_of if name.startswith("test") else dc.client_of
        counted |= set(owner[rows].tolist())
    spec = synthetic.data_spec(cfg, SEED)
    log_pop = torch.as_tensor(spec.log_pop)
    base = threefry.PRNGKey(SEED)
    for k in sorted(counted):
        ids = torch.tensor([k])
        vc = synthetic.client_params(threefry.as_key(base), ids, log_pop,
                                     spec.vocab_size)[0][0]
        vg = synthetic.client_params(threefry.as_key(base, dev), ids.to(dev),
                                     log_pop.to(dev), spec.vocab_size)[0][0]
        vg = vg.cpu()
        require(bool((vc != vg).any()), f"client {k}: its rows differ on the "
                "card, its vocabulary does not")
        j = int((vc != vg).nonzero()[0])
        ck = threefry.fold_in(base, k)
        score = log_pop + threefry.gumbel(threefry.fold_in(ck, 1),
                                          (log_pop.shape[0],))
        x, y = score[vc[j] - 2], score[vg[j] - 2]
        ulp = 2.0 ** -23 * 2.0 ** float(torch.floor(torch.log2(
            torch.maximum(x.abs(), y.abs()))))
        require(float((x - y).abs()) <= 4 * ulp, f"client {k}: its swapped "
                "Gumbel scores are more than 4 ulp apart")
    log(f"[check] generate at scale 0.01 (K = {cfg.num_clients}, d = "
        f"{cfg.num_features}, {dc.num_examples} train rows): card vs CPU, "
        f"every array equal but on {len(counted)} counted clients "
        f"{sorted(counted)}, each a vocabulary order swapped within 4 ulp")


def wkv6_cost(B, S, Hn, D, L=32):
    """wkv6's bytes and f32 operations: r, k, v, w read and out written
    once, u read, the state written; the f32 work a chunk that the
    function needs — the strict lower L(L−1)/2 scores and their product
    with v, r_t·S, the state update k_tᵀv and its scale, the bonus, the
    cumulative decay."""
    BH = B * Hn
    chunk_ops = (2 * (L * (L - 1) // 2) * D * 2 + 2 * L * D * D
                 + 2 * D * D * L + 2 * D * D + 4 * L * D + 3 * L * D)
    return (5 * BH * S * D * 4 + Hn * D * 4 + BH * D * D * 4,
            chunk_ops * BH * (S // L))


def wkv6_bwd_ops(B, S, Hn, D, L=32) -> int:
    """The f32 work wkv6_bwd's function needs: per chunk the five
    strict-lower (L, L) products over D (A, dA, Aᵀ dout, dA k_t, dAᵀ r_t),
    the five (L, D) × (D, D) ones (k_t G, dout S0ᵀ, Y = v dSᵀ, the new dS
    and the forward sweep's k_tᵀ v), dc_L, and ≈ 30 elementwise
    operations an element."""
    macs = 5 * (L * (L - 1) // 2) * D + 5 * L * D * D + D * D + L * D
    return (2 * macs + 30 * L * D) * B * Hn * (S // L)


def graph_ms(fn, iters=10) -> float:
    """Device ms a call of ``fn``: ``iters`` calls captured once in a CUDA
    graph and the graph replayed between CUDA events, so the host's cost
    of a call is not in it (``fn`` runs once first, outside the capture,
    and must launch on PyTorch's current stream)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wkv6_plain_grads(x, s0, d_out, d_fin, chunk=32):
    """The cotangents of r, k, v, w, u (and the start state) by autograd
    through ref.wkv6_ref."""
    import torch
    from repro_torch.kernels import ref
    xs = [t.detach().clone().requires_grad_() for t in x]
    st = None if s0 is None else s0.clone().requires_grad_()
    out, fin = ref.wkv6_ref(*xs, chunk, state=st)
    outs, cots = [out], [d_out]
    if d_fin is not None:
        outs.append(fin)
        cots.append(d_fin)
    return torch.autograd.grad(outs, xs + ([] if st is None else [st]), cots)


def check_wkv6_bwd(dev, gen, compare) -> float:
    """wkv6_bwd against autograd through its plain forward on the card:
    the training path's (2, 128, 40, 64) from zeros, and from a given
    state with the final state's cotangent; the serving shape (8, 2,048,
    40, 64); the (B·Hn, S, D) entry; a strided slice; one chunk (S = L);
    chunk 16; strong decays (the 1e-30 clamp fires, where autograd's dw
    is NaN: against the plain backward ref.wkv6_bwd_ref).  Two calls must
    be bit-equal.  Returns the max abs error at the training shape.

    Tolerance 1e-5 of each cotangent's max + rtol 1e-5: f32 sums of the
    same terms in other orders (the reverse chunk walk in FMAs against
    autograd's)."""
    import torch
    from repro_torch.kernels import ops, ref
    worst = 0.0
    B, S, Hn, D = TRAIN_WKV
    cases = [("training path, zeros", TRAIN_WKV, Hn, False, False, False,
              32),
             ("training, given state and d_final", TRAIN_WKV, Hn, True, True,
              False, 32),
             ("serving shape, zeros", SERVE_WKV, Hn, False, False, False, 32),
             ("(B·Hn, S, D) entry, given state", (B * Hn, S, D), None, True,
              True, False, 32),
             ("strided first 96 of 100 tokens", (B, 100, Hn, D), Hn, False,
              False, False, 32),
             ("strong decays (clamp fires)", TRAIN_WKV, Hn, True, True,
              True, 32),
             ("one chunk, given state and d_final", (B, 32, Hn, D), Hn, True,
              True, False, 32),
             ("chunk 16, given state and d_final", TRAIN_WKV, Hn, True, True,
              False, 16)]
    for label, shape, heads, given, dfin, strong, chunk in cases:
        x = list(wkv6_inputs(dev, gen, shape[0], shape[1], shape[-1],
                             heads=heads))
        if strong:
            x[3][..., :4] = 0.05 + 0.15 * torch.rand(
                x[3][..., :4].shape, device=dev, generator=gen)
        if shape[1] == 100:
            x[:4] = [t[:, :96] for t in x[:4]]
        s_shape = (x[0].shape[0],) + (() if heads is None else (heads,)) \
            + (D, D)
        s0 = 0.5 * torch.randn(s_shape, device=dev, generator=gen) \
            if given else None
        d_out = torch.randn(x[0].shape, device=dev, generator=gen)
        d_fin = torch.randn(s_shape, device=dev, generator=gen) \
            if dfin else None
        got = ops.wkv6_bwd(*x, d_out, chunk, state=s0, d_state=d_fin)
        again = ops.wkv6_bwd(*x, d_out, chunk, state=s0, d_state=d_fin)
        torch.cuda.synchronize()
        require(all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(got, again)),
                f"wkv6_bwd {label}: two calls differ")
        plain = (ref.wkv6_bwd_ref(*x, d_out, chunk, state=s0, d_state=d_fin)
                 if strong else wkv6_plain_grads(x, s0, d_out, d_fin, chunk))
        names = ("dr", "dk", "dv", "dw", "du", "d_state")
        for name, a, p in zip(names, got, plain):
            err = compare("wkv6_bwd", f"{tuple(x[0].shape)} {label} {name}",
                          a, p, 1e-5, 1e-5 * float(p.abs().max()))
            if label == "training path, zeros":
                worst = max(worst, err)
        require(torch.isfinite(got[3]).all().item(),
                f"wkv6_bwd {label}: non-finite dw")
        del x, s0, d_out, d_fin, got, again, plain
    log("[check] wkv6_bwd: two calls bit-equal in every case")
    return worst


def train_phase(dev, sync, compare, cuda_ms, bound) -> dict:
    """Train rwkv6-3b: wkv6_bwd's checks; the reduced config's FSVRG and
    FedAvg rounds on the card against the CPU in f32; then at full width in
    bf16 FSVRG_ROUNDS FSVRG rounds, a FedAvg round and ADAMW_STEPS AdamW
    steps through launch.steps, each with its seconds, peak memory, finite
    loss and full-gradient norm and its wkv6 / wkv6_bwd launches checked
    (the loss rematerializes each layer: 2 forward launches and 1
    backward a layer and pass), and one more FSVRG round traced for the
    device's idle share; then wkv6_bwd's timing.  Returns the kernels
    line's wkv6_bwd row."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import neural
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    max_err = check_wkv6_bwd(dev, gen, compare)

    # the reduced config in f32, the same weights and batches on the card
    # and the CPU.  Tolerance 1e-3 of max |w| (and of |∇f|): f32 sums in
    # other orders (cuBLAS, the kernels) through a gradient that is badly
    # conditioned at a sequence's first tokens (the group norm of a WKV
    # output that is 0, then a multiple of v_0): on the CPU a 1e-7
    # relative perturbation of these weights moves the round by 3.5e-4 of
    # max |w| and |∇f| by 1.0e-4 (tests/test_torch_train.py)
    cfg = get_config(ARCH)
    small = cfg.reduced()
    m_cpu = build_model(small, torch.float32, "cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(SEED))
    m_dev = build_model(small, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(dev)
    batch = train.synthetic_batch(np.random.default_rng(SEED), small, 2, 2,
                                  2, 64, "cpu")
    for alg in ("fsvrg", "fedavg"):
        fed = neural.FedNeuralConfig(stepsize=0.3, local_steps=2,
                                     algorithm=alg)
        new_c, met_c = neural.make_fsvrg_round(m_cpu, fed)(p_cpu, batch)
        new_d, met_d = neural.make_fsvrg_round(m_dev, fed)(
            p_dev, {k: v.to(dev) for k, v in batch.items()})
        scale = max(float(p.detach().abs().max())
                    for p in new_c.parameters())
        err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(new_d.parameters(), new_c.parameters()))
        gn_c, gn_d = (float(m["full_grad_norm"]) for m in (met_c, met_d))
        log(f"[train] {small.name} {alg} round (C = 2, T = 2, 2 × 64 "
            f"tokens) card vs CPU, f32: iterate max_abs_err {err:.3e} of "
            f"max |w| {scale:.3e} ({err / scale:.2e}); |∇f| {gn_d:.6f} vs "
            f"{gn_c:.6f} ({abs(gn_d - gn_c) / gn_c:.2e}); tolerance 1e-3")
        require(err <= 1e-3 * scale and abs(gn_d - gn_c) <= 1e-3 * gn_c,
                f"{alg}: the card's and the CPU's rounds disagree")
    del m_cpu, p_cpu, m_dev, p_dev, new_c, new_d

    # full width, bf16
    L = cfg.num_layers
    Hn = cfg.d_model // cfg.rwkv_head_dim
    model = build_model(cfg, torch.bfloat16)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    sync()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"[train] {cfg.name} at full width in bf16: {L} layers, d "
        f"{cfg.d_model}, {Hn} heads of {cfg.rwkv_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {TRAIN_CLIENTS} clients × "
        f"{TRAIN_LOCAL_STEPS} step × {TRAIN_BATCH} × {TRAIN_SEQ} tokens; "
        f"{held:.2f} GB allocated with the weights")
    rng = np.random.default_rng(SEED)
    C, T, Bc, SQ = TRAIN_CLIENTS, TRAIN_LOCAL_STEPS, TRAIN_BATCH, TRAIN_SEQ
    round_launches = {}

    def expect(passes):
        return {"wkv6": 2 * L * passes, "wkv6_bwd": L * passes}

    def run(label, fn, passes):
        torch.cuda.reset_peak_memory_stats()
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = expect(passes)
        require(all(launches[k] == want.get(k, 0) for k in launches),
                f"{label}: launches {launches}, expected {want}")
        return out, secs, peak, launches

    for alg, rounds in (("fsvrg", FSVRG_ROUNDS), ("fedavg", 1)):
        step = steps.make_fsvrg_step(model, neural.FedNeuralConfig(
            stepsize=TRAIN_STEPSIZE, local_steps=T, algorithm=alg))
        passes = C * T * (3 if alg == "fsvrg" else 2)
        for r in range(rounds):
            batch = train.synthetic_batch(rng, cfg, C, T, Bc, SQ, dev)
            (params, met), secs, peak, launches = run(
                f"{alg} round {r + 1}", lambda: step(params, batch), passes)
            round_launches.setdefault(alg, launches)
            if alg == "fsvrg":
                fsvrg_s = secs
            with torch.no_grad():
                loss = float(model.loss(params, {k: x[0, 0] for k, x
                                                 in batch.items()})[0])
            gn = float(met["full_grad_norm"])
            log(f"[train] {alg} round {r + 1}: {secs:.3f} s, peak "
                f"{peak:.2f} GB allocated; loss after {loss:.4f}, |∇f| "
                f"{gn:.4f}; launches wkv6 {launches['wkv6']}, wkv6_bwd "
                f"{launches['wkv6_bwd']} ({passes} forward and backward "
                "passes), every other kernel 0")
            require(np.isfinite(loss) and np.isfinite(gn),
                    f"{alg} round {r + 1}: non-finite loss or |∇f|")
            del batch, met

    # one more FSVRG round traced on the device alone (the host's operator
    # calls are not traced), over the last unprofiled FSVRG round's wall
    # time
    step = steps.make_fsvrg_step(model, neural.FedNeuralConfig(
        stepsize=TRAIN_STEPSIZE, local_steps=T))
    batch = train.synthetic_batch(rng, cfg, C, T, Bc, SQ, dev)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, _ = step(params, batch)
        sync()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    if events:
        log(f"[profile] {ARCH} fsvrg round at full width: device busy "
            f"{busy_s:.3f} s of the unprofiled {fsvrg_s:.3f} s round -> "
            f"device idle share {1 - busy_s / fsvrg_s:.1%}; "
            f"{sum(e.count for e in events)} device kernels")
    else:
        log(f"[profile] {ARCH} fsvrg round: device idle share: not measured "
            "(the profiler saw no device time)")
    for e in events[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}× {e.key[:90]}")
    bwd = [(m.group(0), e) for e in events
           if (m := re.search(r"wkv6_bwd\w*", e.key))]
    bwd_ms = sum(e.self_device_time_total for _, e in bwd) / 1e3
    log(f"[profile] wkv6_bwd's launches in the round: {bwd_ms:.2f} ms, "
        f"{bwd_ms / 1e3 / max(busy_s, 1e-9):.1%} of the device's busy time ("
        + ", ".join(f"{name} {e.count}× {e.self_device_time_total / 1e3:.2f} "
                    "ms" for name, e in bwd) + ")")
    del batch, prof, events, bwd
    opt = adamw(TRAIN_LR)
    opt_state = opt.init(dict(params.named_parameters()))
    adamw_step = steps.make_adamw_step(model, opt)
    opt_step = 0
    for i in range(ADAMW_STEPS):
        b = train.synthetic_batch(rng, cfg, 1, 1, C * Bc, SQ, dev)
        flat = {k: x[0, 0] for k, x in b.items()}
        (params, opt_state, opt_step, loss, _), secs, peak, launches = run(
            f"adamw step {i + 1}",
            lambda: adamw_step(params, opt_state, opt_step, flat), 1)
        log(f"[train] adamw step {i + 1}: {secs:.3f} s, peak {peak:.2f} GB "
            f"allocated; loss {float(loss):.4f}; launches wkv6 "
            f"{launches['wkv6']}, wkv6_bwd {launches['wkv6_bwd']}")
        require(np.isfinite(float(loss)), f"adamw step {i + 1}: non-finite "
                "loss")
    del model, params, opt_state, b, flat
    torch.cuda.empty_cache()

    # wkv6_bwd's time at the training shape (its row) and at the serving
    # shape, the plain backward (autograd through wkv6_ref, the graph
    # built once) beside it.  Bound: r, k, v, w, dout read and dr, dk, dv,
    # dw written once, u read and du written: bytes over the HBM rate, or
    # the f32 work of wkv6_bwd_ops over 67 TFLOP/s, the larger
    # The kernel's time is the device's, from a CUDA graph of 10 calls
    # (graph_ms); back to back from the host a call also pays the host's
    # enqueue, timed apart.  Each of its three launches is timed apart the
    # same way on one call's scratch (the scan each time on the terms'
    # output of the run before: its time does not depend on the values).
    # wkv6's forward at the training shape beside it (its kernels-line row
    # is at the serving shape).
    from repro_torch.kernels import wkv6 as wkv6_kernel
    times = {}
    for shape in (TRAIN_WKV, SERVE_WKV):
        B_, S_, Hn_, D_ = shape
        x = wkv6_inputs(dev, gen, B_, S_, D_, heads=Hn_)
        d_out = torch.randn(shape, device=dev, generator=gen)
        xs = [t.clone().requires_grad_() for t in x]
        out, _ = ref.wkv6_ref(*xs)
        k_ms = graph_ms(lambda: ops.wkv6_bwd(*x, d_out))
        call_ms = cuda_ms(lambda: ops.wkv6_bwd(*x, d_out), iters=10)
        parts, _ = wkv6_kernel.bwd_launches(*x, d_out)
        part_ms = [graph_ms(fn) for fn in parts]
        log(f"[time] wkv6_bwd {shape} by launch (device): terms "
            f"{part_ms[0]:.4f} ms, scan {part_ms[1]:.4f} ms, chunk backward "
            f"{part_ms[2]:.4f} ms (sum {sum(part_ms):.4f}); a call back to "
            f"back from the host {call_ms:.4f} ms")
        if shape == TRAIN_WKV:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                ops.wkv6_bwd(*x, d_out)
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            log(f"[time] wkv6_bwd {shape}: the host's enqueue {host_ms:.4f} "
                "ms a call (checks, allocations, one launcher call, the du "
                "sum)")
            f_ms = graph_ms(lambda: ops.wkv6(*x))
            f_call = cuda_ms(lambda: ops.wkv6(*x), iters=10)
            fb_ms, fb_by = bound(*wkv6_cost(*shape))
            log(f"[time] wkv6 forward {shape} f32: kernel {f_ms:.4f} ms "
                f"(device), bound {fb_ms:.6f} ms ({fb_by}); "
                f"{fb_ms / f_ms:.1%} of the bound; a call back to back "
                f"from the host {f_call:.4f} ms")
        del parts
        p_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, d_out,
                                                   retain_graph=True),
                       iters=3, warmup=1)
        nbytes = 9 * B_ * S_ * Hn_ * D_ * 4 + 2 * Hn_ * D_ * 4
        b_ms, b_by = bound(nbytes, wkv6_bwd_ops(B_, S_, Hn_, D_))
        times[shape] = (k_ms, p_ms, b_ms, b_by)
        log(f"[time] wkv6_bwd {shape}: kernel {k_ms:.4f} ms (device), plain "
            f"(autograd through wkv6_ref) {p_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}); {b_ms / k_ms:.1%} of the bound")
        del x, d_out, xs, out
    k_ms, p_ms, b_ms, b_by = times[TRAIN_WKV]
    log("[time] wkv6_bwd library: null — no single PyTorch call computes "
        "the WKV-6 VJP")
    return dict(name="wkv6_bwd", route="cuda", source=SOURCES["wkv6_bwd"],
                replaces=TPU_KERNELS["wkv6_bwd"],
                launches=round_launches["fsvrg"]["wkv6_bwd"],
                max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def scale_phase(dev, sync, prob, trace) -> dict:
    """The engine's scale paths on the card, at the §4 problem ``prob``:

    * streamed: FSVRG and FedAvg (kernel aggregator) with ``client_chunk``
      SCALE_CHUNK for SCALE_ROUNDS rounds, each round on
      ``fold_in(PRNGKey(SEED), r)``, beside the plain rounds from the same
      keys (iterates within 1e-5 of max |w|), the counts set to 0 just
      before each streamed run and read just after (``fused_accumulate``
      Σ_b ⌈K_b / chunk⌉ a round, ``fused_epilogue`` 1, ``fused_aggregate``
      0), the peak device memory of each run (the streamed one lower);
    * cohort: FedAvg and FSVRG at participation SCALE_P with
      ``cohort = cohort_capacity(SCALE_P, max K_b)`` against the masked
      round on the same key (1e-5 of max |w|), clients computed and
      seconds; FSVRG + trimmed mean + cohort (one ``robust_aggregate`` a
      round, m = the gathered valid rows); FedAvg's cohort under ``trace``;
      a ``cohort=1`` run that overflows on a small problem, card against
      CPU;
    * virtual: FedAvg over ``get_virtual_k_config(K)`` with
      ``virtual_data`` and ``client_chunk`` VIRTUAL_CHUNK, one round at
      each of VIRTUAL_KS (finite, non-zero; the peak's growth per added
      client under half a client's materialized train rows), and at
      VIRTUAL_SMALL_K the per-client deltas bit-equal to the materialized
      data's on the same path, the iterates within 1e-5.

    Returns the streamed and robust runs' launches by kernel."""
    import gc

    import torch
    from repro_torch.configs import get_logreg_config, get_virtual_k_config
    from repro_torch.core import (build_problem, build_virtual_problem,
                                  cohort_capacity, make_solver)
    from repro_torch.data import generate, materialize_dataset, virtual_dataset
    from repro_torch.fleet import TraceParticipation
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_aggregate as ra_kernel
    from repro_torch.utils import threefry

    base = threefry.as_key(threefry.PRNGKey(SEED), dev)

    def rounds(solver, n, on_round=None):
        """n rounds from fold_in(PRNGKey(SEED), r): (state, seconds)."""
        state, secs = solver.init(), []
        for r in range(n):
            sync()
            t = time.perf_counter()
            state = solver.round(state, threefry.fold_in(base, r))
            sync()
            secs.append(time.perf_counter() - t)
            if on_round is not None:
                on_round(state, r)
        return state, secs

    def measured(make, n, on_round=None):
        """Build a solver and run it with the counts set to 0 just before
        and read just after: (state, seconds, launches, peak GB over the
        memory held before, the solver).  Solvers sit in reference cycles
        (their rounds close over them), so garbage is collected first: a
        solver freed in the middle of a run would hide its bytes."""
        gc.collect()
        sync()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solver = make()
        ops.reset_launch_counts()
        state, secs = rounds(solver, n, on_round)
        launches = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        return state, secs, launches, peak, solver

    def agree(label, got, want, rtol=1e-5):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        log(f"[scale] {label}: max_abs_err {err:.3e}, max |w| {scale:.3e} "
            f"(tolerance {rtol:g}·max|w|)")
        require(bool(torch.isfinite(got).all()) and scale > 0,
                f"{label}: a non-finite or zero iterate")
        require(err <= rtol * scale, f"{label}: disagree")

    sizes = [b.num_clients for b in prob.buckets]
    chunks = sum(-(-k // min(SCALE_CHUNK, k)) for k in sizes)
    launches = {}
    # -- streamed ------------------------------------------------------------
    for name in ("fsvrg", "fedavg"):
        got, s_secs, s_launch, s_peak, solver = measured(
            lambda: make_solver(name, prob, aggregator="pallas",
                                client_chunk=SCALE_CHUNK), SCALE_ROUNDS)
        del solver
        want, p_secs, _, p_peak, solver = measured(
            lambda: make_solver(name, prob, aggregator="pallas"),
            SCALE_ROUNDS)
        del solver
        log(f"[scale] {name} streamed (chunk {SCALE_CHUNK}, {chunks} chunks "
            f"a round): seconds a round " + ", ".join(f"{x:.3f}" for x in
                                                      s_secs)
            + "; plain " + ", ".join(f"{x:.3f}" for x in p_secs)
            + f"; peak device memory {s_peak:.3f} GB streamed, {p_peak:.3f} "
            "GB plain (over what was held); launches "
            + str({k: v for k, v in s_launch.items() if v}))
        agree(f"{name} streamed vs plain after {SCALE_ROUNDS} rounds",
              got.w, want.w)
        require(s_launch["fused_accumulate"] == SCALE_ROUNDS * chunks,
                f"{name}: fused_accumulate launched "
                f"{s_launch['fused_accumulate']} times, not "
                f"{SCALE_ROUNDS * chunks}")
        require(s_launch["fused_epilogue"] == SCALE_ROUNDS,
                f"{name}: fused_epilogue not once a round")
        require(s_launch["fused_aggregate"] == 0,
                f"{name}: the streamed round launched fused_aggregate")
        require(s_peak < p_peak, f"{name}: the streamed peak is not the "
                "lower one")
        for k, v in s_launch.items():
            launches[k] = launches.get(k, 0) + v
        del got, want
        torch.cuda.empty_cache()

    # -- cohort --------------------------------------------------------------
    cohort = cohort_capacity(SCALE_P, max(sizes))

    def computed(solver, masks):
        """Clients whose pass ran: a bucket's cap, or all of it where the
        draw overflowed (or cap ≥ K_b)."""
        eng, n = solver.engine, 0
        for k, m in zip(sizes, masks):
            cap = eng._cohort_cap(k)
            n += cap if (cap < k and int(m.sum()) <= cap) else k
        return n

    for name in ("fedavg", "fsvrg"):
        got, c_secs, c_launch, c_peak, solver = measured(
            lambda: make_solver(name, prob, aggregator="pallas",
                                participation=SCALE_P, cohort=cohort), 1)
        masks = solver.engine.participation_masks(threefry.fold_in(base, 0))
        n_comp = computed(solver, masks)
        del solver
        want, m_secs, _, m_peak, solver = measured(
            lambda: make_solver(name, prob, aggregator="pallas",
                                participation=SCALE_P), 1)
        del solver
        log(f"[scale] {name} cohort (p = {SCALE_P}, cohort {cohort}): "
            f"{n_comp} of {prob.num_clients} clients computed "
            f"({int(sum(float(m.sum()) for m in masks))} drawn); "
            f"{c_secs[0]:.3f} s a round against the masked round's "
            f"{m_secs[0]:.3f} s; peak {c_peak:.3f} GB against {m_peak:.3f} "
            "GB; launches " + str({k: v for k, v in c_launch.items() if v}))
        agree(f"{name} cohort vs masked round", got.w, want.w)
        require(c_launch["fused_epilogue"] == 1
                and c_launch["fused_aggregate"] == 0,
                f"{name}: the cohort round's aggregation launches")
        torch.cuda.empty_cache()

    # FSVRG + trimmed mean on the cohort: one robust_aggregate a round over
    # the gathered stacks, m = the gathered valid rows
    seen = []

    def on_robust(state, r):
        seen.append(ra_kernel.robust_aggregate.last_m)

    got, r_secs, r_launch, _, solver = measured(
        lambda: make_solver("fsvrg", prob, aggregator="pallas",
                            participation=SCALE_P, cohort=cohort,
                            aggregator_guard="trimmed_mean"), 1, on_robust)
    masks = solver.engine.participation_masks(threefry.fold_in(base, 0))
    gathered = sum(min(int(m.sum()), solver.engine._cohort_cap(k))
                   for k, m in zip(sizes, masks))
    log(f"[scale] fsvrg + trimmed_mean cohort: {r_secs[0]:.3f} s; robust m "
        f"{seen[0]} (the gathered valid rows {gathered}); launches "
        + str({k: v for k, v in r_launch.items() if v}))
    require(r_launch["robust_aggregate"] == 1 and seen[0] == gathered,
            "the robust cohort round's robust_aggregate")
    require(bool(torch.isfinite(got.w).all()), "robust cohort: non-finite")
    for k, v in r_launch.items():
        launches[k] = launches.get(k, 0) + v
    del solver, got
    torch.cuda.empty_cache()

    # FedAvg's cohort under the fleet trace of the faulted cells
    model = TraceParticipation(trace)
    t_cap = cohort_capacity(trace.max_rate(), max(sizes))
    got, t_secs, t_launch, _, solver = measured(
        lambda: make_solver("fedavg", prob, aggregator="pallas",
                            participation=trace.max_rate(), cohort=t_cap,
                            participation_model=model), 1)
    masks = solver.engine.participation_masks(None, 0)
    log(f"[scale] fedavg cohort under the fleet trace (cohort {t_cap}): "
        f"{computed(solver, masks)} of {prob.num_clients} clients computed "
        f"({int(sum(float(m.sum()) for m in masks))} returned); "
        f"{t_secs[0]:.3f} s")
    require(bool(torch.isfinite(got.w).all()), "trace cohort: non-finite")
    require(t_launch["fused_epilogue"] == 1, "trace cohort: epilogue")
    del solver, got
    torch.cuda.empty_cache()

    # cohort=1 overflows every bucket with two participants: the masked
    # fallback, card against CPU on a small problem
    small = generate(get_logreg_config().scaled(0.002), seed=SEED,
                     device="cpu")
    ws = []
    for device in ("cpu", dev):
        p = build_problem(small, device=device)
        sv = make_solver("fedavg", p, device=device, aggregator="pallas",
                         participation=0.5, cohort=1)
        ws.append(rounds(sv, ROUNDS)[0].w.cpu())
    agree(f"fedavg cohort=1 (overflow fallback) small problem card vs CPU "
          f"after {ROUNDS} rounds", ws[1], ws[0], rtol=1e-4)

    # -- virtual -------------------------------------------------------------
    vds = virtual_dataset(get_virtual_k_config(VIRTUAL_SMALL_K), seed=SEED)
    pv = build_virtual_problem(vds)
    pm = build_problem(materialize_dataset(vds))
    recorded = []
    for p in (pv, pm):
        sv = make_solver("fedavg", p, aggregator="pallas",
                         client_chunk=VIRTUAL_CHUNK)
        rec = []

        def record(w, bi, cb, keys, out, sv=sv, rec=rec):
            sv._chunk_pass(w, bi, cb, keys, out)
            rec.append(out[:int((cb.n_k > 0).sum())].clone())

        sv._round_fast = sv.engine.compile(sv._pass, chunk_pass=record)
        recorded.append((rounds(sv, 1)[0].w, rec))
    (w_v, rec_v), (w_m, rec_m) = recorded
    require(len(rec_v) == len(rec_m) and all(
        torch.equal(a, b) for a, b in zip(rec_v, rec_m)),
        "virtual per-client deltas differ from the materialized data's")
    log(f"[scale] fedavg virtual at K = {VIRTUAL_SMALL_K}: per-client deltas "
        f"bit-equal to the materialized data's ({sum(len(x) for x in rec_v)}"
        " clients)")
    agree(f"fedavg virtual vs materialized at K = {VIRTUAL_SMALL_K}", w_v,
          w_m)
    del pv, pm, recorded, rec_v, rec_m
    torch.cuda.empty_cache()

    peaks = {}
    for K in VIRTUAL_KS:
        cfg = get_virtual_k_config(K)
        gc.collect()
        sync()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vds = virtual_dataset(cfg, seed=SEED)
        pv = build_virtual_problem(vds)
        sv = make_solver("fedavg", pv, aggregator="pallas",
                         client_chunk=VIRTUAL_CHUNK)
        sync()
        t_build = time.perf_counter() - t0
        ops.reset_launch_counts()
        state, secs = rounds(sv, 1)
        v_launch = ops.launch_counts()
        peaks[K] = torch.cuda.max_memory_allocated() - held
        w = state.w
        train_rows = float(vds.client_sizes.mean())
        log(f"[scale] fedavg virtual K = {K} (d {cfg.num_features}, "
            f"{len(pv.buckets)} buckets of "
            + ", ".join(str(b.num_clients) for b in pv.buckets)
            + f" clients): build {t_build:.2f} s, a round "
            f"{secs[0]:.3f} s; peak {peaks[K] / 1e6:.1f} MB over what was "
            f"held; {train_rows:.2f} train rows a client; launches "
            + str({k: v for k, v in v_launch.items() if v}))
        require(bool(torch.isfinite(w).all()) and float(w.abs().max()) > 0,
                f"virtual K = {K}: the iterate is not finite and non-zero")
        require(v_launch["fused_epilogue"] == 1 and v_launch[
            "fused_accumulate"] == sum(-(-b.num_clients // min(
                VIRTUAL_CHUNK, b.num_clients)) for b in pv.buckets),
            f"virtual K = {K}: aggregation launches")
        del vds, pv, sv, state, w
        torch.cuda.empty_cache()
    k0, k1 = VIRTUAL_KS
    per_client = (peaks[k1] - peaks[k0]) / (k1 - k0)
    width = cfg.nnz_per_example + 2
    row_bytes = width * (8 + 4) + 4        # idx int64, val f32 and y f32
    client_bytes = train_rows * row_bytes
    log(f"[scale] virtual peak growth K = {k0} -> {k1}: {per_client:.1f} B "
        f"a client; one client's materialized train rows {client_bytes:.1f} "
        f"B ({train_rows:.2f} rows of {row_bytes} B), half {client_bytes / 2:.1f}")
    require(per_client < client_bytes / 2,
            "the virtual round's memory grows by half a client's rows or more")
    return launches


def campaign_phase(dev, sync) -> dict:
    """The fleet campaign (``repro_torch.fleet.run_campaign``) on the card
    at the §4 width, each check timed, the counts set to 0 just before each
    campaign and read just after:

    1. kill and resume: FSVRG and GD under ``FleetTrace(seed=0)`` for
       CAMPAIGN_ROUNDS rounds (checkpoints and evaluations every 2); an
       uninterrupted run, a run stopped after 3 rounds (FSVRG after its
       round-2 checkpoint) and its resume — final iterates ``torch.equal``
       and the deterministic event views identical; the checkpoint's
       bytes and its save and restore seconds;
    2. the rollback rail: GD with full participation under
       CAMPAIGN_FAULTS, ``guard="rollback"``, a checkpoint every round — at
       least one rollback, ``guard.json`` quarantining round 1, a finite
       final f;
    3. the engine's guard: FedAvg under the same faults with
       ``guard="trimmed_mean"`` for 2 rounds — no rollback, poisoned
       clients rejected, ``robust_aggregate`` launched;
    4. drift: GD with a new epoch every round (w_true × 0.8 a round,
       clients resampled) for 3 rounds — finite; epoch 2's rows at scale
       DRIFT_SMALL equal on the card and on the CPU;
    5. checkpoints: the reduced rwkv6-3b's bf16 parameter tree saved and
       restored on the card, and saved from the CPU and restored onto the
       card, leaf for leaf ``torch.equal``.

    Returns the launches by kernel over the phase's campaigns."""
    import gc
    import shutil
    import torch
    from repro_torch import checkpoint
    from repro_torch.bridge import tensor_tree_from_params
    from repro_torch.configs import get_config, get_logreg_config
    from repro_torch.core import Trainer
    from repro_torch.data import (drifted_dataset, materialize_dataset,
                                  virtual_dataset)
    from repro_torch.fleet import (CampaignSpec, DeltaFaults, EventLog,
                                   FleetTrace, deterministic_view,
                                   run_campaign)
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    launches = {}

    def campaign(label, spec, out, **kw):
        """``run_campaign`` into CAMPAIGN_DIR/out on the card: (result,
        its launches, seconds)."""
        gc.collect()
        sync()
        t = time.perf_counter()
        ops.reset_launch_counts()
        res = run_campaign(spec, str(CAMPAIGN_DIR / out), verbose=False,
                           device=dev, **kw)
        sync()
        got = {k: v for k, v in ops.launch_counts().items() if v}
        secs = time.perf_counter() - t
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        log(f"[campaign] {label}: {secs:.2f} s; launches {got}")
        return res, got, secs

    def events(out):
        return [deterministic_view(e) for e in
                EventLog(str(CAMPAIGN_DIR / out / "events.jsonl")).load()]

    def cells(summary):
        return "; ".join(
            f"{a} drawn {c['drawn_total']} realized {c['realized_total']} "
            f"stragglers {c['straggler_total']} faults "
            f"{c['faults_injected_total']} rejected "
            f"{c['clients_rejected_total']} rollbacks {c['rollbacks']} "
            f"final f {c.get('final_f')} err {c.get('final_err')}"
            for a, c in summary["cells"].items())

    def finite(summary, label):
        for a, c in summary["cells"].items():
            f = c.get("final_f")
            require(f is not None and math.isfinite(f),
                    f"{label}: {a}'s final f is not finite")

    faults = DeltaFaults.from_spec(CAMPAIGN_FAULTS)
    # -- 1. kill and resume ---------------------------------------------------
    t0 = time.perf_counter()
    spec = CampaignSpec(algos=("fsvrg", "gd"), rounds=CAMPAIGN_ROUNDS,
                        seed=SEED, scale=CAMPAIGN_SCALE, model="trace",
                        trace=FleetTrace(seed=0), eval_every=2,
                        checkpoint_every=2)
    full, got, _ = campaign("kill and resume: uninterrupted", spec, "ref")
    require(got.get("fsvrg_update", 0) > 0,
            "the campaign's FSVRG cell launched no fsvrg_update")
    log(f"[campaign] uninterrupted cells: {cells(full)}")
    finite(full, "kill and resume")
    part, _, _ = campaign("kill and resume: stopped after 3 rounds", spec,
                          "run", stop_after=3)
    require(part.get("interrupted") and part["rounds_done"] == 3,
            "the stopped campaign was not interrupted after 3 rounds")
    ck = CAMPAIGN_DIR / "run" / "cells" / "fsvrg"
    with open(ck / "manifest.json") as f:
        require(json.load(f)["step"] == 2,
                "FSVRG's checkpoint is not the one of round 2")
    nbytes = sum(p.stat().st_size for p in ck.iterdir())
    sync()
    t = time.perf_counter()
    state = Trainer.restore(str(ck), dev)
    sync()
    t_restore = time.perf_counter() - t
    probe = CAMPAIGN_DIR / "save_probe"
    t = time.perf_counter()
    checkpoint.save(str(probe), {"w": state.w, "aux": state.aux,
                                 "round": torch.tensor(state.round,
                                                       dtype=torch.int32)},
                    step=state.round)
    t_save = time.perf_counter() - t
    log(f"[campaign] FSVRG's round-2 checkpoint (d = {state.w.numel()}): "
        f"{nbytes} B on disk, restore {t_restore:.4f} s, save "
        f"{t_save:.4f} s")
    resumed, got, _ = campaign("kill and resume: resumed", spec, "run")
    for a in spec.algos:
        require(torch.equal(full["finals"][a]["w"], resumed["finals"][a]["w"]),
                f"kill and resume: {a}'s final iterate differs")
    ev_ref, ev_run = events("ref"), events("run")
    require(ev_ref == ev_run and len(ev_ref) == 2 * CAMPAIGN_ROUNDS,
            "kill and resume: the deterministic event views differ")
    log(f"[campaign] kill and resume: final iterates torch.equal, "
        f"{len(ev_ref)} deterministic events identical; "
        f"{time.perf_counter() - t0:.2f} s in all")
    del full, part, resumed, state
    # -- 2. the rollback rail -------------------------------------------------
    t0 = time.perf_counter()
    spec = CampaignSpec(algos=("gd",), rounds=CAMPAIGN_ROUNDS, seed=SEED,
                        scale=CAMPAIGN_SCALE, model="full", faults=faults,
                        guard="rollback", checkpoint_every=1)
    s, _, _ = campaign("rollback rail", spec, "rollback")
    with open(CAMPAIGN_DIR / "rollback" / "cells" / "gd" / "guard.json") as f:
        guard = json.load(f)
    cell = s["cells"]["gd"]
    log(f"[campaign] rollback rail: {cells(s)}; guard.json {guard}")
    require(cell["rollbacks"] >= 1, "the rail rolled nothing back")
    require(guard["quarantined"] == [1], "guard.json does not quarantine "
            "round 1")
    finite(s, "rollback rail")
    log(f"[campaign] rollback rail: {time.perf_counter() - t0:.2f} s")
    # -- 3. the engine's guard ------------------------------------------------
    spec = dataclasses.replace(spec, algos=("fedavg",), rounds=2,
                               guard="trimmed_mean")
    s, got, secs = campaign("engine guard (trimmed mean)", spec, "engine")
    cell = s["cells"]["fedavg"]
    log(f"[campaign] engine guard: {cells(s)}")
    require(cell["rollbacks"] == 0, "the trimmed mean still rolled back")
    require(cell["clients_rejected_total"] > 0, "no poisoned client was "
            "rejected")
    require(got.get("robust_aggregate", 0) == 2 and got.get(
        "fedavg_update", 0) > 0, "the guarded FedAvg cell did not launch "
        "robust_aggregate once a round and fedavg_update")
    finite(s, "engine guard")
    # -- 4. drift -------------------------------------------------------------
    t0 = time.perf_counter()
    spec = CampaignSpec(algos=("gd",), rounds=3, seed=SEED,
                        scale=CAMPAIGN_SCALE, model="trace",
                        trace=FleetTrace(seed=0), drift_every=1,
                        drift_w_scale=0.8, drift_resample=True)
    s, _, _ = campaign("drift (an epoch a round)", spec, "drift")
    log(f"[campaign] drift: {cells(s)}")
    finite(s, "drift")
    cfg = get_logreg_config().scaled(DRIFT_SMALL)
    card, host = (materialize_dataset(drifted_dataset(
        virtual_dataset(cfg, SEED, device=where), 2, w_true_scale=0.8,
        resample_clients=True)) for where in (dev, torch.device("cpu")))
    for name in ("idx", "val", "y", "client_of", "test_idx", "test_val",
                 "test_y", "test_client_of"):
        require(torch.equal(getattr(card, name).cpu(), getattr(host, name)),
                f"drift epoch 2 at scale {DRIFT_SMALL}: {name} differs on "
                "the card")
    log(f"[campaign] drift epoch 2 at scale {DRIFT_SMALL} (K = "
        f"{cfg.num_clients}, {host.num_examples} train rows): card vs CPU, "
        f"every array equal; {time.perf_counter() - t0:.2f} s in all")
    del card, host
    # -- 5. checkpoints of a bf16 parameter tree ------------------------------
    t0 = time.perf_counter()
    model = build_model(get_config(ARCH).reduced(), torch.bfloat16, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    tree = tensor_tree_from_params(params)
    leaves = checkpoint.checkpoint._flatten(tree)

    def same(restored, label):
        got = checkpoint.checkpoint._flatten(restored)
        require([p for p, _ in got] == [p for p, _ in leaves]
                and all(b.device.type == dev.type and b.dtype == a.dtype
                        and torch.equal(a, b)
                        for (_, a), (_, b) in zip(leaves, got)),
                f"the bf16 parameter tree {label} differs")

    t = time.perf_counter()
    checkpoint.save(str(CAMPAIGN_DIR / "bf16"), tree, step=1)
    t_save = time.perf_counter() - t
    t = time.perf_counter()
    restored, _ = checkpoint.restore(str(CAMPAIGN_DIR / "bf16"), dev)
    sync()
    t_restore = time.perf_counter() - t
    same(restored, "saved and restored on the card")
    cpu_tree = tensor_tree_from_params({k: v.cpu() for k, v in
                                        params.named_parameters()})
    checkpoint.save(str(CAMPAIGN_DIR / "bf16_cpu"), cpu_tree, step=1)
    restored, _ = checkpoint.restore(str(CAMPAIGN_DIR / "bf16_cpu"), dev)
    same(restored, "saved from the CPU and restored onto the card")
    nbytes = sum(p.stat().st_size for p in (CAMPAIGN_DIR / "bf16").iterdir())
    dtypes = sorted({str(v.dtype) for _, v in leaves})
    log(f"[campaign] reduced {ARCH} parameter tree ({len(leaves)} leaves, "
        f"{dtypes}): {nbytes} B, save {t_save:.4f} s, restore "
        f"{t_restore:.4f} s on the card; saved from the CPU and restored "
        f"onto the card, every leaf torch.equal; "
        f"{time.perf_counter() - t0:.2f} s")
    require("torch.bfloat16" in dtypes, "the reduced tree holds no bf16 leaf")
    del model, params, tree, restored, cpu_tree, leaves
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    gc.collect()
    return launches


def sampled_round_profile(name, solver, res, prob, dev, sync,
                          round_s) -> None:
    """The device's busy share of FSVRG's or FedAvg's round ``ROUNDS``,
    from a sample that stands for it: the prelude (FSVRG's full gradient)
    once, and every bucket's pass over its first PROFILE_ROWS rows (a
    bucket of those rows: the same clients and work a step, fewer steps),
    each part traced alone.  A step's device work does not depend on the
    step, so bucket b's device time counts m_pad / rows times: each bucket
    weighs in by its share of Σ m_pad, as in the round.  The estimated
    busy seconds are taken over ``round_s``, the unprofiled round's wall
    time.  (A pass's host time does not scale so: it has a fixed part, the
    draws and row gathers, which the scaling would count m_pad / rows
    times.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.problem import ClientBucket
    from repro_torch.utils import threefry

    w = res.w
    key = threefry.fold_in(threefry.as_key(threefry.PRNGKey(SEED), dev),
                           ROUNDS)
    ctx = (prob.flat.grad(w),) if name in PRELUDE else ()
    parts = [(1.0, lambda: prob.flat.grad(w))] if ctx else []
    rows = 0
    for bi, (wi, b) in enumerate(zip(solver.engine._offsets, prob.buckets)):
        n = min(b.m_pad, PROFILE_ROWS)
        rows += n
        cut = ClientBucket(b.idx[:, :n].contiguous(),
                           b.val[:, :n].contiguous(),
                           b.y[:, :n].contiguous(), b.n_k.clamp(max=n))

        def part(bi=bi, cut=cut, kb=threefry.fold_in(key, wi)):
            solver._pass(w, bi, cut, kb, torch.empty(
                (cut.num_clients, prob.d), device=dev), *ctx)
        parts.append((b.m_pad / n, part))
    busy_s = traced_s = 0.0
    top = {}                  # kernel -> [weighed device µs, weighed count]
    for weight, fn in parts:
        sync()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        traced_s += time.perf_counter() - t
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                busy_s += weight * e.self_device_time_total / 1e6
                acc = top.setdefault(e.key, [0.0, 0.0])
                acc[0] += weight * e.self_device_time_total
                acc[1] += weight * e.count
    steps = sum(b.m_pad for b in prob.buckets)
    if top:
        log(f"[profile] {name}: a sample of the round under the profiler "
            f"({'the prelude and ' if ctx else ''}every bucket's first "
            f"≤ {PROFILE_ROWS} rows: {rows} of Σ m_pad {steps}, each "
            f"bucket's device time weighed by m_pad / rows; {traced_s:.1f} "
            f"s to trace): device busy {busy_s:.3f} s of the unprofiled "
            f"{round_s:.3f} s round -> device idle share "
            f"{1 - busy_s / round_s:.1%}")
    else:
        log(f"[profile] {name}: device idle share: not measured (the "
            "profiler saw no device time)")
    for k, (us, count) in sorted(top.items(), key=lambda kv: kv[1][0],
                                 reverse=True)[:8]:
        log(f"[profile]   {us / 1e3:9.2f} ms {count:9.0f}× {k[:90]} "
            "(weighed)")


def atomic_data_grad(wk, bucket, plan, out):
    """DANE's local gradient as it was before the fixed-order sum: the
    same terms through CUDA's atomic ``scatter_add_`` (the yardstick of
    the [time] DANE turns; the port never calls it)."""
    from repro_torch.core.dane import row_scales
    Kb = bucket.num_clients
    gs = row_scales(wk, bucket)
    return out.zero_().scatter_add_(
        1, bucket.idx.reshape(Kb, -1),
        (gs[..., None] * bucket.val).reshape(Kb, -1))


def segment_sum_phase(dev, sync, prob, w, cuda_ms, bound) -> dict:
    """``segment_sum`` at DANE's main path's shapes — every bucket of the
    §4 problem with its plan and the local gradient's terms at ``w`` (a
    DANE iterate): the kernel against its plain version (the same bits)
    and against itself (two calls); its time, the plain version's and the
    atomic ``scatter_add_``'s (the sum it replaced) summed over the
    buckets, one call each, beside the bound (bytes: each kept term's slot
    index and b, a and out once).  Returns the numbers for the kernels
    line."""
    import torch
    from repro_torch.core.dane import bucket_plan, row_scales
    from repro_torch.kernels import ops, ref

    d = prob.d
    ms = plain = lib = nbytes = 0.0
    longest, n_terms, n_runs = 0, 0, 0
    for bi, b in enumerate(prob.buckets):
        Kb = b.num_clients
        plan = bucket_plan(b, d)
        flat_idx = b.idx.reshape(Kb, -1)
        gs = row_scales(w, b).contiguous()
        val = b.val.contiguous()
        out = torch.full((Kb, d), float("nan"), device=dev)
        got = ops.segment_sum(plan, gs, val, out).clone()
        again = ops.segment_sum(plan, gs, val, out).clone()
        want = ref.segment_sum_ref(plan, gs, val, torch.empty_like(out))
        sync()
        require(torch.equal(got, again), f"segment_sum bucket {bi}: two "
                "calls differ")
        require(torch.equal(got, want), f"segment_sum bucket {bi}: the "
                "kernel and its plain version differ")
        terms = (gs[..., None] * val).reshape(Kb, -1)
        atomic = torch.zeros_like(out).scatter_add_(1, flat_idx, terms)
        err = float((atomic - got).abs().max())
        require(err <= 1e-5 * float(got.abs().max()) + 1e-12,
                f"segment_sum bucket {bi}: far from the atomic sum")
        runs = plan.run_start[1:] - plan.run_start[:-1]
        longest = max(longest, int(runs.max()))
        n_terms += plan.order.numel()
        n_runs += plan.n_runs
        # the function's bytes: each kept term's slot index and b once, a
        # and out once (the plan's run arrays are the design's, not the
        # function's, and are left out)
        b_bytes = plan.order.numel() * 8 + gs.numel() * 4 + Kb * d * 4
        nbytes += b_bytes
        k_ms = cuda_ms(lambda: ops.segment_sum(plan, gs, val, out))
        p_ms = cuda_ms(lambda: ref.segment_sum_ref(plan, gs, val, out),
                       iters=3, warmup=1)
        a_ms = cuda_ms(lambda: torch.zeros_like(out).scatter_add_(
            1, flat_idx, terms))
        ms, plain, lib = ms + k_ms, plain + p_ms, lib + a_ms
        log(f"[check] segment_sum bucket {bi} ({Kb} × {b.m_pad} rows, "
            f"{plan.order.numel():,} nonzero terms into {Kb * d:,} slots, "
            f"{plan.n_runs:,} runs, the longest {int(runs.max())}): kernel "
            "== plain version and == itself bit for bit; vs the atomic "
            f"scatter_add_ {err:.3e}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.2f} ms, atomic scatter_add_ {a_ms:.4f} ms, bound "
            f"{bound(b_bytes, 0)[0]:.4f} ms (bytes)")
        del out, got, again, want, terms, atomic
    b_ms, b_by = bound(nbytes, 2 * n_terms)
    log(f"[time] segment_sum, one call a bucket ({len(prob.buckets)} "
        f"buckets, {n_terms:,} terms, {n_runs:,} runs, the longest "
        f"{longest}): kernel {ms:.4f} ms, plain {plain:.2f} ms, atomic "
        f"scatter_add_ {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e9:.3f} GB); {b_ms / ms:.1%} of the bound")
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def dane_turns(dev, sync, solver, state) -> dict:
    """DANE's round from one state, in turns: the fixed-order local
    gradient (what the port runs), the atomic one (``atomic_data_grad``),
    the atomic one, the fixed-order one; the fixed-order rounds' iterates
    must be ``torch.equal``.  Returns the seconds of each."""
    import torch
    from repro_torch.core import dane as dane_mod
    from repro_torch.utils import threefry

    key = threefry.fold_in(threefry.PRNGKey(SEED), ROUNDS + 1)
    fixed = dane_mod.data_grad
    secs = {"fixed": [], "atomic": []}
    ws = {"fixed": [], "atomic": []}
    try:
        for kind in ("fixed", "atomic", "atomic", "fixed"):
            dane_mod.data_grad = fixed if kind == "fixed" else (
                atomic_data_grad)
            sync()
            t = time.perf_counter()
            new = solver.round(state, key)
            sync()
            secs[kind].append(time.perf_counter() - t)
            ws[kind].append(new.w.clone())
    finally:
        dane_mod.data_grad = fixed
    same = torch.equal(ws["fixed"][0], ws["fixed"][1])
    same_atomic = torch.equal(ws["atomic"][0], ws["atomic"][1])
    diff = float((ws["fixed"][0] - ws["atomic"][0]).abs().max())
    log(f"[time] dane round from one state, in turns (fixed, atomic, "
        f"atomic, fixed): fixed-order local gradient "
        + ", ".join(f"{x:.3f}" for x in secs["fixed"]) + " s, atomic "
        "scatter_add_ " + ", ".join(f"{x:.3f}" for x in secs["atomic"])
        + f" s ({min(secs['fixed']) / min(secs['atomic']):.2f}× the "
        f"atomic round, target ≤ 1.5×); the two fixed-order rounds "
        f"torch.equal {same}, the two atomic rounds {same_atomic}; fixed "
        f"vs atomic iterate {diff:.3e}")
    require(same, "dane: two rounds from the same state differ on the card")
    return secs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_logreg_config
    from repro_torch.core import (EngineConfig, NonFiniteIterateError,
                                  RoundEngine, Trainer, build_problem,
                                  make_solver)
    from repro_torch.core.problem import LogRegProblem
    from repro_torch.data import generate
    from repro_torch.fleet import (BernoulliParticipation, DeltaFaults,
                                   FleetTrace, TraceParticipation,
                                   fault_counts, fleet_masks)
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import robust_aggregate as ra_kernel
    from repro_torch.utils import threefry

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 yardsticks
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    def phase(name):
        log(f"[phase] {name} at {time.perf_counter() - t_start:.1f} s")

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
    phase("build")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[build] {len(seconds)} libraries, {time.perf_counter() - t0:.2f} s "
        "in all; per library "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    require(len(seconds) == len(_build.SOURCES),
            "not every kernel was built")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    import ctypes
    occupancy = _build.launcher("wkv6", "wkv6_occupancy")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for code, dt in enumerate(("float32", "bfloat16")):
        blocks, regs, smem = (ctypes.c_int(0) for _ in range(3))
        _build.check(occupancy(code, ctypes.byref(blocks), ctypes.byref(regs),
                               ctypes.byref(smem)), "wkv6 occupancy")
        log(f"[build] wkv6 {dt}: {regs.value} registers a thread, "
            f"{smem.value} B of shared memory a block, "
            f"{blocks.value} blocks of 256 an SM (the occupancy "
            f"calculator): {blocks.value * sms} resident on {sms} "
            f"SMs for the {REQUESTS * 40} pairs of the serving prefill")
    occupancy = _build.launcher("wkv6_bwd", "wkv6_bwd_occupancy")
    for which, part in enumerate(("terms", "scan", "chunk backward")):
        res = [ctypes.c_int(0) for _ in range(4)]
        _build.check(occupancy(which, *map(ctypes.byref, res)),
                     "wkv6_bwd occupancy")
        blocks, regs, smem, local = (r.value for r in res)
        log(f"[build] wkv6_bwd {part}: {regs} registers a thread, {smem} B "
            f"of shared memory a block, {blocks} blocks of 256 an SM (the "
            f"occupancy calculator), {local} B of local memory a thread")
    occupancy = _build.launcher("robust_aggregate", "robust_select_occupancy")
    for m_occ in (3922, 10_000, ra_kernel.MAX_VALID):
        res = [ctypes.c_int(0) for _ in range(4)]
        _build.check(occupancy(0, m_occ, *map(ctypes.byref, res)),
                     "robust_select occupancy")
        cols, blocks, regs, smem = (r.value for r in res)
        log(f"[build] robust_select float32 at m = {m_occ}: {cols} columns "
            f"a block, {regs} registers a thread, {smem} B of shared memory "
            f"a block, {blocks} blocks of 512 an SM (the occupancy "
            "calculator)")

    # -- 3. kernels against their plain versions --------------------------- #
    phase("checks")
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

    def randn(shape, dt=torch.float32, scale=1.0):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dt)

    def rand(shape):
        return torch.rand(shape, device=dev, generator=g)

    K, d = 10_000, 20_002
    R = 6_478                            # the largest bucket's clients
    # summation order: the kernel adds K in splits of fused multiply-adds,
    # the plain version reduces in torch's order.  Shapes: the main path's,
    # K = d = 1, d odd (scalar lanes) and d ≡ 2 (mod 4) (float2 lanes, rows
    # not 16-byte aligned), f32 and bf16; a tensor and a float scale
    for KK, dd, dt in [(K, d, torch.float32), (K, d, torch.bfloat16),
                       (33, 999, torch.float32), (1, 1, torch.float32),
                       (1, 1, torch.bfloat16), (7, 1001, torch.float32),
                       (7, 1001, torch.bfloat16), (5, 1002, torch.float32),
                       (5, 1002, torch.bfloat16)]:
        deltas = randn((KK, dd), dt, 0.01)
        wts = rand(KK)
        wts /= wts.sum()
        w_t = randn(dd)
        a = rand(dd) * 3 + 1
        s = torch.tensor(1.25, device=dev)
        label = f"K={KK} d={dd} {dt}"
        got = ops.fused_aggregate(w_t, deltas, wts, a, s)
        err = compare("fused_aggregate", label, got,
                      ref.fused_aggregate_ref(w_t, deltas, wts, a, s),
                      1e-5, 1e-6)
        compare("fused_aggregate", label + " float scale",
                ops.fused_aggregate(w_t, deltas, wts, a, 0.75),
                ref.fused_aggregate_ref(w_t, deltas, wts, a, 0.75),
                1e-5, 1e-6)
        require(torch.equal(ops.fused_aggregate(w_t, deltas, wts, a, s), got),
                f"fused_aggregate {label}: two calls differ")
        log(f"[check] fused_aggregate {label}: two calls bit-equal")
        if (KK, dd, dt) == (K, d, torch.float32):
            max_err["fused_aggregate"] = err
        if dt == torch.float32:
            # the three wrappers over the same kernel
            acc = randn(dd)
            compare("fused_accumulate", label,
                    ops.fused_accumulate(acc, deltas, wts),
                    ref.fused_accumulate_ref(acc, deltas, wts), 1e-5, 1e-6)
            compare("fused_epilogue", f"d={dd}",
                    ops.fused_epilogue(w_t, acc, a, 0.8),
                    ref.fused_epilogue_ref(w_t, acc, a, 0.8), 1e-6, 1e-6)
            w_ks = deltas + w_t
            # w_k − w^t re-rounds each delta at the scale of |w^t| ~ 4
            compare("scaled_aggregate", label,
                    ops.scaled_aggregate(w_t, w_ks, wts, a),
                    ref.scaled_aggregate_ref(w_t, w_ks, wts, a), 1e-5, 1e-5)
            del w_ks
        del deltas
    # the scale paths' shapes: one client, a streamed chunk, a bucket's
    # last chunk (10,000 − 9·1,024 = 784 clients) and that chunk padded to
    # a whole chunk with zero-weight rows of large finite values (they add
    # nothing); the epilogue with a tensor scale
    errs = []
    for KK in (1, SCALE_CHUNK, K % SCALE_CHUNK):
        deltas, acc = randn((KK, d), scale=0.01), randn(d)
        wts = rand(KK) / KK
        got = ops.fused_accumulate(acc, deltas, wts)
        errs.append(compare("fused_accumulate", f"chunk K={KK} d={d}", got,
                            ref.fused_accumulate_ref(acc, deltas, wts),
                            1e-5, 1e-6))
        if KK == K % SCALE_CHUNK:
            pad = SCALE_CHUNK - KK
            padded = torch.cat([deltas, torch.full((pad, d), 3e4,
                                                   device=dev)])
            pw = torch.cat([wts, torch.zeros(pad, device=dev)])
            compare("fused_accumulate", f"chunk K={KK} padded to "
                    f"{SCALE_CHUNK} with zero-weight rows",
                    ops.fused_accumulate(acc, padded, pw), got, 1e-6, 1e-6)
    max_err["fused_accumulate"] = max(errs)
    w_t, a = randn(d), rand(d) * 3 + 1
    s = torch.tensor(1.25, device=dev)
    max_err["fused_epilogue"] = compare(
        "fused_epilogue", f"d={d} tensor scale",
        ops.fused_epilogue(w_t, acc, a, s),
        ref.fused_epilogue_ref(w_t, acc, a, s), 1e-6, 1e-6)
    del deltas, padded
    # FMA contraction in the kernels vs separate roundings in the plain
    # versions: a few ulp of the f32 operands (|S·diff| reaches ~20); bf16
    # outputs may round apart by one bf16 ulp (2^-8 relative)
    for label, shape, shared, dt, tol in [
            ("1-D d=20002 scalar h", (d,), False, torch.float32, 1e-5),
            ("batched R=6478 per-row h", (R, d), False, torch.float32, 1e-5),
            ("broadcast R=6478 (main-path form)", (R, d), True,
             torch.float32, 1e-5),
            ("broadcast R=33 d=999 bf16", (33, 999), True, torch.bfloat16,
             1e-2)]:
        w, S, gn = (randn(shape, dt) for _ in range(3))
        row = shape[-1:] if shared else shape
        go, gb = (randn(row, dt) for _ in range(2))
        h = rand(shape[0]) if len(shape) == 2 else 0.37
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
    # FedAvg's and DANE's steps: per-row h = valid·h with h = 0 rows (the
    # padded slots), DANE's w^t one shared row, as on the main paths
    lam = 1.0 / 2_166_693
    for label, shape, dt, tol in [
            ("R=6478 d=20002 per-row h (main-path form)", (R, d),
             torch.float32, 1e-5),
            ("1-D d=20002 scalar h", (d,), torch.float32, 1e-5),
            ("R=33 d=999 bf16", (33, 999), torch.bfloat16, 1e-2)]:
        w, gr, a = (randn(shape, dt) for _ in range(3))
        w_t = randn(shape[-1:], dt)
        if len(shape) == 2:
            h = rand(shape[0]) * 0.1
            h[::5] = 0.0
        else:
            h = 0.1
        got = ops.fedavg_update(w, gr, h, lam)
        err = compare("fedavg_update", label, got,
                      ref.fedavg_update_ref(w, gr, h, lam), tol, tol)
        if len(shape) == 2:
            require(torch.equal(got[::5], w[::5]), "h = 0 rows changed")
            if dt == torch.float32:
                max_err["fedavg_update"] = err
        del got
        got = ops.dane_update(w, gr, a, w_t, 0.3, lam, 3.0)
        err = compare("dane_update", label.replace(" per-row h", "")
                      .replace(" scalar h", ""), got,
                      ref.dane_update_ref(w, gr, a, w_t, 0.3, lam, 3.0),
                      tol, tol)
        if len(shape) == 2 and dt == torch.float32:
            max_err["dane_update"] = err
        del w, gr, a, got
    # the SDCA solve: the main path's margins reach |m| ~ 10 and its
    # curvature c = σ′||x||²/(2λn) ~ 10⁴; padding slots are a fixed point
    for n_coord, dt, tol in [(R, torch.float32, 1e-5), (1, torch.float32, 1e-5),
                             (127, torch.float32, 1e-5),
                             (127, torch.bfloat16, 1e-2)]:
        b0 = (rand(n_coord) * (1 - 2e-6) + 1e-6).to(dt)
        m = randn(n_coord, dt, 10.0)
        c = (rand(n_coord) * 2e4).to(dt)
        c[::4] = 0.0
        err = compare("cocoa_sdca_update", f"N={n_coord} {dt}",
                      ops.cocoa_sdca_update(b0, m, c),
                      ref.cocoa_sdca_update_ref(b0, m, c), tol, tol)
        if n_coord == R:
            max_err["cocoa_sdca_update"] = err
        pad = torch.full((n_coord,), 0.5, device=dev, dtype=dt)
        zero = torch.zeros_like(pad)
        require(torch.equal(ops.cocoa_sdca_update(pad, zero, zero), pad),
                "padding slots moved")
    # the order-statistic update: valid ≈ 40 % from the fleet trace's
    # round 0 at the main path's K; the window's sum is taken in another
    # order than the plain version's
    trace = FleetTrace(seed=SEED)
    ids_k = torch.arange(K, device=dev)
    valid_k = fleet_masks(trace, 0, ids_k).returned > 0
    m_trace = int(valid_k.sum())

    def robust(label, w_t, x, v, a, trim, mode, exact=False):
        got = ops.robust_aggregate(w_t, x, v, a, trim, mode)
        require(ra_kernel.robust_aggregate.last_m == int((v > 0).sum()),
                f"robust_aggregate {label}: m read back wrong")
        expect = ref.robust_aggregate_ref(w_t, x, v, a, trim, mode)
        if exact:
            require(torch.equal(got, expect), f"robust_aggregate {label} "
                    "is not the plain version bit for bit")
            log(f"[check] robust_aggregate {label}: bit-equal")
            return 0.0
        both_nan = torch.isnan(got) & torch.isnan(expect)
        err = torch.where(both_nan, 0.0, (got - expect).abs())
        bound = 1e-6 + 1e-5 * expect.abs()
        ok = bool(((err <= bound) | (got == expect) | both_nan).all())
        worst = float(err.nan_to_num(0.0, posinf=0.0).max())
        log(f"[check] robust_aggregate {label}: max_abs_err {worst:.3e} "
            "(tolerance 1e-06 + 1e-05·|plain|; NaN and ±inf where the "
            "plain version has them)")
        require(ok, f"robust_aggregate {label} disagrees")
        return worst

    deltas = randn((K, d), scale=0.01)
    w_t, a = randn(d), rand(d) * 3 + 1
    # the scale fault's ×100 on 2 % of the rows: heavy-tailed columns
    heavy = deltas.clone()
    heavy[torch.randperm(K, device=dev, generator=g)[:K // 50]] *= 100
    for mode in ("trimmed_mean", "median"):
        for x, label in ((deltas, ""), (heavy, ", 2 % of rows ×100")):
            err = robust(f"K={K} d={d} m={m_trace} {mode}{label}", w_t, x,
                         valid_k, a, 0.1, mode)
            max_err["robust_aggregate"] = max(
                max_err.get("robust_aggregate", 0.0), err)
        require(torch.equal(ops.robust_aggregate(w_t, deltas, valid_k, a,
                                                 0.1, mode),
                            ops.robust_aggregate(w_t, deltas, valid_k, a,
                                                 0.1, mode)),
                f"robust_aggregate {mode}: two calls differ")
        log(f"[check] robust_aggregate K={K} d={d} m={m_trace} {mode}: two "
            "calls bit-equal")
    del deltas, heavy
    for KK in (1, 127, 999):
        for dd in (1, 127, 999):
            x, w1, a1 = randn((KK, dd)), randn(dd), rand(dd) + 0.5
            v = rand(KK) < 0.6
            for mode in ("trimmed_mean", "median"):
                robust(f"K={KK} d={dd} m={int(v.sum())} {mode}", w1, x, v,
                       a1, 0.25, mode)
    x, w1, a1 = randn((150, 513)), randn(513), rand(513) + 0.5
    every = torch.ones(150, dtype=torch.bool, device=dev)
    sparse = x * (rand((150, 513)) < 0.05)
    odd = torch.arange(150, device=dev) % 3 > 0
    bad = x.clone()
    bad[3, :40] = float("inf")
    bad[4, 20:60] = float("-inf")
    bad[5, 50:90] = float("nan")
    bad[6:9, :5] = float("nan")
    require(ref.robust_window(150, 0.42, "trimmed_mean") == (62, 88),
            "the f32 floor of 0.42·150 is not 62")
    for mode in ("trimmed_mean", "median"):
        robust(f"m=0 {mode}", w1, x, torch.zeros_like(every), a1, 0.1, mode,
               exact=True)
        require(torch.equal(ops.robust_aggregate(
            w1, x, torch.zeros_like(every), a1, 0.1, mode), w1),
            "m = 0 moved w^t")
        for m in (1, 2):
            v = torch.zeros_like(every)
            v[[7, 100][:m]] = True
            robust(f"m={m} {mode}", w1, x, v, a1, 0.1, mode)
        robust(f"heavy ties (95 % zeros) {mode}", w1, sparse, every, a1,
               0.1, mode)
        robust(f"trim=0.42 m=150 (lo=62) {mode}", w1, x, every, a1, 0.42,
               mode)
        robust(f"bf16 deltas {mode}", w1, x.to(torch.bfloat16), odd, a1,
               0.25, mode)
        for v, label in ((every, "all valid"), (odd, "2/3 valid")):
            robust(f"valid rows holding ±inf/NaN, {label}, {mode}", w1, bad,
                   v, a1, 0.25, mode)
    torch.cuda.empty_cache()

    # the card's threefry and everything drawn from it: the CPU's bits
    ids_c = torch.arange(K)
    key = threefry.fold_in(threefry.PRNGKey(SEED), 997)
    kc, kg = threefry.fold_in(key, ids_c), threefry.fold_in(key, ids_k)
    require(all(torch.equal(x, y.cpu()) for x, y in zip(kc, kg)),
            "fold_in on the card differs from the CPU")
    for shape, lo, hi in (((), 0.0, 1.0), ((64,), -1.0, 1.0)):
        require(torch.equal(threefry.uniform(kc, shape, lo, hi),
                            threefry.uniform(kg, shape, lo, hi).cpu()),
                f"uniform {shape} on the card differs from the CPU")
    faults = DeltaFaults(seed=SEED, **FAULT_RATES)
    for r in range(ROUNDS):
        mc, mg = fleet_masks(trace, r, ids_c), fleet_masks(trace, r, ids_k)
        require(torch.equal(mc.available, mg.available.cpu())
                and torch.equal(mc.returned, mg.returned.cpu()),
                f"fleet masks of round {r} differ between card and CPU")
        require(torch.equal(faults.kinds(r, ids_c),
                            faults.kinds(r, ids_k).cpu()),
                f"fault kinds of round {r} differ between card and CPU")
    log(f"[check] threefry fold_in / uniform, fleet masks and fault kinds "
        f"at K={K}, rounds 0-{ROUNDS - 1}: card == CPU bit for bit "
        f"(round 0 returns {m_trace} clients)")
    check_draws(dev)
    max_err["wkv6"] = check_wkv6(dev, g, compare)

    # -- 4. the main paths at full width ----------------------------------- #
    phase("main paths")
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
    steps = sum(m_pads)
    log(f"[main] generate (threefry, on the card) {t_gen:.2f} s "
        f"({ds.num_examples} train rows);"
        f" build_problem {t_build:.2f} s: {len(prob.buckets)} buckets,"
        " Kb×m_pad " + ", ".join(f"{b.num_clients}×{b.m_pad}"
                                  for b in prob.buckets)
        + f"; Σ m_pad {steps}")
    f0 = float(prob.flat.loss(torch.zeros(prob.d, device=dev)))
    check_data(dev)

    # the engine's Bernoulli masks on the card against the CPU's, at the
    # full-width layout: uniform(fold_in(fold_in(key, wi), 997)) < p
    mask_eng = RoundEngine(prob, EngineConfig(participation=0.1))
    drawn = []
    for r in range(ROUNDS):
        key = threefry.fold_in(threefry.PRNGKey(SEED), r)
        mg = mask_eng.participation_masks(key, r)
        mc = BernoulliParticipation(0.1).masks(
            key, r, mask_eng._offsets, mask_eng._sizes, torch.device("cpu"))
        require(all(torch.equal(x.cpu(), y) for x, y in zip(mg, mc)),
                f"the engine's masks of round {r} differ between card and "
                "CPU")
        drawn.append(int(sum(float(m.sum()) for m in mg)))
    log(f"[check] the engine's Bernoulli masks (p = 0.1) at K = "
        f"{prob.num_clients}, rounds 0-{ROUNDS - 1}: card == CPU bit for "
        f"bit ({', '.join(map(str, drawn))} clients drawn)")
    del mask_eng

    def cocoa_dual(state):
        """CoCoA+'s dual objective in f64: D(α) = −(1/n) Σ_i [β_i log β_i
        + (1 − β_i) log(1 − β_i)] − (λ/2)‖w‖², β_i = y_i α_i over the valid
        rows, w the state's iterate (= (1/λn) X α)."""
        ent = torch.zeros((), dtype=torch.float64, device=dev)
        for b, alpha in zip(prob.buckets, state.aux):
            valid = (torch.arange(b.m_pad, device=dev)[None, :]
                     < b.n_k[:, None])
            beta = (b.y.double() * alpha.double())[valid]
            ent = ent + (torch.special.xlogy(beta, beta)
                         + torch.special.xlogy(1 - beta, 1 - beta)).sum()
        w = state.w.double()
        return float(-ent / prob.flat.n - 0.5 * prob.flat.lam * (w @ w))

    def local_steps(name, solver):
        """Launches of the client pass's kernel a round: a batched local
        step each (CoCoA+: the whole pass of a bucket each)."""
        if name == "fedavg":
            return solver.cfg.local_epochs * steps
        if name in ("dane", "cocoa"):
            return (solver.cfg.local_steps if name == "dane" else 1) * len(
                prob.buckets)
        if name == "svrg_naive":
            return solver.cfg.naive_steps * len(prob.buckets)
        return steps

    def draw_seconds(name, solver, r):
        """The seconds round r's own draws take on the card: the masks,
        each bucket's key and its clients' keys and permutations (FSVRG,
        FedAvg, CoCoA+) or samples (svrg_naive; DANE's SVRG solver)."""
        eng = solver.engine
        sync()
        t = time.perf_counter()
        key = threefry.fold_in(threefry.as_key(threefry.PRNGKey(SEED), dev),
                               r)
        eng.participation_masks(key, r)
        for bi, (wi, b) in enumerate(zip(eng._offsets, prob.buckets)):
            kb = threefry.fold_in(key, wi)
            if name in ("fsvrg", "fedavg", "cocoa"):
                solver.permutations(kb, bi, b)
            elif name == "svrg_naive" or (
                    name == "dane" and solver.cfg.local_solver == "svrg"):
                solver.samples(kb, bi, b)
            else:
                eng.client_keys(kb, b.num_clients)
        sync()
        return time.perf_counter() - t

    # the prelude's full gradients, counted where they are computed
    grads = [0]
    plain_grad = LogRegProblem.grad

    def counted_grad(self, w):
        grads[0] += 1
        return plain_grad(self, w)

    def drive(name, solver, on_round=None, rounds=ROUNDS):
        """Run ``solver`` for ``rounds`` rounds with the launch counts set
        to 0 just before and read just after; seconds per round exclude the
        loss evaluation; ``on_round(state, r)`` runs after each round."""
        eval_s, round_s, round_end, w_first = [], [], [0.0], []

        def eval_fn(w):
            sync()
            t = time.perf_counter()
            f = float(prob.flat.loss(w))
            eval_s.append(time.perf_counter() - t)
            return {"f": f}

        def callback(state, r):
            sync()
            now = time.perf_counter()
            round_s.append(now - round_end[0] - eval_s[-1])
            if r == 0:
                w_first.append(state.w.clone())
            if on_round is not None:
                on_round(state, r)
            sync()
            round_end[0] = time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        sync()
        grads[0] = 0
        ops.reset_launch_counts()
        round_end[0] = time.perf_counter()
        res = Trainer(solver, rounds=rounds, seed=SEED, eval_fn=eval_fn,
                      callback=callback).fit()
        sync()
        launches = ops.launch_counts()
        return dict(solver=solver, res=res, launches=launches,
                    round_s=round_s, eval_s=eval_s, w_first=w_first[0],
                    hist=[h["f"] for h in res.history],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    grads=grads[0])

    LogRegProblem.grad = counted_grad
    runs = {}
    for name in STEP_KERNEL:
        t0 = time.perf_counter()
        solver = make_solver(name, prob, aggregator="pallas")
        sync()
        t_make = time.perf_counter() - t0
        duals = []
        run_ = runs[name] = drive(
            name, solver, (lambda state, r: duals.append(cocoa_dual(state)))
            if name == "cocoa" else None)
        res, launches, hist = run_["res"], run_["launches"], run_["hist"]
        kernel = STEP_KERNEL[name]
        expected = ROUNDS * local_steps(name, solver)
        log(f"[main] {name}: make_solver {t_make:.2f} s; loss: round 0 "
            f"{f0:.6f} -> " + " -> ".join(f"{f:.6f}" for f in hist))
        draw_s = draw_seconds(name, solver, ROUNDS - 1)
        run_["draw_s"] = draw_s
        log(f"[main] {name}: seconds per round " + ", ".join(
            f"{s:.3f}" for s in run_["round_s"]) + f"; of a round, its own "
            f"draws (masks, keys, permutations or samples) {draw_s:.4f} s; "
            f"peak device memory {run_['peak_gb']:.2f} GB; full gradients "
            f"{run_['grads']}")
        # DANE's local gradient: one segment_sum a GD step and one for
        # a_k, in every bucket
        also = ({"segment_sum": ROUNDS * (solver.cfg.local_steps + 1)
                 * len(prob.buckets)} if name == "dane" else {})
        log(f"[main] {name}: launches {launches} (expected {kernel} "
            f"{expected}, fused_aggregate {ROUNDS}"
            + "".join(f", {k} {v}" for k, v in also.items()) + ")")
        require(all(f == f and abs(f) != float("inf") for f in hist),
                f"{name}: non-finite loss")
        if name in ("fsvrg", "fedavg"):
            require(all(f < f0 for f in hist),
                    f"{name}: the loss did not fall below round 0's")
        elif name == "cocoa":
            # CoCoA+ ascends the dual; its primal loss is not monotone with
            # σ′ = K (from the seed's data it rises in every round here,
            # and after round 1 at K = 500-2,000 in both packages alike), so
            # the checks are the dual's rise every round, weak duality and
            # the primal–dual invariant w = (1/λn) Σ_k X_k α_k
            log("[main] cocoa: dual objective D(α) (f64), round 0 0 -> "
                + " -> ".join(f"{x:.6f}" for x in duals))
            require(all(b > a for a, b in zip([0.0] + duals, duals)),
                    "cocoa: the dual objective did not rise every round")
            require(all(x < f for x, f in zip(duals, hist)),
                    "cocoa: a dual objective above the primal loss")
            w_dual = torch.zeros(prob.d, dtype=torch.float64, device=dev)
            for b, alpha in zip(prob.buckets, res.state.aux):
                w_dual.index_add_(0, b.idx.reshape(-1), (
                    b.val.double() * alpha.double()[..., None]).reshape(-1))
            w_dual /= prob.flat.lam * prob.flat.n
            err = float((res.w.double() - w_dual).abs().max())
            scale = float(w_dual.abs().max())
            log(f"[main] cocoa: w vs (1/λn) Σ_k X_k α_k (f64): max_abs_err "
                f"{err:.3e}, max |w| {scale:.3e} (tolerance 1e-4·max|w|: "
                "f32 sums over 3 rounds)")
            require(err <= 1e-4 * scale,
                    "cocoa: w drifted from (1/λn) Σ_k X_k α_k")
        # DANE's losses are logged, not held: the paper reports it
        # converging poorly on this data
        require(res.w.shape == (prob.d,)
                and bool(torch.isfinite(res.w).all()), f"{name}: bad iterate")
        require(launches[kernel] == expected,
                f"{name}: {kernel} was not launched once per local step")
        require(launches["fused_aggregate"] == ROUNDS,
                f"{name}: fused_aggregate was not launched once per round")
        require(all(launches[k] == v for k, v in also.items()),
                f"{name}: {also} expected")
        require(all(v == 0 for k, v in launches.items()
                    if k not in (kernel, "fused_aggregate", *also)),
                f"{name}: launched another solver's kernel")
        require(run_["grads"] == (ROUNDS if name in PRELUDE else 0),
                f"{name}: not one full gradient per round")

    # CoCoA+'s pass kernel against the plain step loop on the card, at every
    # full-width bucket from the run's iterate and dual blocks, and at the
    # largest bucket with features repeated in its rows (entry 1 = entry 0
    # everywhere, and every third row one feature five times).  Tolerance
    # 1e-5 of max |plain| for u and r: the kernel reduces each row in
    # another order and adds repeated features in atomic order
    cocoa_solver, cocoa_res = runs["cocoa"]["solver"], runs["cocoa"]["res"]
    flat = prob.flat
    sdca_args = []
    pass_key = threefry.PRNGKey(SEED + 5)
    for bi, (wi, b) in enumerate(zip(cocoa_solver.engine._offsets,
                                     prob.buckets)):
        sdca_args.append((cocoa_res.w, cocoa_res.state.aux[bi], b.idx, b.val,
                          b.y, b.n_k, cocoa_solver.permutations(
                              threefry.fold_in(pass_key, wi), bi, b)))
    big_b = max(range(len(prob.buckets)),
                key=lambda i: prob.buckets[i].num_clients)
    rep_idx = prob.buckets[big_b].idx.clone()
    rep_idx[:, :, 1] = rep_idx[:, :, 0]
    rep_idx[:, ::3, 1:5] = rep_idx[:, ::3, 5:6]
    pass_cases = [(f"bucket {bi} ({b.num_clients}×{b.m_pad})", sdca_args[bi])
                  for bi, b in enumerate(prob.buckets)]
    pass_cases.append((f"bucket {big_b} with repeated features in every row",
                       sdca_args[big_b][:2] + (rep_idx,)
                       + sdca_args[big_b][3:]))
    sdca_scalars = (cocoa_solver.sigma, flat.lam, flat.n)
    worst = 0.0
    pass_times = []      # per bucket: (kernel ms by events, plain ms)
    for label, args in pass_cases:
        Kb = args[1].shape[0]
        r_k = torch.empty((Kb, prob.d), device=dev)
        r_p = torch.empty((Kb, prob.d), device=dev)
        before = ops.launch_counts()["cocoa_sdca_pass"]
        u_k = ops.cocoa_sdca_pass(*args, *sdca_scalars, r_k)
        require(ops.launch_counts()["cocoa_sdca_pass"] == before + 1,
                "cocoa_sdca_pass did not launch")
        sync()
        t0 = time.perf_counter()
        u_p = ref.cocoa_sdca_pass_ref(*args, *sdca_scalars, r_p)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for part, got, expect in (("u", u_k, u_p), ("r", r_k, r_p)):
            worst = max(worst, compare(
                "cocoa_sdca_pass", f"{label} {part}", got, expect, 0.0,
                1e-5 * float(expect.abs().max())))
        if len(pass_times) < len(prob.buckets):
            pass_times.append((cuda_ms(lambda: ops.cocoa_sdca_pass(
                *args, *sdca_scalars, r_k), iters=5, warmup=0), plain_ms))
        del r_k, r_p, u_k, u_p, args
    max_err["cocoa_sdca_pass"] = worst
    del rep_idx, pass_cases, sdca_args   # before the runs that report a peak
    torch.cuda.empty_cache()

    @contextlib.contextmanager
    def plain_sdca_pass():
        """CoCoA+'s pass through the plain step loop on the card (the
        yardstick of the kernel; the port's main path never runs it)."""
        kernel = ops.cocoa_sdca_pass
        ops.cocoa_sdca_pass = ref.cocoa_sdca_pass_ref
        try:
            yield
        finally:
            ops.cocoa_sdca_pass = kernel

    def held_to_plain_pass(label, run_, make):
        """A round of a fresh solver from ``make()`` through the plain pass
        (≈ 40 s at full width), same seed: w within 1e-4 of max |w| of the
        kernel run's first round."""
        with plain_sdca_pass():
            plain = drive("cocoa", make(), rounds=1)
        w_k, w_p = run_["w_first"], plain["res"].w
        err = float((w_k - w_p).abs().max())
        scale = float(w_p.abs().max())
        log(f"[main] {label}: seconds per round through the pass kernel "
            + ", ".join(f"{x:.4f}" for x in run_["round_s"])
            + "; through the plain step loop "
            + ", ".join(f"{x:.3f}" for x in plain["round_s"])
            + f" (same call); w after round 1: max_abs_err {err:.3e}"
            f", max |w| {scale:.3e} (tolerance 1e-4·max|w|)")
        require(err <= 1e-4 * scale,
                f"{label}: the kernel's rounds and the plain pass's disagree")
        del plain                  # its solver's buffers, before the next run
        torch.cuda.empty_cache()

    held_to_plain_pass(
        "cocoa", runs["cocoa"],
        lambda: make_solver("cocoa", prob, aggregator="pallas"))

    # each solver on a small problem, kernels on the card vs plain versions
    # on the CPU, same data and the same round keys: each device draws the
    # masks, permutations and samples itself, bit for bit the same
    small = generate(get_logreg_config().scaled(0.002), seed=SEED,
                     device="cpu")

    def small_runs(name, **kw):
        """The iterate after ROUNDS rounds on the CPU and on the card."""
        ws, engines = [], []
        for device in ("cpu", "cuda"):
            p = build_problem(small, device=device)
            sv = make_solver(name, p, device=device, aggregator="pallas",
                             **kw)
            ws.append(Trainer(sv, rounds=ROUNDS, seed=SEED).fit().w.cpu())
            engines.append(sv.engine)
        return ws, engines

    for name in STEP_KERNEL:
        ws, _ = small_runs(name)
        scale = float(ws[0].abs().max())
        err = float((ws[1] - ws[0]).abs().max())
        log(f"[main] {name} small problem (scale 0.002) card vs CPU after "
            f"{ROUNDS} rounds: max_abs_err {err:.3e}, max |w| {scale:.3e} "
            "(tolerance 1e-4·max|w|: summation order and FMA contraction)")
        require(err <= 1e-4 * scale, f"{name}: card and CPU runs disagree")

    # -- 5. the fault-tolerant rounds at full width ----------------------- #
    phase("faulted paths")
    participation = TraceParticipation(trace)
    ids_k = torch.arange(prob.num_clients, device=dev)
    offsets = [int(x) for x in torch.tensor(
        [0] + [b.num_clients for b in prob.buckets]).cumsum(0)[:-1]]
    sizes = [b.num_clients for b in prob.buckets]
    fault_runs = {}
    for name, guard in GUARDED.items():
        solver = make_solver(name, prob, aggregator="pallas",
                             participation_model=participation,
                             fault_model=faults, **guard)
        per_round = []

        def on_round(state, r, name=name, per_round=per_round):
            require(bool(torch.isfinite(state.w).all()),
                    f"{name}: non-finite iterate in faulted round {r}")
            avail, returned = participation.mask_components(
                None, r, offsets, sizes, dev)
            ret = torch.cat(returned)
            injected, poisoned = fault_counts(faults, r, ids_k, ret)
            row = dict(drawn=int(torch.cat(avail).sum()),
                       realized=int(ret.sum()), injected=injected,
                       poisoned=poisoned,
                       m=ra_kernel.robust_aggregate.last_m)
            ra_kernel.robust_aggregate.last_m = None
            per_round.append(row)

        run_ = fault_runs[name] = drive(name, solver, on_round)
        launches, hist = run_["launches"], run_["hist"]
        kernel = STEP_KERNEL[name]
        order_stat = guard["aggregator_guard"] != "clip"
        for r, (row, sec, f) in enumerate(zip(per_round, run_["round_s"],
                                              hist)):
            log(f"[fault] {name} + {guard['aggregator_guard']} round {r}: "
                f"{sec:.3f} s, loss {f:.6f}; available {row['drawn']}, "
                f"returned (realized cohort) {row['realized']}, faulted "
                f"{row['injected']}, poisoned {row['poisoned']}; robust m "
                f"{row['m']}")
            if order_stat:
                require(row["m"] == row["realized"] - row["poisoned"],
                        f"{name}: robust_aggregate's m is not the realized "
                        "cohort minus the poisoned clients")
            require(f == f and abs(f) != float("inf"),
                    f"{name}: non-finite loss under faults")
        log(f"[fault] {name}: peak device memory {run_['peak_gb']:.2f} GB; "
            f"launches {launches}")
        expected = {kernel: ROUNDS * local_steps(name, solver),
                    "robust_aggregate": ROUNDS if order_stat else 0,
                    "fused_aggregate": 0 if order_stat else ROUNDS}
        require(all(launches[k] == v for k, v in expected.items())
                and all(v == 0 for k, v in launches.items()
                        if k not in expected),
                f"{name}: faulted launch counts {launches}, expected "
                f"{expected}")
        if name == "cocoa":
            held_to_plain_pass(
                "cocoa + clip under faults", run_,
                lambda guard=guard: make_solver(
                    "cocoa", prob, aggregator="pallas",
                    participation_model=participation, fault_model=faults,
                    **guard))
    # the same faults unguarded: the poison reaches the iterate in round 0
    unguarded = make_solver("fsvrg", prob, aggregator="pallas",
                            participation_model=participation,
                            fault_model=faults)
    try:
        Trainer(unguarded, rounds=1, seed=SEED).fit()
        raise RuntimeError("chip_smoke: unguarded faults left the iterate "
                           "finite")
    except NonFiniteIterateError as e:
        require(e.round_index == 0, "unguarded faults broke a later round")
        log(f"[fault] fsvrg unguarded under the same faults: "
            f"NonFiniteIterateError in round {e.round_index}, as required")
    del unguarded
    LogRegProblem.grad = plain_grad
    torch.cuda.empty_cache()

    # card vs CPU on the small problem: every fault kind at 10 % (20
    # clients would rarely see the full-width rates), the same trace
    small_faults = DeltaFaults(seed=SEED, nan_rate=0.1, sign_rate=0.1,
                               scale_rate=0.1, replay_rate=0.1)
    for name, guard in GUARDED.items():
        ws, engines = small_runs(name, participation_model=participation,
                                 fault_model=small_faults, **guard)
        for r in range(ROUNDS):
            mc, mg = (e.participation_masks(None, r) for e in engines)
            require(all(torch.equal(x, y.cpu()) for x, y in zip(mc, mg)),
                    f"{name}: small-problem masks differ, round {r}")
            ids = torch.arange(engines[0].problem.num_clients)
            require(torch.equal(small_faults.kinds(r, ids),
                                small_faults.kinds(r, ids.to(dev)).cpu()),
                    f"{name}: small-problem fault kinds differ, round {r}")
        scale = float(ws[0].abs().max())
        err = float((ws[1] - ws[0]).abs().max())
        log(f"[fault] {name} + {guard['aggregator_guard']} small problem "
            f"card vs CPU after {ROUNDS} rounds: masks and fault kinds "
            f"bit-equal; max_abs_err {err:.3e}, max |w| {scale:.3e} "
            "(tolerance 1e-4·max|w|)")
        require(err <= 1e-4 * scale,
                f"{name}: faulted card and CPU runs disagree")

    # -- 6. the engine's scale paths: streamed, cohort, virtual ------------ #
    phase("scale")
    scale_launches = scale_phase(dev, sync, prob, trace)
    torch.cuda.empty_cache()

    # -- 6b. the fleet campaign at the §4 width, and checkpoints ------------ #
    phase("campaign")
    campaign_launches = campaign_phase(dev, sync)
    torch.cuda.empty_cache()

    # -- 7. Fig. 2 from its command, and the dense ridge methods ----------- #
    phase("fig2")
    fig2_launches = fig2_phase(dev, sync, steps, len(prob.buckets))
    torch.cuda.empty_cache()
    phase("dense")
    dense_phase(dev, sync)
    torch.cuda.empty_cache()

    # -- 7. serving rwkv6-3b at full width ----------------------------------- #
    phase("serving")
    served = serve_phase(dev, sync)
    torch.cuda.empty_cache()

    # -- 8. timing ----------------------------------------------------------- #
    phase("timing")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def row(name, kernel_fn, plain_fn, nbytes, flops, library_fn=None,
            launches=None):
        b_ms, b_by = bound(nbytes, flops)
        if launches is None:     # over the plain and the faulted runs,
            launches = sum(r["launches"][name]    # Fig. 2's and the campaign's
                           for r in (*runs.values(), *fault_runs.values())
                           ) + fig2_launches.get(name, 0) + (
                               campaign_launches.get(name, 0))
        return dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=launches,
            max_abs_err=max_err[name], ms=cuda_ms(kernel_fn),
            plain_ms=cuda_ms(plain_fn), bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library_fn is None else cuda_ms(library_fn))

    def report(r):
        lib = r["library_ms"]
        log(f"[time] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            + ("null" if lib is None else f"{lib:.4f} ms")
            + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")

    # one full-width round of each solver, in parts: the prelude (the full
    # gradient, FSVRG and DANE), each bucket's client pass, aggregation;
    # for the faulted runs also the trace's mask draw and the fault
    # injection (a round past the runs', so the draws are new)
    K, d = prob.num_clients, prob.d
    for name, run_, faulted in ([(n, r_, False) for n, r_ in runs.items()]
                                + [(n, r_, True)
                                   for n, r_ in fault_runs.items()]):
        solver, res = run_["solver"], run_["res"]
        w = res.w
        eng = solver.engine
        key = threefry.fold_in(threefry.as_key(threefry.PRNGKey(SEED), dev),
                               ROUNDS)
        masks, mask_s, fault_s = None, 0.0, 0.0
        if faulted:
            sync()
            t = time.perf_counter()
            masks = eng.participation_masks(key, ROUNDS)
            sync()
            mask_s = time.perf_counter() - t
        sync()
        t = time.perf_counter()
        ctx = (prob.flat.grad(w),) if name in PRELUDE else ()
        sync()
        prelude_s = time.perf_counter() - t
        deltas = torch.empty((K, d), device=dev)
        pass_s = []
        for bi, (wi, b) in enumerate(zip(eng._offsets, prob.buckets)):
            out = deltas[wi:wi + b.num_clients]
            sync()
            t = time.perf_counter()
            kb = threefry.fold_in(key, wi)
            if name == "cocoa":
                solver._pass(w, bi, b, res.state.aux[bi], kb, out)
            else:
                solver._pass(w, bi, b, kb, out, *ctx)
            sync()
            pass_s.append(time.perf_counter() - t)
            if faulted:
                t = time.perf_counter()
                eng._faulted(out, ROUNDS, eng._bucket_ids(bi), masks[bi])
                sync()
                fault_s += time.perf_counter() - t
        sync()
        t = time.perf_counter()
        eng.aggregate(w, deltas, masks)
        sync()
        agg_s = time.perf_counter() - t
        if name == "fsvrg" and not faulted:
            fsvrg_deltas = deltas      # timed below under fused_aggregate
        del deltas
        n_steps = local_steps(name, solver)
        eval_s = run_["eval_s"]
        label = (f"{name} + {GUARDED[name]['aggregator_guard']} under faults"
                 if faulted else name)
        log(f"[time] {label}: one full-width round, in parts: "
            + (f"trace masks {mask_s:.4f} s, fault injection {fault_s:.4f} "
               "s, " if faulted else "")
            + f"prelude {prelude_s:.4f} s, client passes {sum(pass_s):.3f} s"
            f" over {n_steps} "
            + ("pass launches" if name == "cocoa" else "batched local steps")
            + f" ({sum(pass_s) / n_steps * 1e6:.1f} µs a launch; by bucket "
            + ", ".join(f"{s:.3f}" for s in pass_s)
            + f" s), aggregation {agg_s:.4f} s, loss eval "
            f"{sum(eval_s) / len(eval_s):.4f} s")
        torch.cuda.empty_cache()

    rows = []
    fsvrg = runs["fsvrg"]["solver"]
    w = runs["fsvrg"]["res"].w
    fg = prob.flat.grad(w)
    eng = fsvrg.engine
    # fused_aggregate at the main path's shape, over FSVRG's round's deltas
    deltas = fsvrg_deltas
    del fsvrg_deltas
    wts = torch.cat([eng.bucket_weights(wi, b.num_clients)
                     for wi, b in zip(eng._offsets, prob.buckets)])
    a = fsvrg.a_diag
    # in turns, three times, each a mean of 20 launches after 3 warm-ups:
    # the kernel, torch.mv + addcmul (the same function) and torch.addmv
    # (w^t + Σ, no A); the line takes the medians
    turns = {"kernel": lambda: ops.fused_aggregate(w, deltas, wts, a, 1.0),
             "torch.mv + addcmul": lambda: torch.addcmul(
                 w, a, torch.mv(deltas.t(), wts), value=1.0),
             "torch.addmv": lambda: torch.addmv(w, deltas.t(), wts)}
    turn_ms = {k: [] for k in turns}
    for _ in range(3):
        for key, fn in turns.items():
            turn_ms[key].append(cuda_ms(fn))
    med = {k: sorted(v)[1] for k, v in turn_ms.items()}
    log("[time] fused_aggregate in turns (ms, three of each; median): "
        + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in v)
                    + f" ({med[k]:.4f})" for k, v in turn_ms.items()))
    b_ms, b_by = bound(K * d * 4 + K * 4 + 3 * d * 4, 2 * K * d + 3 * d)
    rows.append(dict(
        name="fused_aggregate", route="cuda", source=SOURCES["fused_aggregate"],
        replaces=TPU_KERNELS["fused_aggregate"],
        launches=sum(r_["launches"]["fused_aggregate"]
                     for r_ in (*runs.values(), *fault_runs.values()))
        + fig2_launches.get("fused_aggregate", 0),
        max_abs_err=max_err["fused_aggregate"],
        ms=med["kernel"],
        plain_ms=cuda_ms(lambda: ref.fused_aggregate_ref(w, deltas, wts, a,
                                                         1.0)),
        bound_ms=b_ms, bound_by=b_by, library_ms=med["torch.mv + addcmul"]))

    def device_ms(fn, iters=50):
        """Device time a call by torch.profiler's key_averages() (None if
        it saw no device time)."""
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        return us / iters / 1e3 if us > 0 else None

    def show_ms(x):
        return "not measured (the profiler saw no device time)" if x is None \
            else f"{x:.4f} ms"

    # the scale paths' entries of the same kernel, at their shapes there:
    # fused_accumulate on a streamed chunk of SCALE_CHUNK clients,
    # fused_epilogue once a round (kernels line rows, launches from
    # [scale]); the compatibility entry scaled_aggregate at (K, d) (a
    # wrapper, on no path)
    acc = fg.clone()
    chunk = deltas[:SCALE_CHUNK]
    cwts = wts[:SCALE_CHUNK]
    for name, k_fn, p_fn, nb, lib_fn in [
            ("fused_accumulate",
             lambda: ops.fused_accumulate(acc, chunk, cwts),
             lambda: ref.fused_accumulate_ref(acc, chunk, cwts),
             (SCALE_CHUNK * d + SCALE_CHUNK + 2 * d) * 4,
             lambda: torch.addmv(acc, chunk.t(), cwts)),
            ("fused_epilogue",
             lambda: ops.fused_epilogue(w, acc, a, 0.5),
             lambda: ref.fused_epilogue_ref(w, acc, a, 0.5),
             4 * d * 4,
             lambda: torch.addcmul(w, a, acc, value=0.5))]:
        rows.append(row(name, k_fn, p_fn, nb,
                        2 * SCALE_CHUNK * d if name == "fused_accumulate"
                        else 2 * d, lib_fn, launches=scale_launches[name]))
        log(f"[time] {name} by the profiler: kernel "
            f"{show_ms(device_ms(k_fn))} on the device, library "
            f"{show_ms(device_ms(lib_fn))}")
    b_ms, b_by = bound((K * d + 3 * d) * 4, 0)
    k_ms = cuda_ms(lambda: ops.scaled_aggregate(w, deltas, wts, a), iters=10)
    p_ms = cuda_ms(lambda: ref.scaled_aggregate_ref(w, deltas, wts, a),
                   iters=10)
    log(f"[time] wrapper scaled_aggregate: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, library null (no single call), bound {b_ms:.6f} ms "
        f"({b_by}); {b_ms / k_ms:.1%} of the bound")
    del deltas, chunk
    torch.cuda.empty_cache()

    # the local steps at the largest bucket's shape, in the main paths' form
    big = max(range(len(prob.buckets)),
              key=lambda i: prob.buckets[i].num_clients)
    Kb = prob.buckets[big].num_clients
    wk = w.expand(Kb, d).contiguous()
    S = fsvrg.s_diags[big]
    diff = randn((Kb, d), scale=1e-3)
    zero = torch.zeros(d, device=dev)
    hk = fsvrg.h_k[big] * 1e-3
    rows.append(row(
        "fsvrg_update",
        lambda: ops.fsvrg_update(wk, S, diff, zero, fg, hk, out=wk),
        lambda: ref.fsvrg_update_ref(wk, S, diff, zero, fg, hk, out=wk),
        16 * Kb * d + 2 * 4 * d + 4 * Kb, 5 * Kb * d))
    lam = prob.flat.lam
    h_row = torch.full((Kb,), 1e-3, device=dev)
    h_row[::5] = 0.0
    rows.append(row(
        "fedavg_update",
        lambda: ops.fedavg_update(wk, diff, h_row, lam, out=wk),
        lambda: ref.fedavg_update_ref(wk, diff, h_row, lam, out=wk),
        12 * Kb * d + 4 * Kb, 3 * Kb * d))
    a_k = randn((Kb, d), scale=1e-3)
    dane_cfg = runs["dane"]["solver"].cfg
    rows.append(row(
        "dane_update",
        lambda: ops.dane_update(wk, diff, a_k, w, 1e-3, lam, dane_cfg.mu,
                                out=wk),
        lambda: ref.dane_update_ref(wk, diff, a_k, w, 1e-3, lam, dane_cfg.mu,
                                    out=wk),
        16 * Kb * d + 4 * d, 7 * Kb * d))
    del wk, diff, a_k
    # DANE's local gradient (segment_sum) at every bucket, from DANE's
    # final iterate; then DANE's round with it and with the atomic sum it
    # replaced, in turns
    rows.append(dict(
        name="segment_sum", route="cuda", source=SOURCES["segment_sum"],
        replaces=TPU_KERNELS["segment_sum"],
        launches=sum(r_["launches"]["segment_sum"]
                     for r_ in (*runs.values(), *fault_runs.values()))
        + fig2_launches.get("segment_sum", 0)
        + campaign_launches.get("segment_sum", 0),
        **segment_sum_phase(dev, sync, prob, runs["dane"]["res"].w, cuda_ms,
                            bound)))
    dane_turns(dev, sync, runs["dane"]["solver"], runs["dane"]["res"].state)
    b0 = rand(Kb) * 0.9 + 0.05
    m = randn(Kb, scale=3.0)
    c = rand(Kb) * 1e4
    # the coordinate entry (the TPU kernel's own function, off the main
    # path since the pass replaced its launch a step; not in the kernels
    # line, whose SDCA row is the pass): host-bound, so the device time too
    b_ms, b_by = bound(4 * 4 * Kb, SDCA_OPS_PER_COORD * Kb)
    k_ms = cuda_ms(lambda: ops.cocoa_sdca_update(b0, m, c))
    log(f"[time] cocoa_sdca_update (N = {Kb}, the coordinate entry): kernel "
        f"{k_ms:.4f} ms a call by events (host-bound), "
        + show_ms(device_ms(lambda: ops.cocoa_sdca_update(b0, m, c)))
        + " on the device by the profiler; plain "
        f"{cuda_ms(lambda: ref.cocoa_sdca_update_ref(b0, m, c)):.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}); max_abs_err "
        f"{max_err['cocoa_sdca_update']:.3e} at N = {R}")
    # CoCoA+'s pass at every bucket of a round, from the CoCoA+ run's
    # iterate and dual blocks.  Bound: idx (8 B) and val (4 B) of every
    # padded row's nnz entries, y, α, perms (8 B) and u of every padded
    # row, r written once, w and n_k read: bytes over the HBM rate; the
    # f32 work (3 products a row entry, the Newton solve a row) never
    # binds.  Times from the checks: the kernel by events over 5 launches,
    # the plain step loop by the host clock around one pass ending in a
    # synchronize
    pass_ms, plain_pass_ms, pass_bytes, pass_ops = 0.0, 0.0, 0, 0
    for bi, (b, (k_ms, p_ms)) in enumerate(zip(prob.buckets, pass_times)):
        Kb_, m_pad_, nnz_ = b.idx.shape
        nbytes = (Kb_ * m_pad_ * (12 * nnz_ + 4 + 4 + 8 + 4) + Kb_ * d * 4
                  + d * 4 + Kb_ * 8)
        pass_ms += k_ms
        plain_pass_ms += p_ms
        pass_bytes += nbytes
        pass_ops += Kb_ * m_pad_ * (6 * nnz_ + SDCA_OPS_PER_COORD)
        log(f"[time] cocoa_sdca_pass bucket {bi} ({Kb_}×{m_pad_}): kernel "
            f"{k_ms:.4f} ms ({k_ms / m_pad_ * 1e3:.3f} µs a sequential step),"
            f" plain step loop {p_ms:.2f} ms, bound "
            f"{bound(nbytes, 0)[0]:.4f} ms (bytes)")
    b_ms, b_by = bound(pass_bytes, pass_ops)
    rows.append(dict(
        name="cocoa_sdca_pass", route="cuda", source=SOURCES["cocoa_sdca_pass"],
        replaces=TPU_KERNELS["cocoa_sdca_pass"],
        launches=sum(r_["launches"]["cocoa_sdca_pass"]
                     for r_ in (*runs.values(), *fault_runs.values()))
        + fig2_launches.get("cocoa_sdca_pass", 0),
        max_abs_err=max_err["cocoa_sdca_pass"], ms=pass_ms,
        plain_ms=plain_pass_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None))
    log(f"[time] cocoa_sdca_pass, a round's {len(prob.buckets)} launches: "
        f"kernel {pass_ms:.4f} ms, plain step loop {plain_pass_ms:.2f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {pass_bytes / 1e9:.3f} GB)")
    # the order-statistic update at the full shape, over the trace's round-0
    # cohort (the faulted runs' m) and over every client; the bound counts
    # the valid rows the function must read, (m·d·4 + K + 3·d·4) B; the
    # yardstick is torch.sort of the masked stack (the sort alone)
    deltas = randn((K, d), scale=0.01)
    w_r, a_r = randn(d), rand(d) * 3 + 1
    every = torch.ones(K, dtype=torch.bool, device=dev)
    cohort = fleet_masks(trace, 0, torch.arange(K, device=dev)).returned > 0
    robust_rows = []
    for v, mode in ((cohort, "trimmed_mean"), (cohort, "median"),
                    (every, "trimmed_mean"), (every, "median")):
        m = int(v.sum())
        masked = torch.where(v[:, None], deltas, float("inf"))
        robust_rows.append(row(
            "robust_aggregate",
            lambda v=v, mode=mode: ops.robust_aggregate(w_r, deltas, v, a_r,
                                                        0.1, mode),
            lambda v=v, mode=mode: ref.robust_aggregate_ref(
                w_r, deltas, v, a_r, 0.1, mode),
            m * d * 4 + K + 3 * d * 4, m * d,
            lambda masked=masked: torch.sort(masked, dim=0)))
        robust_rows[-1].update(m=m, mode=mode)
        del masked
    for r in robust_rows:
        log(f"[time] robust_aggregate at m = {r['m']} (K = {K}, "
            f"{r['mode']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.sort of the masked stack "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes "
            f"of the m valid rows; "
            f"{(K * d * 4 + K + 3 * d * 4) / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"for all K rows); {r['bound_ms'] / r['ms']:.1%} of the bound")
    rows.append({k: v for k, v in robust_rows[0].items()
                 if k not in ("m", "mode")})
    del deltas
    # the full gradient's sum into d slots: utils.scatter's fixed order
    # (what LogRegProblem.grad runs on the card) against CUDA's atomic
    # index_add_ on the same terms, and whether each repeats bit for bit
    from repro_torch.utils import scatter
    flat = prob.flat
    w_g = torch.randn(d, device=dev, generator=g) * 0.01
    terms = ((-flat.y * torch.sigmoid(-flat.y * flat.margins(w_g))
              / flat.n)[:, None] * flat.val).reshape(-1)
    slots = flat.idx.reshape(-1)

    def fixed_sum():
        return scatter.index_add(torch.zeros(d, device=dev), slots, terms)

    def atomic_sum():
        return torch.zeros(d, device=dev).index_add_(0, slots, terms)

    same = []
    for fn in (fixed_sum, atomic_sum):
        first = fn()
        same.append(all(torch.equal(first, fn()) for _ in range(2)))
    log(f"[time] the full gradient's sum of {terms.numel()} terms into d = "
        f"{d}: fixed order (utils.scatter) {cuda_ms(fixed_sum):.3f} ms, "
        f"three calls bit-equal {same[0]}; atomic index_add_ "
        f"{cuda_ms(atomic_sum):.3f} ms, three calls bit-equal {same[1]}; "
        f"the whole LogRegProblem.grad {cuda_ms(lambda: flat.grad(w_g)):.3f} "
        "ms")
    require(same[0], "the fixed-order gradient sum differs from call to call")
    del terms, slots, first, flat, w_g
    # wkv6 at the serving prefill's shape, in the entry the model calls:
    # (B, S, Hn, D) = (8, 2,048, 40, 64) f32, chunk 32, with RWKV-like
    # decays; launches from the serving run; bound from wkv6_cost
    B_, Hn_, S_, D_ = REQUESTS, 40, PROMPT_LEN, 64
    BH, L_ = B_ * Hn_, 32
    x6 = wkv6_inputs(dev, g, B_, S_, D_, heads=Hn_)
    rows.append(row(
        "wkv6", lambda: ops.wkv6(*x6), lambda: ref.wkv6_ref(*x6),
        *wkv6_cost(B_, S_, Hn_, D_), launches=served["launches"]["wkv6"]))
    s6 = torch.randn((B_, Hn_, D_, D_), device=dev, generator=g)
    ragged6 = [t[:, :RAGGED_LEN - RAGGED_LEN % L_] for t in x6[:4]]

    def heads_major(t):
        return t.transpose(1, 2).reshape(BH, S_, D_).contiguous()

    x3 = [heads_major(t) for t in x6[:4]] + [x6[4].repeat(B_, 1)]
    turns = {"model layout from zeros": lambda: ops.wkv6(*x6),
             "model layout from a given state":
                 lambda: ops.wkv6(*x6, state=s6),
             f"model layout, {ragged6[0].shape[1]:,} of {S_:,} tokens":
                 lambda: ops.wkv6(*ragged6, x6[4]),
             "(B·Hn, S, D) entry": lambda: ops.wkv6(*x3)}
    log(f"[time] wkv6 ({B_}, {S_:,}, {Hn_}, {D_}) f32: "
        + "; ".join(f"{k} {cuda_ms(fn):.4f} ms" for k, fn in turns.items()))
    # the layout copies around the kernel: none remain; what the four
    # (B, S, Hn, D) -> (B·Hn, S, D) copies in and the one back that the
    # model made before cost at this shape, for the record
    copy_ms = cuda_ms(lambda: heads_major(x6[0]))
    log(f"[time] wkv6 layout: 0 copies a layer (the kernel reads r, k, v, "
        f"w in the projections' (B, S, Hn, D) storage and writes out in "
        f"it); one f32 (B, S, Hn, D) -> (B·Hn, S, D) copy takes "
        f"{copy_ms:.4f} ms, so the 5 a layer it replaces took "
        f"≈ {5 * copy_ms:.3f} ms, {5 * copy_ms * 32:.2f} ms a prefill")
    del x6, s6, ragged6, x3
    for r in rows:
        report(r)
    log("[time] wkv6 library: null — no single PyTorch call computes the "
        "WKV-6 recurrence")
    torch.cuda.empty_cache()

    # the device's busy share of a round: the device's kernel times for one
    # more full-width round of each solver, traced by the profiler (device
    # activity only: tracing the host's operator calls too takes minutes),
    # over the unprofiled rounds' wall time.  FSVRG's and FedAvg's rounds
    # run ≈ 15,000 and 30,000 host-bound batched steps, whose tracing cost
    # ≈ 150 s: for them a sample of the round stands for it
    # (sampled_round_profile)
    phase("profile")
    for name, run_ in runs.items():
        solver, res = run_["solver"], run_["res"]
        if name in ("fsvrg", "fedavg"):
            sampled_round_profile(name, solver, res, prob, dev, sync,
                                  sum(run_["round_s"]) / len(run_["round_s"]))
            continue
        wall_s = sum(run_["round_s"]) / len(run_["round_s"])
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solver.round(res.state, threefry.fold_in(
                threefry.PRNGKey(SEED), ROUNDS))
            sync()
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.self_device_time_total, reverse=True)
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        if events:
            log(f"[profile] {name}: one round under the profiler "
                f"({time.perf_counter() - t:.1f} s to trace): device busy "
                f"{busy_s:.3f} s of the unprofiled {wall_s:.3f} s -> "
                f"device idle share {1 - busy_s / wall_s:.1%}")
        else:
            log(f"[profile] {name}: device idle share: not measured (the "
                "profiler saw no device time)")
        for e in events[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
                f"{e.count:7d}× {e.key[:90]}")
    # one full-width prefill (8 × 2,048 tokens) under the profiler, over
    # the second serving run's unprofiled prefill
    model, params = served["model"], served["params"]
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(params, {"tokens": served["prompt"]})
        sync()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    wall_s = served["runs"][1][0].prefill_s
    if events:
        log(f"[profile] {ARCH} prefill {REQUESTS} × {PROMPT_LEN}: "
            f"({time.perf_counter() - t:.1f} s to trace): device busy "
            f"{busy_s:.4f} s of the unprofiled {wall_s:.4f} s prefill -> "
            f"device busy share {busy_s / wall_s:.1%}")
    else:
        log(f"[profile] {ARCH} prefill: device busy share: not measured "
            "(the profiler saw no device time)")
    for e in events[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}× {e.key[:90]}")
    # DECODE_PROFILED more decode steps from the second serving run's
    # cache, unprofiled and then under the profiler
    res = served["runs"][1][0]

    def decode_steps():
        tok, cache = res.tokens[:, -1:], res.cache
        for _ in range(DECODE_PROFILED):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits.argmax(-1)[:, None]
        sync()

    decode_steps()
    t = time.perf_counter()
    decode_steps()
    wall_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_steps()
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    log(f"[profile] {ARCH} decode, {DECODE_PROFILED} steps of {REQUESTS} "
        f"tokens: device busy {busy_s:.4f} s of the unprofiled "
        f"{wall_s:.4f} s -> device idle share "
        + (f"{1 - busy_s / wall_s:.1%}" if busy_s > 0 else "not measured")
        + f"; {n_kernels / DECODE_PROFILED:.0f} device kernels a step")

    # -- 9. training rwkv6-3b at full width, the serving weights and the
    #       logreg phases' tensors freed first
    del served, model, params, res, runs, fault_runs, prob, ds
    # and every name still holding a solver or a bucket (they hold the
    # problem; the solvers sit in reference cycles)
    del fsvrg, eng, solver, run_, cocoa_solver, cocoa_res, b
    release("training")
    phase("training")
    rows.append(train_phase(dev, sync, compare, cuda_ms, bound))
    report(rows[-1])
    require(sorted(r["name"] for r in rows) == sorted(SOURCES),
            "the kernels line misses a kernel")
    torch.cuda.empty_cache()

    # -- 11. the dense attention family: serving and training -------------- #
    phase("serve-dense")
    serve_dense_phase(dev, sync)
    phase("train-dense")
    train_dense_phase(dev, sync)
    torch.cuda.empty_cache()

    # -- 12. the MoE family: serving and training ----------------------------- #
    phase("serve-moe")
    serve_moe_phase(dev, sync)
    phase("train-moe")
    train_moe_phase(dev, sync)
    phase("done")

    # -- 13. the result ------------------------------------------------------- #
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
