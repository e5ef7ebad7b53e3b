"""CUDA wrapper of the fixed-order segment sum (``csrc/segment_sum.cu``; it
replaces no TPU kernel):

    out[s] = Σ_{t : slots[t] = s} a[t // group] · b[t]

summed in an order fixed by a :class:`SegmentPlan` — the terms' slots
sorted stably once, each slot's terms a run, lane i mod 32 of a run adding
its i-th terms, then a butterfly — so that two calls on the same inputs
give the same bits on the card, where CUDA's atomic ``scatter_add_`` does
not.  The kernel gives each block a unit of the plan — at most TILE
contiguous slots, whose runs start within CAP terms of each other —
gathers the unit's terms with every thread busy, sums each run of at most
32 terms in a thread and each longer one in a warp, and writes the unit's
slots to ``out`` once, in full 16-byte lines; the plan's ``units`` carry
what that needs.  DANE's local gradient
(:func:`repro_torch.core.dane.data_grad`) is its caller: a bucket's slots
(client, feature) never change, so the DANE solver builds a bucket's plan
once (:func:`repro_torch.core.dane.bucket_plan`) and keeps it.  The launch is counted in ``segment_sum.launches``.  Callers go
through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to the
plain version in ``ref.py`` (the same runs, the same order).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _args, _build

_NAME = "segment_sum"
#: the lanes of the kernel's warp: lane i mod 32 of a run adds its i-th terms
LANES = 32
#: the runs of a unit start within this many terms of its first (a run
#: of more terms is a unit's only run); the kernel's constant
CAP = 1024
#: the most slots a unit spans (the kernel stages them in shared memory,
#: 4 B a slot); the kernel's constant
TILE = 4096


@functools.lru_cache(maxsize=None)
def divisor(group: int) -> Tuple[int, int]:
    """(magic, shift) with t // group == ((t · magic >> 32) + t) >> shift
    for every 0 <= t < 2^31: shift = ceil(log2 group) and magic =
    floor(2^32 (2^shift − group) / group) + 1 (Granlund and Montgomery's
    round-up multiplier), which the kernel takes in place of a division a
    term."""
    if not 1 <= group < 2 ** 31:
        raise ValueError(f"{_NAME}: group {group} outside [1, 2^31)")
    shift = (group - 1).bit_length()
    return ((2 ** 32 * (2 ** shift - group)) // group + 1, shift)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The order of a segment sum of ``n_terms`` terms into ``n_slots``
    slots: ``order`` (the indices of the terms it sums, sorted stably by
    slot), ``run_start`` (run r is ``order[run_start[r]:run_start[r + 1]]``)
    and ``run_slot`` (its slot, ascending); and the kernel's units, a
    block each, in ``units`` (3, n_units + 1): unit u spans slots
    ``units[0, u] .. units[0, u + 1]`` (at most TILE), its runs are
    ``units[1, u] .. units[1, u + 1]`` and their terms ``order[units[2, u]
    .. units[2, u + 1]]`` — the runs of a unit start within CAP terms of
    its first, or it holds one run only; all int32 on the terms'
    device."""

    order: torch.Tensor
    run_start: torch.Tensor
    run_slot: torch.Tensor
    n_slots: int
    n_terms: int            # the terms of the inputs, kept or not
    units: torch.Tensor

    @property
    def n_runs(self) -> int:
        return int(self.run_slot.shape[0])

    @property
    def n_units(self) -> int:
        return int(self.units.shape[1]) - 1

    @property
    def unit_bytes(self) -> int:
        """The bytes the kernel's units add to the plan."""
        return 4 * self.units.numel()

    @functools.cached_property
    def lane_steps(self) -> Tuple[torch.Tensor, torch.Tensor,
                                  List[Tuple[int, int]]]:
        """The plan's order as the kernel's warps take it, for the plain
        version (built on its first use): the summed terms' indices grouped
        by step i // LANES (i a term's place in its run), each with its
        (lane, run) key (i mod LANES)·n_runs + run, and each step's
        bounds."""
        starts = self.run_start.long()
        run_of = torch.repeat_interleave(
            torch.arange(self.n_runs, device=starts.device),
            starts[1:] - starts[:-1])
        pos = (torch.arange(self.order.shape[0], device=starts.device)
               - starts[:-1][run_of])
        step = pos // LANES
        perm = torch.argsort(step, stable=True)
        bounds = torch.cumsum(torch.bincount(step), 0).tolist()
        return (self.order.long()[perm],
                ((pos % LANES) * self.n_runs + run_of)[perm],
                list(zip([0] + bounds[:-1], bounds)))


def segment_plan(slots: torch.Tensor, n_slots: int,
                 keep: torch.Tensor) -> SegmentPlan:
    """The plan of the terms whose slots are ``slots`` (any shape, flattened
    row-major: term t is ``slots.reshape(-1)[t]``), each in [0, n_slots),
    summing the terms where ``keep`` (a bool tensor of ``slots``' shape) is
    True.  Leave out only terms known to be zero: a sum that starts at +0
    is never −0, so adding a zero term never changes its bits."""
    flat = slots.reshape(-1).to(torch.int64)
    if flat.numel() >= 2 ** 31 or n_slots >= 2 ** 31:
        raise ValueError(f"{_NAME}: {flat.numel()} terms into {n_slots} "
                         "slots: the plan's int32 indices hold fewer than "
                         "2^31")
    if flat.numel() and not (0 <= int(flat.min()) and
                             int(flat.max()) < n_slots):
        raise ValueError(f"{_NAME}: a slot outside [0, {n_slots})")
    kept = torch.nonzero(keep.reshape(-1)).reshape(-1)
    sorted_slots, perm = torch.sort(flat[kept], stable=True)
    order = kept[perm]
    run_slot, counts = torch.unique_consecutive(sorted_slots,
                                                return_counts=True)
    run_start = torch.zeros(run_slot.shape[0] + 1, dtype=torch.int64,
                            device=flat.device)
    torch.cumsum(counts, 0, out=run_start[1:])
    # units: the batches of runs that start in one CAP-term window of
    # order, cut around each run of more than CAP terms (a batch alone);
    # each batch spans the slots from its first run's to the next batch's
    # (0 and n_slots at the ends), cut into pieces of at most TILE
    big = counts > CAP
    first = torch.ones_like(big)
    window = run_start[:-1] // CAP
    first[1:] = (window[1:] != window[:-1]) | big[1:] | big[:-1]
    edges = torch.cat([run_slot.new_zeros(1), run_slot[first][1:],
                       run_slot.new_full((1,), n_slots)])
    pieces = (edges[1:] - edges[:-1] + TILE - 1) // TILE
    offset = torch.arange(int(pieces.sum()), device=flat.device)
    offset -= torch.repeat_interleave(torch.cumsum(pieces, 0) - pieces,
                                      pieces)
    unit_slot = torch.cat([
        torch.repeat_interleave(edges[:-1], pieces) + TILE * offset,
        edges[-1:]])
    unit_run = torch.searchsorted(run_slot, unit_slot)
    units = torch.stack([unit_slot, unit_run, run_start[unit_run]])
    i32 = torch.int32
    return SegmentPlan(order.to(i32), run_start.to(i32), run_slot.to(i32),
                       int(n_slots), int(flat.numel()),
                       units.to(i32).contiguous())


def check_operands(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor) -> int:
    """Check ``a`` (n_terms / group values), ``b`` (n_terms values) and
    ``out`` (n_slots values): contiguous f32 on the plan's device.  Returns
    ``group``."""
    dev = plan.order.device
    for name, x in (("a", a), ("b", b), ("out", out)):
        _args.require(_NAME, isinstance(x, torch.Tensor) and x.device == dev
                      and x.dtype == torch.float32 and x.is_contiguous(),
                      lambda name=name: f"{name} must be a contiguous "
                      f"float32 tensor on {dev}")
    _args.require(_NAME, b.numel() == plan.n_terms,
                  lambda: f"b holds {b.numel()} terms, the plan "
                  f"{plan.n_terms}")
    _args.require(_NAME, out.numel() == plan.n_slots,
                  lambda: f"out holds {out.numel()} slots, the plan "
                  f"{plan.n_slots}")
    group = plan.n_terms // max(a.numel(), 1)
    _args.require(_NAME, a.numel() * group == plan.n_terms and group >= 1,
                  lambda: f"a's {a.numel()} values do not divide the "
                  f"{plan.n_terms} terms into equal groups")
    return group


def segment_sum(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """Write the plan's sums of a[t // group] · b[t] into ``out`` (every
    slot: 0 where no term lands) on the card, in the plan's order; returns
    ``out``."""
    _args.require(_NAME, plan.order.is_cuda, "the plan must be on a card")
    magic, shift = divisor(check_operands(plan, a, b, out))
    launch = _build.launcher(_NAME)
    with _args.on_card(out.device):
        err = launch(a.data_ptr(), b.data_ptr(), magic, shift,
                     plan.order.data_ptr(), plan.run_start.data_ptr(),
                     plan.run_slot.data_ptr(), plan.units.data_ptr(),
                     plan.n_units, CAP, TILE, out.data_ptr(),
                     _args.stream(out))
    _build.check(err, _NAME)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
