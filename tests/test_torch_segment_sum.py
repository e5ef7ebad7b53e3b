"""The fixed-order segment sum (``kernels/segment_sum.py``, its plain
version ``ref.segment_sum_ref``) on the CPU, and DANE's local gradient,
which sums through it.

The plain version against ``index_add_`` in f64 at runs of one term, of
31–33 terms (a warp's lanes once, and once and a lane more), of many terms
and of a bucket's full rows (the bias feature: one term a row); the lane
and butterfly order written out by hand for a run of 40 terms, bit for bit;
the plan of a DANE bucket (built once a bucket, kept by the solver); and
``data_grad`` against the atomic ``scatter_add_`` it replaces.  The
plan's units (a block of the kernel each) on plans with no runs, with
empty slots around the runs, with runs on a unit's first and last slot,
with a unit's edge inside a client's row, and with runs longer than CAP;
the wrapper's division constants; and the kernel's tree for a run of at
most 32 terms (lanes past the run +0) against the warp's order.

Tolerance: a run of k f32 terms summed in another order than f64 may err
by about k unit roundoffs of the run's sum of magnitudes; 1e-6 of that sum
(about 8 roundoffs) is held (observed ≤ 1.1e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import build_problem  # noqa: E402
from repro_torch.core.dane import (DANE, DANEConfig, bucket_plan,  # noqa: E402
                                   data_grad, row_scales)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import segment_sum as ss  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402


def _held(got, slots, a, b, group, n_slots):
    terms = (a.double()[torch.arange(b.numel()) // group] * b.double())
    want = torch.zeros(n_slots, dtype=torch.float64).index_add_(
        0, slots, terms)
    size = torch.zeros(n_slots, dtype=torch.float64).index_add_(
        0, slots, terms.abs())
    err = (got.double() - want).abs()
    assert bool((err <= 1e-6 * size).all()), float(
        (err / size.clamp_min(1e-30)).max())
    untouched = size == 0
    assert not got[untouched].any()


@pytest.mark.parametrize("run", [1, 31, 32, 33, 97, 1000])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_segment_sum_sums_every_run(run, group):
    """n_slots = 13 slots, 5 of them with a run of ``run`` terms each (in
    scattered positions), the rest untouched and zeroed."""
    rng = np.random.default_rng(run * 10 + group)
    n_slots = 13
    used = rng.choice(n_slots, 5, replace=False)
    slots = torch.from_numpy(rng.permutation(np.repeat(used, run)))
    n = slots.numel()
    n -= n % group
    slots = slots[:n]
    a = torch.from_numpy(rng.standard_normal(n // group).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    plan = ss.segment_plan(slots, n_slots,
                           keep=torch.ones(n, dtype=torch.bool))
    assert plan.n_terms == n and plan.n_slots == n_slots
    assert plan.order.shape == (n,)
    assert plan.order.dtype == plan.run_start.dtype == torch.int32
    assert torch.equal(plan.run_slot.long(), torch.unique(slots))
    out = torch.full((n_slots,), float("nan"))
    assert ops.segment_sum(plan, a, b, out) is out
    _held(out, slots, a, b, group, n_slots)
    again = ops.segment_sum(plan, a, b, torch.empty(n_slots))
    assert torch.equal(again, out)


def test_plain_segment_sum_is_the_warps_order_bit_for_bit():
    """One run of 40 terms: lane l adds terms l and l + 32 in turn, then
    the lanes combine as p_l + p_(l xor o), o = 16, 8, 4, 2, 1."""
    t = torch.from_numpy((np.random.default_rng(3).standard_normal(40)
                          * 10.0 ** (np.arange(40) % 7)).astype(np.float32))
    plan = ss.segment_plan(torch.zeros(40, dtype=torch.int64), 1,
                           keep=torch.ones(40, dtype=torch.bool))
    out = ops.segment_sum(plan, torch.ones(40), t, torch.empty(1))
    lanes = [torch.zeros(())] * 32
    for i in range(40):
        lanes[i % 32] = lanes[i % 32] + t[i]
    p = torch.stack(lanes)
    for off in (16, 8, 4, 2, 1):
        p = p + p[torch.arange(32) ^ off]
    assert torch.equal(out[0], p[0])


def test_segment_plan_and_wrapper_refuse_what_they_cannot_take():
    every = torch.ones(3, dtype=torch.bool)
    plan = ss.segment_plan(torch.tensor([0, 2, 2]), 3, keep=every)
    assert plan.run_start.tolist() == [0, 1, 3]
    assert plan.run_slot.tolist() == [0, 2]
    with pytest.raises(ValueError, match="outside"):
        ss.segment_plan(torch.tensor([0, 3]), 3, keep=every[:2])
    with pytest.raises(ValueError, match="card"):
        ss.segment_sum(plan, torch.ones(3), torch.ones(3), torch.empty(3))
    with pytest.raises(ValueError, match="groups"):
        ss.check_operands(plan, torch.ones(2), torch.ones(3),
                          torch.empty(3))
    with pytest.raises(ValueError, match="slots"):
        ss.check_operands(plan, torch.ones(3), torch.ones(3),
                          torch.empty(4))
    kept = ss.segment_plan(torch.tensor([1, 0, 1, 1]), 2,
                           keep=torch.tensor([True, False, True, False]))
    assert kept.order.tolist() == [0, 2] and kept.n_terms == 4
    assert kept.run_slot.tolist() == [1]
    out = ops.segment_sum(kept, torch.ones(4), torch.tensor([1., 5., 2., 7.]),
                          torch.full((2,), 9.0))
    assert out.tolist() == [0.0, 3.0]
    empty = ss.segment_plan(torch.zeros(0, dtype=torch.int64), 4,
                            keep=every[:0])
    out = ops.segment_sum(empty, torch.ones(0), torch.ones(0),
                          torch.full((4,), 1.0))
    assert not out.any()


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def test_data_grad_sums_a_buckets_rows_in_its_plan(port_problem):
    """Every bucket of the small problem (runs from one term to a client's
    full rows: the bias feature is in every row): DANE's local gradient
    against the atomic scatter_add_ it replaces, within the stated
    tolerance of f64, and each bucket's plan built once by the DANE solver
    and kept from round to round."""
    d = port_problem.d
    rng = np.random.default_rng(0)
    longest = 0
    for b in port_problem.buckets:
        Kb = b.num_clients
        wk = torch.from_numpy(rng.standard_normal((Kb, d))
                              .astype(np.float32) * 0.1)
        plan = bucket_plan(b, d)
        got = data_grad(wk, b, plan, torch.empty(Kb, d))
        runs = plan.run_start[1:] - plan.run_start[:-1]
        longest = max(longest, int(runs.max()))
        # the same terms, summed atomically / in f64
        flat = b.idx.reshape(Kb, -1)
        gs = row_scales(wk, b)
        slots = (flat + d * torch.arange(Kb)[:, None]).reshape(-1)
        _held(got.reshape(-1), slots, gs.reshape(-1), b.val.reshape(-1),
              b.idx.shape[-1], Kb * d)
        atomic = torch.zeros(Kb, d).scatter_add_(
            1, flat, (gs[..., None] * b.val).reshape(Kb, -1))
        assert torch.allclose(got, atomic, rtol=1e-5, atol=1e-7)
        assert torch.equal(data_grad(wk, b, plan, torch.empty(Kb, d)), got)
    # the bias feature's run: a client's rows (the padded rows' zero
    # values left out)
    assert longest == max(int(b.n_k.max()) for b in port_problem.buckets)
    solver = DANE(port_problem, DANEConfig(local_steps=1), device="cpu")
    key = threefry.PRNGKey(0)
    state = solver.round(solver.init(torch.zeros(d)), key)
    plans = dict(solver._plans)
    assert len(plans) == len(port_problem.buckets)
    solver.round(state, key)
    assert all(solver._plans[bi] is p for bi, p in plans.items())


def _check_units(plan, slots, keep):
    """The units cover the slots in order, each at most TILE wide; each
    names the runs of its slots, once and in order, and their terms; a
    unit's runs start within one CAP-term window of order, or it holds one
    run of more than CAP terms."""
    units = plan.units.long()
    assert plan.units.dtype == torch.int32
    assert units.shape == (3, plan.n_units + 1) and plan.n_units >= 1
    lo, run, term = units
    assert lo[0] == 0 and lo[-1] == plan.n_slots
    assert bool((lo[1:] > lo[:-1]).all())
    assert int((lo[1:] - lo[:-1]).max()) <= ss.TILE
    run_slot = plan.run_slot.long()
    assert torch.equal(run, torch.searchsorted(run_slot, lo))
    assert run[0] == 0 and run[-1] == plan.n_runs
    start = plan.run_start.long()
    assert torch.equal(term, start[run])
    assert plan.unit_bytes == 4 * units.numel()
    # the runs are the kept terms' slots, each once
    want = torch.unique(slots.reshape(-1)[keep.reshape(-1)])
    assert torch.equal(run_slot, want)
    lengths = start[1:] - start[:-1]
    for u in range(plan.n_units):
        rb, re = int(run[u]), int(run[u + 1])
        if re == rb:
            continue
        if int(lengths[rb:re].max()) > ss.CAP:
            assert re - rb == 1
        else:
            window = start[rb:re] // ss.CAP
            assert bool((window == window[0]).all())
            assert int(term[u + 1] - term[u]) < 2 * ss.CAP


def _units_case(case):
    """(slots, n_slots, keep) of a case of the units test."""
    rng = np.random.default_rng(7)
    tile = ss.TILE
    if case == "no-runs":
        slots = torch.from_numpy(rng.integers(0, 9_000, 40))
        return slots, 9_000, torch.zeros(40, dtype=torch.bool)
    if case == "empty-ends":
        # runs only in slots 5,000..5,009 of 12,000: empty slots before
        # and after
        slots = torch.from_numpy(rng.integers(5_000, 5_010, 200))
        return slots, 12_000, torch.ones(200, dtype=torch.bool)
    if case == "unit-edges":
        # runs of 1, 3 and 40 terms on each unit's first and last slot (a
        # few terms: one batch, units every TILE slots), and the last slot
        n_slots = 3 * tile + 5
        used = np.unique(np.concatenate([np.arange(0, n_slots, tile),
                                         np.arange(tile - 1, n_slots, tile),
                                         [n_slots - 1]]))
        lengths = np.tile([1, 3, 40], len(used))[:len(used)]
        slots = torch.from_numpy(rng.permutation(np.repeat(used, lengths)))
        return slots, n_slots, torch.ones(slots.numel(), dtype=torch.bool)
    if case == "row-edge":
        # a DANE-like (client, feature) layout: 2 clients × 6 rows × 5
        # values into 2 × 10,000 slots, the bias feature 0 in every row;
        # unit edges (every TILE slots here) fall inside a client's row
        d = 10_000
        idx = rng.integers(1, d, (2, 6, 5))
        idx[..., 0] = 0
        val = (rng.random((2, 6, 5)) < 0.8).astype(np.float32)
        slots = torch.from_numpy(idx + d * np.arange(2)[:, None, None])
        return slots, 2 * d, torch.from_numpy(val != 0)
    # "long-runs": runs of 1–32 terms and of more than CAP (one of more
    # than two windows) among them
    lengths = np.concatenate([rng.integers(1, 33, 300),
                              [ss.CAP + 1, 3 * ss.CAP, 33, 2 * ss.CAP]])
    used = rng.choice(5_000, len(lengths), replace=False)
    slots = torch.from_numpy(rng.permutation(np.repeat(used, lengths)))
    return slots, 5_000, torch.ones(slots.numel(), dtype=torch.bool)


@pytest.mark.parametrize("case", ["no-runs", "empty-ends", "unit-edges",
                                  "row-edge", "long-runs"])
def test_segment_plan_units_name_every_run_once_in_order(case):
    slots, n_slots, keep = _units_case(case)
    plan = ss.segment_plan(slots, n_slots, keep=keep)
    _check_units(plan, slots, keep)
    lengths = plan.run_start[1:] - plan.run_start[:-1]
    edges = set(plan.units[0].tolist())
    if case == "no-runs":
        assert plan.n_runs == 0 and plan.n_units == -(-n_slots // ss.TILE)
    if case == "empty-ends":
        assert int(plan.run_slot.min()) == 5_000
        assert int(plan.run_slot.max()) == 5_009
    if case == "unit-edges":
        assert all(s in edges for s in range(0, n_slots, ss.TILE))
        assert {0, ss.TILE - 1, ss.TILE, 2 * ss.TILE - 1,
                n_slots - 1} <= set(plan.run_slot.tolist())
    if case == "row-edge":
        assert any(s % 10_000 for s in edges - {0, n_slots})
    if case == "long-runs":
        assert int(lengths.max()) > 2 * ss.CAP
        assert int((lengths > ss.LANES).sum()) == 4
    # the plain version sums the plan's runs as ever
    a = torch.ones(slots.numel())
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        slots.numel()).astype(np.float32))
    got = ops.segment_sum(plan, a, b, torch.full((n_slots,), float("nan")))
    want = torch.zeros(n_slots).index_add_(
        0, slots.reshape(-1)[keep.reshape(-1)], b[keep.reshape(-1)])
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [1, 2, 3, 7, 62, 63, 64, 1000, 65_537,
                                   2 ** 31 - 1])
def test_divisor_is_the_division(group):
    """The kernel's t // group: ((t · magic >> 32) + t) >> shift, over
    2^31 − 1, multiples of group, their neighbours and random t."""
    magic, shift = ss.divisor(group)
    assert 0 < magic < 2 ** 32 and 0 <= shift <= 31
    rng = np.random.default_rng(group)
    t = np.concatenate([rng.integers(0, 2 ** 31, 4000), [0, 1, 2 ** 31 - 1],
                        np.arange(1, 50) * group - 1,
                        np.arange(1, 50) * group]).astype(np.uint64)
    t = t[t < 2 ** 31]
    q = (((t * np.uint64(magic)) >> np.uint64(32)) + t) >> np.uint64(shift)
    assert np.array_equal(q, t // np.uint64(group))


def test_a_threads_tree_is_the_warps_order():
    """For every run of 1..32 terms, the kernel's tree in one thread —
    lanes 0..n-1 the products (from +0), the first level folding lane
    l + 16 into lane l only where it holds a term, then levels 8 .. 1 —
    gives the warp's bits (``ref``), −0 products included (a run of
    them sums to +0)."""
    rng = np.random.default_rng(11)
    for n in range(1, 33):
        t = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
             ).astype(np.float32)
        t[rng.random(n) < (0.2 if n % 4 else 1.0)] = -0.0
        plan = ss.segment_plan(torch.zeros(n, dtype=torch.int64), 1,
                               keep=torch.ones(n, dtype=torch.bool))
        want = ops.segment_sum(plan, torch.ones(n), torch.from_numpy(t),
                               torch.empty(1))
        p = [np.float32(0) + x for x in t]
        q = [p[l] if l < n else np.float32(0) for l in range(16)]
        for l in range(16):
            if l + 16 < n:
                q[l] = q[l] + p[l + 16]
        for off in (8, 4, 2, 1):
            q = [q[l] + q[l + off] for l in range(off)]
        got = np.float32(q[0])
        assert got.tobytes() == want.numpy()[0].tobytes()
        assert got != 0 or not np.signbit(got)
