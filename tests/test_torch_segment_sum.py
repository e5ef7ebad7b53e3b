"""The fixed-order segment sum (``kernels/segment_sum.py``, its plain
version ``ref.segment_sum_ref``) on the CPU, and DANE's local gradient,
which sums through it.

The plain version against ``index_add_`` in f64 at runs of one term, of
31–33 terms (a warp's lanes once, and once and a lane more), of many terms
and of a bucket's full rows (the bias feature: one term a row); the lane
and butterfly order written out by hand for a run of 40 terms, bit for bit;
the plan of a DANE bucket (built once a bucket, kept by the solver); and
``data_grad`` against the atomic ``scatter_add_`` it replaces.

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
