"""The port's fleet layer (``repro_torch.fleet``) and its fault-tolerant
rounds against the reference's.

Per-client quantities are held bit for bit: availability and straggler
masks, the trace participation masks over the scale-0.002 problem's
buckets, fault kinds, and the corrupted deltas (sign, scale, replay and the
NaN / ±Inf payloads).  The availability *rate* takes ``sin``, which differs
by an ulp between torch and XLA on about 5 % of the clients; a mask could
flip only where the uniform lies within that ulp of the rate, and none
does here.  Rounds under a trace, faults and a guard are held against the
reference's plain round (never across its round paths, which disagree in
the reference itself under faults), with the reference's permutations
injected, at rtol 1e-4 — the slices 1–2 tolerance (the passes are not
bit-exact: sigmoid ulps and XLA's fused multiply-adds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.core.trainer import NonFiniteIterateError as RefNonFinite  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.bridge import (dataset_from_arrays,  # noqa: E402
                                faults_from_config, trace_from_config)
from repro_torch.core import (CoCoAPlus, FedAvg, FSVRG,  # noqa: E402
                              NonFiniteIterateError, Trainer, build_problem,
                              make_solver)
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

TRACE = rfleet.FleetTrace(seed=5, base=0.5, amplitude=0.3, period=7.0,
                          burst_prob=0.3, burst_frac=0.5,
                          straggler_rate=0.25)
FAULTS = rfleet.DeltaFaults(seed=9, nan_rate=0.15, sign_rate=0.2,
                            scale_rate=0.15, scale_factor=5.0,
                            replay_rate=0.15, replay_window=2)
#: the chip run's fleet and faults, at higher rates so that 20 clients see
#: every kind in three rounds
PATH_TRACE = rfleet.FleetTrace(seed=0)
PATH_FAULTS = rfleet.DeltaFaults(seed=0, nan_rate=0.1, sign_rate=0.1,
                                 scale_rate=0.1, replay_rate=0.1)
IDS = np.arange(10_000, dtype=np.uint32)


def _ids(ids=IDS):
    return torch.tensor(np.asarray(ids).astype(np.int64))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def _layout(problem):
    sizes = tuple(b.num_clients for b in problem.buckets)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes)[:-1])
    return offsets, sizes


# -- traces ------------------------------------------------------------------ #

@pytest.mark.parametrize("kwargs", [
    dict(base=0.0), dict(base=1.5), dict(amplitude=-0.1),
    dict(base=0.3, amplitude=0.4), dict(period=0.0),
    dict(burst_prob=1.5), dict(burst_frac=-0.1), dict(straggler_rate=1.0),
])
def test_fleet_trace_rejects_what_the_reference_rejects(kwargs):
    with pytest.raises(ValueError) as ref_err:
        rfleet.FleetTrace(**kwargs)
    with pytest.raises(ValueError) as port_err:
        fleet.FleetTrace(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("trace", [rfleet.FleetTrace(seed=0), TRACE],
                         ids=["default", "bursty"])
def test_fleet_masks_bit_equal_at_k_10000(trace):
    pt = trace_from_config(trace)
    assert pt.max_rate() == trace.max_rate()
    for r in (0, 1, 17, 30):
        ref = rfleet.fleet_masks(trace, r, IDS)
        got = fleet.fleet_masks(pt, r, _ids())
        np.testing.assert_array_equal(got.available.numpy(),
                                      np.asarray(ref.available))
        np.testing.assert_array_equal(got.returned.numpy(),
                                      np.asarray(ref.returned))
        np.testing.assert_allclose(
            fleet.availability_rate(pt, r, _ids()).numpy(),
            np.asarray(rfleet.availability_rate(trace, r, IDS)),
            rtol=0, atol=1.2e-7)


def test_trace_participation_masks_bit_equal_over_rounds(port_problem):
    """The scale-0.002 problem's bucket offsets, rounds 0–30; the draw
    ignores the round's generator."""
    offsets, sizes = _layout(port_problem)
    ref_model = rfleet.TraceParticipation(TRACE)
    model = fleet.TraceParticipation(trace_from_config(TRACE))
    assert model.needs_round_index
    ref_draw = jax.jit(lambda r: ref_model.mask_components(
        jax.random.PRNGKey(0), r, offsets, sizes))
    for r in range(31):
        ra, rr = ref_draw(jnp.int32(r))
        ga, gr = model.mask_components(threefry.PRNGKey(r), r,
                                       offsets, sizes, torch.device("cpu"))
        masks = model.masks(None, r, offsets, sizes, torch.device("cpu"))
        for x, y, z, u, v in zip(ga, gr, masks, ra, rr):
            np.testing.assert_array_equal(x.numpy(), np.asarray(u))
            np.testing.assert_array_equal(y.numpy(), np.asarray(v))
            np.testing.assert_array_equal(z.numpy(), np.asarray(v))


def test_fleet_masks_invariant_to_batch_shape():
    pt = trace_from_config(TRACE)
    whole = fleet.fleet_masks(pt, 3, _ids(IDS[:500])).returned
    for lo, hi in ((0, 7), (7, 64), (64, 500)):
        assert torch.equal(fleet.fleet_masks(pt, 3, _ids(IDS[lo:hi]))
                           .returned, whole[lo:hi])


# -- faults ------------------------------------------------------------------ #

@pytest.mark.parametrize("faults", [FAULTS, PATH_FAULTS,
                                    rfleet.DeltaFaults(seed=3, sign_rate=1.0),
                                    rfleet.DeltaFaults(seed=4, nan_rate=0.5,
                                                       replay_rate=0.5)],
                         ids=["mixed", "path", "all-sign", "nan-replay"])
def test_fault_kinds_and_apply_bit_equal(faults):
    pf = faults_from_config(faults)
    assert pf.total_rate() == faults.total_rate()
    ids = IDS[:300]
    deltas = np.random.default_rng(0).standard_normal((300, 41)).astype(
        np.float32)
    for r in (0, 1, 2, 5):
        kinds = pf.kinds(r, _ids(ids))
        ref_kinds = np.asarray(faults.kinds(r, ids))
        np.testing.assert_array_equal(kinds.numpy(), ref_kinds)
        assert kinds.dtype == torch.int32
        got = pf.apply(torch.tensor(deltas), r, _ids(ids)).numpy()
        np.testing.assert_array_equal(
            _bits(got), _bits(faults.apply(jnp.asarray(deltas), r, ids)))
    seen = set(np.unique(np.concatenate(
        [np.asarray(faults.kinds(r, ids)) for r in (0, 1, 2, 5)])))
    expect = {k for k, rate in zip(range(1, 5),
                                   (faults.nan_rate, faults.sign_rate,
                                    faults.scale_rate, faults.replay_rate))
              if rate > 0}
    assert expect <= seen


def test_fault_edges_are_the_reference_f32_running_sum():
    """XLA's cumsum adds the rates one at a time in f32; torch's CPU
    cumsum would give 0.1 where XLA gives 0.099999994 for the chip run's
    rates."""
    for rates in ((0.01, 0.05, 0.02, 0.02), (0.1, 0.2, 0.3, 0.4),
                  (0.15, 0.2, 0.15, 0.15), (1 / 3, 1 / 3, 0.1, 0.2)):
        edges = np.asarray(jnp.cumsum(jnp.asarray(rates, jnp.float32)))
        faults = fleet.DeltaFaults(**dict(zip(
            ("nan_rate", "sign_rate", "scale_rate", "replay_rate"), rates)))
        np.testing.assert_array_equal(faults.edges().numpy(), edges)


def test_fault_window_gating_spec_and_counts():
    f = dataclasses.replace(FAULTS, start_round=3, stop_round=5)
    pf = faults_from_config(f)
    ids = _ids(IDS[:100])
    assert not pf.kinds(2, ids).any() and not pf.kinds(5, ids).any()
    assert pf.kinds(3, ids).any()
    assert torch.equal(pf.kinds(4, ids),
                       faults_from_config(FAULTS).kinds(4, ids))
    spec = "nan=0.01,sign=0.05,scale-factor=7,start=3,stop=9,seed=2"
    assert (dataclasses.asdict(fleet.DeltaFaults.from_spec(spec))
            == dataclasses.asdict(rfleet.DeltaFaults.from_spec(spec)))
    with pytest.raises(ValueError, match="knob"):
        fleet.DeltaFaults.from_spec("nans=0.1")
    g = fleet.DeltaFaults(seed=7, nan_rate=0.2, sign_rate=0.2)
    mask = (torch.arange(64) % 3 != 0).to(torch.float32)
    ref = rfleet.fault_counts(rfleet.DeltaFaults(seed=7, nan_rate=0.2,
                                                 sign_rate=0.2), 1,
                              jnp.arange(64, dtype=jnp.uint32),
                              jnp.asarray(mask.numpy()))
    got = fleet.fault_counts(g, 1, torch.arange(64), mask)
    assert got == tuple(int(x) for x in ref) and min(got) > 0
    assert fleet.fault_counts(None, 1, torch.arange(64), mask) == (0, 0)


@pytest.mark.parametrize("kwargs", [
    dict(nan_rate=0.6, sign_rate=0.6), dict(nan_rate=1.5),
    dict(sign_rate=-0.1), dict(replay_window=0),
    dict(start_round=4, stop_round=4),
])
def test_fault_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as ref_err:
        rfleet.DeltaFaults(**kwargs)
    with pytest.raises(ValueError) as port_err:
        fleet.DeltaFaults(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


# -- the engine's faulted round ---------------------------------------------- #

def _fixed_deltas(problem, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b.num_clients, problem.d)) * 0.1).astype(
        np.float32) for b in problem.buckets]


def _passes(deltas):
    """The same deltas every round in both packages, so that what differs
    is only the engine: masks, faults and the guard."""
    def ref_pass(w, bi, b, kb):
        return jnp.asarray(deltas[bi])

    def port_pass(w, bi, b, gen, out):
        out.copy_(torch.tensor(deltas[bi]))

    def ref_state_pass(w, bi, b, s, kb):
        return jnp.asarray(deltas[bi]), s + 1.0

    def port_state_pass(w, bi, b, s, gen, out):
        out.copy_(torch.tensor(deltas[bi]))
        return s + 1.0

    return ref_pass, port_pass, ref_state_pass, port_state_pass


@pytest.mark.parametrize("aggregator,guard", [
    ("dense", "clip"), ("pallas", "clip"), ("dense", "trimmed_mean"),
    ("pallas", "median")])
def test_faulted_round_matches_reference(small_problem, port_problem, guard,
                                         aggregator):
    """A trace, every fault kind and each guard, on the plain round with
    fixed client deltas: held at rtol 1e-5 (the aggregation sums in another
    order); the faults and the guard both change the round."""
    rp, pp = small_problem, port_problem
    deltas = _fixed_deltas(rp)
    ref_pass, port_pass, _, _ = _passes(deltas)
    kw = dict(participation=TRACE.max_rate(), aggregator_guard=guard,
              aggregator=aggregator)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw),
                         participation_model=rfleet.TraceParticipation(TRACE),
                         fault_model=FAULTS)
    port = RoundEngine(pp, EngineConfig(**kw),
                       participation_model=fleet.TraceParticipation(
                           trace_from_config(TRACE)),
                       fault_model=faults_from_config(FAULTS))
    w = (np.random.default_rng(1).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    for r in (0, 1, 2):
        expect = np.asarray(ref.round(jnp.asarray(w), jax.random.PRNGKey(r),
                                      ref_pass, round_index=r))
        got = port.round(torch.tensor(w), threefry.PRNGKey(r), port_pass,
                         round_index=r).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_faulted_state_round_keeps_honest_state(small_problem, port_problem):
    """round_with_state under a trace and faults: the delta is corrupted,
    the state is the pass's own, and clients that did not return keep
    theirs bit for bit — as in the reference."""
    rp, pp = small_problem, port_problem
    deltas = _fixed_deltas(rp, 4)
    _, _, ref_pass, port_pass = _passes(deltas)
    kw = dict(weighting="sum", participation=TRACE.max_rate(),
              aggregator_guard="clip")
    ref = RefRoundEngine(rp, RefEngineConfig(**kw),
                         participation_model=rfleet.TraceParticipation(TRACE),
                         fault_model=FAULTS)
    port = RoundEngine(pp, EngineConfig(**kw),
                       participation_model=fleet.TraceParticipation(
                           trace_from_config(TRACE)),
                       fault_model=faults_from_config(FAULTS))
    states = [np.zeros((b.num_clients, 3), np.float32) for b in rp.buckets]
    w = np.zeros(rp.d, np.float32)
    ew, es = ref.round_with_state(jnp.asarray(w),
                                  [jnp.asarray(s) for s in states],
                                  jax.random.PRNGKey(0), ref_pass,
                                  round_index=2)
    gw, gs = port.round_with_state(torch.tensor(w),
                                   [torch.tensor(s) for s in states],
                                   threefry.PRNGKey(0), port_pass,
                                   round_index=2)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ew), rtol=1e-5,
                               atol=1e-6)
    for x, y in zip(gs, es):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_round_dependent_models_need_the_round(port_problem):
    pp = port_problem
    _, port_pass, _, _ = _passes(_fixed_deltas(pp))
    for kw in (dict(participation_model=fleet.TraceParticipation(
            trace_from_config(TRACE))),
               dict(fault_model=faults_from_config(FAULTS))):
        eng = RoundEngine(pp, EngineConfig(), **kw)
        with pytest.raises(ValueError, match="round"):
            eng.round(torch.zeros(pp.d), threefry.PRNGKey(0), port_pass)
    with pytest.raises(ValueError, match="participation_model"):
        RoundEngine(pp, EngineConfig(), participation_model=object())
    with pytest.raises(ValueError, match="fault_model"):
        RoundEngine(pp, EngineConfig(), fault_model=object())


def test_straggler_equals_removed_delta(port_problem):
    """Replaying the trace's returned masks through FixedParticipation
    gives the trace round bit for bit, and differs from the
    availability-only round whenever someone straggled."""
    pp = port_problem
    offsets, sizes = _layout(pp)
    model = fleet.TraceParticipation(trace_from_config(TRACE))
    avail, returned = model.mask_components(None, 2, offsets, sizes,
                                            torch.device("cpu"))
    assert sum(float((a - b).sum()) for a, b in zip(avail, returned)) > 0
    _, port_pass, _, _ = _passes(_fixed_deltas(pp))
    w = torch.zeros(pp.d)
    outs = [RoundEngine(pp, EngineConfig(), participation_model=m).round(
        w, threefry.PRNGKey(0), port_pass, round_index=2)
        for m in (model, fleet.FixedParticipation(tuple(returned)),
                  fleet.FixedParticipation(tuple(avail)))]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_bernoulli_model_is_the_engines_draw(port_problem):
    pp = port_problem
    _, port_pass, _, _ = _passes(_fixed_deltas(pp))
    eng = RoundEngine(pp, EngineConfig(participation=0.4))
    eng_m = RoundEngine(pp, EngineConfig(participation=0.4),
                        participation_model=fleet.BernoulliParticipation(0.4))
    w = torch.zeros(pp.d)
    for r in range(3):
        g1 = threefry.PRNGKey(30 + r)
        g2 = threefry.PRNGKey(30 + r)
        for a, b in zip(eng.participation_masks(g1),
                        eng_m.participation_masks(g2, r)):
            assert torch.equal(a, b)
        assert torch.equal(
            eng.round(w, threefry.PRNGKey(r), port_pass),
            eng_m.round(w, threefry.PRNGKey(r), port_pass,
                        round_index=r))
    assert fleet.BernoulliParticipation(1.0).masks(
        None, 0, (0,), (3,), torch.device("cpu")) is None


def test_zero_rate_faults_are_the_identity(port_problem):
    pp = port_problem
    _, port_pass, _, _ = _passes(_fixed_deltas(pp))
    w = torch.zeros(pp.d)
    outs = [RoundEngine(pp, EngineConfig(participation=0.5), **kw).round(
        w, threefry.PRNGKey(7), port_pass, round_index=0)
        for kw in ({}, dict(fault_model=fleet.DeltaFaults(seed=3)))]
    assert torch.equal(outs[0], outs[1])


# -- three faulted rounds of each solver ------------------------------------- #

def _reference_permutations(seed, r, wi, num_clients, m_pad, epochs=None):
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r),
                            wi)
    keys = jax.random.split(kb, num_clients)
    if epochs is None:
        return np.stack([np.asarray(jax.random.permutation(k, m_pad))
                         for k in keys])
    return np.stack([[np.asarray(jax.random.permutation(ek, m_pad))
                      for ek in jax.random.split(k, epochs)] for k in keys])


def _reference_draws(cls):
    class ReferenceDraws(cls):
        def round(self, state, gen):
            self._r = state.round
            return super().round(state, gen)

        def permutations(self, gen, bucket_index, bucket):
            wi = sum(b.num_clients for b in self.problem.buckets[:bucket_index])
            epochs = getattr(self.cfg, "local_epochs", None)
            return torch.as_tensor(_reference_permutations(
                0, self._r, wi, bucket.num_clients, bucket.m_pad, epochs))
    return ReferenceDraws


@pytest.mark.parametrize("name,cls,kw", [
    ("fsvrg", FSVRG, dict(aggregator_guard="trimmed_mean", guard_trim=0.1,
                          aggregator="pallas")),
    ("fedavg", FedAvg, dict(aggregator_guard="median", aggregator="pallas")),
    ("cocoa", CoCoAPlus, dict(aggregator_guard="clip", aggregator="pallas")),
], ids=["fsvrg-trimmed_mean", "fedavg-median", "cocoa-clip"])
def test_faulted_solver_matches_reference_trainer(small_problem,
                                                  port_problem, name, cls,
                                                  kw):
    """Three rounds under each package's Trainer with the chip run's trace,
    all four fault kinds and the solver's guard, the reference's
    permutations injected.  Held at rtol 1e-4 of max |w|; observed (CPU)
    max abs error: FSVRG 7.2e-7 (max |w| 1.51), FedAvg 2.8e-7 (1.02),
    CoCoA+ 1.1e-5 (36.1: the wire faults break w = Xα/(λn), in the
    reference too)."""
    rp, pp = small_problem, port_problem
    loss = lambda prob: (lambda w: {"f": prob.flat.loss(w)})
    ref = RefTrainer(ref_make_solver(
        name, rp, participation_model=rfleet.TraceParticipation(PATH_TRACE),
        fault_model=PATH_FAULTS, **kw), rounds=3, seed=0,
        eval_fn=loss(rp)).fit()
    cfg = make_solver(name, pp, device="cpu",
                      participation_model=fleet.TraceParticipation(
                          trace_from_config(PATH_TRACE)),
                      fault_model=faults_from_config(PATH_FAULTS), **kw).cfg
    solver = (_reference_draws(cls)(pp, cfg=cfg, device="cpu")
              if name == "cocoa" else
              _reference_draws(cls)(pp, cfg, device="cpu"))
    got = Trainer(solver, rounds=3, seed=0, eval_fn=loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    np.testing.assert_allclose([h["f"] for h in got.history],
                               [h["f"] for h in ref.history], rtol=1e-4)


def test_unguarded_nan_round_raises_in_both(small_problem, port_problem):
    """NaN poisoning through the unguarded weighted sum: both Trainers
    stop in round 0."""
    rp, pp = small_problem, port_problem
    nan = rfleet.DeltaFaults(seed=2, nan_rate=0.3)
    with pytest.raises(RefNonFinite) as ref_err:
        RefTrainer(ref_make_solver("gd", rp, fault_model=nan),
                   rounds=2).fit()
    with pytest.raises(NonFiniteIterateError) as port_err:
        Trainer(make_solver("gd", pp, device="cpu",
                            fault_model=faults_from_config(nan)),
                rounds=2).fit()
    assert port_err.value.round_index == ref_err.value.round_index == 0
