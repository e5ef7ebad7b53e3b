"""The port's cohort round (``cohort``) against the reference's.

Both engines run their cohort round on the same problem with the same
per-client-keyed pass (a client's delta is ``(uniform(key, (d,)) − 0.5)·
(1 + 0.1·n_k)``, bit-equal in both packages), so the iterates differ only
in summation order (rtol 1e-5).  Covered: cohort ∈ {1, 2, capacity} (1
overflows the draw and takes the masked fallback), with and without
``client_chunk``, the three weightings, both aggregators, a fleet trace
with faults under the clip guard, the state round (gathered state put
back, everyone else's frozen bit for bit), and the robust cohort under
the trimmed mean and the median — which drops the participants beyond
``cap`` instead of falling back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fleet as rfleet  # noqa: E402
from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.core.engine import cohort_capacity as ref_capacity  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.bridge import (dataset_from_arrays,  # noqa: E402
                                faults_from_config, trace_from_config)
from repro_torch.core import build_problem, cohort_capacity  # noqa: E402
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

TRACE = rfleet.FleetTrace(seed=5, base=0.5, amplitude=0.3, period=7.0,
                          burst_prob=0.3, burst_frac=0.5,
                          straggler_rate=0.25)
FAULTS = rfleet.DeltaFaults(seed=9, nan_rate=0.15, sign_rate=0.2,
                            scale_rate=0.15, scale_factor=5.0,
                            replay_rate=0.15, replay_window=2)


@pytest.fixture(scope="module")
def problems(small_problem, small_dataset):
    return small_problem, build_problem(
        dataset_from_arrays(small_dataset, device="cpu"), device="cpu")


def ref_pass(w, bi, cb, keys):
    def one(n_k, ck):
        return ((jax.random.uniform(ck, w.shape) - 0.5)
                * (1.0 + 0.1 * n_k.astype(jnp.float32)))
    return jax.vmap(one)(cb.n_k, keys)


def port_pass(w, bi, cb, keys, out):
    u = threefry.uniform(keys, (w.shape[0],))
    out.copy_((u - 0.5) * (1.0 + 0.1 * cb.n_k.to(torch.float32))[:, None])


# the new state is exact in f32 and a function of each client's own state
# and key, so gathered and put-back states compare bit for bit
def ref_state_pass(w, bi, cb, s_c, keys):
    tag = (keys[:, 1] % 7).astype(jnp.float32)[:, None]
    return ref_pass(w, bi, cb, keys), 2.0 * s_c + tag


def port_state_pass(w, bi, cb, s_c, keys, out):
    port_pass(w, bi, cb, keys, out)
    return 2.0 * s_c + (keys[1] % 7).to(torch.float32)[:, None]


def _cap(prob, p):
    return cohort_capacity(p, max(b.num_clients for b in prob.buckets))


def _w(d):
    return (np.random.default_rng(1).standard_normal(d) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("K", [1, 7, 20, 10_000])
def test_cohort_capacity_is_the_references(p, K):
    assert cohort_capacity(p, K) == ref_capacity(p, K)
    assert 1 <= cohort_capacity(p, K) <= K


@pytest.mark.parametrize("cohort,chunk,weighting,aggregator", [
    (1, None, "nk", "dense"),
    (2, None, "uniform", "pallas"),
    ("cap", None, "sum", "dense"),
    (2, 3, "nk", "pallas"),
    ("cap", 2, "uniform", "dense"),
], ids=["c1-overflow-nk-dense", "c2-uniform-pallas", "cap-sum-dense",
        "c2-chunk3-nk-pallas", "cap-chunk2-uniform-dense"])
def test_cohort_round_matches_reference_cohort_round(
        problems, cohort, chunk, weighting, aggregator):
    rp, pp = problems
    p = 0.3
    cohort = _cap(rp, p) if cohort == "cap" else cohort
    a = np.abs(np.random.default_rng(2).standard_normal(rp.d)).astype(
        np.float32) + 0.5
    kw = dict(participation=p, cohort=cohort, client_chunk=chunk,
              weighting=weighting, aggregator=aggregator,
              server_scaling="diag")
    ref = RefRoundEngine(rp, RefEngineConfig(**kw), a_diag=jnp.asarray(a))
    port = RoundEngine(pp, EngineConfig(**kw), a_diag=torch.tensor(a))
    w = _w(rp.d)
    for r in (0, 1):
        expect = ref.round_cohort(jnp.asarray(w), jax.random.PRNGKey(r),
                                  ref_pass)
        got = port.round_cohort(torch.tensor(w), threefry.PRNGKey(r),
                                port_pass)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-5)


def test_cohort_overflow_takes_the_masked_bucket(problems, monkeypatch):
    """cohort=1 at p = 0.9: every bucket with more than one participant
    falls back to the masked bucket — and still matches the reference's
    cohort round (its lax.cond fallback) on the same key."""
    rp, pp = problems
    kw = dict(participation=0.9, cohort=1)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw))
    port = RoundEngine(pp, EngineConfig(**kw))
    fallbacks = []
    real = RoundEngine._masked_bucket

    def masked(self, w, bi, bucket, *args, **kwargs):
        if bucket is pp.buckets[bi]:        # the whole bucket, not a gather
            fallbacks.append(bi)
        return real(self, w, bi, bucket, *args, **kwargs)

    monkeypatch.setattr(RoundEngine, "_masked_bucket", masked)
    w = _w(rp.d)
    got = port.round_cohort(torch.tensor(w), threefry.PRNGKey(11), port_pass)
    expect = ref.round_cohort(jnp.asarray(w), jax.random.PRNGKey(11),
                              ref_pass)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)
    masks = port.participation_masks(threefry.PRNGKey(11))
    overflow = [bi for bi, m in enumerate(masks) if int(m.sum()) > 1
                and pp.buckets[bi].num_clients > 1]
    # a one-client bucket (cap = Kb) runs the masked body by definition
    whole = [bi for bi, b in enumerate(pp.buckets) if b.num_clients == 1]
    assert overflow and sorted(fallbacks) == sorted(overflow + whole)


@pytest.mark.parametrize("cohort,chunk", [(1, None), (3, 2)])
def test_cohort_state_round_matches_reference(problems, cohort, chunk):
    """The gathered state goes back to its clients' slots: new states equal
    the reference's bit for bit, and a client outside the draw keeps its
    old state bit for bit."""
    rp, pp = problems
    kw = dict(weighting="sum", participation=0.3, cohort=cohort,
              client_chunk=chunk)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw))
    port = RoundEngine(pp, EngineConfig(**kw))
    rng = np.random.default_rng(3)
    states = [rng.standard_normal((b.num_clients, 3)).astype(np.float32)
              for b in rp.buckets]
    key = 7
    w_ref, st_ref = ref.round_cohort_with_state(
        jnp.zeros(rp.d), [jnp.asarray(s) for s in states],
        jax.random.PRNGKey(key), ref_state_pass)
    w_port, st_port = port.round_cohort_with_state(
        torch.zeros(pp.d), [torch.tensor(s) for s in states],
        threefry.PRNGKey(key), port_state_pass)
    np.testing.assert_allclose(w_port.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-5)
    masks = port.participation_masks(threefry.PRNGKey(key))
    moved = 0
    for s_p, s_r, s_old, sel in zip(st_port, st_ref, states, masks):
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
        out = sel.numpy() <= 0
        np.testing.assert_array_equal(s_p.numpy()[out], s_old[out])
        moved += int((s_p.numpy()[~out] != s_old[~out]).any(axis=1).sum())
    assert moved > 0


def test_cohort_round_under_a_trace_and_faults_matches_reference(problems):
    """A fleet trace (the participation model counts as partial) and every
    fault kind under the clip guard: the gathered clients are faulted by
    their global ids, as on the reference's cohort round."""
    rp, pp = problems
    kw = dict(participation=TRACE.max_rate(), cohort=_cap(rp, 0.8),
              aggregator="pallas", aggregator_guard="clip",
              guard_clip_norm=5.0)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw),
                         participation_model=rfleet.TraceParticipation(TRACE),
                         fault_model=FAULTS)
    port = RoundEngine(pp, EngineConfig(**kw),
                       participation_model=fleet.TraceParticipation(
                           trace_from_config(TRACE)),
                       fault_model=faults_from_config(FAULTS))
    assert port.round_path() == "cohort"
    w = _w(rp.d)
    for r in (0, 1, 2):
        expect = ref.round_cohort(jnp.asarray(w), jax.random.PRNGKey(r),
                                  ref_pass, round_index=r)
        got = port.round_cohort(torch.tensor(w), threefry.PRNGKey(r),
                                port_pass, round_index=r)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("guard,cohort,faulted", [
    ("trimmed_mean", 2, False), ("median", "cap", False),
    ("trimmed_mean", "cap", True), ("median", 1, True)],
    ids=["trimmed-c2", "median-cap", "trimmed-cap-faults",
         "median-c1-faults"])
def test_robust_cohort_round_matches_reference(problems, guard, cohort,
                                               faulted, monkeypatch):
    """Under an order-statistic guard the gathered (cap, d) stacks go
    through one robust_aggregate over the valid rows; a draw above cap
    drops the participants beyond the first cap, as the reference does."""
    from repro_torch.kernels import ops
    rp, pp = problems
    p = 0.5
    cohort = _cap(rp, p) if cohort == "cap" else cohort
    kw = dict(participation=p, cohort=cohort, aggregator_guard=guard)
    extra_ref, extra_port = {}, {}
    if faulted:
        extra_ref = dict(fault_model=FAULTS)
        extra_port = dict(fault_model=faults_from_config(FAULTS))
    ref = RefRoundEngine(rp, RefEngineConfig(**kw), **extra_ref)
    port = RoundEngine(pp, EngineConfig(**kw), **extra_port)
    seen = []
    real = ops.robust_aggregate

    def robust(w, deltas, valid, *args):
        seen.append((tuple(deltas.shape), int(valid.sum())))
        return real(w, deltas, valid, *args)

    monkeypatch.setattr(ops, "robust_aggregate", robust)
    w = _w(rp.d)
    for r in (0, 1):
        expect = ref.round_cohort(jnp.asarray(w), jax.random.PRNGKey(r),
                                  ref_pass, round_index=r)
        got = port.round_cohort(torch.tensor(w), threefry.PRNGKey(r),
                                port_pass, round_index=r)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-6)
        masks = port.participation_masks(threefry.PRNGKey(r))
        caps = [port._cohort_cap(b.num_clients) for b in pp.buckets]
        rows = sum(c if c < b.num_clients else b.num_clients
                   for c, b in zip(caps, pp.buckets))
        kept = sum(min(int(m.sum()), c) for m, c in zip(masks, caps))
        shape, m = seen[-1]
        assert shape == (rows, pp.d)
        assert m <= kept
        if not faulted:
            assert m == kept
    assert len(seen) == 2


def test_cohort_round_requires_and_dispatch(problems):
    rp, pp = problems
    eng = RoundEngine(pp, EngineConfig(participation=0.5))
    with pytest.raises(ValueError, match="round_cohort requires cfg.cohort"):
        eng.round_cohort(torch.zeros(pp.d), threefry.PRNGKey(0), port_pass)
    with pytest.raises(ValueError,
                       match="round_cohort_with_state requires cfg.cohort"):
        eng.round_cohort_with_state(torch.zeros(pp.d), [],
                                    threefry.PRNGKey(0), port_state_pass)
    with pytest.raises(ValueError):
        RefRoundEngine(rp, RefEngineConfig(participation=0.5)).round_cohort(
            jnp.zeros(rp.d), jax.random.PRNGKey(0), ref_pass)
    cohort = RoundEngine(pp, EngineConfig(participation=0.5, cohort=3))
    with pytest.raises(ValueError, match="no chunk_pass was supplied"):
        cohort.compile(lambda *a: None)
    assert cohort.round_path() == "cohort"
    assert cohort.pass_rows() == max(cohort._cohort_cap(b.num_clients)
                                     for b in pp.buckets)
    # cohort and client_chunk: the cohort round, streamed
    both = RoundEngine(pp, EngineConfig(participation=0.5, cohort=3,
                                        client_chunk=2))
    assert both.round_path() == "cohort" and both.pass_rows() == 2
    # at participation 1.0 the knob is a no-op: the plain round
    full = RoundEngine(pp, EngineConfig(cohort=3))
    assert full.round_path() == "plain"

    def plain_pass(w, bi, b, kb, out):
        port_pass(w, bi, b, full.client_keys(kb, b.num_clients), out)

    w, key = torch.tensor(_w(pp.d)), threefry.PRNGKey(5)
    assert torch.equal(full.compile(plain_pass)(w, key),
                       RoundEngine(pp, EngineConfig()).round(w, key,
                                                             plain_pass))
