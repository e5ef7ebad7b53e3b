"""The port's round engine against the reference's.

Every validation case of ``tests/test_engine.py`` (its 30 invalid
configurations and 7 valid ones, the scale paths' knobs included) must
raise the same exception with the same message in both packages, and
``aggregate`` given the same deltas and the same participation masks must
agree with the reference's — masks zero weights, and the reweight scalar
restores the expected mass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import build_problem  # noqa: E402
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

#: tests/test_engine.py's _INVALID_CONFIGS, all 30, in its order
_INVALID = [
    (dict(weighting="bogus"), "weighting must be one of"),
    (dict(server_scaling="block"), "server_scaling must be one of"),
    (dict(aggregator="sparse"), "aggregator must be one of"),
    (dict(participation=0.0), r"participation must be in \(0, 1\]"),
    (dict(participation=1.5), r"participation must be in \(0, 1\]"),
    (dict(participation=-0.25), r"participation must be in \(0, 1\]"),
    # bool is a subclass of int: client_chunk=True must not mean chunk=1
    (dict(client_chunk=True), "client_chunk must be a positive int"),
    (dict(client_chunk=0), "client_chunk must be a positive int"),
    (dict(client_chunk=-4), "client_chunk must be a positive int"),
    (dict(client_chunk=2.5), "client_chunk must be a positive int"),
    (dict(cohort=True), "cohort must be a positive int"),
    (dict(cohort=0), "cohort must be a positive int"),
    (dict(cohort=-1), "cohort must be a positive int"),
    (dict(virtual_data=1), "virtual_data must be a bool"),
    (dict(virtual_data=None), "virtual_data must be a bool"),
    (dict(aggregator_guard="huber"), "aggregator_guard must be one of"),
    # order-statistic guards need the materialized (K, d) stacks
    (dict(aggregator_guard="trimmed_mean", client_chunk=8), "materialized"),
    (dict(aggregator_guard="median", client_chunk=8), "materialized"),
    (dict(aggregator_guard="trimmed_mean", virtual_data=True), "virtual"),
    (dict(aggregator_guard="median", virtual_data=True), "virtual"),
    # ... and replace the weighted sum dual methods rely on
    (dict(aggregator_guard="trimmed_mean", weighting="sum"),
     "exact plain sum"),
    (dict(aggregator_guard="median", weighting="sum"), "exact plain sum"),
    (dict(guard_trim=-0.1), r"guard_trim must be in \[0, 0.5\)"),
    (dict(guard_trim=0.5), r"guard_trim must be in \[0, 0.5\)"),
    (dict(guard_trim=0.7), r"guard_trim must be in \[0, 0.5\)"),
    (dict(guard_clip_norm=0.0), "guard_clip_norm must be a positive number"),
    (dict(guard_clip_norm=-1.0), "guard_clip_norm must be a positive number"),
    (dict(guard_clip_norm=True), "guard_clip_norm must be a positive number"),
    (dict(guard_clip_norm=1.0), "requires aggregator_guard='clip'"),
    (dict(guard_clip_norm=1.0, aggregator_guard="median"),
     "requires aggregator_guard='clip'"),
]


@pytest.mark.parametrize("kwargs,match", _INVALID,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw, _ in _INVALID])
def test_engine_config_rejects_what_the_reference_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match) as ref_err:
        RefEngineConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as port_err:
        EngineConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_the_matrix_is_the_references_whole():
    from test_engine import _INVALID_CONFIGS
    assert len(_INVALID) == len(_INVALID_CONFIGS) == 30
    assert _INVALID == _INVALID_CONFIGS


@pytest.mark.parametrize("kwargs", [
    dict(), dict(participation=0.5), dict(weighting="sum"),
    dict(server_scaling="diag", aggregator="pallas", weighting="uniform"),
    # tests/test_engine.py's valid combinations
    dict(participation=0.5, cohort=4),
    dict(client_chunk=8, virtual_data=True),
    dict(aggregator_guard="trimmed_mean", guard_trim=0.2),
    dict(aggregator_guard="median", participation=0.3),
    dict(aggregator_guard="clip", guard_clip_norm=5.0, client_chunk=8),
    dict(aggregator_guard="clip", virtual_data=True),
])
def test_engine_config_valid_combinations(kwargs):
    EngineConfig(**kwargs)
    RefEngineConfig(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(client_chunk=True), dict(cohort=True), dict(cohort=0),
    dict(client_chunk=False)])
def test_engine_config_rejects_bool_counts(kwargs):
    """isinstance(True, int) holds, so a bool count must be refused
    explicitly — as the reference's test_engine_config_rejects_bool_counts
    holds it; real ints pass."""
    with pytest.raises(ValueError) as ref_err:
        RefEngineConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        EngineConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)
    cfg = EngineConfig(client_chunk=1, cohort=1)
    assert cfg.client_chunk == 1 and cfg.cohort == 1


@pytest.fixture(scope="module")
def problems(small_problem, small_dataset):
    return small_problem, build_problem(
        dataset_from_arrays(small_dataset, device="cpu"), device="cpu")


def test_diag_scaling_requires_a_diag(problems):
    _, pp = problems
    with pytest.raises(ValueError, match="requires an a_diag"):
        RoundEngine(pp, EngineConfig(server_scaling="diag"))


@pytest.mark.parametrize("aggregator", ["dense", "pallas"])
@pytest.mark.parametrize("eng_kw", [
    {}, {"server_scaling": "diag"}, {"participation": 0.5},
    {"weighting": "uniform", "server_scaling": "diag", "participation": 0.3},
    {"weighting": "sum", "participation": 0.5},
], ids=["plain", "diag", "p0.5", "uniform-diag-p0.3", "sum-p0.5"])
def test_aggregate_matches_reference_with_injected_masks(problems, eng_kw,
                                                         aggregator):
    rp, pp = problems
    rng = np.random.default_rng(4)
    deltas = [rng.standard_normal((b.num_clients, rp.d)).astype(np.float32)
              for b in rp.buckets]
    w = (rng.standard_normal(rp.d) * 0.1).astype(np.float32)
    a = (np.abs(rng.standard_normal(rp.d)) + 0.5).astype(np.float32)
    kw = dict(eng_kw, aggregator=aggregator)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw), a_diag=jnp.asarray(a))
    port = RoundEngine(pp, EngineConfig(**kw), a_diag=torch.tensor(a))
    masks = ref.participation_masks(jax.random.PRNGKey(9))
    expect = ref.aggregate(jnp.asarray(w), [jnp.asarray(x) for x in deltas],
                           jax.random.PRNGKey(9), masks=masks)
    got = port.aggregate(
        torch.tensor(w), torch.tensor(np.concatenate(deltas)),
        None if masks is None else [torch.tensor(np.asarray(m))
                                    for m in masks])
    if masks is not None:
        assert 0 < sum(float(m.sum()) for m in masks) < rp.num_clients
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-6)


def test_partial_participation_needs_the_rounds_masks(problems):
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(participation=0.5))
    with pytest.raises(ValueError, match="masks"):
        eng.aggregate(torch.zeros(pp.d), torch.zeros(pp.num_clients, pp.d))


def test_masks_are_drawn_once_per_round_from_the_generator(problems):
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(participation=0.5))
    draw = lambda: eng.participation_masks(threefry.PRNGKey(3))
    a, b = draw(), draw()
    assert [m.shape[0] for m in a] == [bk.num_clients for bk in pp.buckets]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert set(x.unique().tolist()) <= {0.0, 1.0}
    assert RoundEngine(pp, EngineConfig()).participation_masks(
        threefry.PRNGKey(0)) is None


def _state_passes(rp):
    """The same deterministic state pass in both packages: deltas
    (Σ_j s_kj)·w per client, new state 2s + 1 + bucket index."""

    def ref_pass(w, bi, b, s_b, kb):
        return s_b.sum(axis=1)[:, None] * w[None, :], 2.0 * s_b + 1.0 + bi

    def port_pass(w, bi, b, s_b, gen, out):
        torch.mul(s_b.sum(dim=1)[:, None], w[None, :], out=out)
        return 2.0 * s_b + 1.0 + bi

    return ref_pass, port_pass


@pytest.mark.parametrize("aggregator", ["dense", "pallas"])
@pytest.mark.parametrize("participation", [1.0, 0.5])
def test_round_with_state_matches_reference(problems, participation,
                                             aggregator):
    """round_with_state with the reference's masks injected: every frozen
    client's state is bit-identical to its old state, every participant's
    is its pass's new state, and the new iterate matches the reference's
    round_with_state on the same inputs (rtol 1e-5: summation order)."""
    rp, pp = problems
    rng = np.random.default_rng(12)
    states = [rng.standard_normal((b.num_clients, 3)).astype(np.float32)
              for b in rp.buckets]
    w = (rng.standard_normal(rp.d) * 0.1).astype(np.float32)
    kw = dict(weighting="sum", participation=participation,
              aggregator=aggregator)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw))
    port = RoundEngine(pp, EngineConfig(**kw))
    ref_pass, port_pass = _state_passes(rp)
    key = jax.random.PRNGKey(5)
    w_ref, s_ref = ref.round_with_state(jnp.asarray(w),
                                        [jnp.asarray(s) for s in states],
                                        key, ref_pass)
    masks = ref.participation_masks(key)
    if masks is not None:
        masks = [torch.tensor(np.asarray(m)) for m in masks]
        assert 0 < sum(float(m.sum()) for m in masks) < pp.num_clients
        port.participation_masks = lambda gen, round_index=None: masks
    old = [torch.tensor(s) for s in states]
    w_got, s_got = port.round_with_state(torch.tensor(w), old,
                                         threefry.PRNGKey(0), port_pass)
    for bi, (o, new, expect) in enumerate(zip(old, s_got, s_ref)):
        sel = (torch.ones(o.shape[0]) if masks is None else masks[bi]) > 0
        assert torch.equal(new[~sel], o[~sel])          # frozen: bit-exact
        assert torch.equal(new[sel], 2.0 * o[sel] + 1.0 + bi)
        np.testing.assert_array_equal(new.numpy(), np.asarray(expect))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-6)


def test_reference_and_compile_with_state_take_the_prelude(problems):
    """The prelude's results reach the state pass; the compiled round is
    the reference round."""
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(weighting="sum"))
    seen = []

    def pass_(w, bi, b, s_b, gen, out, extra):
        seen.append(extra)
        out.zero_()
        return s_b + extra

    states = tuple(torch.zeros(b.num_clients, 2) for b in pp.buckets)
    w = torch.ones(pp.d)
    outs = [f(pass_, prelude=lambda w: (float(w.sum()),))(w, states,
                                                          threefry.PRNGKey(0))
            for f in (eng.reference_with_state, eng.compile_with_state)]
    assert seen == [float(pp.d)] * (2 * len(pp.buckets))
    for w2, s2 in outs:
        assert torch.equal(w2, w) and isinstance(s2, tuple)
        assert all(torch.equal(s, torch.full_like(s, pp.d)) for s in s2)
