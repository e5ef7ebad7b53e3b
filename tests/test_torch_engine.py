"""The port's round engine against the reference's.

The validation cases of ``tests/test_engine.py`` that involve only the four
ported knobs (participation, weighting, server_scaling, aggregator) must
raise the same exception with the same message, and ``aggregate`` given the
same deltas and the same participation masks must agree with the
reference's — masks zero weights, and the reweight scalar restores the
expected mass.
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

#: tests/test_engine.py's _INVALID_CONFIGS restricted to the ported knobs
_INVALID = [
    (dict(weighting="bogus"), "weighting must be one of"),
    (dict(server_scaling="block"), "server_scaling must be one of"),
    (dict(aggregator="sparse"), "aggregator must be one of"),
    (dict(participation=0.0), r"participation must be in \(0, 1\]"),
    (dict(participation=1.5), r"participation must be in \(0, 1\]"),
    (dict(participation=-0.25), r"participation must be in \(0, 1\]"),
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


@pytest.mark.parametrize("kwargs", [
    dict(), dict(participation=0.5), dict(weighting="sum"),
    dict(server_scaling="diag", aggregator="pallas", weighting="uniform"),
])
def test_engine_config_valid_combinations(kwargs):
    EngineConfig(**kwargs)
    RefEngineConfig(**kwargs)


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
    draw = lambda: eng.participation_masks(torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert [m.shape[0] for m in a] == [bk.num_clients for bk in pp.buckets]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert set(x.unique().tolist()) <= {0.0, 1.0}
    assert RoundEngine(pp, EngineConfig()).participation_masks(
        torch.Generator()) is None
