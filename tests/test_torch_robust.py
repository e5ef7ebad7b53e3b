"""The order-statistic server update: the port's plain version of
``robust_aggregate`` against the reference's oracle and its Pallas kernel
(interpret mode, as the reference's own tests run it on the CPU), and the
engine's ``aggregator_guard`` against the reference's engine.

Tolerances: the sort is exact; only the sum over the rank window is taken
in another order (torch's against XLA's), so the outputs are held at
atol 1e-6 / rtol 1e-5 — the tolerance the card's kernel is held to.  At
m = 0 the output is w^t bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import build_problem  # noqa: E402
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

MODES = ("trimmed_mean", "median")


def _inputs(K, d, rate, seed, dtype=np.float32, ties=False):
    rng = np.random.default_rng(seed)
    wt = rng.standard_normal(d).astype(np.float32)
    deltas = rng.standard_normal((K, d)).astype(np.float32)
    if ties:                                  # sparse deltas: mostly zero
        deltas *= rng.random((K, d)) < 0.05
    valid = rng.random(K) < rate
    a = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
    return wt, deltas.astype(dtype), valid, a


def _both(wt, deltas, valid, a, trim, mode, pallas=True):
    """The port's output and the reference oracle's (and its interpret-mode
    Pallas kernel's), all as numpy f32."""
    tdel = (torch.tensor(deltas.astype(np.float32)).to(torch.bfloat16)
            if deltas.dtype != np.float32 else torch.tensor(deltas))
    got = ops.robust_aggregate(torch.tensor(wt), tdel, torch.tensor(valid),
                               torch.tensor(a), trim, mode).numpy()
    jd = jnp.asarray(tdel.float().numpy()).astype(
        jnp.bfloat16 if deltas.dtype != np.float32 else jnp.float32)
    args = (jnp.asarray(wt), jd, jnp.asarray(valid), jnp.asarray(a), trim,
            mode)
    expects = [np.asarray(jref.robust_aggregate_ref(*args))]
    if pallas:
        expects.append(np.asarray(jops.robust_aggregate(*args)))
    return got, expects


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K,d,trim,rate", [
    (1, 1, 0.0, 1.0), (2, 127, 0.1, 0.5), (16, 128, 0.25, 0.7),
    (24, 1000, 0.49, 0.3), (7, 4097, 0.1, 1.0),
])
def test_plain_version_matches_reference_and_pallas(K, d, trim, rate, mode):
    """The shapes of the reference's tests/test_robust_aggregate.py."""
    got, expects = _both(*_inputs(K, d, rate, K * 7919 + d), trim, mode)
    for expect in expects:
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["m0", "m1", "m2", "ties", "bf16",
                                  "trim0.42-m150", "nonfinite"])
def test_plain_version_edge_cases(case, mode):
    K, d, trim, kw = 40, 129, 0.1, {}
    if case == "ties":
        kw = dict(ties=True)
    elif case == "bf16":
        import ml_dtypes
        kw = dict(dtype=ml_dtypes.bfloat16)
    elif case == "trim0.42-m150":
        K, trim = 150, 0.42
    wt, deltas, valid, a = _inputs(K, d, 0.6, 11, **kw)
    if case == "trim0.42-m150":
        valid[:] = True
    elif case[0] == "m":
        valid[:] = False
        valid[[3, 30][:int(case[1])]] = True
    elif case == "nonfinite":
        deltas[3, :40] = np.inf
        deltas[4, 20:60] = -np.inf
        deltas[5, 50:90] = np.nan
        deltas[6:9, :5] = np.nan
    got, expects = _both(wt, deltas, valid, a, trim, mode,
                         pallas=case != "nonfinite")
    for expect in expects:
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    if case == "m0":
        np.testing.assert_array_equal(got, wt)


def test_order_keys_sort_as_values():
    """The kernel's key map: unsigned key order is value order (−0 before
    +0), every NaN after +inf, and the keys map back to the values."""
    x = torch.tensor([float("-inf"), -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0,
                      float("inf"), float("nan")])
    k = ref.order_keys(x)
    assert bool((k[1:] > k[:-1]).all())
    assert int(k[-1]) == 0xFFFFFFFF
    assert torch.equal(ref.key_values(k)[:-1], x[:-1])
    assert torch.isnan(ref.key_values(k)[-1])
    y = torch.tensor(np.random.default_rng(1).standard_normal(999)
                     .astype(np.float32))
    assert torch.equal(ref.key_values(ref.order_keys(y)), y)
    assert torch.equal(torch.argsort(ref.order_keys(y), stable=True),
                       torch.argsort(y, stable=True))


@pytest.mark.parametrize("ties", [False, True])
def test_radix_edges_are_the_sorted_ranks(ties):
    """Digit by digit (8/8/8/8 bits), the select lands on the keys that a
    sort puts at the ranks asked for, tie runs included."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((301, 64)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
    keys = ref.order_keys(torch.tensor(x))
    ranks = torch.tensor(rng.integers(0, 301, size=(2, 64)))
    edges = ref.radix_edges(keys, ranks)
    assert ref.RADIX_DIGITS == (8, 8, 8, 8)
    assert torch.equal(edges, torch.sort(keys, dim=0).values.gather(0, ranks))


_SELECT_CASES = ["ties-straddle", "all-equal", "zeros95", "heavy-tail",
                 "nonfinite", "m0", "m1", "m2", "m-odd", "m-even",
                 "trim0.42-m150", "bf16"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", _SELECT_CASES)
def test_select_arithmetic_matches_reference_and_pallas(case, mode):
    """The kernel's arithmetic on the CPU (``ref.robust_select_ref``: the
    edges by radix select, the window summed from them with exact ties)
    against the sort-based plain version, the reference's oracle and its
    interpret-mode kernel, at atol 1e-6 / rtol 1e-5."""
    K, d, trim, kw = 40, 129, 0.1, {}
    rng = np.random.default_rng(13)
    if case == "zeros95":
        kw = dict(ties=True)
    elif case == "bf16":
        import ml_dtypes
        kw = dict(dtype=ml_dtypes.bfloat16)
    elif case == "trim0.42-m150":
        K, trim = 150, 0.42
    wt, deltas, valid, a = _inputs(K, d, 0.6, 17, **kw)
    if case == "ties-straddle":              # 7 levels: every edge in a run
        deltas = (rng.integers(-3, 4, (K, d)) * 0.01).astype(np.float32)
    elif case == "all-equal":
        deltas = np.broadcast_to(rng.standard_normal(d), (K, d)).astype(
            np.float32)
    elif case == "heavy-tail":                # 2 % of rows scaled ×100
        deltas = deltas * 0.01
        deltas[rng.choice(K, size=max(1, K // 50), replace=False)] *= 100
    elif case == "nonfinite":
        deltas[3, :40] = np.inf
        deltas[4, 20:60] = -np.inf
        deltas[5, 50:90] = np.nan
        deltas[6:9, :5] = np.nan
    elif case in ("m0", "m1", "m2"):
        valid[:] = False
        valid[[3, 30][:int(case[1])]] = True
    elif case in ("m-odd", "m-even"):
        valid[:] = False
        valid[:37 if case == "m-odd" else 38] = True
    elif case == "trim0.42-m150":
        valid[:] = True
    tdel = (torch.tensor(deltas.astype(np.float32)).to(torch.bfloat16)
            if case == "bf16" else torch.tensor(deltas))
    got = ref.robust_select_ref(torch.tensor(wt), tdel, torch.tensor(valid),
                                torch.tensor(a), trim, mode).numpy()
    plain, expects = _both(wt, deltas, valid, a, trim, mode,
                           pallas=case != "nonfinite")
    for expect in (plain, *expects):
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    if case == "m0":
        np.testing.assert_array_equal(got, wt)


def test_trimmed_window_floor_is_f32():
    """lo = ⌊f32(trim)·f32(m)⌋: 0.42·150 is 62.999996 in f32, so lo = 62
    (the exact product would give 63) — the one such case for trims
    0.01–0.49 and m < 200."""
    assert ref.robust_window(150, 0.42, "trimmed_mean") == (62, 88)
    assert int(np.floor(np.float32(0.42) * np.float32(150))) == 62
    odd = [(t, m) for t in np.round(np.arange(0.01, 0.50, 0.01), 2)
           for m in range(1, 200)
           if ref.robust_window(m, float(t), "trimmed_mean")[0]
           != int(np.floor(float(t) * m + 1e-9))]
    assert odd == [(0.42, 150)]
    assert ref.robust_window(0, 0.1, "median") == (0, 0)
    assert ref.robust_window(7, 0.1, "median") == (3, 4)
    assert ref.robust_window(8, 0.1, "median") == (3, 5)


def test_matches_numpy_order_statistics():
    """Against numpy's median and a sorted slice, as the reference's own
    test: m = 7 valid rows of 9."""
    rng = np.random.default_rng(0)
    deltas = rng.normal(size=(9, 300)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1], bool)
    w = rng.normal(size=300).astype(np.float32)
    a = (np.abs(rng.normal(size=300)) + 0.5).astype(np.float32)
    rows = deltas[valid]
    for mode, expect in (("median", w + a * np.median(rows, axis=0)),
                         ("trimmed_mean", w + a * np.sort(rows, axis=0)[1:6]
                          .mean(axis=0))):
        got = ops.robust_aggregate(torch.tensor(w), torch.tensor(deltas),
                                   torch.tensor(valid), torch.tensor(a), 0.2,
                                   mode)
        np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_validation_matches_reference():
    w, deltas = np.zeros(8, np.float32), np.zeros((2, 8), np.float32)
    valid = np.ones(2, bool)
    for trim, mode in ((0.1, "mean"), (0.5, "trimmed_mean")):
        with pytest.raises(ValueError) as ref_err:
            jops.robust_aggregate(jnp.asarray(w), jnp.asarray(deltas),
                                  jnp.asarray(valid), jnp.ones(8), trim, mode)
        with pytest.raises(ValueError) as port_err:
            ops.robust_aggregate(torch.tensor(w), torch.tensor(deltas),
                                 torch.tensor(valid), torch.ones(8), trim,
                                 mode)
        assert str(port_err.value) == str(ref_err.value)


# -- the engine's guards ----------------------------------------------------- #

#: tests/test_engine.py's guard rows that need no client_chunk/virtual_data
_INVALID = [
    (dict(aggregator_guard="huber"), "aggregator_guard must be one of"),
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
def test_guard_config_rejects_what_the_reference_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match) as ref_err:
        RefEngineConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as port_err:
        EngineConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kwargs", [
    dict(aggregator_guard="trimmed_mean", guard_trim=0.2),
    dict(aggregator_guard="median", participation=0.3),
    dict(aggregator_guard="clip", guard_clip_norm=5.0),
])
def test_guard_config_valid_combinations(kwargs):
    EngineConfig(**kwargs)
    RefEngineConfig(**kwargs)


@pytest.fixture(scope="module")
def problems(small_problem, small_dataset):
    return small_problem, build_problem(
        dataset_from_arrays(small_dataset, device="cpu"), device="cpu")


@pytest.mark.parametrize("eng_kw", [
    dict(aggregator_guard="clip"),
    dict(aggregator_guard="clip", guard_clip_norm=0.5, aggregator="pallas",
         server_scaling="diag"),
    dict(aggregator_guard="clip", guard_clip_norm=2.0, participation=0.5),
    dict(aggregator_guard="trimmed_mean", guard_trim=0.25,
         server_scaling="diag", participation=0.5),
    dict(aggregator_guard="median", aggregator="pallas"),
    dict(aggregator_guard="median", participation=0.5, weighting="uniform"),
], ids=["clip", "clip-norm-pallas-diag", "clip-norm-p0.5",
        "trimmed-diag-p0.5", "median-pallas", "median-uniform-p0.5"])
def test_guarded_aggregate_matches_reference(problems, eng_kw):
    """The same deltas (a NaN row, an Inf row, a huge row) and the same
    masks through each package's ``aggregate``."""
    rp, pp = problems
    rng = np.random.default_rng(6)
    deltas = [rng.standard_normal((b.num_clients, rp.d)).astype(np.float32)
              for b in rp.buckets]
    deltas[-1][0, 3] = np.nan
    deltas[-1][1, :] = np.inf
    deltas[-1][2, :] *= 1e6
    w = (rng.standard_normal(rp.d) * 0.1).astype(np.float32)
    a = (np.abs(rng.standard_normal(rp.d)) + 0.5).astype(np.float32)
    diag = eng_kw.get("server_scaling") == "diag"
    ref_eng = RefRoundEngine(rp, RefEngineConfig(**eng_kw),
                             a_diag=jnp.asarray(a) if diag else None)
    port_eng = RoundEngine(pp, EngineConfig(**eng_kw),
                           a_diag=torch.tensor(a) if diag else None)
    masks = None
    if eng_kw.get("participation", 1.0) < 1.0:
        masks = [(rng.random(b.num_clients) < 0.6).astype(np.float32)
                 for b in rp.buckets]
        masks[-1][:3] = 1.0
    expect = np.asarray(ref_eng.aggregate(
        jnp.asarray(w), [jnp.asarray(x) for x in deltas], None,
        masks=None if masks is None else [jnp.asarray(m) for m in masks]))
    got = port_eng.aggregate(
        torch.tensor(w), torch.tensor(np.concatenate(deltas)),
        None if masks is None else [torch.tensor(m) for m in masks]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_guard_clip_rejects_nonfinite_and_caps_norms(problems):
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(aggregator_guard="clip",
                                       guard_clip_norm=0.5))
    d = pp.d
    small = torch.full((d,), 1e-3 / np.sqrt(d))
    safe = eng._guard_clip(torch.stack([torch.full((d,), float("nan")),
                                        torch.ones(d), small]))
    assert torch.equal(safe[0], torch.zeros(d))
    assert float(safe[1].norm()) == pytest.approx(0.5, rel=1e-5)
    torch.testing.assert_close(safe[2], small, rtol=1e-6, atol=0)
