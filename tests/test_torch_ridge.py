"""The port's dense ridge solvers, Algorithm 1 and the one-call baselines
against the reference's, and the paper's two equivalence results on the
port alone.

The ridge methods run in f64 in both packages from the same numpy inputs
(JAX under x64, scoped to each test): ``build_dense_problem``'s buckets are
equal, and ``DANERidge``, ``PrimalMethod``, ``DualMethod``,
``dual_to_primal`` and ``ridge_grad`` agree at rtol 1e-10 / atol 1e-12
(LAPACK's solves and the matmuls' summation order differ at 1e-15 of the
data's scale; observed ≤ 2.5e-15 of max |w|).  Theorem 5 holds on the
port at rtol 1e-9 / atol 1e-11, as in the reference's own test.

Algorithm 1, GD, FedAvg and one-shot averaging run in f32 on the logreg
problem, drawing their samples and permutations from the same threefry
keys in both packages: their iterates agree at rtol 1e-5 of max |w| (the
sigmoid ulp and XLA's fused multiply-adds; observed ≤ 2.7e-7 of max |w|).
Proposition 1 compares two f32 code paths of the port (the naive FSVRG
step kernel's plain version and DANE's SVRG pass) at rtol 1e-5 of max |w|
(observed ≤ 1.7e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DANERidge as RefDANERidge  # noqa: E402
from repro.core import DualMethod as RefDualMethod  # noqa: E402
from repro.core import PrimalMethod as RefPrimalMethod  # noqa: E402
from repro.core import build_dense_problem as ref_build_dense  # noqa: E402
from repro.core import get_spec as ref_get_spec  # noqa: E402
from repro.core.baselines import fedavg_round as ref_fedavg_round  # noqa: E402
from repro.core.baselines import majority_baseline_error as ref_majority  # noqa: E402
from repro.core.baselines import run_gd as ref_run_gd  # noqa: E402
from repro.core.cocoa import dual_to_primal as ref_dual_to_primal  # noqa: E402
from repro.core.dane import ridge_grad as ref_ridge_grad  # noqa: E402
from repro.core.svrg import run_svrg as ref_run_svrg  # noqa: E402
from repro.core.svrg import svrg_epoch as ref_svrg_epoch  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.core import (DANERidge, DualMethod, PrimalMethod,  # noqa: E402
                              available, build_dense_problem, build_problem,
                              dane_svrg_round, get_spec, make_solver,
                              naive_fsvrg_round)
from repro_torch.core.baselines import (fedavg_round,  # noqa: E402
                                        majority_baseline_error,
                                        one_shot_average, run_gd)
from repro_torch.core.cocoa import dual_to_primal  # noqa: E402
from repro_torch.core.dane import ridge_grad  # noqa: E402
from repro_torch.core.svrg import run_svrg, svrg_epoch  # noqa: E402
from repro_torch.data import generate  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

F64 = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def ridge_data(sizes=(12, 12, 12, 12), d=8, seed=0, alphas=False):
    rng = np.random.default_rng(seed)
    Xs = [rng.standard_normal((d, m)) for m in sizes]
    ys = [rng.standard_normal(m) for m in sizes]
    if alphas:
        return Xs, ys, [rng.standard_normal(m) for m in sizes]
    return Xs, ys


def both_problems(Xs, ys, lam):
    ref = ref_build_dense([jnp.asarray(X) for X in Xs],
                          [jnp.asarray(y) for y in ys], lam)
    return ref, build_dense_problem(Xs, ys, lam, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_dense_problem_buckets_match_the_reference(x64):
    """Unequal sizes: one bucket per distinct m_k, stable order, no
    padding, f64 data, f32 weights — equal to the reference's."""
    Xs, ys = ridge_data(sizes=(9, 6, 9, 4, 6, 9), d=5)
    rp, pp = both_problems(Xs, ys, 0.1)
    assert len(pp.buckets) == len(rp.buckets) == 3
    for rb, pb in zip(rp.buckets, pp.buckets):
        for field in ("idx", "val", "y", "n_k"):
            np.testing.assert_array_equal(_np(getattr(pb, field)),
                                          _np(getattr(rb, field)))
        assert pb.val.dtype == torch.float64
    assert pp.client_weights.dtype == torch.float32
    np.testing.assert_array_equal(_np(pp.client_weights),
                                  _np(rp.client_weights))
    for field in ("idx", "val", "y"):
        np.testing.assert_array_equal(_np(getattr(pp.flat, field)),
                                      _np(getattr(rp.flat, field)))
    assert (pp.flat.n, pp.flat.lam, pp.d, pp.num_clients) == (
        rp.flat.n, rp.flat.lam, rp.d, rp.num_clients)


@pytest.mark.parametrize("eta,mu", [(1.0, 0.0), (0.7, 0.5)])
def test_dane_ridge_matches_the_reference(x64, eta, mu):
    """3 rounds from the same w0, with unequal client sizes (2 buckets)."""
    Xs, ys = ridge_data(sizes=(12, 12, 7, 12, 7), seed=1)
    rp, pp = both_problems(Xs, ys, 0.1)
    w0 = np.random.default_rng(2).standard_normal(8)
    ref = RefDANERidge(rp, eta=eta, mu=mu)
    port = DANERidge(pp, eta=eta, mu=mu, device="cpu")
    rs, ps = ref.init(jnp.asarray(w0)), port.init(torch.as_tensor(w0))
    for r in range(3):
        rs = ref.round(rs, jax.random.PRNGKey(r))
        ps = port.round(ps, threefry.PRNGKey(r))
        assert ps.w.dtype == torch.float64
        np.testing.assert_allclose(_np(ps.w), _np(rs.w), **F64)
    np.testing.assert_allclose(_np(port.full_grad(ps.w)),
                               _np(ref.full_grad(rs.w)), **F64)
    assert port.hyperparams == ref.hyperparams
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("sigma", [2.0, 4.0])
def test_primal_method_matches_the_reference(x64, sigma):
    Xs, ys, a0 = ridge_data(seed=4, alphas=True)
    rp, pp = both_problems(Xs, ys, 0.1)
    ref = RefPrimalMethod(rp, sigma=sigma, alphas0=[jnp.asarray(a)
                                                    for a in a0])
    port = PrimalMethod(pp, sigma=sigma, alphas0=a0, device="cpu")
    rs, ps = ref.init(), port.init()
    np.testing.assert_allclose(_np(ps.w), _np(rs.w), **F64)
    for r in range(3):
        rs = ref.round(rs, jax.random.PRNGKey(0))
        ps = port.round(ps, threefry.PRNGKey(0))
        np.testing.assert_allclose(_np(ps.w), _np(rs.w), **F64)
        np.testing.assert_allclose(_np(ps.aux[0]), _np(rs.aux[0]), **F64)
    assert port.hyperparams == ref.hyperparams
    assert repr(port) == repr(ref)


def test_primal_method_leaves_the_old_state_as_it_was(x64):
    """Step 9 reads g_k after the engine's round: the round must hand back
    new state tensors, never write into the old ones."""
    Xs, ys, a0 = ridge_data(seed=4, alphas=True)
    port = PrimalMethod(build_dense_problem(Xs, ys, 0.1, device="cpu"),
                        sigma=2.0, alphas0=a0, device="cpu")
    s0 = port.init()
    kept = s0.aux[0].clone()
    s1 = port.round(s0, threefry.PRNGKey(0))
    assert torch.equal(s0.aux[0], kept)
    assert not torch.equal(s1.aux[0], kept)


@pytest.mark.parametrize("sigma", [1.0, 4.0])
def test_dual_method_matches_the_reference(x64, sigma):
    Xs, ys, a0 = ridge_data(seed=6, alphas=True)
    rp, pp = both_problems(Xs, ys, 0.1)
    ref = RefDualMethod(rp, sigma=sigma, alphas0=[jnp.asarray(a)
                                                  for a in a0])
    port = DualMethod(pp, sigma=sigma, alphas0=a0, device="cpu")
    rs, ps = ref.init(), port.init()
    np.testing.assert_allclose(_np(ps.w), _np(rs.w), **F64)
    for r in range(3):
        rs = ref.round(rs, jax.random.PRNGKey(0))
        ps = port.round(ps, threefry.PRNGKey(0))
        np.testing.assert_allclose(_np(ps.w), _np(rs.w), **F64)
        np.testing.assert_allclose(_np(ps.aux[0]), _np(rs.aux[0]), **F64)
    assert port.hyperparams == ref.hyperparams
    assert repr(port) == repr(ref)


def test_dual_to_primal_and_ridge_grad_match_the_reference(x64):
    Xs, ys, a0 = ridge_data(sizes=(5, 9, 7), d=6, seed=8, alphas=True)
    w = np.random.default_rng(9).standard_normal(6)
    t = torch.as_tensor
    np.testing.assert_allclose(
        _np(dual_to_primal([t(X) for X in Xs], [t(a) for a in a0], 0.3)),
        _np(ref_dual_to_primal([jnp.asarray(X) for X in Xs],
                               [jnp.asarray(a) for a in a0], 0.3)), **F64)
    for X, y in zip(Xs, ys):
        np.testing.assert_allclose(
            _np(ridge_grad(t(X), t(y), t(w), 0.3)),
            _np(ref_ridge_grad(jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(w), 0.3)), **F64)


@pytest.mark.parametrize("sigma", [1.0, 2.0, 4.0])
def test_theorem_5_on_the_port(sigma):
    """Algorithms 5 and 6 give the same iterates under w = (1/λn) X α, and
    the dual's iterate is (1/λn) X α of its current blocks."""
    Xs, ys, a0 = ridge_data(sizes=(12,) * 4, d=8, seed=0, alphas=True)
    dense = build_dense_problem(Xs, ys, 0.1, device="cpu")
    primal = PrimalMethod(dense, sigma=sigma, alphas0=a0, device="cpu")
    dual = DualMethod(dense, sigma=sigma, alphas0=a0, device="cpu")
    sp, sd = primal.init(), dual.init()
    key = threefry.PRNGKey(0)
    Xt = [torch.as_tensor(X) for X in Xs]
    for _ in range(6):
        sd = dual.round(sd, key)
        sp = primal.round(sp, key)
        np.testing.assert_allclose(_np(sp.w), _np(sd.w), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(
            _np(sd.w), _np(dual_to_primal(Xt, list(sd.aux[0]), 0.1)),
            rtol=1e-9, atol=1e-11)


def test_dane_ridge_solves_identical_data_in_one_round():
    """Property (D) (§3.4): identical local data, η = 1, µ = 0 — the local
    subproblem is the global one, solved exactly in one round."""
    rng = np.random.default_rng(2)
    X, y = rng.standard_normal((6, 20)), rng.standard_normal(20)
    solver = DANERidge(build_dense_problem([X] * 4, [y] * 4, 0.1,
                                           device="cpu"), device="cpu")
    w1 = solver.round(solver.init(torch.as_tensor(rng.standard_normal(6))),
                      threefry.PRNGKey(0)).w
    g = ridge_grad(torch.as_tensor(X), torch.as_tensor(y), w1, 0.1)
    assert float(torch.linalg.norm(g)) < 1e-8


@pytest.fixture(scope="module")
def tiny_port_problem():
    return build_problem(generate(get_logreg_config().scaled(0.001), 3,
                                  device="cpu"), device="cpu")


@pytest.mark.parametrize("stepsize,m", [(0.05, 10), (0.2, 25)])
def test_proposition_1_on_the_port(tiny_port_problem, stepsize, m):
    """DANE (η = 1, µ = 0, one SVRG epoch) and naive FSVRG (Algorithm 3)
    from the same w and key draw the same samples and give the same
    iterate (f32, two code paths)."""
    prob = tiny_port_problem
    w = 0.2 * torch.as_tensor(np.random.default_rng(7).standard_normal(
        prob.d), dtype=torch.float32)
    key = threefry.PRNGKey(11)
    w_alg3 = naive_fsvrg_round(prob, w, key, stepsize=stepsize, m=m)
    w_dane = dane_svrg_round(prob, w, key, stepsize=stepsize, m=m)
    scale = float(w_alg3.abs().max())
    np.testing.assert_allclose(_np(w_dane), _np(w_alg3), rtol=1e-5,
                               atol=1e-5 * scale)
    assert not torch.equal(w_alg3, w)


def test_appendix_a_rejects_unequal_sizes_and_a_custom_w0():
    Xs, ys, a0 = ridge_data(sizes=(6, 9), d=5, seed=8, alphas=True)
    uneven = build_dense_problem(Xs, ys, 0.1, device="cpu")
    for cls in (PrimalMethod, DualMethod):
        with pytest.raises(ValueError, match="equal n_k"):
            cls(uneven, sigma=2.0, alphas0=a0, device="cpu")
    Xs, ys = ridge_data(sizes=(6, 6), d=5, seed=8)
    even = build_dense_problem(Xs, ys, 0.1, device="cpu")
    for cls in (PrimalMethod, DualMethod):
        with pytest.raises(ValueError, match="w0"):
            cls(even, device="cpu").init(torch.zeros(5, dtype=torch.float64))


def test_registry_layouts_match_the_reference():
    assert available() == ("cocoa", "dane", "dane_ridge", "dual", "fedavg",
                           "fsvrg", "gd", "primal", "svrg_naive")
    for name in available():
        assert get_spec(name).layout == ref_get_spec(name).layout, name
    assert {n for n in available() if get_spec(n).layout == "dense"} == {
        "dane_ridge", "primal", "dual"}
    Xs, ys = ridge_data(sizes=(6, 6), d=5)
    dense = build_dense_problem(Xs, ys, 0.1, device="cpu")
    assert isinstance(make_solver("dane_ridge", dense, device="cpu"),
                      DANERidge)


# --------------------------------------------------------------------- #
# Algorithm 1 and the one-call baselines, on the logreg problem (f32)
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def logreg_pair(tiny_dataset, tiny_problem):
    return tiny_problem, build_problem(dataset_from_arrays(tiny_dataset,
                                                           device="cpu"),
                                       device="cpu")


def _close(got, expect, rtol=1e-5):
    expect = _np(expect)
    scale = float(np.abs(expect).max())
    np.testing.assert_allclose(_np(got), expect, rtol=rtol,
                               atol=rtol * scale)


def test_svrg_epoch_and_run_svrg_match_the_reference(logreg_pair):
    """The samples are randint(fold_in(PRNGKey(seed), s), (m,), 0, n) in
    both; one epoch from a nonzero w, then 2 epochs of run_svrg."""
    rp, pp = logreg_pair
    w0 = 0.1 * np.random.default_rng(1).standard_normal(pp.d).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    got = svrg_epoch(pp.flat, torch.as_tensor(w0), threefry.PRNGKey(5),
                     stepsize=0.1, m=150)
    _close(got, ref_svrg_epoch(rp.flat, jnp.asarray(w0), key, stepsize=0.1,
                               m=150))
    w, hist = run_svrg(pp.flat, torch.zeros(pp.d), epochs=2, stepsize=0.1,
                       m=200, seed=3)
    rw, rhist = ref_run_svrg(rp.flat, jnp.zeros(rp.d), epochs=2,
                             stepsize=0.1, m=200, seed=3)
    _close(w, rw)
    np.testing.assert_allclose(hist, rhist, rtol=1e-5)
    assert hist[1] < hist[0] < float(np.log(2))


def test_run_gd_matches_the_reference(logreg_pair):
    rp, pp = logreg_pair
    w, hist = run_gd(pp, torch.zeros(pp.d), 3, 2.0,
                     callback=lambda w, r: float(pp.flat.loss(w)))
    rw, rhist = ref_run_gd(rp, jnp.zeros(rp.d), 3, 2.0,
                           callback=lambda w, r: float(rp.flat.loss(w)))
    _close(w, rw)
    np.testing.assert_allclose(hist, rhist, rtol=1e-5)


@pytest.mark.parametrize("epochs", [1, 3])
def test_fedavg_round_and_one_shot_match_the_reference(logreg_pair, epochs):
    """fedavg_round, and one_shot_average (the same round with many
    epochs), from the key the Fig. 2 one-shot uses."""
    rp, pp = logreg_pair
    rkey = jax.random.fold_in(jax.random.PRNGKey(0), 10_000)
    key = threefry.fold_in(threefry.PRNGKey(0), 10_000)
    got = (fedavg_round(pp, torch.zeros(pp.d), key, 0.5, epochs=epochs)
           if epochs == 1 else
           one_shot_average(pp, torch.zeros(pp.d), key, 0.5, epochs=epochs))
    _close(got, ref_fedavg_round(rp, jnp.zeros(rp.d), rkey, 0.5,
                                 epochs=epochs))


def test_majority_baseline_error_matches_the_reference(tiny_dataset):
    ds = tiny_dataset
    t = torch.as_tensor
    got = majority_baseline_error(t(np.asarray(ds.y)),
                                  t(np.asarray(ds.client_of)),
                                  t(np.asarray(ds.test_y)),
                                  t(np.asarray(ds.test_client_of)))
    assert got == ref_majority(np.asarray(ds.y), np.asarray(ds.client_of),
                               np.asarray(ds.test_y),
                               np.asarray(ds.test_client_of))
    # a tie votes +1; a client without training rows (2) votes −1
    y = np.array([1, -1, -1, -1, 1], np.float32)
    of = np.array([0, 0, 1, 1, 3])
    ty = np.array([1, 1, -1, -1, 1, -1], np.float32)
    tof = np.array([0, 1, 2, 2, 3, 3])
    expect = ref_majority(y, of, ty, tof)
    assert majority_baseline_error(t(y), t(of), t(ty), t(tof)) == expect
    assert expect == 2 / 6
