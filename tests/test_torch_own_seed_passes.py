"""The port's round engine and client passes drawing from their own keys,
against the reference's with the same keys.

Nothing is injected: the port's pass for the bucket whose first client is
wi, in round r of seed 0, gets ``kb = fold_in(fold_in(PRNGKey(0), r), wi)``
from ``repro_torch.utils.threefry`` and draws its clients' permutations or
samples itself; the reference's keyed pass gets ``split(kb, Kb)`` from
``jax.random``.  The draws are bit-equal, so what is left is ROADMAP C1's
arithmetic: ``torch.sigmoid`` against ``jax.nn.sigmoid`` and XLA's fused
multiply-adds and row-sum order.  Tolerances (observed in each test's
docstring): FSVRG and the naive Algorithm 3 atol 1e-7 / rtol 1e-5, FedAvg
(E = 2), CoCoA+ and DANE-SVRG atol 1e-6 / rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scaling as ref_scaling  # noqa: E402
from repro.core.cocoa import _sdca_local_pass_keyed  # noqa: E402
from repro.core.dane import DANEConfig as RefDANEConfig  # noqa: E402
from repro.core.dane import _dane_svrg_pass_keyed  # noqa: E402
from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.core.fedavg import FedAvgConfig as RefFedAvgConfig  # noqa: E402
from repro.core.fedavg import _local_sgd_pass_keyed  # noqa: E402
from repro.core.fsvrg import FSVRGConfig as RefFSVRGConfig  # noqa: E402
from repro.core.fsvrg import _client_pass_keyed  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import build_problem, make_solver  # noqa: E402
from repro_torch.core.cocoa import sdca_local_pass_keyed  # noqa: E402
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

ROUND = 1


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def _firsts(problem):
    return np.cumsum([0] + [b.num_clients for b in problem.buckets])[:-1]


def _keys(r, wi):
    """The bucket's key in both packages: (jax key, port key)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), r),
                             int(wi))
    pk = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), r), int(wi))
    return key, pk


def _iterate(d, seed=1):
    return (np.random.default_rng(seed).standard_normal(d) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("participation", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("r", [0, 3])
def test_engine_masks_equal_the_references(small_problem, port_problem,
                                           participation, r):
    """The Bernoulli masks of round r: ``uniform(fold_in(fold_in(key, wi),
    997), (Kb,)) < p`` per bucket, bit for bit, also through the
    BernoulliParticipation model."""
    from repro_torch.fleet import BernoulliParticipation
    key = jax.random.fold_in(jax.random.PRNGKey(0), r)
    pk = threefry.fold_in(threefry.PRNGKey(0), r)
    ref = RefRoundEngine(small_problem,
                         RefEngineConfig(participation=participation))
    expect = [np.asarray(m) for m in ref.participation_masks(key)]
    for eng in (RoundEngine(port_problem,
                            EngineConfig(participation=participation)),
                RoundEngine(port_problem, EngineConfig(),
                            participation_model=BernoulliParticipation(
                                participation))):
        got = eng.participation_masks(pk, r)
        assert len(got) == len(expect)
        for x, y in zip(got, expect):
            np.testing.assert_array_equal(x.numpy(), y)
    assert 0 < sum(m.sum() for m in expect) < port_problem.num_clients


def test_engine_client_keys_are_jax_split(small_problem, port_problem):
    eng = RoundEngine(port_problem, EngineConfig())
    ref = RefRoundEngine(small_problem, RefEngineConfig())
    for wi, b in zip(_firsts(port_problem), port_problem.buckets):
        key, pk = _keys(ROUND, wi)
        expect = np.asarray(ref.client_keys(key, b.num_clients))
        got = eng.client_keys(pk, b.num_clients)
        np.testing.assert_array_equal(
            np.stack([got[0].numpy(), got[1].numpy()], -1),
            expect.astype(np.int64))


def test_engine_round_hands_each_bucket_its_key(port_problem):
    """Bucket wi's pass receives fold_in(key, wi), on the engine's
    device."""
    eng = RoundEngine(port_problem, EngineConfig())
    seen = []

    def pass_(w, bi, b, kb, out):
        seen.append((int(kb[0]), int(kb[1])))
        out.zero_()

    pk = threefry.fold_in(threefry.PRNGKey(0), 5)
    eng.round(torch.zeros(port_problem.d), pk, pass_)
    assert seen == [tuple(int(x) for x in threefry.fold_in(pk, int(wi)))
                    for wi in _firsts(port_problem)]


@pytest.mark.parametrize("naive", [False, True], ids=["fsvrg", "svrg_naive"])
def test_fsvrg_passes_from_own_keys(small_problem, port_problem, naive):
    """Every bucket of round 1: Algorithm 4's permutations and Algorithm 3's
    50 samples with replacement (randint to n_k), S = I and h fixed.  Held
    at atol 1e-7 / rtol 1e-5; observed ≤ 3.0e-8 abs (FSVRG) and ≤ 1.5e-8
    (naive, h = 0.01)."""
    rp, pp = small_problem, port_problem
    w = _iterate(rp.d)
    full_grad = rp.flat.grad(jnp.asarray(w))
    rphi = ref_scaling.global_feature_counts(rp.flat) / rp.flat.n
    if naive:
        ref_cfg = RefFSVRGConfig(stepsize=0.01, naive=True, naive_steps=50)
        solver = make_solver("svrg_naive", pp, device="cpu")
        assert solver.name == "svrg_naive"
    else:
        ref_cfg = RefFSVRGConfig(stepsize=1.0)
        solver = make_solver("fsvrg", pp, device="cpu", stepsize=1.0)
    fg = torch.tensor(np.asarray(full_grad))
    for bi, (wi, rb, pb) in enumerate(zip(_firsts(pp), rp.buckets,
                                          pp.buckets)):
        key, pk = _keys(ROUND, wi)
        expect = _client_pass_keyed(jnp.asarray(w), full_grad, rb,
                                    rp.flat.lam, rphi, ref_cfg,
                                    jax.random.split(key, rb.num_clients))
        out = torch.empty((pb.num_clients, pp.d))
        solver._pass(torch.tensor(w), bi, pb, pk, out, fg)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-7)


def test_fedavg_pass_from_own_keys(small_problem, port_problem):
    """E = 2 epochs, each over permutation(split(ck, 2)[e], m_pad).  Held at
    atol 1e-6 / rtol 1e-5; observed ≤ 4.8e-7 abs."""
    rp, pp = small_problem, port_problem
    w = _iterate(rp.d, 2)
    ref_cfg = RefFedAvgConfig(stepsize=0.1, local_epochs=2)
    solver = make_solver("fedavg", pp, device="cpu", stepsize=0.1,
                         local_epochs=2)
    for bi, (wi, rb, pb) in enumerate(zip(_firsts(pp), rp.buckets,
                                          pp.buckets)):
        key, pk = _keys(ROUND, wi)
        expect = _local_sgd_pass_keyed(jnp.asarray(w), rb, rp.flat.lam,
                                       ref_cfg, False,
                                       jax.random.split(key, rb.num_clients))
        out = torch.empty((pb.num_clients, pp.d))
        solver._pass(torch.tensor(w), bi, pb, pk, out)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-6)


def test_cocoa_pass_from_own_keys(small_problem, port_problem):
    """σ′ = K from a random iterate and dual blocks, each client's
    coordinates in permutation(split(kb, Kb)[k], m_pad).  Held at atol
    1e-6 / rtol 1e-5 for u and r; observed ≤ 1.6e-7 abs."""
    rp, pp = small_problem, port_problem
    rng = np.random.default_rng(4)
    w = _iterate(rp.d, 3)
    lam, n, sigma = rp.flat.lam, rp.flat.n, float(rp.num_clients)
    solver = make_solver("cocoa", pp, device="cpu")
    for bi, (wi, rb, pb) in enumerate(zip(_firsts(pp), rp.buckets,
                                          pp.buckets)):
        key, pk = _keys(ROUND, wi)
        alpha = (np.asarray(rb.y) * rng.uniform(0.05, 0.95, rb.y.shape)
                 ).astype(np.float32)
        u_ref, r_ref = _sdca_local_pass_keyed(
            jnp.asarray(w), jnp.asarray(alpha), rb, lam, n, sigma, False,
            jax.random.split(key, rb.num_clients))
        r = torch.empty((pb.num_clients, pp.d))
        u = sdca_local_pass_keyed(torch.tensor(w), torch.tensor(alpha), pb,
                                  lam, n, sigma,
                                  solver.permutations(pk, bi, pb), r)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5,
                                   atol=1e-6)


def test_dane_svrg_pass_from_own_keys(small_problem, port_problem):
    """Proposition 1's SVRG epoch over 25 samples a client from
    randint(split(kb, Kb)[k], (25,), 0, max(n_k, 1)).  Held at atol 1e-6 /
    rtol 1e-5; observed ≤ 6.0e-8 abs."""
    rp, pp = small_problem, port_problem
    w = _iterate(rp.d, 5)
    full_grad = rp.flat.grad(jnp.asarray(w))
    ref_cfg = RefDANEConfig(local_solver="svrg")
    solver = make_solver("dane", pp, device="cpu", local_solver="svrg")
    assert solver.cfg.svrg_steps == ref_cfg.svrg_steps
    fg = torch.tensor(np.asarray(full_grad))
    for bi, (wi, rb, pb) in enumerate(zip(_firsts(pp), rp.buckets,
                                          pp.buckets)):
        key, pk = _keys(ROUND, wi)
        samples = solver.samples(pk, bi, pb)
        assert bool((samples < pb.n_k.clamp(min=1)[:, None]).all())
        expect = _dane_svrg_pass_keyed(jnp.asarray(w), full_grad, rb,
                                       rp.flat.lam, ref_cfg,
                                       jax.random.split(key, rb.num_clients))
        out = torch.empty((pb.num_clients, pp.d))
        solver._pass(torch.tensor(w), bi, pb, pk, out, fg)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-6)
