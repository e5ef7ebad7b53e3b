"""The port's CoCoA+ against the reference's.

The port is fed the reference's own permutations of each client's dual
coordinates, rebuilt as the reference's round derives them:
``permutation(split(fold_in(fold_in(PRNGKey(seed), r), wi), Kb)[k], m_pad)``
for round r, the bucket's first client wi and its client k; under partial
participation it is also fed the reference's masks.

Tolerances (CPU): the Newton solve takes ``log`` and ``sigmoid``, which
differ by an ulp between torch and XLA, and XLA contracts the coefficient
arithmetic into fused multiply-adds, so one pass is held at atol 1e-6 /
rtol 1e-5 and three rounds at rtol 1e-4 (observed errors in each test's
docstring).  Frozen dual blocks are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core.cocoa import _sdca_local_pass_keyed  # noqa: E402
from repro.core.problem import ClientBucket as RefBucket  # noqa: E402
from repro_torch.bridge import dataset_from_arrays, state_from_array  # noqa: E402
from repro_torch.core import CoCoAPlus, CoCoAConfig, Trainer  # noqa: E402
from repro_torch.core import build_problem, make_solver  # noqa: E402
from repro_torch.core.cocoa import sdca_local_pass_keyed  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

ROUNDS = 3


def reference_permutations(seed, r, wi, num_clients, m_pad):
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r),
                            wi)
    keys = jax.random.split(kb, num_clients)
    return np.stack([np.asarray(jax.random.permutation(keys[k], m_pad))
                     for k in range(num_clients)])


class ReferenceDrawsCoCoA(CoCoAPlus):
    """The port's CoCoA+ with the reference's permutations and, given a
    reference engine, the reference's participation masks of each round."""

    def __init__(self, problem, cfg, seed, ref_engine=None):
        super().__init__(problem, cfg=cfg, device="cpu")
        self.seed = seed
        self._first = np.cumsum([0] + [b.num_clients
                                       for b in problem.buckets])
        self.masks = []
        if ref_engine is not None:
            def masks(gen, round_index=None):
                key = jax.random.fold_in(jax.random.PRNGKey(seed), self._r)
                m = [torch.tensor(np.asarray(x))
                     for x in ref_engine.participation_masks(key)]
                self.masks.append(m)
                return m
            self.engine.participation_masks = masks

    def round(self, state, gen):
        self._r = state.round
        return super().round(state, gen)

    def permutations(self, gen, bucket_index, bucket):
        return torch.as_tensor(reference_permutations(
            self.seed, self._r, int(self._first[bucket_index]),
            bucket.num_clients, bucket.m_pad))


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def test_one_bucket_sdca_pass_matches_reference(small_problem, port_problem):
    """The largest bucket (15 clients × 135 coordinates), σ′ = K, from a
    random iterate and random dual block.  Held at atol 1e-6 / rtol 1e-5;
    observed: u 6.0e-8 abs (of up to 0.015), r 1.2e-7 abs (of up to
    0.039)."""
    rp, pp = small_problem, port_problem
    bi = len(rp.buckets) - 1
    rb, pb = rp.buckets[bi], pp.buckets[bi]
    wi = sum(b.num_clients for b in rp.buckets[:bi])
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(rp.d) * 0.1).astype(np.float32)
    alpha = (np.asarray(rb.y) * rng.uniform(0.05, 0.95, rb.y.shape)).astype(
        np.float32)
    lam, n, sigma = rp.flat.lam, rp.flat.n, float(rp.num_clients)
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), wi)
    u_ref, r_ref = _sdca_local_pass_keyed(
        jnp.asarray(w), jnp.asarray(alpha), rb, lam, n, sigma, False,
        jax.random.split(kb, rb.num_clients))
    perms = reference_permutations(0, 0, wi, rb.num_clients, rb.m_pad)
    r = torch.full((pb.num_clients, pp.d), float("nan"))
    u = sdca_local_pass_keyed(torch.tensor(w), torch.tensor(alpha), pb, lam,
                              n, sigma, torch.as_tensor(perms), r)
    assert pb.m_pad > 100
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5,
                               atol=1e-6)
    # padded coordinates never move
    pad = torch.arange(pb.m_pad)[None, :] >= pb.n_k[:, None]
    assert not u[pad].any()


def _bucket_with_repeats(rng, Kb, m_pad, nnz, d):
    """A bucket whose rows repeat features — entry 1 of every row is entry
    0's feature, and every third row holds one feature four more times —
    and whose clients after the first have n_k < m_pad where m_pad > 1
    (padded slots: idx 0, val 0, y 1, as ``build_problem`` pads)."""
    n_k = rng.integers(1, m_pad + 1, Kb)
    n_k[0] = m_pad
    idx = rng.integers(0, d, (Kb, m_pad, nnz))
    if nnz > 1:
        idx[:, :, 1] = idx[:, :, 0]
    if nnz > 5:
        idx[:, ::3, 1:5] = idx[:, ::3, 5:6]
    val = rng.uniform(0.05, 1.0, (Kb, m_pad, nnz)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (Kb, m_pad)).astype(np.float32)
    pad = np.arange(m_pad)[None, :] >= n_k[:, None]
    idx[pad], val[pad], y[pad] = 0, 0.0, 1.0
    return idx.astype(np.int64), val, y, n_k.astype(np.int64)


@pytest.mark.parametrize("Kb,m_pad,nnz,d", [(1, 1, 3, 5), (4, 9, 7, 50),
                                            (6, 33, 62, 400)])
def test_plain_pass_matches_reference_with_repeats(Kb, m_pad, nnz, d):
    """``ref.cocoa_sdca_pass_ref`` (what ``ops.cocoa_sdca_pass`` runs on the
    CPU) against the reference's ``_sdca_local_pass_keyed`` with the plain
    Newton (``use_kernel=False``) and the reference's permutations, on a
    bucket with repeated features in a row and padded slots: u and r at
    atol 1e-7 / rtol 1e-5; padded coordinates never move."""
    rng = np.random.default_rng(Kb * 1000 + m_pad)
    idx, val, y, n_k = _bucket_with_repeats(rng, Kb, m_pad, nnz, d)
    w = (rng.standard_normal(d) * 0.3).astype(np.float32)
    alpha = (y * rng.uniform(0.05, 0.95, y.shape)).astype(np.float32)
    n = int(n_k.sum())
    lam, sigma = 1.0 / n, float(Kb)
    keys = jax.random.split(jax.random.PRNGKey(Kb + m_pad), Kb)
    u_ref, r_ref = _sdca_local_pass_keyed(
        jnp.asarray(w), jnp.asarray(alpha),
        RefBucket(jnp.asarray(idx, jnp.int32), jnp.asarray(val),
                  jnp.asarray(y), jnp.asarray(n_k, jnp.int32)),
        lam, n, sigma, False, keys)
    perms = torch.as_tensor(np.stack(
        [np.asarray(jax.random.permutation(keys[k], m_pad))
         for k in range(Kb)]).astype(np.int64))
    T = torch.as_tensor
    r = torch.full((Kb, d), float("nan"))
    u = ref.cocoa_sdca_pass_ref(T(w), T(alpha), T(idx), T(val), T(y),
                                T(n_k), perms, sigma, lam, n, r)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5,
                               atol=1e-7)
    assert not u[torch.as_tensor(np.arange(m_pad)[None, :]
                                 >= n_k[:, None])].any()
    r2 = torch.empty_like(r)
    assert torch.equal(ops.cocoa_sdca_pass(T(w), T(alpha), T(idx), T(val),
                                           T(y), T(n_k), perms, sigma, lam,
                                           n, r2), u)
    assert torch.equal(r2, r)


def _dual_blocks_to_primal(pp, alphas):
    """(1/λn) Σ_k X_k α_k over every bucket."""
    w = torch.zeros(pp.d, dtype=torch.float64)
    for b, a in zip(pp.buckets, alphas):
        w.index_add_(0, b.idx.reshape(-1),
                     (b.val.double() * a.double()[..., None]).reshape(-1))
    return w / (pp.flat.lam * pp.flat.n)


def test_cocoa_matches_reference_trainer(small_problem, port_problem):
    """The registry's CoCoA+ (σ′ = K) with the kernel aggregator, three
    rounds under each package's Trainer, the reference's permutations
    injected: w and every α block held at rtol 1e-4, and the primal–dual
    invariant w = (1/λn) Σ_k X_k α_k holds on the port's state (rtol 1e-5).
    Observed: w 1.2e-7 abs (8.3e-8 of max |w| = 1.43), α 1.5e-8 abs,
    loss 9.7e-8 relative, invariant 1.0e-7 of max |w|."""
    rp, pp = small_problem, port_problem
    loss = lambda prob: (lambda w: {"f": prob.flat.loss(w)})
    ref = RefTrainer(ref_make_solver("cocoa", rp, aggregator="pallas"),
                     rounds=ROUNDS, seed=0, eval_fn=loss(rp)).fit()
    solver = ReferenceDrawsCoCoA(pp, CoCoAConfig(aggregator="pallas"), seed=0)
    assert solver.sigma == float(pp.num_clients)
    got = Trainer(solver, rounds=ROUNDS, seed=0, eval_fn=loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    assert len(got.state.aux) == len(ref.state.aux) == len(pp.buckets)
    for a, a_ref in zip(got.state.aux, ref.state.aux):
        a_ref = np.asarray(a_ref)
        np.testing.assert_allclose(a.numpy(), a_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(a_ref).max())
    f_got = [h["f"] for h in got.history]
    np.testing.assert_allclose(f_got, [h["f"] for h in ref.history],
                               rtol=1e-4)
    assert f_got[-1] < f_got[0] < float(pp.flat.loss(torch.zeros(pp.d)))
    w_dual = _dual_blocks_to_primal(pp, got.state.aux)
    torch.testing.assert_close(got.w.double(), w_dual, rtol=1e-5,
                               atol=1e-5 * float(w_dual.abs().max()))


def test_cocoa_partial_participation_freezes_dual_blocks(small_problem,
                                                         port_problem):
    """p = 0.5, three rounds, the reference's masks and permutations
    injected: each round leaves the α of every client its mask left out bit
    for bit as it was, and w and α agree with the reference (rtol 1e-4)."""
    rp, pp = small_problem, port_problem
    ref_solver = ref_make_solver("cocoa", rp, participation=0.5)
    ref = RefTrainer(ref_solver, rounds=ROUNDS, seed=0).fit()
    solver = ReferenceDrawsCoCoA(pp, CoCoAConfig(participation=0.5), seed=0,
                                 ref_engine=ref_solver.engine)
    states = [solver.init()]
    Trainer(solver, rounds=ROUNDS, seed=0,
            callback=lambda s, r: states.append(s)).fit()
    frozen = 0
    for r, masks in enumerate(solver.masks):
        for old, new, m in zip(states[r].aux, states[r + 1].aux, masks):
            out = m == 0
            assert torch.equal(new[out], old[out])
            frozen += int(out.sum())
    assert 0 < frozen < ROUNDS * pp.num_clients
    got = states[-1]
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    for a, a_ref in zip(got.aux, ref.state.aux):
        a_ref = np.asarray(a_ref)
        np.testing.assert_allclose(a.numpy(), a_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(a_ref).max())
    # the sum weighting keeps w = (1/λn) X α under partial participation too
    w_dual = _dual_blocks_to_primal(pp, got.aux)
    torch.testing.assert_close(got.w.double(), w_dual, rtol=1e-5,
                               atol=1e-5 * float(w_dual.abs().max()))


def test_cocoa_resumes_from_a_reference_state(small_problem, port_problem):
    """A reference SolverState (w and the α blocks) carried across by the
    bridge: one more round from it agrees with the reference's."""
    rp, pp = small_problem, port_problem
    ref_solver = ref_make_solver("cocoa", rp)
    mid = RefTrainer(ref_solver, rounds=1, seed=0).fit().state
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    expect = ref_solver.round(mid, key)
    state = state_from_array(np.asarray(mid.w), 1, "cpu",
                             aux=[np.asarray(a) for a in mid.aux])
    got = ReferenceDrawsCoCoA(pp, CoCoAConfig(), seed=0).round(
        state, threefry.fold_in(threefry.PRNGKey(0), 1))
    assert got.round == 2
    w_ref = np.asarray(expect.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())


def test_cocoa_init_and_registry_defaults(port_problem):
    pp = port_problem
    solver = make_solver("cocoa", pp, device="cpu")
    assert solver.sigma == float(pp.num_clients)
    assert make_solver("cocoa", pp, device="cpu", sigma=3.0).sigma == 3.0
    state = solver.init(torch.zeros(pp.d))
    assert [tuple(a.shape) for a in state.aux] == [
        (b.num_clients, b.m_pad) for b in pp.buckets]
    assert not state.w.any() and not any(a.any() for a in state.aux)
    with pytest.raises(ValueError, match="alpha=0"):
        solver.init(torch.ones(pp.d))


def test_cocoa_primal_loss_rises_after_round_one_at_k100():
    """CoCoA+ ascends the dual; with the safe σ′ = K its primal loss is not
    monotone once K reaches the hundreds.  At scale 0.01 (K = 100) both
    packages, on the same data and draws, lower the loss in round 1 and
    raise it in rounds 2 and 3 — so a full-width run is held to its first
    round's fall and to the primal–dual invariant, not to a falling loss.
    w held at rtol 1e-4 of max |w|."""
    from repro.configs import get_logreg_config
    from repro.core import build_problem as ref_build_problem
    from repro.data.synthetic import generate
    ds = generate(get_logreg_config().scaled(0.01), seed=0)
    rp = ref_build_problem(ds)
    pp = build_problem(dataset_from_arrays(ds, device="cpu"), device="cpu")
    assert pp.num_clients == 100
    loss = lambda prob: (lambda w: {"f": prob.flat.loss(w)})
    ref = RefTrainer(ref_make_solver("cocoa", rp), rounds=ROUNDS, seed=0,
                     eval_fn=loss(rp)).fit()
    got = Trainer(ReferenceDrawsCoCoA(pp, CoCoAConfig(), seed=0),
                  rounds=ROUNDS, seed=0, eval_fn=loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    f0 = float(np.log(2.0))
    for hist in (ref.history, got.history):
        f = [h["f"] for h in hist]
        assert f[0] < f0 and f[0] < f[1] < f[2]
