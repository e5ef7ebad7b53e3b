"""The port's FSVRG and GD against the reference's.

These tests hold the pass apart from the draws: the port is fed the
reference's own per-client permutations, rebuilt here exactly as the
reference's round derives them (``test_torch_own_seed_*`` hold the port's
own draws):
``permutation(split(fold_in(fold_in(PRNGKey(seed), r), wi), Kb)[k], m_pad)``
for round r, the bucket's first client wi and its client k.

Tolerances (CPU, jax and torch on the same inputs): the client pass is not
bit-exact — ``torch.sigmoid`` and ``jax.nn.sigmoid`` differ by an ulp, and
XLA contracts ``w − h(s·d + g)`` into fused multiply-adds and sums the 62
row products in another order than torch — so one bucket's deltas agree to
atol 1e-7 / rtol 1e-5 (observed 2.2e-8 abs on deltas up to 0.046), and
three rounds to rtol 1e-4 (observed below in each test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core import scaling as ref_scaling  # noqa: E402
from repro.core.fsvrg import FSVRGConfig as RefFSVRGConfig  # noqa: E402
from repro.core.fsvrg import _client_pass_keyed  # noqa: E402
from repro_torch.bridge import dataset_from_arrays, state_from_array  # noqa: E402
from repro_torch.core import FSVRG, FSVRGConfig, Trainer  # noqa: E402
from repro_torch.core import build_problem, make_solver, scaling  # noqa: E402
from repro_torch.core.baselines import gd_round  # noqa: E402
from repro_torch.core.fsvrg import client_pass_keyed  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

ROUNDS = 3


def reference_permutations(seed, r, wi, num_clients, m_pad):
    """The (Kb, m_pad) permutations the reference's round r gives the
    bucket whose first client is wi."""
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r),
                            wi)
    keys = jax.random.split(kb, num_clients)
    return np.stack([np.asarray(jax.random.permutation(keys[k], m_pad))
                     for k in range(num_clients)])


class ReferenceDrawsFSVRG(FSVRG):
    """The port's FSVRG with the reference's permutations in place of its
    own draws (everything else is the port's)."""

    def __init__(self, problem, cfg, seed):
        super().__init__(problem, cfg, device="cpu")
        self.seed = seed
        self._r = 0
        self._first = np.cumsum([0] + [b.num_clients
                                       for b in problem.buckets])

    def round(self, state, gen):
        self._r = state.round
        return super().round(state, gen)

    def permutations(self, gen, bucket_index, bucket):
        return torch.as_tensor(reference_permutations(
            self.seed, self._r, int(self._first[bucket_index]),
            bucket.num_clients, bucket.m_pad), dtype=torch.int64)


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def test_one_bucket_client_pass_matches_reference(small_problem,
                                                  port_problem):
    rp, pp = small_problem, port_problem
    bi = len(rp.buckets) - 1                   # the largest bucket
    rb, pb = rp.buckets[bi], pp.buckets[bi]
    wi = sum(b.num_clients for b in rp.buckets[:bi])
    w = (np.random.default_rng(1).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    w0 = jnp.asarray(w)
    full_grad = rp.flat.grad(w0)
    rphi = ref_scaling.global_feature_counts(rp.flat) / rp.flat.n
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), wi)
    keys = jax.random.split(kb, rb.num_clients)
    expect = _client_pass_keyed(w0, full_grad, rb, rp.flat.lam, rphi,
                                RefFSVRGConfig(stepsize=1.0), keys)

    perms = reference_permutations(0, 0, wi, rb.num_clients, rb.m_pad)
    phi = scaling.global_feature_counts(pp.flat) / pp.flat.n
    s_diag = scaling.s_k_diag(phi, pb.idx, pb.val, pb.n_k)
    h_k = torch.ones(pb.num_clients) / pb.n_k.float().clamp(min=1.0)
    out = torch.empty((pb.num_clients, pp.d))
    got = client_pass_keyed(torch.tensor(w), torch.tensor(np.asarray(
        full_grad)), pb, pp.flat.lam, s_diag, h_k, torch.as_tensor(perms),
        out)
    assert got is out and pb.m_pad > 100
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-7)


def test_fsvrg_slice_matches_reference_trainer(small_problem, port_problem):
    """FSVRG with the kernel aggregator, three rounds under each package's
    Trainer, the reference's draws injected into the port.  Held at rtol
    1e-4; observed: iterate max abs err 3.0e-8 (1.3e-7 of max |w| = 0.233),
    loss history max rel err 8.9e-8."""
    rp, pp = small_problem, port_problem
    loss = lambda prob: (lambda w: {"f": prob.flat.loss(w)})
    ref = RefTrainer(ref_make_solver("fsvrg", rp, aggregator="pallas"),
                     rounds=ROUNDS, seed=0, eval_fn=loss(rp)).fit()
    solver = ReferenceDrawsFSVRG(pp, FSVRGConfig(aggregator="pallas"), seed=0)
    got = Trainer(solver, rounds=ROUNDS, seed=0, eval_fn=loss(pp)).fit()
    assert got.state.round == ROUNDS
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    f_ref = [h["f"] for h in ref.history]
    f_got = [h["f"] for h in got.history]
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-4)
    assert f_got[-1] < f_got[0] < float(pp.flat.loss(torch.zeros(pp.d)))


def test_fsvrg_dense_and_kernel_aggregators_agree(port_problem):
    """One round from the same iterate with the same draws: the plain
    weighted sum and the fused aggregation agree to float tolerance."""
    pp = port_problem
    w = torch.tensor(np.random.default_rng(2).standard_normal(pp.d) * 0.1,
                     dtype=torch.float32)
    outs = []
    for aggregator in ("dense", "pallas"):
        solver = ReferenceDrawsFSVRG(pp, FSVRGConfig(aggregator=aggregator),
                                     seed=1)
        outs.append(solver.round(state_from_array(w.numpy(), 0, "cpu"),
                                 threefry.PRNGKey(0)).w)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-7)


def test_fsvrg_own_draws_are_seeded_and_decrease_the_loss(port_problem):
    pp = port_problem
    f0 = float(pp.flat.loss(torch.zeros(pp.d)))
    runs = [make_solver("fsvrg", pp, device="cpu").fit(
        2, seed=5, eval_fn=lambda w: {"f": pp.flat.loss(w)})
        for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w)
    assert runs[0].history[-1]["f"] < runs[0].history[0]["f"] < f0


def test_gd_matches_reference_trainer(small_problem, port_problem):
    """GD is deterministic: no draws to inject.  Held at rtol 1e-5;
    observed: iterate max abs err 1.5e-7 (5.3e-7 of max |w| = 0.281), loss
    history max rel err 1.6e-7."""
    rp, pp = small_problem, port_problem
    ref = RefTrainer(ref_make_solver("gd", rp), rounds=ROUNDS, seed=0,
                     eval_fn=lambda w: {"f": rp.flat.loss(w)}).fit()
    solver = make_solver("gd", pp, device="cpu")
    got = Trainer(solver, rounds=ROUNDS, seed=0,
                  eval_fn=lambda w: {"f": pp.flat.loss(w)}).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(w_ref).max())
    np.testing.assert_allclose([h["f"] for h in got.history],
                               [h["f"] for h in ref.history], rtol=1e-5)
    # the engine's per-client GD is the flat gradient step
    w = torch.zeros(pp.d)
    for _ in range(ROUNDS):
        w = gd_round(pp, w, solver.stepsize)
    torch.testing.assert_close(got.w, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(use_S=False, use_local_stepsize=False),
    dict(use_A=False, use_weighted_agg=False, participation=0.5),
], ids=["no_S-no_local_stepsize", "no_A-uniform_agg-p0.5"])
def test_fsvrg_options_match_reference_for_one_round(small_problem,
                                                     port_problem, kw):
    """The ablation switches of §3.6.2 and partial participation, one round
    from a random iterate with the reference's permutations and (for
    participation) its masks injected.  Held at rtol 1e-4."""
    rp, pp = small_problem, port_problem
    w = (np.random.default_rng(3).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    ref_solver = ref_make_solver("fsvrg", rp, **kw)
    expect = np.asarray(ref_solver.round(ref_solver.init(jnp.asarray(w)),
                                         key).w)
    solver = ReferenceDrawsFSVRG(pp, FSVRGConfig(**kw), seed=0)
    if "participation" in kw:
        masks = [torch.tensor(np.array(m)) for m in
                 ref_solver.engine.participation_masks(key)]
        assert 0 < sum(float(m.sum()) for m in masks) < pp.num_clients
        solver.engine.participation_masks = lambda gen, round_index=None: masks
    got = solver.round(state_from_array(w, 0, "cpu"),
                       threefry.fold_in(threefry.PRNGKey(0), 0)).w
    scale = np.abs(expect - w).max()
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4,
                               atol=1e-4 * scale)


def test_registry_names():
    """The reference's nine names: the solvers of Fig. 2 and the dense
    ridge ones."""
    from repro.core import available as ref_available
    from repro_torch.core import available
    assert available() == ("cocoa", "dane", "dane_ridge", "dual", "fedavg",
                           "fsvrg", "gd", "primal", "svrg_naive")
    assert available() == ref_available()
    with pytest.raises(KeyError, match="unknown solver"):
        make_solver("no_such_solver", None)


def test_trainer_eval_every_and_fail_fast(port_problem):
    from repro_torch.core import NonFiniteIterateError
    pp = port_problem
    loss = lambda w: {"f": pp.flat.loss(w)}
    res = Trainer(make_solver("gd", pp, device="cpu"), rounds=5,
                  eval_fn=loss, eval_every=2).fit()
    assert len(res.history) == 3            # rounds 2, 4 and the last
    assert res.state.round == 5
    diverging = make_solver("gd", pp, device="cpu", stepsize=float("inf"))
    with pytest.raises(NonFiniteIterateError) as err:
        Trainer(diverging, rounds=3).fit()
    assert err.value.round_index == 0 and err.value.solver_name == "gd"
    res = Trainer(diverging, rounds=2, fail_fast=False).fit()
    assert not bool(torch.isfinite(res.w).all())
    with pytest.raises(ValueError, match="eval_every"):
        Trainer(diverging, rounds=2, eval_every=0)
