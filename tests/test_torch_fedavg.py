"""The port's FedAvg against the reference's.

The port is fed the reference's own permutations, rebuilt as the reference's
round derives them: client k of the bucket whose first client is wi, in
epoch e of round r, walks
``permutation(split(split(fold_in(fold_in(PRNGKey(seed), r), wi), Kb)[k],
E)[e], m_pad)``.

Tolerances (CPU, jax and torch on the same inputs): as for FSVRG, the pass
is not bit-exact — ``torch.sigmoid`` and ``jax.nn.sigmoid`` differ by an ulp
and XLA contracts ``(1 − hλ)w − hg`` into fused multiply-adds — so one
bucket's deltas are held at atol 1e-7 / rtol 1e-5 and three rounds at
rtol 1e-4 (observed errors in each test's docstring).  The reference side
of the rounds is ``make_solver("fedavg")`` under the reference's Trainer,
not the oracle loop of ``tests/_oracles.py``, whose pin
(``test_trainer_pins_fig2_fedavg_loop``) is red in the reference itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core.fedavg import FedAvgConfig as RefFedAvgConfig  # noqa: E402
from repro.core.fedavg import _local_sgd_pass_keyed  # noqa: E402
from repro_torch.bridge import dataset_from_arrays, state_from_array  # noqa: E402
from repro_torch.core import FedAvg, FedAvgConfig, Trainer  # noqa: E402
from repro_torch.core import build_problem, make_solver  # noqa: E402
from repro_torch.core.fedavg import local_sgd_pass_keyed  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

ROUNDS = 3
EPOCHS = 2      # configs/fedavg_gplus.py's E


def reference_permutations(seed, r, wi, num_clients, epochs, m_pad):
    """The (Kb, E, m_pad) permutations the reference's round r gives the
    bucket whose first client is wi."""
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r),
                            wi)
    keys = jax.random.split(kb, num_clients)
    return np.stack([[np.asarray(jax.random.permutation(ek, m_pad))
                      for ek in jax.random.split(keys[k], epochs)]
                     for k in range(num_clients)])


class ReferenceDrawsFedAvg(FedAvg):
    """The port's FedAvg with the reference's permutations (and, when
    given, its participation masks) in place of its own draws."""

    def __init__(self, problem, cfg, seed, masks=None):
        super().__init__(problem, cfg, device="cpu")
        self.seed = seed
        self._first = np.cumsum([0] + [b.num_clients
                                       for b in problem.buckets])
        if masks is not None:
            self.engine.participation_masks = lambda gen, round_index=None: masks

    def round(self, state, gen):
        self._r = state.round
        return super().round(state, gen)

    def permutations(self, gen, bucket_index, bucket):
        return torch.as_tensor(reference_permutations(
            self.seed, self._r, int(self._first[bucket_index]),
            bucket.num_clients, self.cfg.local_epochs, bucket.m_pad))


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def test_one_bucket_local_sgd_pass_matches_reference(small_problem,
                                                     port_problem):
    """The largest bucket (15 clients × 135 slots), E = 2, h = 0.1, from a
    random iterate.  Observed: max abs err 7.2e-7 on deltas up to 1.17
    (6.1e-7 relative)."""
    rp, pp = small_problem, port_problem
    bi = len(rp.buckets) - 1
    rb, pb = rp.buckets[bi], pp.buckets[bi]
    wi = sum(b.num_clients for b in rp.buckets[:bi])
    w = (np.random.default_rng(1).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), wi)
    cfg = RefFedAvgConfig(stepsize=0.1, local_epochs=EPOCHS)
    expect = _local_sgd_pass_keyed(jnp.asarray(w), rb, rp.flat.lam, cfg,
                                   False, jax.random.split(kb,
                                                           rb.num_clients))
    perms = reference_permutations(0, 0, wi, rb.num_clients, EPOCHS,
                                   rb.m_pad)
    out = torch.empty((pb.num_clients, pp.d))
    g = torch.zeros((pb.num_clients + 2, pp.d))
    got = local_sgd_pass_keyed(torch.tensor(w), pb, pp.flat.lam, 0.1,
                               torch.as_tensor(perms), out, g=g)
    assert got is out and pb.m_pad > 100
    assert not g.any()                     # the scratch is left all zeros
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-7)


def test_fedavg_matches_reference_trainer(small_problem, port_problem):
    """The registry's FedAvg (E = 2, h = 0.1) with the kernel aggregator,
    three rounds under each package's Trainer, the reference's draws
    injected.  Held at rtol 1e-4; observed: iterate max abs err 6.0e-8
    (8.5e-8 of max |w| = 0.704), loss history equal."""
    rp, pp = small_problem, port_problem
    loss = lambda prob: (lambda w: {"f": prob.flat.loss(w)})
    ref = RefTrainer(ref_make_solver("fedavg", rp, aggregator="pallas"),
                     rounds=ROUNDS, seed=0, eval_fn=loss(rp)).fit()
    port = make_solver("fedavg", pp, device="cpu", aggregator="pallas")
    solver = ReferenceDrawsFedAvg(pp, port.cfg, seed=0)
    assert solver.cfg.local_epochs == EPOCHS
    got = Trainer(solver, rounds=ROUNDS, seed=0, eval_fn=loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    f_ref = [h["f"] for h in ref.history]
    f_got = [h["f"] for h in got.history]
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-4)
    assert f_got[-1] < f_got[0] < float(pp.flat.loss(torch.zeros(pp.d)))


def test_fedavg_partial_participation_uniform_matches_reference(
        small_problem, port_problem):
    """p = 0.5 with uniform weighting and the dense aggregator, one round
    from a random iterate, the reference's masks and permutations
    injected.  Held at rtol 1e-4."""
    rp, pp = small_problem, port_problem
    w = (np.random.default_rng(3).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    kw = dict(participation=0.5, use_weighted_agg=False, local_epochs=1)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    ref_solver = ref_make_solver("fedavg", rp, **kw)
    expect = np.asarray(ref_solver.round(ref_solver.init(jnp.asarray(w)),
                                         key).w)
    masks = [torch.tensor(np.array(m)) for m in
             ref_solver.engine.participation_masks(key)]
    assert 0 < sum(float(m.sum()) for m in masks) < pp.num_clients
    solver = ReferenceDrawsFedAvg(pp, FedAvgConfig(stepsize=0.1, **kw),
                                  seed=0, masks=masks)
    got = solver.round(state_from_array(w, 0, "cpu"),
                       threefry.fold_in(threefry.PRNGKey(0), 0)).w
    scale = np.abs(expect - w).max()
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4,
                               atol=1e-4 * scale)


def test_fedavg_dense_and_kernel_aggregators_agree(port_problem):
    pp = port_problem
    w = torch.tensor(np.random.default_rng(2).standard_normal(pp.d) * 0.1,
                     dtype=torch.float32)
    outs = [ReferenceDrawsFedAvg(pp, FedAvgConfig(aggregator=agg),
                                 seed=1).round(
        state_from_array(w.numpy(), 0, "cpu"), threefry.PRNGKey(0)).w
        for agg in ("dense", "pallas")]
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-7)


def test_fedavg_own_draws_are_seeded_and_decrease_the_loss(
        port_problem):
    """The port's own permutations: the same seed gives the same run, the
    loss falls, and each client gets one permutation of its m_pad slots
    per epoch."""
    pp = port_problem
    f0 = float(pp.flat.loss(torch.zeros(pp.d)))
    runs = [make_solver("fedavg", pp, device="cpu").fit(
        2, seed=5, eval_fn=lambda w: {"f": pp.flat.loss(w)})
        for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w)
    assert runs[0].history[-1]["f"] < runs[0].history[0]["f"] < f0
    solver = make_solver("fedavg", pp, device="cpu")
    perms = solver.permutations(threefry.PRNGKey(0), 0,
                                pp.buckets[0])
    b = pp.buckets[0]
    assert perms.shape == (b.num_clients, EPOCHS, b.m_pad)
    assert torch.equal(perms.sort(dim=-1).values,
                       torch.arange(b.m_pad).expand_as(perms))
