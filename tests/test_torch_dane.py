"""The port's DANE against the reference's.

The GD local solver draws nothing, so the two packages run the same rounds
from the same data.  The Proposition-1 SVRG solver is fed the reference's
own sample indices, rebuilt as the reference's round derives them: client k
of the bucket whose first client is wi, in round r, samples
``randint(split(fold_in(fold_in(PRNGKey(seed), r), wi), Kb)[k], (m,), 0,
max(n_k, 1))``.

Tolerances (CPU): the sigmoid ulp and XLA's fused multiply-adds, as for
FSVRG (see ``test_torch_fsvrg.py``); iterates are held at rtol 1e-4 of
max |w| (observed errors in each test's docstring).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core.dane import DANEConfig as RefDANEConfig  # noqa: E402
from repro.core.dane import _dane_gd_pass  # noqa: E402
from repro_torch.bridge import dataset_from_arrays, state_from_array  # noqa: E402
from repro_torch.core import DANE, DANEConfig, Trainer  # noqa: E402
from repro_torch.core import build_problem, make_solver  # noqa: E402
from repro_torch.core.dane import dane_gd_pass  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

ROUNDS = 3


def reference_samples(seed, r, wi, bucket, m):
    kb = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r),
                            wi)
    keys = jax.random.split(kb, bucket.num_clients)
    return np.stack([np.asarray(jax.random.randint(
        keys[k], (m,), 0, jnp.maximum(bucket.n_k[k], 1)))
        for k in range(bucket.num_clients)])


class ReferenceDrawsDANE(DANE):
    """The port's DANE with the reference's SVRG sample indices."""

    def __init__(self, problem, cfg, seed, ref_problem):
        super().__init__(problem, cfg, device="cpu")
        self.seed = seed
        self._ref_buckets = ref_problem.buckets
        self._first = np.cumsum([0] + [b.num_clients
                                       for b in problem.buckets])

    def round(self, state, gen):
        self._r = state.round
        return super().round(state, gen)

    def samples(self, gen, bucket_index, bucket):
        return torch.as_tensor(reference_samples(
            self.seed, self._r, int(self._first[bucket_index]),
            self._ref_buckets[bucket_index], self.cfg.svrg_steps),
            dtype=torch.int64)


@pytest.fixture(scope="module")
def port_problem(small_dataset):
    return build_problem(dataset_from_arrays(small_dataset, device="cpu"),
                         device="cpu")


def _loss(prob):
    return lambda w: {"f": prob.flat.loss(w)}


def test_one_bucket_gd_pass_matches_reference(small_problem, port_problem):
    """The largest bucket, the registry's defaults (25 steps, lr 0.3,
    µ = 3, η = 1), from a random iterate.  Held at atol 1e-7 / rtol 1e-5;
    observed: 3.0e-8 abs on deltas up to 0.029."""
    rp, pp = small_problem, port_problem
    bi = len(rp.buckets) - 1
    w = (np.random.default_rng(1).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    cfg = dict(eta=1.0, mu=3.0, local_steps=25, local_lr=0.3)
    fg = rp.flat.grad(jnp.asarray(w))
    expect = _dane_gd_pass(jnp.asarray(w), fg, rp.buckets[bi], rp.flat.lam,
                           RefDANEConfig(**cfg), False, None)
    pb = pp.buckets[bi]
    out = torch.empty((pb.num_clients, pp.d))
    got = dane_gd_pass(torch.tensor(w), torch.tensor(np.asarray(fg)), pb,
                       pp.flat.lam, DANEConfig(**cfg), out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-7)


def test_dane_gd_matches_reference_trainer(small_problem, port_problem):
    """The registry's DANE (GD solver) with the kernel aggregator, three
    rounds under each package's Trainer.  Held at rtol 1e-4; observed:
    iterate max abs err 1.1e-8 (2.0e-7 of max |w| = 0.055), loss 1.8e-7
    relative."""
    rp, pp = small_problem, port_problem
    ref = RefTrainer(ref_make_solver("dane", rp, aggregator="pallas"),
                     rounds=ROUNDS, seed=0, eval_fn=_loss(rp)).fit()
    got = Trainer(make_solver("dane", pp, device="cpu", aggregator="pallas"),
                  rounds=ROUNDS, seed=0, eval_fn=_loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    np.testing.assert_allclose([h["f"] for h in got.history],
                               [h["f"] for h in ref.history], rtol=1e-4)
    assert got.history[-1]["f"] < float(pp.flat.loss(torch.zeros(pp.d)))


def test_dane_svrg_matches_reference_trainer(small_problem, port_problem):
    """The Proposition-1 SVRG solver (h = 0.05, m = 25), three rounds, the
    reference's sample indices injected.  Held at rtol 1e-4; observed:
    iterate max abs err 3.0e-8 (2.4e-7 of max |w| = 0.124), loss 8.9e-8
    relative."""
    rp, pp = small_problem, port_problem
    ref = RefTrainer(ref_make_solver("dane", rp, local_solver="svrg"),
                     rounds=ROUNDS, seed=0, eval_fn=_loss(rp)).fit()
    cfg = make_solver("dane", pp, device="cpu", local_solver="svrg").cfg
    solver = ReferenceDrawsDANE(pp, cfg, seed=0, ref_problem=rp)
    got = Trainer(solver, rounds=ROUNDS, seed=0, eval_fn=_loss(pp)).fit()
    w_ref = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(w_ref).max())
    np.testing.assert_allclose([h["f"] for h in got.history],
                               [h["f"] for h in ref.history], rtol=1e-4)


@pytest.mark.parametrize("local_solver", ["gd", "svrg"])
def test_dane_dense_and_kernel_aggregators_agree(port_problem, local_solver):
    pp = port_problem
    w = np.random.default_rng(2).standard_normal(pp.d).astype(np.float32)
    outs = [make_solver("dane", pp, device="cpu", aggregator=agg,
                        local_solver=local_solver).round(
        state_from_array(w * 0.1, 0, "cpu"), threefry.PRNGKey(3)
    ).w for agg in ("dense", "pallas")]
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-7)


def test_dane_partial_participation_matches_reference(small_problem,
                                                      port_problem):
    """p = 0.5 (uniform weighting, reweighted), one GD round from a random
    iterate with the reference's masks injected.  Held at rtol 1e-4."""
    rp, pp = small_problem, port_problem
    w = (np.random.default_rng(3).standard_normal(rp.d) * 0.1).astype(
        np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    ref_solver = ref_make_solver("dane", rp, participation=0.5)
    expect = np.asarray(ref_solver.round(ref_solver.init(jnp.asarray(w)),
                                         key).w)
    masks = [torch.tensor(np.array(m)) for m in
             ref_solver.engine.participation_masks(key)]
    assert 0 < sum(float(m.sum()) for m in masks) < pp.num_clients
    solver = make_solver("dane", pp, device="cpu", participation=0.5)
    solver.engine.participation_masks = lambda gen, round_index=None: masks
    got = solver.round(state_from_array(w, 0, "cpu"),
                       threefry.fold_in(threefry.PRNGKey(0), 0)).w
    scale = np.abs(expect - w).max()
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4,
                               atol=1e-4 * scale)


def test_dane_config_and_draws():
    with pytest.raises(ValueError, match="local_solver must be one of") as e:
        DANEConfig(local_solver="newton")
    with pytest.raises(ValueError) as ref_e:
        RefDANEConfig(local_solver="newton")
    assert str(e.value) == str(ref_e.value)


def test_dane_own_samples_lie_in_each_clients_rows(port_problem):
    pp = port_problem
    solver = make_solver("dane", pp, device="cpu", local_solver="svrg")
    for bi, b in enumerate(pp.buckets):
        s = solver.samples(threefry.PRNGKey(bi), bi, b)
        assert s.shape == (b.num_clients, solver.cfg.svrg_steps)
        assert bool((s >= 0).all()) and bool((s < b.n_k[:, None]).all())
