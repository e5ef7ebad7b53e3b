"""The port's main path from its own seed against the reference's.

``generate(scale 0.002, seed 0)`` in each package (bit-equal rows), then
``Trainer(make_solver(name), rounds=3, seed=0)`` in each, round by round:
round r runs on ``fold_in(PRNGKey(0), r)`` in both, and every mask,
permutation and sample is drawn from it by the port itself.  The iterates
are held after every round at rtol 1e-4 of max |w| (ROADMAP C1: the passes
differ by ulps of sigmoid and FMA contraction, and the cross-bucket sums
are associated in another order); the losses at rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.core import (Trainer, build_problem, make_solver,  # noqa: E402
                              sweep)
from repro_torch.data import generate  # noqa: E402

ROUNDS = 3


@pytest.fixture(scope="module")
def port_problem():
    """The port's own data: ``tests/conftest.py``'s small_dataset config."""
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    return build_problem(ds, device="cpu")


def _run(trainer_cls, solver, prob, to_numpy, **kw):
    """The iterate after every round and the loss history."""
    ws = []
    res = trainer_cls(solver, rounds=ROUNDS, seed=0,
                      eval_fn=lambda w: {"f": prob.flat.loss(w)},
                      callback=lambda s, r: ws.append(to_numpy(s.w)),
                      **kw).fit()
    return ws, [h["f"] for h in res.history]


@pytest.mark.parametrize("name,kw", [
    ("fsvrg", dict(aggregator="pallas")),
    ("fsvrg", dict(participation=0.5)),
    ("svrg_naive", {}),
    ("gd", {}),
    ("fedavg", {}),
    ("cocoa", {}),
])
def test_trainer_from_its_own_seed_matches_the_reference(
        small_problem, port_problem, name, kw):
    """Observed (CPU) max abs error over the 3 rounds, as a share of max
    |w|: FSVRG 2.0e-7 (5.7e-7 at p = 0.5, the masks drawn by each
    package), svrg_naive 1.1e-7, GD 5.3e-7, FedAvg (E = 2)
    1.7e-7, CoCoA+ 9.6e-8; losses within 1.6e-7 relative."""
    rp, pp = small_problem, port_problem
    w_ref, f_ref = _run(RefTrainer, ref_make_solver(name, rp, **kw), rp,
                        np.asarray)
    solver = make_solver(name, pp, device="cpu", **kw)
    w_got, f_got = _run(Trainer, solver, pp, lambda w: w.numpy().copy())
    assert len(w_got) == len(w_ref) == ROUNDS
    for r, (got, expect) in enumerate(zip(w_got, w_ref)):
        scale = np.abs(expect).max()
        np.testing.assert_allclose(got, expect, rtol=1e-4,
                                   atol=1e-4 * scale,
                                   err_msg=f"{name} round {r}")
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-4)
    assert np.isfinite(f_got).all()


def test_sweep_picks_the_references_candidate(tiny_dataset, tiny_problem):
    """Three stepsizes for FSVRG, one divergent (h = ∞: the iterate goes
    NaN, which the sweep discards with fail_fast off, as the reference's
    does): the same winner, and its final loss at rtol 1e-4."""
    rp = tiny_problem
    pp = build_problem(dataset_from_arrays(tiny_dataset, device="cpu"),
                       device="cpu")
    candidates = (0.3, 1.0, float("inf"))
    ref_res, ref_best = ref_sweep(
        lambda h: ref_make_solver("fsvrg", rp, stepsize=h), candidates,
        rounds=2, seed=0, eval_fn=lambda w: {"f": rp.flat.loss(w)})
    res, best = sweep(
        lambda h: make_solver("fsvrg", pp, device="cpu", stepsize=h),
        candidates, rounds=2, seed=0,
        eval_fn=lambda w: {"f": pp.flat.loss(w)})
    assert best == ref_best and np.isfinite(best)
    np.testing.assert_allclose(res.history[-1]["f"],
                               ref_res.history[-1]["f"], rtol=1e-4)
    # every candidate diverging: nothing is picked
    assert sweep(lambda h: make_solver("gd", pp, device="cpu", stepsize=h),
                 [float("inf")], rounds=1,
                 eval_fn=lambda w: {"f": pp.flat.loss(w)}) == (None, None)
    assert jnp.isfinite(ref_res.history[-1]["f"])
