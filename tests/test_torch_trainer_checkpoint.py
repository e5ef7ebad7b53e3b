"""The port's Trainer checkpoints against the reference's Trainer.

FSVRG (no per-client state) and CoCoA+ (its dual blocks in ``aux``) at
scale 0.002, seed 0, each package on its own data (bit-equal rows):

* a 4-round fit with ``checkpoint_every=2``, killed in round 3 and resumed
  from the checkpoint of round 2, equals the uninterrupted fit bit for bit
  in the port (iterate and aux);
* a port checkpoint continued by the reference's Trainer, and a reference
  checkpoint continued by the port's, stay within rtol 1e-5 of max |w| of
  the continuing package's uninterrupted run (ROADMAP C1: a round of the
  two packages differs by ulps of sigmoid and summation order);
* the saved checkpoint never lags the returned result, also for a restored
  state handed to a fit past its budget; ``checkpoint_every`` without a
  directory raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.core import Trainer as RefTrainer  # noqa: E402
from repro.core import make_solver as ref_make_solver  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.core import Trainer, build_problem, make_solver  # noqa: E402
from repro_torch.data import generate  # noqa: E402

ROUNDS, SAVE_AT = 4, 2
SOLVERS = ["fsvrg", "cocoa"]


class _Killed(Exception):
    pass


@pytest.fixture(scope="module")
def port_problem():
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    return build_problem(ds, device="cpu")


def _fit(prob, name, rounds, **kw):
    return Trainer(make_solver(name, prob, device="cpu"), rounds=rounds,
                   seed=0, **kw)


def _kill_in_round(r_kill):
    def callback(state, r):
        if r == r_kill:
            raise _Killed
    return callback


def _aux(state):
    return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in state.aux]


@pytest.mark.parametrize("name", SOLVERS)
def test_killed_and_resumed_fit_is_bit_identical(tmp_path, port_problem,
                                                 name):
    full = _fit(port_problem, name, ROUNDS).fit()
    d = str(tmp_path / "ck")
    with pytest.raises(_Killed):
        _fit(port_problem, name, ROUNDS, checkpoint_dir=d,
             checkpoint_every=SAVE_AT, callback=_kill_in_round(2)).fit()
    state = Trainer.restore(d, "cpu")
    assert state.round == SAVE_AT and isinstance(state.round, int)
    assert isinstance(state.aux, tuple)
    res = _fit(port_problem, name, ROUNDS, checkpoint_dir=d,
               checkpoint_every=SAVE_AT).fit(state=state)
    assert res.state.round == ROUNDS
    assert torch.equal(res.w, full.w)
    assert len(res.state.aux) == len(full.state.aux)
    for a, b in zip(res.state.aux, full.state.aux):
        assert torch.equal(a, b)
    saved = Trainer.restore(d, "cpu")          # the final save is there
    assert saved.round == ROUNDS and torch.equal(saved.w, full.w)
    tree, info = checkpoint.restore(d, "cpu")
    assert tree["round"].dtype == torch.int32 and tree["round"].dim() == 0
    assert info["metadata"] == {"solver": make_solver(
        name, port_problem, device="cpu").name, "seed": 0}


def _close(got, expect, what):
    scale = np.abs(expect).max()
    err = np.abs(np.asarray(got) - np.asarray(expect)).max()
    assert err <= 1e-5 * scale, f"{what}: {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("name", SOLVERS)
def test_checkpoints_continue_in_the_other_package(tmp_path, small_problem,
                                                   port_problem, name):
    """Observed (CPU), port → reference / reference → port, of max |w|:
    FSVRG 4.9e-8 / 9.9e-8; CoCoA+ 7.7e-8 / 7.7e-8, its dual blocks up to
    1.1e-7 / 1.2e-7 of their max."""
    rp, pp = small_problem, port_problem
    ref_full = RefTrainer(ref_make_solver(name, rp), rounds=ROUNDS,
                          seed=0).fit()
    port_full = _fit(pp, name, ROUNDS).fit()

    d_port = str(tmp_path / "port")
    _fit(pp, name, SAVE_AT, checkpoint_dir=d_port).fit()
    state = RefTrainer.restore(d_port)
    assert int(state.round) == SAVE_AT and state.round.dtype == jnp.int32
    ref_cont = RefTrainer(ref_make_solver(name, rp), rounds=ROUNDS,
                          seed=0).fit(state=state)
    _close(ref_cont.w, ref_full.w, f"{name} port → reference")
    for a, b in zip(ref_cont.state.aux, ref_full.state.aux):
        _close(a, b, f"{name} aux port → reference")

    d_ref = str(tmp_path / "ref")
    RefTrainer(ref_make_solver(name, rp), rounds=SAVE_AT, seed=0,
               checkpoint_dir=d_ref).fit()
    state = Trainer.restore(d_ref, "cpu")
    assert state.round == SAVE_AT
    port_cont = _fit(pp, name, ROUNDS).fit(state=state)
    _close(port_cont.w.numpy(), port_full.w.numpy(),
           f"{name} reference → port")
    for a, b in zip(_aux(port_cont.state), _aux(port_full.state)):
        _close(a, b, f"{name} aux reference → port")


def test_a_fit_past_its_budget_still_saves(tmp_path, port_problem):
    d = str(tmp_path / "ck")
    res = _fit(port_problem, "fsvrg", 3, checkpoint_dir=d).fit()
    state = Trainer.restore(d, "cpu")
    assert state.round == 3 and torch.equal(state.w, res.w)
    d2 = str(tmp_path / "past")
    past = _fit(port_problem, "fsvrg", 2, checkpoint_dir=d2).fit(state=state)
    assert past.history == [] and past.state is state
    again = Trainer.restore(d2, "cpu")
    assert again.round == 3 and torch.equal(again.w, res.w)


def test_checkpoint_every_needs_a_directory(port_problem):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _fit(port_problem, "gd", 2, checkpoint_every=1)
