"""Helpers of the scale-path solver tests: build a solver in both
packages with the same knobs, run one round from the same key, compare."""
import jax
import numpy as np

from repro.configs.gplus_logreg import LogRegConfig as RefLogRegConfig
from repro.core import build_virtual_problem as ref_build_virtual
from repro.core import make_solver as ref_make_solver
from repro.data.synthetic import virtual_dataset as ref_virtual_dataset
from repro_torch.configs.gplus_logreg import LogRegConfig
from repro_torch.core import build_virtual_problem, make_solver
from repro_torch.data import virtual_dataset
from repro_torch.utils import threefry

#: the reference's virtual property-test scale
TINY = dict(name="virtual-pt", num_clients=12, num_features=64,
             num_examples=60, min_client_examples=2, max_client_examples=10,
             nnz_per_example=6)
#: fast local solvers: the comparison needs a few steps, not 50
DANE = dict(local_steps=5, local_lr=0.3, mu=0.1, svrg_steps=10)


def virtual_pair():
    """(reference, port) virtual problems of the TINY config, seed 0."""
    return (ref_build_virtual(ref_virtual_dataset(RefLogRegConfig(**TINY),
                                                  seed=0)),
            build_virtual_problem(virtual_dataset(LogRegConfig(**TINY),
                                                  seed=0, device="cpu")))


def one_round(rp, pp, name, kw, seed=3):
    """One round of ``name`` with knobs ``kw`` in each package from the
    same key: (reference state, port state, port solver)."""
    ref = ref_make_solver(name, rp, **kw)
    port = make_solver(name, pp, device="cpu", **kw)
    assert port.engine.round_path() == round_path(ref.engine)
    s_ref = ref.round(ref.init(), jax.random.PRNGKey(seed))
    s_port = port.round(port.init(), threefry.PRNGKey(seed))
    return s_ref, s_port, port


def round_path(ref_engine):
    """The round the reference's compiled round dispatches."""
    if ref_engine._use_cohort():
        return "cohort"
    if ref_engine.cfg.client_chunk is not None:
        return "streamed"
    return "virtual" if ref_engine.cfg.virtual_data else "plain"


def check(s_ref, s_port, rtol=1e-5):
    """Iterates at rtol of max |w|, states (CoCoA+'s α) at 1e-6."""
    w = np.asarray(s_ref.w)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(s_port.w.numpy(), w, rtol=rtol,
                               atol=rtol * np.abs(w).max())
    for a, b in zip(s_port.aux, s_ref.aux):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
