"""Every solver's virtual round against the reference solver's.

A problem built by ``build_virtual_problem`` switches ``virtual_data`` on
by itself; FSVRG (whole buckets regenerated), FedAvg (chunks, the
kernel aggregator), svrg_naive (a cohort), DANE's SVRG solver, GD and
CoCoA+ (chunks, α kept materialized) run one round from the same key in
both packages, at the reference's virtual property-test scale: iterates
at rtol 1e-5, CoCoA+'s α at 1e-6.  The helpers are
``tests/_torch_scale.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_scale import DANE, check, one_round, virtual_pair  # noqa: E402


@pytest.fixture(scope="module")
def virtual():
    return virtual_pair()


@pytest.mark.parametrize("name,kw", [
    ("fsvrg", dict()),
    ("fedavg", dict(client_chunk=2, aggregator="pallas")),
    ("svrg_naive", dict(participation=0.5, cohort=2, naive_steps=8)),
    ("dane", dict(DANE, local_solver="svrg", mu=0.0, client_chunk=3)),
    ("gd", dict(client_chunk=2)),
    ("cocoa", dict(client_chunk=2, participation=0.5)),
], ids=["fsvrg-bucket", "fedavg-c2-pallas", "svrg_naive-cohort2",
        "dane-svrg-c3", "gd-c2", "cocoa-c2-p0.5"])
def test_solver_virtual_round_matches_reference(virtual, name, kw):
    """A virtual problem switches the knob on by itself (auto-detected)."""
    rp, pp = virtual
    s_ref, s_port, port = one_round(rp, pp, name, kw)
    assert port.engine.cfg.virtual_data
    check(s_ref, s_port)
