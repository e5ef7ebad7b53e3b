"""Every solver's streamed, cohort and virtual rounds against the
reference solver with the same knobs.

FSVRG, svrg_naive, FedAvg, DANE (GD and SVRG solvers), CoCoA+ and
distributed GD are built in both packages with ``client_chunk``,
``cohort`` or a virtual problem, and one round from the same key is
compared: iterates at rtol 1e-5 (ROADMAP C1: the passes differ by ulps of
sigmoid and FMA contraction, and the sums are associated in another
order), CoCoA+'s α at 1e-6.  On one device, a keyed chunk pass gives each
client the delta the plain pass gives it, bit for bit; and on the
streamed and virtual paths no solver keeps an O(K·d) or O(Kb·d) cache.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_scale import DANE, check, one_round, virtual_pair  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import (build_problem, cohort_capacity,  # noqa: E402
                              make_solver)
from repro_torch.utils import threefry  # noqa: E402

@pytest.fixture(scope="module")
def small(small_problem, small_dataset):
    return small_problem, build_problem(
        dataset_from_arrays(small_dataset, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def tiny(tiny_problem, tiny_dataset):
    return tiny_problem, build_problem(
        dataset_from_arrays(tiny_dataset, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def virtual():
    return virtual_pair()


@pytest.mark.parametrize("name,kw", [
    ("fsvrg", dict(client_chunk=3, aggregator="pallas")),
    ("fsvrg", dict(participation=0.3, cohort="cap")),
    ("svrg_naive", dict(client_chunk=4, naive_steps=20)),
    ("svrg_naive", dict(participation=0.5, cohort=2, naive_steps=20)),
    ("fedavg", dict(client_chunk=3, participation=0.5)),
    ("fedavg", dict(participation=0.5, cohort=2, client_chunk=3,
                    aggregator="pallas")),
    ("gd", dict(client_chunk=4)),
    ("gd", dict(participation=0.5, cohort=3)),
], ids=["fsvrg-c3-pallas", "fsvrg-cohort-cap", "svrg_naive-c4",
        "svrg_naive-cohort2", "fedavg-c3-p0.5", "fedavg-cohort2-c3-pallas",
        "gd-c4", "gd-cohort3"])
def test_solver_scale_round_matches_reference(small, name, kw):
    rp, pp = small
    if kw.get("cohort") == "cap":
        kw = dict(kw, cohort=cohort_capacity(
            kw["participation"], max(b.num_clients for b in rp.buckets)))
    check(*one_round(rp, pp, name, kw)[:2])


@pytest.mark.parametrize("name,kw", [
    ("dane", dict(DANE, client_chunk=2)),
    ("dane", dict(DANE, local_solver="svrg", mu=0.0, participation=0.5,
                  cohort=2)),
    ("cocoa", dict(client_chunk=2, participation=0.5)),
    ("cocoa", dict(participation=0.5, cohort=2, aggregator="pallas")),
], ids=["dane-gd-c2", "dane-svrg-cohort2", "cocoa-c2-p0.5",
        "cocoa-cohort2-pallas"])
def test_dual_and_dane_scale_round_matches_reference(tiny, name, kw):
    rp, pp = tiny
    check(*one_round(rp, pp, name, kw)[:2])


def test_registry_plumbs_client_chunk_and_cohort(small):
    """make_solver passes the knobs through to the engine, for every
    sparse solver, as the reference's registry does."""
    _, pp = small
    for name in ("fsvrg", "svrg_naive", "fedavg", "dane", "cocoa", "gd"):
        s = make_solver(name, pp, device="cpu", client_chunk=5,
                        participation=0.5, cohort=4)
        assert s.engine.cfg.client_chunk == 5 and s.engine.cfg.cohort == 4
        assert s.engine.round_path() == "cohort"
        assert make_solver(name, pp, device="cpu",
                           client_chunk=5).engine.round_path() == "streamed"


@pytest.mark.parametrize("name", ["fsvrg", "svrg_naive", "fedavg", "dane",
                                  "cocoa", "gd"])
def test_streamed_and_virtual_solvers_hold_no_per_client_cache(small,
                                                               virtual, name):
    """On the streamed and virtual paths a solver's scratches are a
    chunk's rows and it keeps no S_k cache; the plain path keeps its
    (Kb, d) S_k cache and a largest-bucket scratch."""
    _, pp = small
    big = max(b.num_clients for b in pp.buckets)
    for prob, kw in ((pp, dict(client_chunk=2)),
                     (virtual[1], dict(client_chunk=2))):
        s = make_solver(name, prob, device="cpu", **kw)
        if hasattr(s, "s_diags"):
            assert s.s_diags is None and s.h_k is None
        for attr in ("_diff", "_g", "_a"):
            buf = getattr(s, attr, None)
            assert buf is None or buf.shape[0] == 2, attr
        s.round(s.init(), threefry.PRNGKey(0))
        for attr in ("_diff", "_g", "_a"):
            buf = getattr(s, attr, None)
            assert buf is None or buf.shape[0] == 2, attr
    plain = make_solver(name, pp, device="cpu")
    if name == "fsvrg":
        assert [tuple(x.shape) for x in plain.s_diags] == [
            (b.num_clients, pp.d) for b in pp.buckets]
        assert plain._diff.shape[0] == big


@pytest.mark.parametrize("name,kw", [
    ("fsvrg", {}), ("svrg_naive", dict(naive_steps=12)),
    ("dane", dict(DANE, local_solver="svrg", mu=0.0)), ("cocoa", {})])
def test_chunk_pass_deltas_are_the_plain_pass_deltas(small, name, kw):
    """On one device the keyed chunk pass gives each client of a chunk the
    delta (and α) the plain pass gives it over the whole bucket, bit for
    bit: the chunk gets its entries of split(kb, Kb) and forms S_k and h_k
    from its own rows."""
    _, pp = small
    s = make_solver(name, pp, device="cpu", client_chunk=3, **kw)
    plain = make_solver(name, pp, device="cpu", **kw)
    eng = s.engine
    w = torch.linspace(-0.05, 0.05, pp.d)
    ctx = () if name == "cocoa" else (pp.flat.grad(w),)
    for bi, b in enumerate(pp.buckets):
        kb = threefry.fold_in(threefry.PRNGKey(5), eng._offsets[bi])
        full = torch.empty((b.num_clients, pp.d))
        alpha = torch.zeros((b.num_clients, b.m_pad))
        if name == "cocoa":
            a_full = plain._pass(w, bi, b, alpha, kb, full)
        else:
            plain._pass(w, bi, b, kb, full, *ctx)
        c0 = 1 if b.num_clients > 1 else 0
        c1 = min(4, b.num_clients)
        part = type(b)(b.idx[c0:c1], b.val[c0:c1], b.y[c0:c1], b.n_k[c0:c1])
        keys = eng.client_keys(kb, c1 - c0, start=c0)
        out = torch.empty((c1 - c0, pp.d))
        if name == "cocoa":
            a_part = s._chunk_pass(w, bi, part, alpha[c0:c1], keys, out)
            assert torch.equal(a_part, a_full[c0:c1])
        else:
            s._chunk_pass(w, bi, part, keys, out, *ctx)
        assert torch.equal(out, full[c0:c1]), bi
