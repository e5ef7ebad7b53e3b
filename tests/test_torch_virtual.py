"""The port's virtual data layer and virtual rounds against the reference's.

``virtual_dataset`` is ``data_spec``'s draws plus the base key; any
client's rows regenerate from it bit-equal to ``generate``'s
(``make_client_batch`` on every client of a small config, and the padded
batch the engine regenerates against the reference's
``client_rows_padded``).  ``build_virtual_problem`` has
``build_problem``'s buckets, order and weights; ``VirtualFlat`` streams
the materialized flat view's loss, gradient, error and counts (the counts
exactly).  Virtual rounds — whole buckets, chunks, cohorts, the state
round — are held against the reference's virtual rounds on the same key
(rtol 1e-5), and against the port's materialized rounds on the same path
bit for bit (the regenerated rows are the materialized rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.gplus_logreg import LogRegConfig as RefLogRegConfig  # noqa: E402
from repro.core import build_virtual_problem as ref_build_virtual  # noqa: E402
from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.data.synthetic import virtual_dataset as ref_virtual_dataset  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.configs.gplus_logreg import LogRegConfig  # noqa: E402
from repro_torch.core import (VirtualBucket, build_problem,  # noqa: E402
                              build_virtual_problem, scaling)
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.data import (generate, make_client_batch,  # noqa: E402
                              materialize_dataset, virtual_dataset)
from repro_torch.utils import threefry  # noqa: E402

#: the reference's property-test scale: several buckets, tiny m_pad
_TINY = dict(name="virtual-pt", num_clients=12, num_features=64,
             num_examples=60, min_client_examples=2, max_client_examples=10,
             nnz_per_example=6)


@pytest.fixture(scope="module")
def tiny():
    cfg = LogRegConfig(**_TINY)
    vds = virtual_dataset(cfg, seed=0, device="cpu")
    ds = generate(cfg, seed=0, device="cpu")
    rvds = ref_virtual_dataset(RefLogRegConfig(**_TINY), seed=0)
    return (vds, ds, build_virtual_problem(vds), build_problem(ds, device="cpu"),
            ref_build_virtual(rvds), rvds)


@pytest.fixture(scope="module")
def ref_materialized():
    from repro.core import build_problem as ref_build_problem
    from repro.data.synthetic import generate as ref_generate
    return ref_build_problem(ref_generate(RefLogRegConfig(**_TINY), seed=0))


def test_virtual_dataset_is_the_references(tiny):
    vds, _, _, _, _, rvds = tiny
    np.testing.assert_array_equal(vds.full_sizes, rvds.full_sizes)
    np.testing.assert_array_equal(vds.client_sizes, rvds.client_sizes)
    for name in ("w_true", "log_pop", "global_cdf"):
        np.testing.assert_array_equal(getattr(vds, name).numpy(),
                                      np.asarray(getattr(rvds, name)))
    assert [int(w) for w in vds.base_key] == [
        int(x) for x in np.asarray(rvds.base_key)]
    for name in ("num_features", "nnz", "vocab_size", "n_own",
                 "num_clients", "num_examples"):
        assert getattr(vds, name) == getattr(rvds, name), name


def test_make_client_batch_matches_generate_every_client():
    """Every client of the small config (K = 20), train and test rows:
    make_client_batch is generate's row slice, bit for bit; generate is
    materialize_dataset of the virtual spec."""
    cfg = get_logreg_config().scaled(0.002)
    vds = virtual_dataset(cfg, seed=0, device="cpu")
    ds = generate(cfg, seed=0, device="cpu")
    again = materialize_dataset(vds)
    for f in ("idx", "val", "y", "client_of", "test_idx", "test_val",
              "test_y"):
        assert torch.equal(getattr(again, f), getattr(ds, f)), f
    tr = np.asarray(vds.client_sizes, np.int64)
    te = np.asarray(vds.full_sizes, np.int64) - tr
    tr_off = np.concatenate([[0], np.cumsum(tr)[:-1]])
    te_off = np.concatenate([[0], np.cumsum(te)[:-1]])
    for k in range(vds.num_clients):
        idx, val, y = make_client_batch(vds, k)
        n = int(tr[k])
        a, b = int(tr_off[k]), int(te_off[k])
        assert torch.equal(idx[:n], ds.idx[a:a + n]), k
        assert torch.equal(val[:n], ds.val[a:a + n]), k
        assert torch.equal(y[:n], ds.y[a:a + n]), k
        assert torch.equal(idx[n:], ds.test_idx[b:b + int(te[k])]), k
        assert torch.equal(val[n:], ds.test_val[b:b + int(te[k])]), k
        assert torch.equal(y[n:], ds.test_y[b:b + int(te[k])]), k
    idx, _, _ = make_client_batch(vds, 3, num_rows=2)
    assert idx.shape == (2, vds.nnz + 2)


def test_client_rows_padded_matches_the_references(tiny, ref_materialized):
    """The engine's regenerated batch — every client of the tiny config at
    its bucket's m_pad, padding rows idx 0 / val 0 / y 1 — is the
    reference's bucket, bit for bit (the reference holds its own
    client_rows_padded to its materialized buckets)."""
    vds, _, pv, _, _, _ = tiny
    for vb, rb in zip(pv.buckets, ref_materialized.buckets):
        idx, val, y = vds.client_rows_padded(vb.client_ids, vb.n_k, vb.m_pad)
        ridx, rval, ry = rb.idx, rb.val, rb.y
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(rval))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
        pad = (torch.arange(vb.m_pad)[None, :] >= vb.n_k[:, None])
        assert (idx[pad] == 0).all() and (val[pad] == 0).all()
        assert (y[pad] == 1).all()


def test_virtual_problem_mirrors_materialized_layout(tiny):
    _, _, pv, pm, rpv, _ = tiny
    assert pv.virtual is not None and pm.virtual is None
    assert len(pv.buckets) == len(pm.buckets) == len(rpv.buckets) > 1
    assert pv.num_clients == pm.num_clients and pv.d == pm.d
    assert pv.flat.n == pm.flat.n and pv.flat.lam == pm.flat.lam
    assert torch.equal(pv.client_weights, pm.client_weights)
    np.testing.assert_array_equal(pv.client_weights.numpy(),
                                  np.asarray(rpv.client_weights))
    for bm, bv, rb in zip(pm.buckets, pv.buckets, rpv.buckets):
        assert isinstance(bv, VirtualBucket)
        assert bv.m_pad == bm.m_pad == rb.m_pad
        assert torch.equal(bv.n_k, bm.n_k)
        np.testing.assert_array_equal(bv.client_ids.numpy(),
                                      np.asarray(rb.client_ids))
        cb = pv.virtual.realize(bv)
        for f in ("idx", "val", "y", "n_k"):
            assert torch.equal(getattr(cb, f), getattr(bm, f)), f


def test_virtual_flat_matches_materialized_flat(tiny):
    """VirtualFlat against the port's materialized flat view (held to the
    reference's in tests/test_torch_problem.py): loss and error to 1e-6,
    the gradient to 1e-5 (scatter order), the counts exactly."""
    _, _, pv, pm, _, _ = tiny
    fv, fm = pv.flat, pm.flat
    fv.eval_chunk = 5          # several chunks a bucket
    wt = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(7), (fm.num_features,)) * 0.2))
    for got, expect in ((fv.loss(wt), fm.loss(wt)),
                        (fv.error_rate(wt), fm.error_rate(wt))):
        np.testing.assert_allclose(float(got), float(expect), rtol=1e-6)
    np.testing.assert_allclose(fv.grad(wt).numpy(), fm.grad(wt).numpy(),
                               rtol=1e-5, atol=2e-6)
    assert torch.equal(fv.feature_counts(), scaling.global_feature_counts(fm))
    assert torch.equal(scaling.global_feature_counts(fv),
                       scaling.global_feature_counts(fm))
    assert torch.equal(fv.omega(), scaling.omega(pm))
    assert torch.equal(scaling.omega(pv), scaling.omega(pm))
    assert torch.equal(scaling.aggregation_diag(pv),
                       scaling.aggregation_diag(pm))
    with pytest.raises(NotImplementedError):
        fv.margins(wt)


def test_engine_virtual_config_guards(tiny, ref_materialized):
    """The same refusals, with the same messages, as the reference's."""
    _, _, pv, pm, rpv, _ = tiny
    rpm = ref_materialized
    for port_args, ref_args in [
            ((pv, EngineConfig()), (rpv, RefEngineConfig())),
            ((pm, EngineConfig(virtual_data=True)),
             (rpm, RefEngineConfig(virtual_data=True)))]:
        with pytest.raises(ValueError) as ref_err:
            RefRoundEngine(*ref_args)
        with pytest.raises(ValueError) as port_err:
            RoundEngine(*port_args)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="round_virtual requires "
                       "cfg.virtual_data"):
        RoundEngine(pm, EngineConfig()).round_virtual(
            torch.zeros(pm.d), threefry.PRNGKey(0), lambda *a: None)
    with pytest.raises(ValueError,
                       match="round_virtual_with_state requires"):
        RoundEngine(pm, EngineConfig()).round_virtual_with_state(
            torch.zeros(pm.d), [], threefry.PRNGKey(0), lambda *a: None)
    eng = RoundEngine(pv, EngineConfig(virtual_data=True))
    with pytest.raises(ValueError, match="no chunk_pass was supplied"):
        eng.compile(lambda *a: None)
    with pytest.raises(ValueError, match="no chunk_pass was supplied"):
        eng.reference(lambda *a: None)
    assert eng.round_path() == eng.round_path(compiled=False) == "virtual"


def _ref_data_pass(lam):
    def chunk_pass(w, bi, cb, keys):
        def one(idx, val, y, n_k, ck):
            nkf = jnp.maximum(n_k.astype(jnp.float32), 1.0)
            z = (val * w[idx]).sum(axis=1)
            g_sc = -y * jax.nn.sigmoid(-y * z) / nkf
            g = jnp.zeros_like(w).at[idx].add(g_sc[:, None] * val)
            r = jax.random.uniform(ck, w.shape) - 0.5
            return -0.5 * (g + lam * w) + 0.01 * r
        return jax.vmap(one)(cb.idx, cb.val, cb.y, cb.n_k, keys)
    return chunk_pass


def _port_data_pass(lam):
    """One local gradient step from the client's rows plus a keyed
    perturbation from its own key: the reference's twin above."""
    def chunk_pass(w, bi, cb, keys, out):
        C, d = cb.num_clients, w.shape[0]
        nkf = cb.n_k.to(torch.float32).clamp(min=1.0)
        z = (cb.val * w[cb.idx]).sum(dim=-1)
        g_sc = -cb.y * torch.sigmoid(-cb.y * z) / nkf[:, None]
        g = torch.zeros((C, d)).scatter_add_(
            1, cb.idx.reshape(C, -1), (g_sc[..., None] * cb.val).reshape(C, -1))
        r = threefry.uniform(keys, (d,)) - 0.5
        out.copy_(-0.5 * (g + lam * w) + 0.01 * r)
    return chunk_pass


@pytest.mark.parametrize("chunk,participation,weighting,aggregator,cohort", [
    (None, 1.0, "nk", "dense", None),
    (2, 0.5, "uniform", "pallas", None),
    (3, 1.0, "sum", "pallas", None),
    (None, 0.5, "nk", "pallas", 2),
    (2, 0.3, "sum", "dense", 4),
], ids=["bucket-nk", "c2-p0.5-uniform-pallas", "c3-sum-pallas",
        "cohort2-p0.5", "cohort4-c2-p0.3-sum"])
def test_virtual_round_matches_reference_virtual_round(
        tiny, chunk, participation, weighting, aggregator, cohort):
    """The port's virtual round (or virtual cohort round) against the
    reference's on the same key, rtol 1e-5; and bit-equal to the port's
    materialized round on the same path."""
    _, _, pv, pm, rpv, _ = tiny
    kw = dict(participation=participation, weighting=weighting,
              aggregator=aggregator, client_chunk=chunk, cohort=cohort)
    ref = RefRoundEngine(rpv, RefEngineConfig(virtual_data=True, **kw))
    port = RoundEngine(pv, EngineConfig(virtual_data=True, **kw))
    mat = RoundEngine(pm, EngineConfig(**kw))
    lam = pm.flat.lam
    w = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (pm.d,)) * 0.1)
    wt = torch.tensor(w)
    cohort_path = cohort is not None and participation < 1.0
    ref_round = jax.jit(lambda w_, k: (ref.round_cohort if cohort_path
                                       else ref.round_virtual)(
        w_, k, _ref_data_pass(lam)))
    for r in (0, 1):
        key = threefry.PRNGKey(r)
        expect = ref_round(jnp.asarray(w), jax.random.PRNGKey(r))
        if cohort_path:
            got = port.round_cohort(wt, key, _port_data_pass(lam))
            same_path = mat.round_cohort(wt, key, _port_data_pass(lam))
        else:
            got = port.round_virtual(wt, key, _port_data_pass(lam))
            same_path = mat._streamed_round(wt, key, _port_data_pass(lam),
                                            (), None, None)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(got, same_path)


@pytest.mark.parametrize("chunk", [None, 2])
def test_virtual_state_round_matches_reference(tiny, chunk):
    """State rounds over regenerated rows: the state stays materialized,
    frozen where the draw left a client out; the states equal the
    reference's bit for bit, the iterate to rtol 1e-5."""
    _, _, pv, _, rpv, _ = tiny
    kw = dict(weighting="sum", participation=0.5, client_chunk=chunk,
              virtual_data=True)
    ref = RefRoundEngine(rpv, RefEngineConfig(**kw))
    port = RoundEngine(pv, EngineConfig(**kw))
    lam = pv.flat.lam
    ref_pass, port_pass = _ref_data_pass(lam), _port_data_pass(lam)

    def ref_state_pass(w, bi, cb, s_c, keys):
        tag = cb.n_k.astype(jnp.float32)[:, None]
        return ref_pass(w, bi, cb, keys), 2.0 * s_c + tag

    def port_state_pass(w, bi, cb, s_c, keys, out):
        port_pass(w, bi, cb, keys, out)
        return 2.0 * s_c + cb.n_k.to(torch.float32)[:, None]

    states = [np.full((b.num_clients, 2), 1.5, np.float32)
              for b in pv.buckets]
    w_ref, st_ref = jax.jit(lambda st: ref.round_virtual_with_state(
        jnp.zeros(pv.d), st, jax.random.PRNGKey(4), ref_state_pass))(
        [jnp.asarray(s) for s in states])
    w_port, st_port = port.round_virtual_with_state(
        torch.zeros(pv.d), [torch.tensor(s) for s in states],
        threefry.PRNGKey(4), port_state_pass)
    np.testing.assert_allclose(w_port.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-6)
    for s_p, s_r in zip(st_port, st_ref):
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))


def test_virtual_configs_are_the_references():
    from repro import configs as rconfigs
    from repro_torch import configs
    assert (dataclasses.asdict(configs.get_paper_k_config())
            == dataclasses.asdict(rconfigs.get_paper_k_config()))
    for K in (8, 10_000, 1_000_000):
        assert (dataclasses.asdict(configs.get_virtual_k_config(K))
                == dataclasses.asdict(rconfigs.get_virtual_k_config(K)))
    for bad in (configs.get_virtual_k_config, rconfigs.get_virtual_k_config):
        with pytest.raises(ValueError, match="num_clients must be >= 8"):
            bad(7)
