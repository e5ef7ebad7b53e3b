"""The port's problem layout and sparsity statistics against the reference.

The reference's dataset (``small_dataset``: scale 0.002, seed 0) goes into
both packages — into the port through ``repro_torch.bridge``.  Bucket
layouts, client weights, φ, ω, A and S_k are integer counts and IEEE
divisions, so they must match exactly; loss, gradient and error rate sum
in another order and match at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_problem as ref_build_problem  # noqa: E402
from repro.core import build_test_problem as ref_build_test_problem  # noqa: E402
from repro.core import scaling as ref_scaling  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import build_problem, build_test_problem  # noqa: E402
from repro_torch.core import scaling  # noqa: E402


@pytest.fixture(scope="module")
def port_dataset(small_dataset):
    return dataset_from_arrays(small_dataset, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("max_bucket_rows", [None, 1000, 200])
def test_bucket_layout_matches_exactly(small_dataset, port_dataset,
                                       max_bucket_rows):
    rp = ref_build_problem(small_dataset, max_bucket_rows=max_bucket_rows)
    pp = build_problem(port_dataset, max_bucket_rows=max_bucket_rows,
                       device="cpu")
    assert pp.num_clients == rp.num_clients and pp.d == rp.d
    assert len(pp.buckets) == len(rp.buckets)
    if max_bucket_rows is not None:
        assert len(pp.buckets) > len(ref_build_problem(small_dataset).buckets)
    for rb, pb in zip(rp.buckets, pp.buckets):
        for field in ("idx", "val", "y", "n_k"):
            np.testing.assert_array_equal(_np(getattr(pb, field)),
                                          _np(getattr(rb, field)), field)
    np.testing.assert_array_equal(_np(pp.client_weights),
                                  _np(rp.client_weights))
    for field in ("idx", "val", "y"):
        np.testing.assert_array_equal(_np(getattr(pp.flat, field)),
                                      _np(getattr(rp.flat, field)))
    assert pp.flat.lam == rp.flat.lam


def test_scaling_statistics_match_exactly(small_problem, port_dataset):
    rp = small_problem
    pp = build_problem(port_dataset, device="cpu")
    rphi = ref_scaling.global_feature_counts(rp.flat) / rp.flat.n
    phi = scaling.global_feature_counts(pp.flat) / pp.flat.n
    np.testing.assert_array_equal(_np(phi), _np(rphi))
    np.testing.assert_array_equal(_np(scaling.omega(pp)),
                                  _np(ref_scaling.omega(rp)))
    np.testing.assert_array_equal(_np(scaling.aggregation_diag(pp)),
                                  _np(ref_scaling.aggregation_diag(rp)))
    for rb, pb in zip(rp.buckets, pp.buckets):
        expect = jax.vmap(lambda i, v, n: ref_scaling.s_k_diag(rphi, i, v, n))(
            rb.idx, rb.val, rb.n_k)
        got = scaling.s_k_diag(phi, pb.idx, pb.val, pb.n_k)
        np.testing.assert_array_equal(_np(got), _np(expect))
        # the one-client form is a row of the batched one
        one = scaling.s_k_diag(phi, pb.idx[0], pb.val[0], pb.n_k[0])
        np.testing.assert_array_equal(_np(one), _np(got[0]))


def test_objective_matches_at_random_iterate(small_problem, small_dataset,
                                             port_dataset):
    rp = small_problem
    pp = build_problem(port_dataset, device="cpu")
    w = (np.random.default_rng(1).standard_normal(rp.d) * 0.3).astype(
        np.float32)
    for name in ("loss", "grad", "error_rate", "margins"):
        got = getattr(pp.flat, name)(torch.tensor(w))
        expect = getattr(rp.flat, name)(jnp.asarray(w))
        np.testing.assert_allclose(_np(got), _np(expect), rtol=1e-5,
                                   atol=1e-7)
    rt = ref_build_test_problem(small_dataset)
    pt = build_test_problem(port_dataset, device="cpu")
    np.testing.assert_allclose(float(pt.loss(torch.tensor(w))),
                               float(rt.loss(jnp.asarray(w))), rtol=1e-5)


def test_zero_margin_predicts_positive(port_dataset):
    """error_rate's tie-break: at w = 0 every prediction is +1, so the
    error is the share of negative labels."""
    pp = build_problem(port_dataset, device="cpu")
    err = float(pp.flat.error_rate(torch.zeros(pp.d)))
    assert err == pytest.approx(float((pp.flat.y < 0).float().mean()))
