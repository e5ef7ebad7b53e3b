"""``repro_torch.utils.floatmath``: f32 functions computed in f64 from
IEEE operations alone and rounded once.

Held against numpy's f64 functions rounded to f32: bit for bit (their f64
error, ≈ 1e-16, decides the rounding only on exact ties, which these
inputs do not hold), and against XLA's f32 ``log``, ``pow`` and
``logistic`` within the ulps those round apart (1, 1 and 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import floatmath  # noqa: E402


def _inputs(n=400_000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.random(n), np.exp(rng.standard_normal(n) * 8),
                        [1.0, 2.0 ** -126, 0.5, 1 - 2.0 ** -24,
                         1 + 2.0 ** -23, 3.0e38]]).astype(np.float32)
    return x[np.isfinite(x) & (x >= 2.0 ** -126)]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_log_rounds_correctly():
    x = _inputs()
    got = floatmath.log_f32(torch.tensor(x)).numpy()
    expect = np.log(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    l64 = floatmath.log64(torch.tensor(x, dtype=torch.float64)).numpy()
    ref = np.log(x.astype(np.float64))
    assert np.max(np.abs(l64 - ref) / np.maximum(np.abs(ref), 1.0)) < 1e-15
    assert _ulps(got, np.asarray(jax.jit(jnp.log)(x))).max() <= 1


def test_exp_pow_and_sigmoid():
    rng = np.random.default_rng(1)
    z = rng.standard_normal(400_000) * 60
    e = floatmath.exp64(torch.tensor(z)).numpy()
    ez = np.exp(np.clip(z, -708, 709))
    assert np.max(np.abs(e - ez) / ez) < 1e-15
    x = _inputs(200_000, 2)[:200_000] * np.float32(0.01)
    y32 = np.float64(np.float32(1.0 / 0.3))
    got = floatmath.pow_f32(torch.tensor(x), 1.0 / 0.3).numpy()
    expect = (x.astype(np.float64) ** y32).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    assert _ulps(got, np.asarray(jax.jit(lambda v: v ** (1.0 / 0.3))(x))
                 ).max() <= 1
    z32 = (rng.standard_normal(400_000) * 8).astype(np.float32)
    got = floatmath.sigmoid_f32(torch.tensor(z32)).numpy()
    expect = (1.0 / (1.0 + np.exp(-z32.astype(np.float64)))).astype(
        np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    assert _ulps(got, np.asarray(jax.jit(jax.nn.sigmoid)(z32))).max() <= 2


@pytest.mark.parametrize("n", [1, 8, 62, 400])
def test_sums_add_left_to_right(n):
    """As XLA's sum and cumsum add at the tests' vocabulary width (8)."""
    x = np.random.default_rng(n).random((300, n)).astype(np.float32)
    acc = np.zeros(300, np.float32)
    run = []
    for j in range(n):
        acc = (acc + x[:, j]).astype(np.float32)
        run.append(acc)
    got_sum = floatmath.sum_f32(torch.tensor(x)).numpy()
    got_cum = floatmath.cumsum_f32(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got_sum, acc)
    np.testing.assert_array_equal(got_cum, np.stack(run, 1))
    if n == 8:
        np.testing.assert_array_equal(
            got_sum, np.asarray(jax.jit(jax.vmap(jnp.sum))(x)))
        np.testing.assert_array_equal(
            got_cum, np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x)))
