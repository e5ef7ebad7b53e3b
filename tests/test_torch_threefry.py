"""The port's threefry (``repro_torch.utils.threefry``) against
``jax.random``, bit for bit.

The port's draws are JAX's with ``jax_threefry_partitionable=True`` (the
default of jax 0.5 and later); under the older layout the bits differ by
design, so each test skips, with that reason, when the flag is off.  Every
comparison is exact: uint32 words for keys and bits, the f32 bit patterns
for uniforms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import threefry  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1]
DATA = [0, 1, 997, 123_456_789, 2 ** 31, 2 ** 32 - 1]
IDS = np.array([0, 5, 19, 9_999, 123_456, 2 ** 31 + 7, 2 ** 32 - 1],
               np.uint32)


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port draws JAX's partitionable threefry layout; "
                    "jax_threefry_partitionable is off in this JAX")


def _words(key):
    return [int(key[0]), int(key[1])]


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _ids():
    return torch.tensor(IDS.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    pk = threefry.PRNGKey(seed)
    assert list(pk) == np.asarray(key).tolist()
    for data in DATA:
        assert (_words(threefry.fold_in(pk, data))
                == np.asarray(jax.random.fold_in(key, data)).tolist())
    # a chain of folds, as the fleet's tag / round / client chains
    chained = threefry.fold_in(threefry.fold_in(pk, 3), 29)
    assert _words(chained) == np.asarray(jax.random.fold_in(
        jax.random.fold_in(key, 3), 29)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_vectorised_over_ids(seed):
    key = jax.random.PRNGKey(seed)
    expect = np.asarray(jax.vmap(lambda c: jax.random.fold_in(key, c))(IDS))
    k0, k1 = threefry.fold_in(threefry.PRNGKey(seed), _ids())
    np.testing.assert_array_equal(np.stack([k0.numpy(), k1.numpy()], 1),
                                  expect.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (1000,), (3, 5),
                                   (4, 1001)])
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_random_bits(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    pk = threefry.fold_in(threefry.PRNGKey(seed), 11)
    np.testing.assert_array_equal(
        threefry.random_bits(pk, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, shape)))


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (-1.0, 1.0),
                                           (-0.7, 0.7), (-3.0, 2.0)])
@pytest.mark.parametrize("shape", [(), (1,), (999,), (17, 513)])
def test_uniform(shape, minval, maxval):
    """XLA contracts the scale and shift into a fused multiply-add; the
    port rounds once too."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    pk = threefry.fold_in(threefry.PRNGKey(3), 2)
    np.testing.assert_array_equal(
        _f32_bits(threefry.uniform(pk, shape, minval, maxval).numpy()),
        _f32_bits(jax.random.uniform(key, shape, jnp.float32, minval,
                                     maxval)))


def test_uniform_per_key():
    """One uniform per folded key, and one (d,) row per folded key: the
    fleet's per-client draw and the replay fault's pseudo-delta."""
    key = jax.random.PRNGKey(9)
    pk = threefry.PRNGKey(9)
    keys = threefry.fold_in(pk, _ids())
    expect = jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(key, c)))(IDS)
    np.testing.assert_array_equal(_f32_bits(threefry.uniform(keys).numpy()),
                                  _f32_bits(expect))
    expect = jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(key, c), (33,), jnp.float32, -1.0, 1.0))(IDS)
    np.testing.assert_array_equal(
        _f32_bits(threefry.uniform(keys, (33,), -1.0, 1.0).numpy()),
        _f32_bits(expect))


def test_fma_f32_rounds_once():
    """Against a·b + c computed exactly (fractions) and rounded once to
    the nearest f32, ties to even, including midpoint cases where rounding
    to f64 first and then to f32 would be wrong."""
    from fractions import Fraction

    def nearest_f32(x: Fraction) -> np.float32:
        f = np.float32(float(x))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(_f32_bits(v)) & 1))
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 1e-3).astype(np.float32)
    # a·b = 2^-24 (1 − 2^-46): with c = 1 + 2^-23 the f64 sum rounds onto
    # the f32 midpoint 1 + 2^-23 + 2^-24, which ties to even (upwards),
    # while the exact sum lies just below it; and its mirror image
    a[:2] = np.float32((2 ** 23 - 1) * 2.0 ** -35)
    b[:2] = [np.float32((2 ** 23 + 1) * 2.0 ** -35),
             np.float32(-(2 ** 23 + 1) * 2.0 ** -35)]
    c[:2] = [np.float32(1 + 2 ** -23), np.float32(-(1 + 2 ** -23))]
    naive = (a[:2].astype(np.float64) * b[:2] + c[:2]).astype(np.float32)
    got = threefry.fma_f32(*(torch.tensor(x) for x in (a, b, c))).numpy()
    expect = np.array([nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(expect))
    assert (naive != expect[:2]).all()     # rounding twice would be wrong


def test_seed_range():
    with pytest.raises(ValueError, match="seed"):
        threefry.PRNGKey(-1)
    with pytest.raises(ValueError, match="seed"):
        threefry.PRNGKey(2 ** 32)
    with pytest.raises(ValueError, match="shapes"):
        threefry.random_bits(threefry.PRNGKey(0), (2, 2, 2))
