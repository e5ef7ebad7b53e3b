"""The port's ``split``, ``randint``, ``permutation`` and ``gumbel``
(``repro_torch.utils.threefry``) against ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``).

``split``, ``randint`` and ``permutation`` are held bit for bit, on one key
and on a batch of keys.  ``gumbel``'s uniforms are held bit for bit; its
value is −log(−log u) through ``floatmath.log_f32``, which rounds
correctly where XLA's ``log`` rounds about one input in seven an ulp away,
so the value is held within 2 ulp of max(|g|, 1): near g = 0 the outer log
turns one ulp of the inner log (≈ 1) into an absolute error of ≈ 1.2e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import threefry  # noqa: E402

SPANS = [1, 2, 97, 6_750, 65_536, 65_537, 2 ** 31 - 1]


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port draws JAX's partitionable threefry layout; "
                    "jax_threefry_partitionable is off in this JAX")


def _stack(key):
    return np.stack([key[0].numpy(), key[1].numpy()], -1)


@pytest.mark.parametrize("n", [1, 2, 7, 1_000])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_split(seed, n):
    key = jax.random.PRNGKey(seed)
    pk = threefry.PRNGKey(seed)
    expect = np.asarray(jax.random.split(key, n)).astype(np.int64)
    np.testing.assert_array_equal(_stack(threefry.split(pk, n)), expect)
    # split is fold_in of the index
    folded = threefry.fold_in(pk, torch.arange(n))
    np.testing.assert_array_equal(_stack(folded), expect)


def test_split_of_a_batch_of_keys():
    """A batch of keys of shape B splits into B + (n,): FedAvg's epoch
    keys ``split(ck, E)`` of every client at once."""
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 5)
    expect = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = threefry.split(threefry.split(threefry.PRNGKey(3), 5), 3)
    assert tuple(got[0].shape) == (5, 3)
    np.testing.assert_array_equal(_stack(got), expect.astype(np.int64))


@pytest.mark.parametrize("shape", [(50,), (4, 3)])
def test_randint_per_key_maxval(shape):
    """One maxval per key, as the solvers call it with each client's n_k:
    spans on both sides of 2¹⁶, where the uint32 product wraps."""
    key = jax.random.PRNGKey(7)
    maxval = np.array(SPANS, np.int32)
    keys = jax.random.split(key, len(SPANS))
    expect = np.asarray(jax.vmap(
        lambda k, mv: jax.random.randint(k, shape, 0, mv))(keys, maxval))
    got = threefry.randint(threefry.split(threefry.PRNGKey(7), len(SPANS)),
                           shape, 0, torch.tensor(maxval.astype(np.int64)))
    assert got.dtype == torch.int64 and tuple(got.shape) == expect.shape
    np.testing.assert_array_equal(got.numpy(), expect)
    assert (got.numpy() < maxval.reshape((-1,) + (1,) * len(shape))).all()


def test_randint_wraps_where_int64_would_not():
    """For a span above 2¹⁶ the multiplier (2¹⁶)² wraps to 0 in uint32;
    carried exactly it would be 2³² mod span, and the draws would differ."""
    key = jax.random.PRNGKey(1)
    expect = np.asarray(jax.random.randint(key, (200,), 0, 65_537))
    got = threefry.randint(threefry.PRNGKey(1), (200,), 0, 65_537).numpy()
    np.testing.assert_array_equal(got, expect)
    ks = threefry.split(threefry.PRNGKey(1), 2)
    hi = threefry.random_bits(threefry.take(ks, 0), (200,))
    lo = threefry.random_bits(threefry.take(ks, 1), (200,))
    exact = ((hi % 65_537) * ((1 << 32) % 65_537) + lo % 65_537) % 65_537
    assert (exact.numpy() != expect).any()


@pytest.mark.parametrize("minval,maxval", [(10, 5), (7, 7), (-3, 4),
                                           (-(2 ** 31), 2 ** 31 - 1),
                                           (5, 2 ** 31 - 1)])
def test_randint_scalar_bounds(minval, maxval):
    """minval ≥ maxval returns minval; a span of 2³² − 1 and negative
    bounds wrap as int32 and uint32 arithmetic does."""
    key = jax.random.PRNGKey(11)
    expect = np.asarray(jax.random.randint(key, (64,), minval, maxval))
    got = threefry.randint(threefry.PRNGKey(11), (64,), minval, maxval)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_randint_per_key_minval_at_or_above_maxval():
    key = jax.random.PRNGKey(5)
    lo = np.array([0, 3, 10, 65_540, 2 ** 31 - 1], np.int32)
    hi = np.array([0, 2, 97, 65_537, 5], np.int32)
    keys = jax.random.split(key, len(lo))
    expect = np.asarray(jax.vmap(
        lambda k, a, b: jax.random.randint(k, (9,), a, b))(keys, lo, hi))
    got = threefry.randint(threefry.split(threefry.PRNGKey(5), len(lo)),
                           (9,), torch.tensor(lo.astype(np.int64)),
                           torch.tensor(hi.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("n", [0, 1, 2, 1_625, 1_626, 8_192])
def test_permutation_on_a_batch_of_keys(n):
    """n ≤ 1,625 sorts once, n ≥ 1,626 twice (the §4 buckets' m_pad of
    8,192 included); equal sort keys keep their order (stable)."""
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 4)
    expect = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(
        keys))
    got = threefry.permutation(threefry.split(threefry.PRNGKey(0), 4), n)
    assert got.dtype == torch.int64 and tuple(got.shape) == (4, n)
    np.testing.assert_array_equal(got.numpy(), expect)
    one = threefry.permutation(threefry.take(threefry.split(
        threefry.PRNGKey(0), 4), 2), n)
    np.testing.assert_array_equal(one.numpy(), expect[2])


def test_permutation_keeps_the_order_of_equal_sort_keys():
    """Where two of a round's 32-bit sort keys collide (at n = 100,000 about
    one pair a round), the stable sort keeps their previous order, and the
    result is JAX's."""
    n = 100_000
    seeds = []
    for s in range(6):
        ks = threefry.split(threefry.PRNGKey(s), 2)
        bits = threefry.random_bits(threefry.take(ks, 1), (n,))
        if bits.unique().numel() < n:
            seeds.append(s)
    assert seeds                 # a first round with equal sort keys
    for s in seeds:
        expect = np.asarray(jax.random.permutation(jax.random.PRNGKey(s), n))
        np.testing.assert_array_equal(
            threefry.permutation(threefry.PRNGKey(s), n).numpy(), expect)


@pytest.mark.parametrize("shape", [(100_000,), (3, 4_001)])
def test_gumbel(shape):
    key = jax.random.PRNGKey(7)
    pk = threefry.PRNGKey(7)
    tiny = np.finfo(np.float32).tiny
    u_ref = np.asarray(jax.random.uniform(key, shape, jnp.float32, tiny, 1.0))
    u = threefry.uniform(pk, shape, 2.0 ** -126, 1.0).numpy()
    np.testing.assert_array_equal(u.view(np.uint32), u_ref.view(np.uint32))
    g_ref = np.asarray(jax.random.gumbel(key, shape)).astype(np.float64)
    g = threefry.gumbel(pk, shape).numpy().astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g_ref), 1.0).astype(np.float32))
    assert (np.abs(g - g_ref) <= 2 * ulp).all()


def test_gumbel_per_key():
    keys = jax.random.split(jax.random.PRNGKey(2), 6)
    g_ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (500,)))(
        keys)).astype(np.float64)
    g = threefry.gumbel(threefry.split(threefry.PRNGKey(2), 6),
                        (500,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(g_ref), 1.0).astype(np.float32))
    assert g.shape == (6, 500) and (np.abs(g - g_ref) <= 2 * ulp).all()


def test_as_key_places_the_words():
    k = threefry.as_key(threefry.PRNGKey(9), "cpu")
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.int64
               for w in k)
    np.testing.assert_array_equal(
        threefry.permutation(k, 33).numpy(),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(9), 33)))
