"""The port's ``generate`` from its own seed against the reference's.

Both draw every row from JAX's threefry with the same keys, so the
integer arrays are bit-equal at ``tests/conftest.py``'s two configs; the
floats the sampler computes (the mixture's CDF, the label bias) come from
``floatmath``'s correctly rounded log, power and sigmoid where XLA rounds
an ulp or two apart, and are held within 1e-6 relative.

At the paper's width (d = 20,002, a vocabulary of V = 400) two Gumbel
scores of a client can lie within ulps of each other, and the two packages
may then order the vocabulary differently: every such client is counted,
and its first swapped pair must lie within 4 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_logreg_config as ref_config  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.data import generate, synthetic  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

CONFIGS = [(0.001, 3), (0.002, 0)]          # tests/conftest.py's two
ARRAYS = ("idx", "val", "y", "client_of", "test_idx", "test_val", "test_y",
          "test_client_of")


@pytest.fixture(scope="module", params=CONFIGS, ids=["tiny", "small"])
def both(request):
    scale, seed = request.param
    ref = ref_synthetic.generate(ref_config().scaled(scale), seed)
    port = generate(get_logreg_config().scaled(scale), seed, device="cpu")
    return scale, seed, ref, port


@pytest.mark.parametrize("name", ARRAYS)
def test_generate_is_bit_equal_to_the_reference(both, name):
    _, _, ref, port = both
    expect = np.asarray(getattr(ref, name))
    got = getattr(port, name).numpy()
    assert got.shape == expect.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      expect.view(np.uint32))
    else:
        np.testing.assert_array_equal(got, expect)


def test_sizes_are_the_references(both):
    _, _, ref, port = both
    np.testing.assert_array_equal(port.client_sizes, ref.client_sizes)
    assert port.num_features == ref.num_features
    assert port.num_examples == ref.num_examples


def _ref_params(vds, ids):
    return [np.asarray(x) for x in ref_synthetic._param_block(
        vds.base_key, jnp.asarray(ids, jnp.uint32), vds.log_pop,
        vocab_size=vds.vocab_size)]


def test_client_params_match_the_reference(both):
    """Vocabularies and rows keys bit-equal; the mixture's CDF and the
    label bias within 1e-6 relative (observed: CDF ≤ 4.9e-7, bias ≤
    1.2e-7)."""
    scale, seed, _, _ = both
    vds = ref_synthetic.virtual_dataset(ref_config().scaled(scale), seed)
    ids = np.arange(vds.num_clients)
    vocab, cdf, bias, rows_key = _ref_params(vds, ids)
    base = threefry.as_key(threefry.PRNGKey(seed), "cpu")
    pv, pc, pb, pk = synthetic.client_params(
        base, torch.arange(vds.num_clients),
        torch.tensor(np.asarray(vds.log_pop)), vds.vocab_size)
    np.testing.assert_array_equal(pv.numpy(), vocab[:len(ids)])
    np.testing.assert_array_equal(np.stack([pk[0].numpy(), pk[1].numpy()],
                                           -1), rows_key[:len(ids)])
    np.testing.assert_allclose(pc.numpy(), cdf[:len(ids)], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(pb.numpy(), bias[:len(ids)], rtol=1e-6,
                               atol=0)


def test_client_params_do_not_depend_on_the_batch():
    """A client's parameters are a function of its key alone: drawn in one
    batch, in two, or one at a time, the bits are the same."""
    cfg = get_logreg_config().scaled(0.002)
    spec = synthetic.data_spec(cfg, 0)
    base = threefry.as_key(threefry.PRNGKey(0), "cpu")
    log_pop = torch.tensor(spec.log_pop)
    whole = synthetic.client_params(base, torch.arange(12), log_pop,
                                    spec.vocab_size)
    parts = [synthetic.client_params(base, torch.arange(a, b), log_pop,
                                     spec.vocab_size)
             for a, b in ((0, 5), (5, 6), (6, 12))]
    for i, got in enumerate(zip(*parts)):
        if i == 3:
            got = [torch.stack(k, -1) for k in got]
            expect = torch.stack(whole[3], -1)
        else:
            expect = whole[i]
        assert torch.equal(torch.cat(list(got)), expect)


def test_vocabularies_at_full_width():
    """The §4 width (d = 20,002, V = 400), the first 128 clients of seed 0:
    every vocabulary is the reference's set, and a client whose order
    differs is counted; its first swapped pair of the reference's Gumbel
    scores lies within 4 ulp.  Observed: 0 of 128 (and of 300) differ."""
    vds = ref_synthetic.virtual_dataset(ref_config(), 0)
    assert (vds.num_features, vds.vocab_size) == (20_002, 400)
    C = 128
    ids = np.arange(C, dtype=np.uint32)
    vocab = _ref_params(vds, ids)[0][:C]
    scores = np.asarray(jax.jit(jax.vmap(
        lambda c: vds.log_pop + jax.random.gumbel(jax.random.fold_in(
            jax.random.fold_in(vds.base_key, c), 1), vds.log_pop.shape)))(
        ids))
    base = threefry.as_key(threefry.PRNGKey(0), "cpu")
    got = synthetic.client_params(base, torch.arange(C),
                                  torch.tensor(np.asarray(vds.log_pop)),
                                  vds.vocab_size)[0].numpy()
    differ = []
    for k in range(C):
        assert set(got[k]) == set(vocab[k])
        if (got[k] != vocab[k]).any():
            j = int(np.argmax(got[k] != vocab[k]))
            a, b = scores[k][got[k][j] - 2], scores[k][vocab[k][j] - 2]
            ulp = np.spacing(np.float32(max(abs(a), abs(b))))
            assert abs(float(a) - float(b)) <= 4 * ulp, (k, j, a, b)
            differ.append(k)
    print(f"clients whose vocabulary order differs: {len(differ)} of {C}"
          f" {differ}")
    assert len(differ) <= C // 10
