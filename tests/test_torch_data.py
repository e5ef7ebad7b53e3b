"""The port's synthetic data against the reference's.

Sizes and ``w_true`` come from the same numpy stream and must be bit-equal.
The rows are held here to the reference's structure and statistics; since
the port draws them from JAX's threefry too, ``test_torch_synthetic_rows``
holds them bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_logreg_config as ref_logreg_config  # noqa: E402
from repro.data.synthetic import generate as ref_generate  # noqa: E402
from repro.data.synthetic import virtual_dataset  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.data import data_spec, generate, train_split_sizes  # noqa: E402

SCALE = 0.002


@pytest.fixture(scope="module")
def port_dataset():
    return generate(get_logreg_config().scaled(SCALE), seed=0, device="cpu")


def test_configs_are_the_references():
    for scale in (SCALE, 1.0):
        assert (dataclasses.asdict(get_logreg_config().scaled(scale))
                == dataclasses.asdict(ref_logreg_config().scaled(scale)))
    full = get_logreg_config()
    assert (full.num_clients, full.num_features, full.num_examples,
            full.nnz_per_example) == (10_000, 20_002, 2_166_693, 60)


@pytest.mark.parametrize("seed", [0, 3])
def test_sizes_and_ground_truth_are_bit_equal(small_dataset, seed):
    cfg = get_logreg_config().scaled(SCALE)
    spec = data_spec(cfg, seed)
    ref = virtual_dataset(ref_logreg_config().scaled(SCALE), seed)
    np.testing.assert_array_equal(spec.full_sizes, ref.full_sizes)
    np.testing.assert_array_equal(spec.client_sizes, ref.client_sizes)
    np.testing.assert_array_equal(spec.w_true, np.asarray(ref.w_true))
    np.testing.assert_array_equal(spec.log_pop, np.asarray(ref.log_pop))
    np.testing.assert_array_equal(spec.global_cdf, np.asarray(ref.global_cdf))
    assert (spec.nnz, spec.vocab_size, spec.n_own) == (ref.nnz,
                                                       ref.vocab_size,
                                                       ref.n_own)
    np.testing.assert_array_equal(train_split_sizes(spec.full_sizes),
                                  spec.client_sizes)
    if seed == 0:
        np.testing.assert_array_equal(
            generate(cfg, seed, device="cpu").client_sizes,
            small_dataset.client_sizes)


def test_rows_have_the_references_structure(port_dataset, small_dataset):
    ds, ref = port_dataset, small_dataset
    d = ds.num_features
    assert ds.idx.shape[1] == ref.idx.shape[1]
    assert ds.num_examples == ref.num_examples
    assert ds.test_y.shape[0] == ref.test_y.shape[0]
    for idx, val, y in ((ds.idx, ds.val, ds.y),
                        (ds.test_idx, ds.test_val, ds.test_y)):
        assert idx.dtype == torch.int64 and val.dtype == torch.float32
        assert int(idx.min()) >= 0 and int(idx.max()) < d
        assert torch.equal(idx[:, 0], torch.zeros_like(idx[:, 0]))
        assert torch.equal(idx[:, 1], torch.ones_like(idx[:, 1]))
        assert bool((val[:, :2] == 1).all())
        assert set(val.unique().tolist()) <= {0.0, 1.0}
        assert set(y.unique().tolist()) <= {-1.0, 1.0}
        assert int(idx[:, 2:].min()) >= 2           # bias / unk stay special
        # a feature keeps value 1 exactly once per row, repeats are zeroed
        for i in range(0, idx.shape[0], 97):
            live = idx[i][val[i] == 1]
            assert live.unique().numel() == live.numel()
            assert set(idx[i].tolist()) == set(live.tolist())
    # client-contiguous, chronological split by the shared rule
    counts = np.bincount(ds.client_of.numpy(), minlength=ds.num_clients)
    np.testing.assert_array_equal(counts, ds.client_sizes)
    assert bool((ds.client_of[1:] >= ds.client_of[:-1]).all())


def test_label_share_matches_the_reference():
    """The positive-label share, pooled over four seeds at scale 0.02 (200
    clients): one seed's share swings by ±0.1 with its clients' label biases
    at the 20 clients of scale 0.002, so a single small draw cannot be held
    to 0.03.  Observed: 0.4142 (port) vs 0.4162 (reference)."""
    cfg, ref_cfg = get_logreg_config().scaled(0.02), ref_logreg_config(
    ).scaled(0.02)
    pos = ref_pos = total = 0
    for seed in range(4):
        ds = generate(cfg, seed, device="cpu")
        ref = ref_generate(ref_cfg, seed)
        assert ds.num_examples == ref.num_examples
        pos += int((ds.y > 0).sum())
        ref_pos += int((ref.y > 0).sum())
        total += ds.num_examples
    share, ref_share = pos / total, ref_pos / total
    assert abs(share - ref_share) < 0.03, (share, ref_share)


def test_same_seed_same_data():
    cfg = get_logreg_config().scaled(0.001)
    a, b = (generate(cfg, 1, device="cpu") for _ in range(2))
    c = generate(cfg, 2, device="cpu")
    assert torch.equal(a.idx, b.idx) and torch.equal(a.y, b.y)
    assert a.num_examples != c.num_examples or not torch.equal(a.idx, c.idx)
