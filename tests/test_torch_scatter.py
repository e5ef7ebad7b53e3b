"""``repro_torch.utils.scatter``: the fixed-order sums the card's full
gradients go through, run here on CPU tensors.

``fixed_order_index_add`` (the CUDA path) against ``index_add_`` in f64,
below and above one block, with an index that repeats in every row as the
full gradient's bias feature does; the CPU entries are ``index_add_`` and
``scatter_add_`` themselves, bit for bit.  That the CUDA path repeats bit
for bit is a property of CUDA's sorted ``index_put_`` (the CPU's adds in
parallel): ``tests/test_torch_cuda.py`` holds it on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import scatter  # noqa: E402


def _terms(n, d, seed=0):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, d, n)
    index[::7] = 0                      # a slot every row touches
    return (torch.from_numpy(index),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)))


@pytest.mark.parametrize("n,slice_", [
    (1_000, None), (scatter.BLOCK, None), (3 * scatter.BLOCK + 5, None),
    (5 * scatter.BLOCK + 3, 2 * scatter.BLOCK)])
def test_fixed_order_index_add_sums_every_term(n, slice_, monkeypatch):
    """The last case goes through three slices of terms."""
    if slice_ is not None:
        monkeypatch.setattr(scatter, "SLICE", slice_)
    d = 97
    index, src = _terms(n, d)
    start = torch.linspace(-1, 1, d)
    got = scatter.fixed_order_index_add(start.clone(), index, src)
    want = start.double().index_add_(0, index, src.double())
    # 1e-6 (about 17 f32 unit roundoffs) of each slot's sum of magnitudes:
    # slot 0 sums n / 7 terms, and a sequential f32 sum of k terms may err
    # by up to k roundoffs of it
    size = 1.0 + torch.zeros(d, dtype=torch.float64).index_add_(
        0, index, src.double().abs())
    err = (got.double() - want).abs()
    assert bool((err <= 1e-6 * size).all()), float((err / size).max())


def test_the_cpu_entries_are_index_add_and_scatter_add():
    index, src = _terms(5_000, 31)
    assert torch.equal(scatter.index_add(torch.zeros(31), index, src),
                       torch.zeros(31).index_add_(0, index, src))
    rows, srows = index.reshape(50, 100), src.reshape(50, 100)
    assert torch.equal(
        scatter.scatter_add_rows(torch.zeros(50, 31), rows, srows),
        torch.zeros(50, 31).scatter_add_(1, rows, srows))
