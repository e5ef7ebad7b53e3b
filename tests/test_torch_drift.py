"""``drifted_dataset`` on the port against the reference's: an epoch's rows
bit for bit.

At scale 0.002, epochs 0–3 under concept drift alone (w_true × 0.8^e), under
resampled clients alone, and under both (× 1.1^e): the materialized train
and test ``idx`` / ``val`` / ``y`` equal the reference's exactly.  The
drift factor is XLA's integer power of an f32 (repeated squaring, rounded
after each product), which ``pow_f32`` reproduces — a correctly rounded
power would move ``w_true`` by an ulp and can flip a label.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_logreg_config as ref_get_logreg_config  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

SCALE = 0.002
FIELDS = ("idx", "val", "y", "client_of", "test_idx", "test_val", "test_y",
          "test_client_of")


@pytest.fixture(scope="module")
def specs():
    ref = ref_synthetic.virtual_dataset(
        ref_get_logreg_config().scaled(SCALE), seed=0)
    port = synthetic.virtual_dataset(get_logreg_config().scaled(SCALE), 0,
                                     device="cpu")
    return ref, port


@pytest.mark.parametrize("w_scale,resample", [(0.8, False), (1.0, True),
                                               (1.1, True)])
def test_drifted_epochs_are_the_references_rows(specs, w_scale, resample):
    ref, port = specs
    for epoch in range(4):
        rv = ref_synthetic.drifted_dataset(
            ref, epoch, w_true_scale=w_scale, resample_clients=resample)
        pv = synthetic.drifted_dataset(
            port, epoch, w_true_scale=w_scale, resample_clients=resample)
        np.testing.assert_array_equal(
            pv.w_true.numpy().view(np.uint32),
            np.asarray(rv.w_true).view(np.uint32))
        assert tuple(int(w) for w in pv.base_key) == tuple(
            int(w) for w in np.asarray(rv.base_key))
        rds = ref_synthetic.materialize_dataset(rv)
        pds = synthetic.materialize_dataset(pv)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(pds, f).numpy(), np.asarray(getattr(rds, f)),
                err_msg=f"epoch {epoch}, {f}")


def test_epoch_zero_is_the_identity_and_a_negative_epoch_raises(specs):
    _, port = specs
    assert synthetic.drifted_dataset(port, 0, w_true_scale=0.5,
                                     resample_clients=True) is port
    with pytest.raises(ValueError, match="epoch"):
        synthetic.drifted_dataset(port, -1)


def test_drift_keeps_the_shapes_and_changes_the_rows(specs):
    _, port = specs
    base = synthetic.materialize_dataset(port)
    drifted = synthetic.materialize_dataset(synthetic.drifted_dataset(
        port, 2, resample_clients=True))
    np.testing.assert_array_equal(drifted.client_sizes, base.client_sizes)
    assert drifted.idx.shape == base.idx.shape
    assert not torch.equal(drifted.idx, base.idx)


@pytest.mark.parametrize("scale", [0.8, 0.9, 1.1, 1.3, 0.37, 2.0])
def test_pow_f32_is_xlas_integer_power(scale):
    """Every epoch to 40, bit for bit: 0.8 ** 4 is 0.40960005 in XLA (and
    here), where correct rounding gives 0.40960002."""
    for e in range(1, 41):
        got = synthetic.pow_f32(scale, e)
        expect = np.asarray(jnp.float32(scale) ** e)
        assert got.dtype == np.float32
        assert got.view(np.uint32) == expect.view(np.uint32), (scale, e)
    assert float(synthetic.pow_f32(0.8, 4)) == float(np.float32(0.40960005))
