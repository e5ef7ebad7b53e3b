"""The port's training path on the dense attention family against the
reference's, on the CPU: each reduced dense config (2 layers, d 256, 4
query heads of 64) in f32 with the reference's ``init(PRNGKey(0))``
weights carried across by ``repro_torch.bridge`` and the same numpy
batches, and the entry points with ``--arch llama3-8b``.

Tolerances, each beside what was observed:

* ``model.loss`` 1e-6 relative (observed ≤ 1.4e-7) and its gradients
  5e-5 of each leaf's max, as for RWKV-6 (observed ≤ 2.7e-6): f32 in
  other orders (SDPA's backward against XLA's of the blocked softmax);
* one FSVRG / FedAvg round of reduced danube (its 64-token window binding
  at S = 96): every leaf at 1e-5 of max |w| (the ROADMAP's calibration;
  observed 1.2e-7), ``full_grad_norm`` 1e-4 relative (observed 4.0e-5).
  The reference's round runs eagerly here: under ``jax.jit`` its
  ``full_grad_norm`` on this input is 2.339479, 3.2e-3 below its own
  eager round's 2.347064 (the port's: 2.347157); on a T = 2 batch
  ``jax.grad`` of the same mean loss, jitted or not, agreed with the
  eager round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import neural as ref_neural  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import neural  # noqa: E402
from repro_torch.examples import federated_lm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

DENSE = ("llama3-8b", "h2o-danube-1.8b", "codeqwen1.5-7b", "granite-20b")
F32_TOL = 1e-5
GRAD_TOL = 5e-5


def _rel(got, expect):
    got = np.asarray(got, np.float64)
    expect = np.asarray(expect, np.float64)
    assert got.shape == expect.shape
    return np.abs(got - expect).max() / max(np.abs(expect).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(arch):
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    return jm, jp, pm, pp


def _batch(seed, lead, S, vocab, holes=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(*lead, S + 1))
    mask = np.ones((*lead, S), np.float32)
    if holes:
        mask = (rng.random((*lead, S)) > 0.1).astype(np.float32)
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32), "mask": mask}


@pytest.mark.parametrize("arch", DENSE)
def test_model_loss_and_gradients_match_the_reference(arch):
    """2 sequences of 96 tokens with holes in the mask (past the reduced
    danube's window of 64): the loss and every leaf of its gradient
    against ``jax.grad`` of the reference's loss."""
    jm, jp, pm, pp = _models(arch)
    b = _batch(1, (2,), 96, pm.cfg.vocab_size, holes=True)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, b))
    names, leaves = zip(*pp.named_parameters())
    tl, taux = pm.loss(pp, bridge.batch_from_arrays(b, "cpu"))
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert float(taux["aux"]) == 0.0
    port = _leaves(bridge.tree_from_params(dict(zip(names, grads))))
    expect = _leaves(jg)
    assert port.keys() == expect.keys()
    for k in expect:
        assert _rel(port[k], expect[k]) <= GRAD_TOL, k


@pytest.fixture(scope="module")
def danube():
    return _models("h2o-danube-1.8b")


@pytest.mark.parametrize("algorithm", ["fsvrg", "fedavg"])
def test_round_of_reduced_danube_matches_the_reference(danube, algorithm):
    """One neural round (C = 2 clients, T = 1 local step, 2 × 96 tokens
    a step) of reduced danube, the reference's run eagerly: every leaf and
    the full gradient's norm."""
    jm, jp, pm, pp = danube
    b = _batch(2, (2, 1, 2), 96, pm.cfg.vocab_size)
    kw = dict(algorithm=algorithm, stepsize=0.3, local_steps=1)
    jnew, jmet = ref_neural.make_fsvrg_round(
        jm, ref_neural.FedNeuralConfig(**kw))(jp, jax.tree.map(jnp.asarray, b))
    pnew, pmet = neural.make_fsvrg_round(pm, neural.FedNeuralConfig(**kw))(
        pp, bridge.batch_from_arrays(b, "cpu"))
    expect, port = _leaves(jnew), _leaves(bridge.tree_from_params(pnew))
    assert port.keys() == expect.keys()
    scale = max(np.abs(v).max() for v in expect.values())
    for k in expect:
        err = np.abs(port[k].astype(np.float64) - expect[k]).max() / scale
        assert err <= F32_TOL, (k, err)
    gn, pg = float(jmet["full_grad_norm"]), float(pmet["full_grad_norm"])
    assert abs(pg - gn) <= 1e-4 * gn


@pytest.mark.parametrize("mode", ["fsvrg", "adamw"])
def test_train_main_runs_a_dense_arch_on_the_cpu(mode, capsys):
    logged = train.main(["--arch", "llama3-8b", "--mode", mode, "--device",
                         "cpu", "--rounds", "2", "--log-every", "1",
                         "--seq", "32"])
    assert [r for r, _ in logged] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in logged)
    assert "llama3-8b-reduced" in capsys.readouterr().out


def test_federated_lm_example_runs_a_dense_arch_on_the_cpu(capsys):
    loss = federated_lm.main(["--arch", "llama3-8b", "--device", "cpu",
                              "--rounds", "2", "--local-steps", "1", "--seq",
                              "32", "--batch-per-client", "1", "--clients",
                              "2"])
    assert np.isfinite(loss)
    assert "llama3-8b-reduced-100m" in capsys.readouterr().out
