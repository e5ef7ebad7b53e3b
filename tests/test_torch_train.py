"""The port's training path against the reference's, on the CPU: the
reduced rwkv6-3b (2 layers, d 256, 4 heads of 64, d_ff 512, vocab 1,024)
in f32 with the reference's ``init(PRNGKey(0))`` weights carried across by
``repro_torch.bridge``, and the same numpy batches.

Tolerances, each beside what was observed:

* ``rms_norm``'s and ``lm_head_loss``'s values and gradients: f32 in
  other orders, 1e-5 of the max (observed ≤ 3.5e-7); the optimizers the
  same (observed equal);
* ``model.loss`` 1e-6 relative (observed equal) and its gradients 5e-5 of
  each leaf's max (observed ≤ 4.7e-6).  The gradient is badly
  conditioned at a sequence's first tokens: token 0's WKV output is 0 and
  token 1's is v_0 scaled, so the group norm's rsqrt(var + 1e-5)
  amplifies rounding; the reference's own gradient moves by 1.8e-5 of a
  leaf's max when its weights are perturbed by 1e-7 relative
  (``test_tolerances_cover_rounding_level_perturbations``);
* one FSVRG / FedAvg round: every leaf at 1e-5 of max |w| (the ROADMAP's
  calibration; observed ≤ 4.1e-6), ``full_grad_norm`` 1e-4 relative
  (observed 2.0e-5; at the card test's inputs a 1e-7 perturbation of the
  weights moves the port's own round by 1.0e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro import optim as ref_optim  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import neural as ref_neural  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import neural  # noqa: E402
from repro_torch.examples import federated_lm  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

F32_TOL = 1e-5
GRAD_TOL = 5e-5


def _rel(got, expect):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    expect = np.asarray(expect, np.float64)
    assert got.shape == expect.shape
    return np.abs(got - expect).max() / max(np.abs(expect).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def models():
    """The reference model and its params, and the port's with the same
    weights, in f32."""
    ref_cfg = ref_get_config("rwkv6-3b").reduced()
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_config("rwkv6-3b").reduced(), torch.float32,
                     device="cpu")
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


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gradient_matches_the_reference_vjp(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jy, vjp = jax.vjp(lambda a, b: ref_layers.rms_norm(a, b, 1e-5), jx,
                      jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(dtype))
    tx = bridge.tensor_like_array(np.asarray(jx), "cpu").requires_grad_()
    tw = torch.tensor(w, requires_grad=True)
    ty = layers.rms_norm(tx, tw, 1e-5)
    dx, dw = torch.autograd.grad(
        ty, [tx, tw], bridge.tensor_like_array(np.asarray(jnp.asarray(g)
                                                          .astype(dtype)),
                                               "cpu"))
    assert ty.dtype == dx.dtype == tx.dtype and dw.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else 1e-2    # a bf16 ulp is 2^-8
    assert _rel(ty.float(), jnp.asarray(jy, jnp.float32)) <= tol
    assert _rel(dx.float(), jnp.asarray(jdx, jnp.float32)) <= tol
    assert _rel(dw, jdw) <= F32_TOL


@pytest.mark.parametrize("S,chunk", [(64, 2048), (64, 16), (40, 16)],
                         ids=["one-chunk", "four-chunks", "ragged"])
def test_lm_head_loss_and_gradients_match(S, chunk):
    rng = np.random.default_rng(S + chunk)
    B, d, V = 2, 32, 96
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)

    def f(x, e):
        return ref_layers.lm_head_loss(x, e, jnp.asarray(labels, jnp.int32),
                                       jnp.asarray(mask), chunk=chunk)

    jl, (jdx, jde) = jax.value_and_grad(f, argnums=(0, 1))(x, emb)
    tx, te = (torch.tensor(a, requires_grad=True) for a in (x, emb))
    tl = layers.lm_head_loss(tx, te, torch.tensor(labels), torch.tensor(mask),
                             chunk=chunk)
    dx, de = torch.autograd.grad(tl, [tx, te])
    assert abs(float(tl.detach()) - float(jl)) <= F32_TOL * abs(float(jl))
    assert _rel(dx, jdx) <= F32_TOL and _rel(de, jde) <= F32_TOL
    # an all-zero mask divides by 1, not 0
    zero = layers.lm_head_loss(tx, te, torch.tensor(labels),
                               torch.zeros((B, S)), chunk=chunk)
    assert float(zero.detach()) == 0.0


# --------------------------------------------------------------------- #
# the model's loss
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("S", [64, 40], ids=["S64", "ragged-S40"])
def test_model_loss_and_gradients_match_the_reference(models, S):
    """S = 40 runs the wkv6 path over 32 tokens and the sequential tail over
    8 in the port (the reference runs a ragged S sequentially)."""
    jm, jp, pm, pp = models
    b = _batch(S, (2,), S, pm.cfg.vocab_size, holes=True)
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, b))
    names, leaves = zip(*pp.named_parameters())
    tl, taux = pm.loss(pp, bridge.batch_from_arrays(b, "cpu"))
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert taux["ce"] is tl and float(taux["aux"]) == 0.0
    port = _leaves(bridge.tree_from_params(dict(zip(names, grads))))
    expect = _leaves(jg)
    assert port.keys() == expect.keys()
    for k in expect:
        assert _rel(port[k], expect[k]) <= GRAD_TOL, k


def test_remat_changes_nothing_but_the_recompute(models):
    """stack_forward with remat: the same hidden states and gradients, the
    layers' forward run again in the backward."""
    _, _, pm, pp = models
    x = torch.randn((2, 64, pm.cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    calls = []
    orig = transformer.R.rwkv_time_mix

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    out = {}
    transformer.R.rwkv_time_mix = counted
    try:
        for remat in (False, True):
            calls.clear()
            xr = x.clone().requires_grad_()
            h, _ = transformer.stack_forward(pp.layers, pm.cfg, xr,
                                             remat=remat)
            grads = torch.autograd.grad(h.square().sum(),
                                        [xr, *pp.layers.parameters()])
            out[remat] = (h, grads, len(calls))
    finally:
        transformer.R.rwkv_time_mix = orig
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    n = pm.cfg.num_layers
    assert out[False][2] == n and out[True][2] == 2 * n


def test_prefill_still_builds_no_graph(models):
    _, _, pm, pp = models
    toks = torch.randint(0, pm.cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    logits, cache = pm.prefill(pp, {"tokens": toks})
    assert not logits.requires_grad
    assert all(p.requires_grad for p in pp.parameters())


# --------------------------------------------------------------------- #
# the federated round
# --------------------------------------------------------------------- #


def _rounds(models, fed_kw, seed=0, C=2, T=2, S=64):
    jm, jp, pm, pp = models
    b = _batch(seed, (C, T, 2), S, pm.cfg.vocab_size)
    jfn = jax.jit(ref_neural.make_fsvrg_round(
        jm, ref_neural.FedNeuralConfig(local_steps=T, **fed_kw)))
    jnew, jmet = jfn(jp, jax.tree.map(jnp.asarray, b))
    pfn = neural.make_fsvrg_round(
        pm, neural.FedNeuralConfig(local_steps=T, **fed_kw))
    before = {n: p.detach().clone() for n, p in pp.named_parameters()}
    pnew, pmet = pfn(pp, bridge.batch_from_arrays(b, "cpu"))
    for n, p in pp.named_parameters():          # the round is functional
        assert torch.equal(p, before[n])
    return _leaves(jnew), jmet, bridge.tree_from_params(pnew), pmet, pnew


@pytest.mark.parametrize("fed_kw", [
    dict(algorithm="fsvrg", stepsize=0.3),
    dict(algorithm="fedavg", stepsize=0.3),
    dict(algorithm="fsvrg", stepsize=0.3, use_S=False),
    dict(algorithm="fsvrg", stepsize=0.3, use_A=False),
], ids=["fsvrg", "fedavg", "fsvrg-no-S", "fsvrg-no-A"])
def test_round_matches_the_reference(models, fed_kw):
    jn, jmet, tree, pmet, _ = _rounds(models, fed_kw)
    port = _leaves(tree)
    assert port.keys() == jn.keys()
    scale = max(np.abs(v).max() for v in jn.values())
    for k in jn:
        err = np.abs(port[k].astype(np.float64) - jn[k]).max() / scale
        assert err <= F32_TOL, (k, err)
    gn, pg = float(jmet["full_grad_norm"]), float(pmet["full_grad_norm"])
    assert abs(pg - gn) <= 1e-4 * gn


def test_stepsize_zero_is_the_identity(models):
    _, _, tree, _, _ = _rounds(models, dict(stepsize=0.0), C=2, T=1)
    _, _, _, pp = models
    before = _leaves(bridge.tree_from_params(pp))
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(v, before[k])


def test_vocab_stats_semantics():
    """The reference's tests/test_neural.py::test_vocab_stats_semantics."""
    vocab = 16
    # client 0 uses tokens {0,1}, client 1 uses {2,3} -> omega=1 for all, a=2
    tokens = torch.tensor([[[0, 1, 0, 1]], [[2, 3, 2, 3]]])
    phi, omega, a = neural.vocab_stats(tokens, vocab)
    np.testing.assert_allclose(phi[:4].numpy(), 0.25)
    assert (omega[:4] == 1).all()
    np.testing.assert_allclose(a[:4].numpy(), 2.0)     # C/omega = 2/1
    np.testing.assert_allclose(a[4:].numpy(), 1.0)     # unseen tokens
    s0 = neural.s_k_vocab(phi, tokens[0].reshape(-1), vocab)
    # client 0 sees tokens 0,1 with local freq 0.5 vs global 0.25 -> s=0.5
    np.testing.assert_allclose(s0[:2].numpy(), 0.5)
    np.testing.assert_allclose(s0[2:].numpy(), 1.0)
    # and the reference's numbers on a random batch, bit for bit
    toks = np.random.default_rng(0).integers(0, 64, (3, 5, 7))
    ref = ref_neural.vocab_stats(jnp.asarray(toks), 64)
    port = neural.vocab_stats(torch.tensor(toks), 64)
    for a_, b_ in zip(port, ref):
        np.testing.assert_array_equal(a_.numpy(), np.asarray(b_))
    np.testing.assert_array_equal(
        neural.s_k_vocab(port[0], torch.tensor(toks[1]).reshape(-1),
                         64).numpy(),
        np.asarray(ref_neural.s_k_vocab(ref[0], jnp.asarray(toks[1])
                                        .reshape(-1), 64)))


def test_vocab_row_params_and_client_batches(models):
    _, _, pm, pp = models
    V = pm.cfg.vocab_size
    rows = [n for n, p in pp.named_parameters()
            if neural._is_vocab_row_param(n, V, p.shape)]
    assert rows == ["embed"]                 # unembed is (d, V): not a row
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int64)}
    cb = neural.make_client_batches(batch, num_clients=4, local_steps=2)
    assert cb["tokens"].shape == (4, 2, 1, 16)
    with pytest.raises(ValueError):
        neural.make_client_batches(batch, num_clients=3, local_steps=2)


# --------------------------------------------------------------------- #
# optimizers and the AdamW step
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("adamw", {}),
    ("adamw", dict(weight_decay=0.1))], ids=["sgd", "momentum", "adamw",
                                            "adamw-wd"])
def test_optimizers_match_the_reference_over_three_steps(name, kw):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal((6,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = ref_optim.get(name, 0.1, **kw)
    topt = optim.get(name, 0.1, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, jnp.asarray(i, jnp.int32))
        tp, ts = topt.update(tp, {k: torch.tensor(v) for k, v in g.items()},
                             ts, i)
    for k in params:
        assert _rel(tp[k], jp[k]) <= F32_TOL


def test_optimizer_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.ones((3, 3), dtype=torch.bfloat16)}
    g = {"w": torch.full((3, 3), 0.5, dtype=torch.bfloat16)}
    opt = optim.adamw(0.1)
    new, st = opt.update(p, g, opt.init(p), 0)
    assert new["w"].dtype == torch.bfloat16 and st["m"]["w"].dtype == torch.float32
    assert torch.equal(p["w"], torch.ones((3, 3), dtype=torch.bfloat16))


def test_adamw_step_matches_the_reference(models):
    """One step through launch.steps.make_adamw_step.  Adam's first step
    is lr·g/(|g| + eps) ≈ lr·sign(g): where |g| is near eps = 1e-8 the two
    packages' rounding of g decides it, so the weights are held at 1e-5 of
    max |w| where the reference's |g| ≥ 1e-4 (observed 2.5e-9) and within
    the step's bound 2·lr everywhere (observed 5.2e-4 = 1.7·lr)."""
    jm, jp, pm, pp = models
    b = _batch(3, (2,), 32, pm.cfg.vocab_size)
    lr = 3e-4
    jopt = ref_optim.adamw(lr)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, b))
    jnew, _ = jopt.update(jp, jg, jopt.init(jp), jnp.zeros((), jnp.int32))
    opt = optim.adamw(lr)
    step = steps.make_adamw_step(pm, opt)
    new, state, n, loss, metrics = step(
        pp, opt.init(dict(pp.named_parameters())), 0,
        bridge.batch_from_arrays(b, "cpu"))
    assert n == 1 and abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    assert set(metrics) == {"ce", "aux"}
    expect, grads = _leaves(jnew), _leaves(jg)
    port = _leaves(bridge.tree_from_params(new))
    scale = max(np.abs(v).max() for v in expect.values())
    for k in expect:
        err = np.abs(port[k] - expect[k])
        assert err.max() <= 2 * lr, k
        firm = np.abs(grads[k]) >= 1e-4
        assert (err[firm].max(initial=0.0) <= F32_TOL * scale), k


# --------------------------------------------------------------------- #
# the drivers and the bridge
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["fsvrg", "fedavg", "adamw"])
def test_train_main_runs_on_the_cpu(mode, capsys):
    logged = train.main(["--arch", "rwkv6-3b", "--mode", mode, "--device",
                         "cpu", "--rounds", "2", "--log-every", "1",
                         "--seq", "32"])
    assert [r for r, _ in logged] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in logged)
    assert "rwkv6-3b-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--production-mesh", "--checkpoint-dir",
                                   "ckpt"],
                                  ["--production-mesh"]])
def test_train_main_refuses_what_is_not_ported(flag):
    """``--production-mesh`` (ROADMAP N7) raises before anything runs,
    with a checkpoint directory or without; ``--checkpoint-dir`` itself is
    ported (``tests/test_torch_checkpoint.py``)."""
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", *flag])


def test_federated_lm_example_runs_on_the_cpu():
    loss = federated_lm.main(["--device", "cpu", "--rounds", "2",
                              "--local-steps", "1", "--seq", "32",
                              "--batch-per-client", "1", "--clients", "2"])
    assert np.isfinite(loss)
    with pytest.raises(NotImplementedError):
        federated_lm.main(["--arch", "phi3.5-moe-42b-a6.6b", "--device",
                           "cpu"])


def test_tree_from_params_inverts_params_from_tree(models):
    _, jp, pm, pp = models
    back = _leaves(bridge.tree_from_params(pp))
    expect = _leaves(jp)
    assert back.keys() == expect.keys()
    for k in expect:
        np.testing.assert_array_equal(back[k], expect[k])
    cfg4 = dataclasses.replace(pm.cfg, num_layers=4)
    m4 = build_model(cfg4, torch.bfloat16, device="cpu")
    p4 = m4.init(torch.Generator().manual_seed(0))
    tree = bridge.tree_from_params(p4)
    assert tree["layers"]["pos0"]["norm1"].shape == (4, pm.cfg.d_model)
    assert tree["embed"].dtype == np.float32      # bf16, widened exactly
    again = bridge.params_from_tree(tree, m4)
    for (n, a), (_, b) in zip(p4.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a.to(b.dtype), b), n


def _perturbed(tree_or_params, seed):
    """Every weight times (1 + 1e-7·N(0, 1)): rounding-level noise."""
    rng = np.random.default_rng(seed)
    if isinstance(tree_or_params, torch.nn.Module):
        p = {n: t.detach() * (1 + 1e-7 * torch.tensor(
            rng.standard_normal(t.shape), dtype=torch.float32))
            for n, t in tree_or_params.named_parameters()}
        return type(tree_or_params).from_named(p)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)),
        a.dtype), tree_or_params)


def test_tolerances_cover_rounding_level_perturbations(models):
    """The loss's gradient and the round are badly conditioned at a
    sequence's first tokens (token 0's WKV output is 0, token 1's a
    multiple of v_0, and the group norm's rsqrt(var + 1e-5) amplifies), so
    a rounding-level change of the weights moves them far more than an
    ulp.  Measured here: the reference's gradient at the S = 64 batch of
    the loss test moves by 1.8e-5 of a leaf's max, the port's round at
    the card test's inputs (its own init, C = 2, T = 2, 2 × 64 tokens,
    h = 0.3) by 3.5e-4 of max |w| and |∇f| by 1.0e-4 relative.  The
    comparisons' tolerances stay above them: GRAD_TOL here, 1e-3 for the
    round on the card against the CPU (tests/test_torch_cuda.py,
    chip_smoke.py)."""
    jm, jp, pm, _ = models
    b = jax.tree.map(jnp.asarray, _batch(64, (2,), 64, pm.cfg.vocab_size,
                                         holes=True))

    def grads(p):
        return _leaves(jax.grad(lambda q: jm.loss(q, b)[0])(p))

    g0, g1 = grads(jp), grads(_perturbed(jp, 1))
    assert max(_rel(g1[k], g0[k]) for k in g0) <= GRAD_TOL

    p0 = pm.init(torch.Generator().manual_seed(0))
    batch = train.synthetic_batch(np.random.default_rng(0), pm.cfg, 2, 2, 2,
                                  64, "cpu")
    rnd = neural.make_fsvrg_round(pm, neural.FedNeuralConfig(
        stepsize=0.3, local_steps=2))
    (a, ma), (c, mc) = rnd(p0, batch), rnd(_perturbed(p0, 5), batch)
    scale = max(float(t.detach().abs().max()) for t in a.parameters())
    moved = max(float((x - y).detach().abs().max())
                for x, y in zip(a.parameters(), c.parameters())) / scale
    gn = float(ma["full_grad_norm"])
    assert moved <= 1e-3
    assert abs(float(mc["full_grad_norm"]) - gn) <= 1e-3 * gn
