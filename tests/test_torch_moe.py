"""The port's MoE family against the reference's, on the CPU: the router
(``route_topk``), the load-balance loss, ``core.scaling.expert_occupancy``
and ``moe_fwd`` on the same numpy inputs — reduced phi3.5-moe (E = 4,
top-2: capacity C = S, nothing dropped), a top-4 config (dbrx's k on E = 8:
the reduced config caps k at 2), capacity factor 0.5 and E = 8 with top-2
(tokens dropped), forced ties — and each reduced model in f32 with the
reference's ``init(PRNGKey(0))`` weights carried across by
``repro_torch.bridge``: prefill logits and cache, a decode step from the
reference's own cache, ``model.loss`` (ce + load_balance_weight · aux)
with its gradients against ``jax.grad``, one FSVRG neural round against
the reference's round run eagerly, and the entry points with
``--arch phi3.5-moe-42b-a6.6b`` and ``--arch dbrx-132b``.

Tolerances, each beside what was observed:

* f32: the same f32 terms summed in other orders (XLA's dots against
  torch's bmm): 1e-5 of the quantity's max plus rtol 1e-5 for ``moe_fwd``
  (observed ≤ 8.2e-7) and the model's prefill logits and cache (observed
  ≤ 1.9e-6), the decode steps held the same; the load-balance loss and
  the loss's ce and aux 1e-6 relative (observed ≤ 2.2e-7);
* the router's mask, the gathered token indices and the expert counts:
  equal;
* bf16 ``moe_fwd``: XLA keeps f32 between fused elementwise bf16
  operations where torch rounds each one, and the k outputs and their
  combine weights are rounded to bf16 once more: 2e-2 of the output's
  max, two bf16 ulps of it (observed ≤ 9.0e-3);
* gradients of ``model.loss`` and of ``moe_fwd`` with tokens dropped:
  5e-5 of each leaf's max, as for the dense family (observed ≤ 3.0e-6
  and ≤ 8.1e-7): f32 in other orders;
* one FSVRG round of reduced phi3.5 (the reference's run eagerly, as in
  ``test_torch_dense_train.py``: its jitted round's ``full_grad_norm`` is
  8e-4 off its eager one here): every leaf at 1e-5 of max |w| (the
  ROADMAP's calibration; observed 4.7e-8), ``full_grad_norm`` 1e-4
  relative (observed 3.3e-5).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core import neural as ref_neural  # noqa: E402
from repro.core import scaling as ref_scaling  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import neural, scaling  # noqa: E402
from repro_torch.examples import federated_lm  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402

PHI, DBRX = "phi3.5-moe-42b-a6.6b", "dbrx-132b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 5e-5

#: name -> (arch, (E, k) in place of the reduced config's, or None)
CONFIGS = {"phi3.5": (PHI, None), "dbrx-top4": (DBRX, (8, 4)),
           "phi3.5-e8": (PHI, (8, 2))}


def _configs(name):
    """The reference's and the port's reduced config of ``name``."""
    arch, ek = CONFIGS[name]
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if ek is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=RefMoEConfig(*ek))
        cfg = dataclasses.replace(cfg, moe=MoEConfig(*ek))
    return ref_cfg, cfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, expect):
    got, expect = _np(got).astype(np.float64), _np(expect).astype(np.float64)
    assert got.shape == expect.shape
    return np.abs(got - expect).max() / max(np.abs(expect).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, expect, tol):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1e-30))


def _pair(a, dtype):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, bridge.tensor_like_array(np.asarray(j), "cpu")


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", [PHI, DBRX])
def test_moe_configs_are_the_reference_configs(arch):
    ours, theirs = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        theirs.reduced())
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert dataclasses.asdict(MoEConfig(16, 4)) == dataclasses.asdict(
        RefMoEConfig(16, 4))


# --------------------------------------------------------------------- #
# the router, the aux loss, the occupancy
# --------------------------------------------------------------------- #


def _logits(seed, E, ties):
    """(2, 24, E) f32 logits; with ``ties`` every third token's logits
    repeat one value in pairs of experts and every fifth is constant."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, E)).astype(np.float32)
    if ties:
        x[:, ::3, 1::2] = x[:, ::3, 0::2]
        x[:, ::5] = 0.25
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 4), (16, 2)])
def test_route_topk_and_load_balance_loss_match_the_reference(E, k, ties):
    x = _logits(E * 10 + k, E, ties)
    jw, jp, jm = ref_moe.route_topk(jnp.asarray(x), k)
    tw, tp, tm = moe.route_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.sum(-1) == k).all()
    _close(tp, jp, F32_TOL)
    _close(tw, jw, F32_TOL)
    jl = float(ref_moe.load_balance_loss(jp, jm))
    tl = float(moe.load_balance_loss(tp, tm))
    assert abs(tl - jl) <= 1e-6 * abs(jl)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 4), (16, 2)])
def test_expert_occupancy_matches_the_reference(E, k, ties):
    x = _logits(E + k, E, ties).reshape(-1, E)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    expect = np.asarray(ref_scaling.expert_occupancy(jnp.asarray(probs), k))
    got = scaling.expert_occupancy(torch.from_numpy(probs), k)
    assert got.dtype == torch.float32 and got.shape == (E,)
    np.testing.assert_array_equal(got.numpy(), expect)
    assert float(got.sum()) == k * x.shape[0]


def test_topk_keeps_the_lower_index_first_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]])
    v, i = moe.topk(x, 4)
    assert i.tolist() == [[1, 2, 4, 0]] and v.tolist() == [[3, 3, 3, 1]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# --------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------- #


def _moe_inputs(name, seed, dtype, S=40, zero_router=False):
    """``init_moe``'s leaves drawn with numpy (normal / √fan-in, the
    router f32, the experts in ``dtype``) and an (2, S, d) input, as
    reference arrays and port tensors."""
    ref_cfg, cfg = _configs(name)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    jp, tp = {}, {}
    for k, shp in shapes.items():
        a = rng.standard_normal(shp) / np.sqrt(shp[0])
        if k == "router" and zero_router:
            a = np.zeros(shp)
        jp[k], tp[k] = _pair(a, "float32" if k == "router" else dtype)
    jx, tx = _pair(rng.standard_normal((2, S, d)), dtype)
    return ref_cfg, cfg, jp, tp, jx, tx


#: the reference's MoE layer, compiled once per config and shape
_ref_moe_fwd = jax.jit(ref_moe.moe_fwd,
                       static_argnames=("cfg", "capacity_factor"))


MOE_CASES = [("phi3.5", 2.0, "float32"), ("phi3.5", 2.0, "bfloat16"),
             ("dbrx-top4", 2.0, "float32"), ("dbrx-top4", 2.0, "bfloat16"),
             ("phi3.5", 0.5, "float32"), ("phi3.5-e8", 1.0, "bfloat16")]


@pytest.mark.parametrize("name,cf,dtype", MOE_CASES,
                         ids=[f"{n}-cf{c}-{t}" for n, c, t in MOE_CASES])
def test_moe_fwd_matches_the_reference(name, cf, dtype):
    """Output, aux loss and each expert's gathered token indices; the
    cases with C < S drop tokens (checked: some token is routed to more
    experts than took it)."""
    ref_cfg, cfg, jp, tp, jx, tx = _moe_inputs(name, 3, dtype)
    jo, ja = _ref_moe_fwd(jp, jx, cfg=ref_cfg, capacity_factor=cf)
    to, ta = moe.moe_fwd(tp, tx, cfg, capacity_factor=cf)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    _close(to, jo, F32_TOL if dtype == "float32" else BF16_TOL)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))

    S, k = tx.shape[1], cfg.moe.experts_per_token
    C = moe.capacity(S, cfg, cf)
    assert C == max(1, min(S, int(cf * k * S / cfg.moe.num_experts)))
    jw = ref_moe.route_topk(jx.astype(jnp.float32) @ jp["router"], k)[0]
    _, jidx = jax.lax.top_k(jw.transpose(0, 2, 1), C)
    tw, _, tm = moe.route_topk(tx.float() @ tp["router"], k)
    _, tidx = moe.dispatch(tw, C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if C < S:
        taken = torch.zeros_like(tm)
        for e in range(cfg.moe.num_experts):
            taken[torch.arange(2)[:, None], tidx[:, e], e] = 1.0
        dropped = int(((tm > 0) & (taken == 0)).sum())
        assert dropped > 0


@pytest.mark.parametrize("name", ["phi3.5", "dbrx-top4"])
def test_moe_fwd_with_forced_ties_matches_the_reference(name):
    """A zero router: every expert equally likely, so each token's top-k
    is experts 0..k-1 and every expert's top-C is tokens 0..C-1 (the
    lower index first among equal weights); the other experts run on
    weight-0 tokens."""
    ref_cfg, cfg, jp, tp, jx, tx = _moe_inputs(name, 5, "float32",
                                               zero_router=True)
    jo, _ = _ref_moe_fwd(jp, jx, cfg=ref_cfg, capacity_factor=0.5)
    to, _ = moe.moe_fwd(tp, tx, cfg, capacity_factor=0.5)
    _close(to, jo, F32_TOL)
    k, E, S = cfg.moe.experts_per_token, cfg.moe.num_experts, tx.shape[1]
    tw, _, tm = moe.route_topk(tx @ tp["router"], k)
    assert (tm[..., :k] == 1).all() and not tm[..., k:].any()
    C = moe.capacity(S, cfg, 0.5)
    _, tidx = moe.dispatch(tw, C)
    assert (tidx == torch.arange(C)).all()
    _, jidx = jax.lax.top_k(ref_moe.route_topk(
        jnp.zeros((2, S, E)), k)[0].transpose(0, 2, 1), C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_moe_fwd_gradients_with_dropped_tokens_match_the_reference():
    """E = 8, top-2 at capacity factor 0.5: the gradients of Σ out · r
    with respect to the input and every weight (the router's through the
    combine weights of the tokens each expert took) against
    ``jax.grad``."""
    ref_cfg, cfg, jp, tp, jx, tx = _moe_inputs("phi3.5-e8", 9, "float32")
    r = np.random.default_rng(10).standard_normal(tx.shape)

    def ref_obj(p, x):
        out, aux = ref_moe.moe_fwd(p, x, ref_cfg, capacity_factor=0.5)
        return (out * r).sum() + aux

    jg = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(jp, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = tx.clone().requires_grad_(True)
    out, aux = moe.moe_fwd(leaves, x, cfg, capacity_factor=0.5)
    ((out * torch.from_numpy(r).float()).sum() + aux).backward()
    for k in leaves:
        assert _rel(leaves[k].grad, jg[0][k]) <= GRAD_TOL, k
    assert _rel(x.grad, jg[1]) <= GRAD_TOL


def test_moe_decode_runs_every_expert_on_the_token():
    """S = 1: C = 1, so each expert takes the one token, the unrouted ones
    at weight 0 — the reference's output."""
    ref_cfg, cfg, jp, tp, jx, tx = _moe_inputs("dbrx-top4", 7, "float32",
                                               S=1)
    assert moe.capacity(1, cfg) == 1
    jo, _ = _ref_moe_fwd(jp, jx, cfg=ref_cfg, capacity_factor=2.0)
    to, _ = moe.moe_fwd(tp, tx, cfg)
    _close(to, jo, F32_TOL)


# --------------------------------------------------------------------- #
# the reduced models
# --------------------------------------------------------------------- #


#: the reduced models held against the reference's
MODELS = ("phi3.5", "dbrx-top4")


@functools.lru_cache(maxsize=None)
def _models(name):
    """The reference model and its params, and the port's with the same
    weights, in f32, built once a module run."""
    ref_cfg, cfg = _configs(name)
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    return jm, jp, pm, pp


@pytest.fixture(scope="module", params=MODELS)
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _models.cache_clear()


def _tokens(seed, S, B=2):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


def test_moe_prefill_and_decode_match_the_reference(models):
    """Prefill of 2 × 48 tokens (the last logits and every cache leaf),
    then 3 greedy decode steps from the reference's own prefill cache
    given room (the bridge carries it across): logits, tokens and cache.
    Under capacity dispatch a prefill + decode need not equal a longer
    prefill, so decode is held against the reference's decode step."""
    jm, jp, pm, pp = models
    toks = _tokens(0, 48)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, F32_TOL)
    assert tc["len"] == int(jc["len"]) == 48
    for i, layer in enumerate(tc["layers"]):
        assert set(layer) == set(jc["pos0"]) == {"k", "v"}
        for k, v in layer.items():
            _close(v, jc["pos0"][k][i], F32_TOL)

    jc = jax.tree.map(np.asarray, jc)
    jc["pos0"] = {k: np.concatenate([v, np.zeros_like(v[:, :, :3])], axis=2)
                  for k, v in jc["pos0"].items()}
    tc = bridge.cache_from_tree(jc, "cpu")
    jc = jax.tree.map(jnp.asarray, jc)
    step = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl, -1)[:, None]
    tt = torch.from_numpy(np.asarray(jt).astype(np.int64))
    for _ in range(3):
        jl, jc = step(jp, jt, jc)
        tl, tc = pm.decode_step(pp, tt, tc)
        _close(tl, jl, F32_TOL)
        jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["len"] == int(jc["len"]) == 51
    for i, layer in enumerate(tc["layers"]):
        for k, v in layer.items():
            _close(v, jc["pos0"][k][i], F32_TOL)


def test_moe_params_bridge_both_ways_in_their_dtypes():
    """bf16 experts stay bf16 through ``params_from_tree`` and
    ``tensor_tree_from_params``, the router and the norms f32;
    ``tree_from_params`` gives the reference's tree back; the port's own
    init draws every leaf with the reference's name and shape."""
    ref_cfg, cfg = _configs("dbrx-top4")
    jp = jax.jit(ref_build_model(ref_cfg, jnp.bfloat16).init)(
        jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.bfloat16, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    lay = pp.layers[1]
    assert set(lay.moe) == {"router", "w_gate", "w_up", "w_down"}
    assert not hasattr(lay, "mlp")
    assert lay.moe["router"].dtype == lay.norm1.dtype == torch.float32
    assert lay.moe["w_down"].dtype == lay.attn["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lay.moe["w_up"].detach().float().numpy(),
        np.asarray(jp["layers"]["pos0"]["moe"]["w_up"][1].astype(jnp.float32)))
    tree = bridge.tensor_tree_from_params(pp)
    assert tree["layers"]["pos0"]["moe"]["router"].dtype == torch.float32
    assert tree["layers"]["pos0"]["moe"]["w_gate"].dtype == torch.bfloat16
    back = jax.tree_util.tree_flatten_with_path(bridge.tree_from_params(pp))[0]
    expect = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(back) == len(expect)
    for path, v in back:
        np.testing.assert_array_equal(
            v, np.asarray(expect[path].astype(jnp.float32)))
    own = pm.init(torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in own.named_parameters()}
    flat = {".".join(str(k.key) for k in path if hasattr(k, "key")): v
            for path, v in expect.items()}
    for name, shape in shapes.items():
        key = ("layers.pos0." + name.split(".", 2)[2]
               if name.startswith("layers.") else name)
        assert shape == tuple(flat[key].shape[1 if "layers." in name
                                              else 0:]), name
    assert len(shapes) == 3 + cfg.num_layers * 10
    assert own.layers[0].moe["router"].dtype == torch.float32


def _batch(seed, lead, S, vocab, holes=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(*lead, S + 1))
    mask = np.ones((*lead, S), np.float32)
    if holes:
        mask = (rng.random((*lead, S)) > 0.1).astype(np.float32)
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32), "mask": mask}


def test_moe_loss_and_gradients_match_the_reference(models):
    """2 sequences of 48 tokens with holes in the mask: the loss
    (ce + load_balance_weight · aux), its ce and aux, and every leaf of
    its gradient (the router's through the combine weights and the aux
    loss) against ``jax.grad`` of the reference's loss."""
    jm, jp, pm, pp = models
    b = _batch(1, (2,), 48, pm.cfg.vocab_size, holes=True)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, b))
    names, leaves = zip(*pp.named_parameters())
    tl, tmet = pm.loss(pp, bridge.batch_from_arrays(b, "cpu"))
    grads = torch.autograd.grad(tl, leaves)
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"]),
                      (tmet["aux"], jmet["aux"])):
        assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(
            float(want))
    lb = pm.cfg.moe.load_balance_weight
    assert float(tmet["aux"]) > 0.0 and lb > 0.0
    assert float(tl.detach()) == pytest.approx(
        float(tmet["ce"].detach()) + lb * float(tmet["aux"].detach()),
        rel=1e-7)
    port = _leaves(bridge.tree_from_params(dict(zip(names, grads))))
    expect = _leaves(jg)
    assert port.keys() == expect.keys()
    assert any("moe" in k and "router" in k for k in expect)
    for k in expect:
        assert _rel(port[k], expect[k]) <= GRAD_TOL, k


def test_moe_round_matches_the_reference():
    """One FSVRG neural round (C = 2 clients, T = 1 local step, 2 × 48
    tokens a step) of reduced phi3.5, the reference's run eagerly: every
    leaf and the full gradient's norm."""
    jm, jp, pm, pp = _models("phi3.5")
    b = _batch(2, (2, 1, 2), 48, pm.cfg.vocab_size)
    kw = dict(algorithm="fsvrg", stepsize=0.3, local_steps=1)
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


@pytest.mark.parametrize("arch,mode", [(PHI, "fsvrg"), (DBRX, "adamw")])
def test_train_main_runs_a_moe_arch_on_the_cpu(arch, mode, capsys):
    logged = train.main(["--arch", arch, "--mode", mode, "--device", "cpu",
                         "--rounds", "2", "--log-every", "1", "--seq", "16",
                         "--clients", "2"])
    assert [r for r, _ in logged] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in logged)
    assert f"{arch}-reduced" in capsys.readouterr().out


def test_federated_lm_example_runs_a_moe_arch_on_the_cpu(capsys):
    loss = federated_lm.main(["--arch", PHI, "--device", "cpu", "--rounds",
                              "2", "--local-steps", "1", "--seq", "16",
                              "--batch-per-client", "1", "--clients", "2"])
    assert np.isfinite(loss)
    assert f"{PHI}-reduced" in capsys.readouterr().out


def test_serve_main_runs_a_moe_arch_on_the_cpu(capsys):
    for arch in (PHI, DBRX):
        serve.main(["--arch", arch, "--requests", "2", "--prompt-len", "16",
                    "--max-new", "3", "--device", "cpu"])
        assert f"{arch}-reduced on cpu" in capsys.readouterr().out
