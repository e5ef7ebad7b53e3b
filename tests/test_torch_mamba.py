"""The port's Mamba block and the Jamba hybrid against the reference's, on
the CPU: ``ref.selective_scan_ref`` (the selective_scan kernel's plain
version) against the reference's discretization, ``_ssm_scan_chunked`` and
its C contraction; ``mamba_fwd`` on the same numpy inputs (S = 64 in
chunks of 16, S = 48 in one chunk, from given SSM and convolution states,
S = 1, bf16); and the reduced jamba-v0.1-52b (one pattern block of 8
layers: Mamba at positions 0–6, attention at 7, MoE at odd positions;
d 256, di 512, N 16, E 4 top-2, so C = S and nothing is dropped) in f32
with the reference's ``init(PRNGKey(0))`` weights carried across by
``repro_torch.bridge``: prefill logits and every cache leaf, prefill +
``grow_cache`` + 4 decode steps against the reference's logits of the
longer prompt, 8 decode steps from the reference's ``init_cache``, the
parameter bridge both ways, and the entry points (``launch.serve`` serves
the hybrid; ``launch.train`` and ``examples.federated_lm`` refuse it).

Tolerances, each beside what was observed:

* f32: the reference forms a and b as (B, S, di, N) tensors and scans
  them with an associative scan (products of a in another order) and
  contracts C with XLA's dot; the port steps through t and sums over N
  with torch, and XLA's and torch's matrix products round apart (x_bc's
  product 6.1e-7 of its max): 1e-5 of the quantity's max plus rtol 1e-5
  for the scan (observed ≤ 1.6e-7), a layer's output (≤ 1.4e-6) and its
  states (≤ 9.3e-7);
* the model in f32: the same differences carried through the 8 layers,
  whose residual stream grows from 4 to 3,381 in max |x| in the
  reference's random init (the first MoE layer adds most of it): 1e-4 of
  the quantity's max plus rtol 1e-4 for the logits and every cache leaf
  (observed: logits ≤ 2.1e-5, the Mamba states ≤ 1.9e-5, the attention
  layer's K and V ≤ 3.4e-5 — its input is 2.1e-5 off);
* bf16 ``mamba_fwd``: the projections, the convolution's taps and the
  gate round to bf16 at each operation in torch, where XLA keeps f32
  between fused elementwise operations: 2e-2 of the output's max, about
  five bf16 ulps of it (observed 8.5e-3); the f32 SSM state the same
  (observed 8.6e-3); the convolution state (the last inputs) equal.

Greedy tokens must agree exactly in f32.
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
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.examples import federated_lm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model, make_batch, mamba  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

JAMBA = "jamba-v0.1-52b"
F32_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, expect):
    got, expect = _np(got).astype(np.float64), _np(expect).astype(np.float64)
    assert got.shape == expect.shape
    return np.abs(got - expect).max() / max(np.abs(expect).max(), 1e-30)


def _close(got, expect, tol):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1e-30))


def _pair(a, dtype):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, bridge.tensor_like_array(np.asarray(j), "cpu")


def _configs():
    return ref_get_config(JAMBA).reduced(), get_config(JAMBA).reduced()


# --------------------------------------------------------------------- #
# the config
# --------------------------------------------------------------------- #


def test_jamba_config_is_the_reference_config():
    ours, theirs = get_config(JAMBA), ref_get_config(JAMBA)
    assert ours.family == "hybrid"
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        theirs.reduced())
    assert ours.param_count() == theirs.param_count()
    cut = dataclasses.replace(ours, num_layers=16)
    assert cut.param_count() == dataclasses.replace(
        theirs, num_layers=16).param_count()
    # the served cut: 2 whole pattern blocks, 14 Mamba and 2 attention
    # layers, 8 MoE and 8 dense MLPs, 52.0 GB of bf16 weights
    kinds = [transformer.layer_kind(cut, i % 8) for i in range(16)]
    assert sum(m == "mamba" for m, _ in kinds) == 14
    assert sum(f == "moe" for _, f in kinds) == 8
    assert 25.9e9 < cut.param_count() < 26.0e9


# --------------------------------------------------------------------- #
# the selective scan's plain version
# --------------------------------------------------------------------- #


def _scan_inputs(seed, B, S, di, N=16, spread=1.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((B, S, di)).astype(f),
                dt_pre=(spread * rng.standard_normal((B, S))).astype(f),
                dt_bias=(0.5 * rng.standard_normal(di)).astype(f),
                a_log=(np.log(np.tile(np.arange(1, N + 1, dtype=f), (di, 1)))
                       + 0.1 * rng.standard_normal((di, N))).astype(f),
                b=rng.standard_normal((B, S, N)).astype(f),
                c=rng.standard_normal((B, S, N)).astype(f),
                d_skip=(1 + 0.1 * rng.standard_normal(di)).astype(f),
                h0=rng.standard_normal((B, di, N)).astype(f))


def _ref_scan(inp, chunk, from_h0):
    """The reference's discretization (``mamba_fwd``'s lines), chunked
    associative scan and C contraction on the same inputs."""
    x = jnp.asarray(inp["x"])
    dt = jax.nn.softplus(jnp.asarray(inp["dt_pre"])[..., None]
                         + jnp.asarray(inp["dt_bias"]))
    A = -jnp.exp(jnp.asarray(inp["a_log"]))
    a_bar = jnp.exp(dt[..., None] * A[None, None])
    b_bar = dt[..., None] * jnp.asarray(inp["b"])[:, :, None, :] \
        * x[..., None]
    B, S, di = x.shape
    h0 = (jnp.asarray(inp["h0"]) if from_h0
          else jnp.zeros((B, di, A.shape[1]), jnp.float32))
    hs, h_last = ref_mamba._ssm_scan_chunked(a_bar, b_bar, h0, chunk)
    y = jnp.einsum("bsdn,bsn->bsd", hs, jnp.asarray(inp["c"]))
    return y + x * jnp.asarray(inp["d_skip"]), h_last


SCAN_CASES = [(64, 16, False, 1.0), (64, 16, True, 1.0), (48, 256, True, 1.0),
              (1, 256, True, 1.0), (40, 8, True, 12.0)]


@pytest.mark.parametrize("S,chunk,from_h0,spread", SCAN_CASES,
                         ids=["chunks-zeros", "chunks-h0", "one-chunk-h0",
                              "S1-h0", "large-dt"])
def test_selective_scan_ref_matches_the_reference_scan(S, chunk, from_h0,
                                                       spread):
    """y and the last state; ``large-dt`` puts dt_pre + dt_bias past 20,
    where torch's ``F.softplus`` would return its input but
    ``jax.nn.softplus`` (and ``ref.softplus_ref``) do not."""
    inp = _scan_inputs(S + chunk, 2, S, 96, spread=spread)
    jy, jh = _ref_scan(inp, chunk, from_h0)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ty, th = ref.selective_scan_ref(t["x"], t["dt_pre"], t["dt_bias"],
                                    t["a_log"], t["b"], t["c"], t["d_skip"],
                                    t["h0"] if from_h0 else None)
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy, F32_TOL)
    _close(th, jh, F32_TOL)
    if spread > 1.0:
        v = torch.from_numpy(inp["dt_pre"])
        assert float(v.abs().max()) > 20.0
        np.testing.assert_allclose(
            ref.softplus_ref(v).numpy(),
            np.asarray(jax.nn.softplus(jnp.asarray(inp["dt_pre"]))),
            rtol=1e-6, atol=1e-7)


def test_ops_selective_scan_takes_strided_halves_on_the_cpu():
    """``ops.selective_scan`` on CPU tensors is the plain version: B and C
    as the two halves of one (B, S, 2N) tensor, dt_pre a (B, S, 1)
    column, x a strided half of an (B, S, 2·di) projection."""
    inp = _scan_inputs(3, 2, 24, 64)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    bc = torch.cat([t["b"], t["c"]], dim=-1)
    xz = torch.cat([t["x"], t["x"]], dim=-1)
    got = ops.selective_scan(xz[..., :64], t["dt_pre"][..., None][..., 0],
                             t["dt_bias"], t["a_log"], bc[..., :16],
                             bc[..., 16:], t["d_skip"], t["h0"])
    want = ref.selective_scan_ref(t["x"], t["dt_pre"], t["dt_bias"],
                                  t["a_log"], t["b"], t["c"], t["d_skip"],
                                  t["h0"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------------- #
# the Mamba block
# --------------------------------------------------------------------- #


def _mamba_inputs(seed, S, dtype, B=2, states=False):
    """``init_mamba``'s leaves drawn with numpy (normal / √fan-in in
    ``dtype``, dt_bias, a_log and d_skip near their inits in f32), an
    (B, S, d) input and, with ``states``, an SSM state (f32) and a
    convolution state (``dtype``), as reference arrays and port
    tensors."""
    ref_cfg, cfg = _configs()
    d, N, Kc = cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv
    di = cfg.mamba_expand * d
    rng = np.random.default_rng(seed)
    shapes = {"in_proj": (d, 2 * di), "conv_w": (Kc, di), "x_bc": (di, 2 * N),
              "x_dt": (di, 1), "out_proj": (di, d)}
    jp, tp = {}, {}
    for k, shp in shapes.items():
        jp[k], tp[k] = _pair(rng.standard_normal(shp) / np.sqrt(shp[0]),
                             dtype)
    f32 = {"dt_bias": 0.5 * rng.standard_normal(di),
           "a_log": np.log(np.tile(np.arange(1, N + 1), (di, 1)))
           + 0.1 * rng.standard_normal((di, N)),
           "d_skip": 1 + 0.1 * rng.standard_normal(di)}
    for k, a in f32.items():
        jp[k], tp[k] = _pair(a, "float32")
    jx, tx = _pair(rng.standard_normal((B, S, d)), dtype)
    st = {}
    if states:
        st["ssm_state"] = _pair(rng.standard_normal((B, di, N)), "float32")
        st["conv_state"] = _pair(rng.standard_normal((B, Kc - 1, di)), dtype)
    return ref_cfg, cfg, jp, tp, jx, tx, st


MAMBA_CASES = [(64, 16, False), (48, 256, False), (32, 8, True),
               (1, 256, True), (1, 256, False)]


@pytest.mark.parametrize("S,chunk,states", MAMBA_CASES,
                         ids=["S64-chunk16", "S48-one-chunk", "S32-states",
                              "S1-states", "S1-zeros"])
def test_mamba_fwd_matches_the_reference(S, chunk, states):
    """Output, the SSM state and the convolution state in f32; S = 1 is
    the reference's O(1) decode update."""
    ref_cfg, cfg, jp, tp, jx, tx, st = _mamba_inputs(S, S, "float32",
                                                     states=states)
    jkw = {k: v[0] for k, v in st.items()}
    tkw = {k: v[1] for k, v in st.items()}
    jo, (jh, jc) = ref_mamba.mamba_fwd(jp, jx, ref_cfg, chunk=chunk, **jkw)
    to, (th, tc) = mamba.mamba_fwd(tp, tx, cfg, chunk=chunk, **tkw)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    assert th.dtype == torch.float32 and tc.dtype == tx.dtype
    _close(to, jo, F32_TOL)
    _close(th, jh, F32_TOL)
    _close(tc, jc, F32_TOL)
    # the chunk does not change the port's sequential scan
    to2, _ = mamba.mamba_fwd(tp, tx, cfg, chunk=max(1, S // 2), **tkw)
    assert torch.equal(to, to2)


def test_mamba_fwd_bf16_matches_the_reference():
    ref_cfg, cfg, jp, tp, jx, tx, st = _mamba_inputs(11, 40, "bfloat16",
                                                     states=True)
    jo, (jh, jc) = ref_mamba.mamba_fwd(jp, jx, ref_cfg, chunk=8,
                                       ssm_state=st["ssm_state"][0],
                                       conv_state=st["conv_state"][0])
    to, (th, tc) = mamba.mamba_fwd(tp, tx, cfg, chunk=8,
                                   ssm_state=st["ssm_state"][1],
                                   conv_state=st["conv_state"][1])
    assert to.dtype == tc.dtype == torch.bfloat16
    assert th.dtype == torch.float32
    assert _rel(to, jo) <= BF16_TOL
    assert _rel(th, jh) <= BF16_TOL
    assert _rel(tc, jc) == 0.0          # the last inputs, copied


def test_mamba_decode_steps_continue_the_prefill():
    """mamba_fwd over 24 tokens, then 4 steps of S = 1 from its states,
    against mamba_fwd over all 28 (the port alone: the same scan)."""
    _, cfg, _, tp, _, tx, _ = _mamba_inputs(5, 28, "float32")
    whole, (h_all, c_all) = mamba.mamba_fwd(tp, tx, cfg)
    out, (h, c) = mamba.mamba_fwd(tp, tx[:, :24], cfg)
    outs = [out]
    for t in range(24, 28):
        o, (h, c) = mamba.mamba_fwd(tp, tx[:, t:t + 1], cfg, ssm_state=h,
                                    conv_state=c)
        outs.append(o)
    _close(torch.cat(outs, dim=1), whole, F32_TOL)
    _close(h, h_all, F32_TOL)
    _close(c, c_all, F32_TOL)       # in_proj of one token, of 28


# --------------------------------------------------------------------- #
# the reduced hybrid
# --------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _models():
    """The reference model and its params, and the port's with the same
    weights, in f32, built once a module run."""
    ref_cfg, cfg = _configs()
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    return jm, jp, pm, pp


@pytest.fixture(scope="module")
def models():
    yield _models()
    _models.cache_clear()


def _tokens(seed, S, B=2):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


@functools.lru_cache(maxsize=None)
def _ref_all_logits():
    """The reference's logits at every position of a 2 × 52-token prompt
    (its stack forward, out norm and unembedding), and the prompt."""
    jm, jp, _, _ = _models()
    ref_cfg = jm.cfg
    toks = _tokens(1, 52)

    @jax.jit
    def logits(p, t):
        x = jnp.take(p["embed"], t, axis=0)
        pos = jnp.broadcast_to(jnp.arange(t.shape[1]), t.shape)
        h, _ = ref_transformer.stack_forward(p["layers"], ref_cfg, x, pos,
                                             remat=False)
        h = ref_layers.rms_norm(h, p["out_norm"], ref_cfg.norm_eps)
        return h @ p["unembed"]

    return toks, logits(jp, jnp.asarray(toks, jnp.int32))


def _check_cache(tc, jc, P=8):
    for i, layer in enumerate(tc["layers"]):
        ref_layer = jc[f"pos{i % P}"]
        assert set(layer) == set(ref_layer)
        assert set(layer) == ({"ssm", "conv"} if i % P != P - 1
                              else {"k", "v"})
        for k, v in layer.items():
            _close(v, ref_layer[k][i // P], MODEL_TOL)


def test_hybrid_prefill_matches_the_reference(models):
    """The last logits and every cache leaf (7 Mamba layers' ssm and conv,
    the attention layer's K and V) of a 2 × 48-token prefill."""
    jm, jp, pm, pp = models
    toks = _tokens(0, 48)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, MODEL_TOL)
    assert tc["len"] == int(jc["len"]) == 48
    assert len(tc["layers"]) == 8
    _check_cache(tc, jc)


def test_hybrid_prefill_then_decode_matches_the_longer_prefill(models):
    """Prefill of 48 tokens, ``grow_cache`` to 52 (the Mamba entries left
    as they are, the attention layer given 4 more slots), then 4 decode
    steps fed the prompt's next tokens: each step's logits against the
    reference's logits of the 52-token prompt at that position (with C =
    S nothing is dropped, so the two routes compute the same thing)."""
    _, _, pm, pp = models
    toks, want = _ref_all_logits()
    tl, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :48])})
    _close(tl, want[:, 47], MODEL_TOL)
    grown = pm.grow_cache(tc, 52)
    for old, new in zip(tc["layers"], grown["layers"]):
        if "ssm" in old:
            assert new["ssm"] is old["ssm"] and new["conv"] is old["conv"]
        else:
            assert new["k"].shape[1] == 52
    cache = grown
    for t in range(48, 52):
        tl, cache = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]),
                                   cache)
        _close(tl, want[:, t], MODEL_TOL)
    assert cache["len"] == 52


def test_hybrid_decode_from_an_empty_cache_matches_the_reference(models):
    """8 greedy decode steps from the reference's ``init_cache(2, 8)``
    (carried across by ``bridge.cache_from_tree``; the port's own
    ``init_cache`` has its layout): logits, tokens and every cache leaf."""
    jm, jp, pm, pp = models
    jc = jm.init_cache(2, 8)
    tc = bridge.cache_from_tree(jax.tree.map(np.asarray, jc), "cpu")
    own = pm.init_cache(2, 8)
    for a, b in zip(own["layers"], tc["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert not a[k].any()
    step = jax.jit(jm.decode_step)
    jt = jnp.asarray(_tokens(2, 1), jnp.int32)
    tt = torch.from_numpy(np.asarray(jt).astype(np.int64))
    for _ in range(8):
        jl, jc = step(jp, jt, jc)
        tl, tc = pm.decode_step(pp, tt, tc)
        _close(tl, jl, MODEL_TOL)
        jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["len"] == int(jc["len"]) == 8
    _check_cache(tc, jc)


def test_hybrid_params_bridge_both_ways_in_their_dtypes():
    """bf16 weights stay bf16 through ``params_from_tree`` and
    ``tensor_tree_from_params``, ``dt_bias``, ``a_log``, ``d_skip``, the
    router and the norms f32; ``tree_from_params`` gives the reference's
    8-position tree back; the port's own init draws every leaf with the
    reference's name, shape and dtype."""
    ref_cfg, cfg = _configs()
    jp = jax.jit(ref_build_model(ref_cfg, jnp.bfloat16).init)(
        jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.bfloat16, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    lay = pp.layers[1]
    assert set(lay.mamba) == {"in_proj", "conv_w", "x_bc", "x_dt", "dt_bias",
                              "a_log", "d_skip", "out_proj"}
    assert hasattr(lay, "moe") and not hasattr(lay, "attn")
    assert hasattr(pp.layers[7], "attn") and not hasattr(pp.layers[7],
                                                         "mamba")
    for k in ("dt_bias", "a_log", "d_skip"):
        assert lay.mamba[k].dtype == torch.float32
    assert lay.mamba["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lay.mamba["x_bc"].detach().float().numpy(),
        np.asarray(jp["layers"]["pos1"]["mamba"]["x_bc"][0]
                   .astype(jnp.float32)))
    tree = bridge.tensor_tree_from_params(pp)
    assert sorted(tree["layers"]) == [f"pos{j}" for j in range(8)]
    assert tree["layers"]["pos0"]["mamba"]["a_log"].dtype == torch.float32
    assert tree["layers"]["pos0"]["mamba"]["conv_w"].dtype == torch.bfloat16
    back = jax.tree_util.tree_flatten_with_path(bridge.tree_from_params(pp))[0]
    expect = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(back) == len(expect)
    for path, v in back:
        np.testing.assert_array_equal(
            v, np.asarray(expect[path].astype(jnp.float32)))
    own = pm.init(torch.Generator().manual_seed(0))
    flat = {".".join(str(k.key) for k in path if hasattr(k, "key")): v
            for path, v in expect.items()}
    names = dict(own.named_parameters())
    assert len(names) == len(flat)
    for name, p in names.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            key = f"layers.pos{i}.{rest}"
            want = flat[key]
            assert tuple(p.shape) == tuple(want.shape[1:]), name
        else:
            want = flat[name]
            assert tuple(p.shape) == tuple(want.shape), name
        assert str(p.dtype).split(".")[-1] == str(want.dtype), name
    # log(1..N) in each row, within an ulp (torch's f32 log, not XLA's)
    np.testing.assert_allclose(
        own.layers[0].mamba["a_log"].detach().numpy(),
        np.log(np.tile(np.arange(1, 17, dtype=np.float64), (512, 1))),
        rtol=2 ** -23, atol=0)


# --------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------- #


def test_serve_main_runs_the_hybrid_on_the_cpu(capsys):
    serve.main(["--arch", JAMBA, "--requests", "2", "--prompt-len", "16",
                "--max-new", "4", "--device", "cpu"])
    assert f"{JAMBA}-reduced on cpu" in capsys.readouterr().out
    _, cfg = _configs()
    batch = make_batch(cfg, InputShape("serve", 16, 2, "prefill"),
                       torch.Generator().manual_seed(1))
    assert batch["tokens"].shape == (2, 16)


def test_training_the_hybrid_raises_naming_the_backward():
    for fn, argv in ((train.main, ["--arch", JAMBA, "--device", "cpu"]),
                     (federated_lm.main, ["--arch", JAMBA, "--device",
                                          "cpu"])):
        with pytest.raises(NotImplementedError,
                           match="selective_scan backward.*A11"):
            fn(argv)
    with pytest.raises(NotImplementedError, match="selective_scan backward"):
        transformer.require_trainable(get_config(JAMBA))
    transformer.require_trainable(get_config("phi3.5-moe-42b-a6.6b"))
