"""The port's RWKV-6 stack against the reference's, on the reduced
rwkv6-3b (2 layers, d 256, 4 heads of 64, d_ff 512, vocab 1,024) with the
reference's weights (``build_model(cfg).init(PRNGKey(0))``) carried across
by ``repro_torch.bridge`` and the same numpy inputs.

Tolerances, f32: the two packages add the same f32 terms in other orders
(XLA's dot and scan against torch's matmul and the chunk loop): 1e-5 of the
quantity's max plus rtol 1e-5 (observed ≤ 1.5e-6 of the max).  bf16: both
round every matmul output to bf16, but XLA keeps f32 between fused
elementwise bf16 operations where torch rounds each one, so a value may
differ by a bf16 ulp (2^-8) before a matmul spreads it: 1e-2 of the max
(observed ≤ 3.7e-3).
Greedy tokens must agree exactly in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 1e-2


def _close(got, expect, tol):
    got = np.asarray(torch.as_tensor(got).float().numpy())
    expect = np.asarray(jnp.asarray(expect).astype(jnp.float32))
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1e-30))


@pytest.fixture(scope="module")
def cfgs():
    return ref_get_config("rwkv6-3b").reduced(), get_config("rwkv6-3b").reduced()


@pytest.fixture(scope="module")
def f32_models(cfgs):
    """The reference model and its params, and the port's with the same
    weights, in f32."""
    ref_cfg, cfg = cfgs
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    return jm, jp, pm, pp


def _layer0(dtype, seed=0):
    """Layer 0's time- and channel-mix params of the reference model in
    ``dtype``, as jnp and as torch dicts, with a nonzero bonus u."""
    ref_cfg = ref_get_config("rwkv6-3b").reduced()
    jp = ref_build_model(ref_cfg, dtype).init(jax.random.PRNGKey(0))
    stacked = jax.tree.map(np.asarray, jp["layers"]["pos0"])
    u = 0.1 * np.random.default_rng(seed).standard_normal(
        stacked["rwkv_tm"]["bonus_u"].shape[1:]).astype(np.float32)
    out = []
    for part in ("rwkv_tm", "rwkv_cm"):
        leaves = {k: v[0] for k, v in stacked[part].items()}
        if part == "rwkv_tm":
            leaves["bonus_u"] = u
        out.append(({k: jnp.asarray(v) for k, v in leaves.items()},
                    {k: bridge.tensor_like_array(v, "cpu")
                     for k, v in leaves.items()}))
    return out


def _array(rng, shape, jdtype, scale=1.0):
    a = jnp.asarray(scale * rng.standard_normal(shape), jnp.float32)
    a = a.astype(jdtype)
    return a, bridge.tensor_like_array(np.asarray(a), "cpu")


@pytest.mark.parametrize("mode", ["prefill", "decode", "continue", "ragged",
                                  "continue_ragged"])
@pytest.mark.parametrize("jdtype,tol", [(jnp.float32, F32_TOL),
                                        (jnp.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_time_and_channel_mix_match_reference(mode, jdtype, tol, cfgs):
    """Prefill (S = 64, no state: the wkv6 path), decode (S = 1 with a
    state and shift: sequential), a given state with S = 64 (wkv6 from that
    state), a ragged S = 40 (wkv6 over 32 tokens, then 8 sequential; the
    reference runs all 40 sequentially) and a ragged S = 40 from a given
    state, with a nonzero bonus u."""
    ref_cfg, cfg = cfgs
    (jtm, ttm), (jcm, tcm) = _layer0(jdtype)
    rng = np.random.default_rng(1)
    B, d, Hn, hd = 2, cfg.d_model, cfg.d_model // 64, 64
    S = {"prefill": 64, "decode": 1, "continue": 64, "ragged": 40,
         "continue_ragged": 40}[mode]
    jx, tx = _array(rng, (B, S, d), jdtype)
    kw_j, kw_t = {}, {}
    if mode in ("decode", "continue", "continue_ragged"):
        js, ts = _array(rng, (B, Hn, hd, hd), jnp.float32, 0.5)
        jl, tl = _array(rng, (B, d), jdtype)
        kw_j = dict(state=js, shift_last=jl)
        kw_t = dict(state=ts, shift_last=tl)
    j_out, (j_state, j_shift) = ref_rwkv.rwkv_time_mix(jtm, jx, ref_cfg,
                                                        **kw_j)
    t_out, (t_state, t_shift) = rwkv.rwkv_time_mix(ttm, tx, cfg, **kw_t)
    assert t_out.dtype == tx.dtype and t_state.dtype == torch.float32
    _close(t_out, j_out, tol)
    _close(t_state, j_state, tol)
    _close(t_shift, j_shift, 0.0)
    shift = kw_j.get("shift_last")
    j_cm, j_sl = ref_rwkv.rwkv_channel_mix(jcm, jx, shift_last=shift)
    t_cm, t_sl = rwkv.rwkv_channel_mix(tcm, tx, shift_last=kw_t.get(
        "shift_last"))
    _close(t_cm, j_cm, tol)
    _close(t_sl, j_sl, 0.0)


@pytest.mark.parametrize("S", [16, 40, 64])
def test_model_prefill_and_decode_match_reference(S, f32_models):
    """Prefill of B = 2 prompts (S = 16 and 64 through wkv6, a ragged 40
    sequential): last logits and every cache leaf; then 4 greedy decode
    steps: logits and tokens."""
    jm, jp, pm, pp = f32_models
    toks = np.random.default_rng(S).integers(0, 1024, (2, S))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, F32_TOL)
    assert tc["len"] == int(jc["len"]) == S
    for i, layer in enumerate(tc["layers"]):
        assert set(layer) == set(jc["pos0"])
        for k, v in layer.items():
            _close(v, jc["pos0"][k][i], F32_TOL)
    step = jax.jit(jm.decode_step)
    jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    for _ in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = step(jp, jt, jc)
        tl, tc = pm.decode_step(pp, tt, tc)
        _close(tl, jl, F32_TOL)
        jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["len"] == int(jc["len"]) == S + 4


def test_bridged_cache_decodes_like_the_reference(f32_models):
    """A reference cache carried across by the bridge decodes like the
    reference's own."""
    jm, jp, pm, pp = f32_models
    toks = np.random.default_rng(3).integers(0, 1024, (2, 32))
    _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tc = bridge.cache_from_tree(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["len"] == 32 and len(tc["layers"]) == 2
    tok = np.array([[5], [7]])
    jl, _ = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
    tl, _ = pm.decode_step(pp, torch.from_numpy(tok), tc)
    _close(tl, jl, F32_TOL)


def test_prefill_equals_token_by_token_decode(f32_models):
    """The port's prefill (wkv6 path) against its own decode of the same
    prompt from an empty cache (sequential path), as the reference's decode
    tests hold its own model."""
    _, _, pm, pp = f32_models
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 1024,
                                                              (2, 64)))
    lp, cp = pm.prefill(pp, {"tokens": toks})
    cache = pm.init_cache(2, 64)
    for t in range(64):
        ld, cache = pm.decode_step(pp, toks[:, t:t + 1], cache)
    torch.testing.assert_close(ld, lp, rtol=1e-4, atol=1e-4)
    for a, b in zip(cp["layers"], cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-4)
    assert cache["len"] == cp["len"] == 64


def test_ragged_prefill_equals_token_by_token_decode(f32_models):
    """A ragged prompt (47 tokens: wkv6 over 32, the sequential WKV over
    the tail of 15 from the kernel's state) against the port's own decode
    of it from an empty cache; tolerance as above."""
    _, _, pm, pp = f32_models
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 1024,
                                                               (2, 47)))
    lp, cp = pm.prefill(pp, {"tokens": toks})
    cache = pm.init_cache(2, 47)
    for t in range(47):
        ld, cache = pm.decode_step(pp, toks[:, t:t + 1], cache)
    torch.testing.assert_close(ld, lp, rtol=1e-4, atol=1e-4)
    for a, b in zip(cp["layers"], cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,given", [(64, False), (40, False), (16, False),
                                     (20, False), (64, True), (40, True),
                                     (1, True)])
def test_every_multi_token_call_runs_wkv6(S, given, cfgs, monkeypatch):
    """Every S > 1 time mix sends its whole chunks of min(32, S) tokens to
    ``ops.wkv6`` once, with the given state or none; decode (S = 1) does
    not call it."""
    _, cfg = cfgs
    (_, ttm), _ = _layer0(jnp.float32)
    calls = []
    real = rwkv.ops.wkv6

    def counted(r, k, v, w, u, chunk, *, state=None):
        calls.append((r.shape[1], chunk, state is not None))
        return real(r, k, v, w, u, chunk, state=state)

    monkeypatch.setattr(rwkv.ops, "wkv6", counted)
    B, d, Hn = 2, cfg.d_model, cfg.d_model // 64
    x = torch.randn((B, S, d), generator=torch.Generator().manual_seed(S))
    kw = {}
    if given:
        kw = dict(state=torch.zeros((B, Hn, 64, 64)),
                  shift_last=torch.zeros((B, d)))
    out, (state, _) = rwkv.rwkv_time_mix(ttm, x, cfg, **kw)
    assert out.shape == (B, S, d) and state.shape == (B, Hn, 64, 64)
    L = min(32, S)
    assert calls == ([] if S == 1 else [(S - S % L, L, given)])


def test_bridged_bf16_params_keep_their_dtypes(cfgs):
    ref_cfg, cfg = cfgs
    jp = ref_build_model(ref_cfg, jnp.bfloat16).init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.bfloat16, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    assert pp.embed.dtype == torch.bfloat16
    assert pp.out_norm.dtype == torch.float32
    tm = pp.layers[1].rwkv_tm
    assert tm["wr"].dtype == torch.bfloat16 and tm["mix_r"].dtype == torch.float32
    np.testing.assert_array_equal(
        tm["wr"].detach().float().numpy(),
        np.asarray(jp["layers"]["pos0"]["rwkv_tm"]["wr"][1].astype(
            jnp.float32)))
    assert all(p.requires_grad for p in pp.parameters())


@pytest.mark.parametrize("B", [1, 2])
def test_kernel_layout_is_contiguous_and_round_trips(B):
    """The wkv6 entry in the model's (B, S, Hn, D) layout returns a
    contiguous out in that layout and a (B, Hn, D, D) state, equal to the
    (B·Hn, S, D) entry's on the transposed copies, also for one request."""
    Hn, S, D = 4, 64, 16
    g = torch.Generator().manual_seed(B)
    r, k, v = (torch.randn((B, S, Hn, D), generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + torch.randn((B, S, Hn, D), generator=g)))
    u = 0.1 * torch.randn((Hn, D), generator=g)
    s0 = torch.randn((B, Hn, D, D), generator=g)
    out, state = rwkv.ops.wkv6(r, k, v, w, u, 32, state=s0)
    assert out.shape == (B, S, Hn, D) and out.is_contiguous()
    assert state.shape == (B, Hn, D, D)

    def heads(t):
        return t.transpose(1, 2).reshape(B * Hn, S, D).contiguous()

    out3, state3 = rwkv.ops.wkv6(*map(heads, (r, k, v, w)), u.repeat(B, 1),
                                 32, state=s0.reshape(B * Hn, D, D))
    assert torch.equal(out3.reshape(B, Hn, S, D).transpose(1, 2), out)
    assert torch.equal(state3.reshape(B, Hn, D, D), state)


@pytest.mark.parametrize("S,given", [(64, False), (40, False), (47, True),
                                     (16, True)])
def test_time_mix_hands_wkv6_the_projections_storage(S, given, cfgs,
                                                     monkeypatch):
    """``rwkv_time_mix`` passes ``ops.wkv6`` views of the projections'
    own (B, S, Hn, D) storage — for a ragged S the strided slice of its
    whole chunks — and u as (Hn, D): no copy into another layout."""
    _, cfg = cfgs
    (_, ttm), _ = _layer0(jnp.float32)
    seen = []
    real = rwkv.ops.wkv6

    def capture(r, k, v, w, u, chunk, *, state=None):
        seen.append(((r, k, v, w), u, state))
        return real(r, k, v, w, u, chunk, state=state)

    monkeypatch.setattr(rwkv.ops, "wkv6", capture)
    B, d, Hn, hd = 2, cfg.d_model, cfg.d_model // 64, 64
    x = torch.randn((B, S, d), generator=torch.Generator().manual_seed(S))
    kw = {}
    if given:
        kw = dict(state=torch.randn((B, Hn, hd, hd)),
                  shift_last=torch.zeros((B, d)))
    rwkv.rwkv_time_mix(ttm, x, cfg, **kw)
    (tensors, u, state), = seen
    n = S - S % min(32, S)
    for t in tensors:
        assert t.shape == (B, n, Hn, hd)
        assert t.stride() == (S * d, d, hd, 1)
        assert t.untyped_storage().nbytes() == B * S * d * 4
    assert u.shape == (Hn, hd)
    assert (state is not None) == given
    if given:
        assert state.shape == (B, Hn, hd, hd)
