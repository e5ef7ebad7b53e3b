"""The port's dense attention family against the reference's, on the CPU:
RoPE, attention (the port's ``flash_attention`` — SDPA — and its plain
``flash_attention_ref``), decode attention and the MLPs on the same numpy
inputs (GQA, MHA and MQA), and each reduced dense config (2 layers, d 256,
4 query heads of 64 over 4 KV heads, granite-20b's over 1; danube's
window 64) in f32 with the reference's ``init(PRNGKey(0))`` weights
carried across by ``repro_torch.bridge``.

Tolerances, each beside what was observed:

* f32: the two packages add the same f32 terms in other orders (XLA's
  dots and scans against torch's matmul and SDPA): 1e-5 of the quantity's
  max plus rtol 1e-5, for a layer's output (observed ≤ 8.4e-7 of the max)
  and for the model's logits and cache (observed ≤ 6.4e-6, the RoPE'd
  keys the largest);
* RoPE: the same f32 angles (frequencies bit-equal but for one ulp at
  θ = 10⁶, which moves the angle at position 8,191 by 2.4e-7), cos and
  sin within an ulp: 2e-6 absolute plus 2e-6 relative on unit-scale
  inputs at positions up to 8,191 (observed ≤ 1.1e-6);
* bf16 attention: the reference and the plain version cast each block's
  probabilities to bf16 with the running max of that block, SDPA with its
  own blocks, and the output is rounded to bf16 (2^-8 relative): 2e-2 of
  the output's max (observed ≤ 3.9e-3);
* bf16 MLP: XLA keeps f32 between fused elementwise bf16 operations where
  torch rounds each one: 1e-2 of the max (observed ≤ 6.1e-3).

Greedy tokens must agree exactly in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DENSE = ("llama3-8b", "h2o-danube-1.8b", "codeqwen1.5-7b", "granite-20b")
F32_TOL = 1e-5
ROPE_TOL = 2e-6
BF16_ATTN_TOL = 2e-2
BF16_TOL = 1e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, expect, tol):
    got, expect = _np(got), _np(expect)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1e-30))


def _pair(a, dtype):
    """numpy ``a`` as a reference array and a port tensor of ``dtype``
    ("float32" / "bfloat16"), the same values."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, bridge.tensor_like_array(np.asarray(j), "cpu")


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_are_the_reference_configs(arch):
    ours, theirs = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        theirs.reduced())
    assert ours.param_count() == theirs.param_count()


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (80, 10000.0),
                                            (128, 1e6), (64, 10000.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_the_reference(head_dim, theta, dtype):
    """Positions 0..8,191 (danube's 2× window), (B, S) and (S,) positions;
    halves rotated, not interleaved pairs."""
    rng = np.random.default_rng(head_dim)
    S = 8192
    x = rng.standard_normal((1, S, 2, head_dim)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    pos = np.arange(S)[None]
    jy = ref_layers.apply_rope(jx, jnp.asarray(pos, jnp.int32), theta)
    ty = layers.apply_rope(tx, torch.from_numpy(pos), theta)
    assert ty.dtype == tx.dtype
    tol = ROPE_TOL if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    flat = layers.apply_rope(tx, torch.arange(S), theta)
    assert torch.equal(flat, ty)
    np.testing.assert_array_max_ulp(
        layers.rope_freqs(head_dim, theta).numpy(),
        np.asarray(ref_layers.rope_freqs(head_dim, theta)), maxulp=1)


ATTN_CASES = [(8, 2), (4, 4), (4, 1)]


@pytest.mark.parametrize("heads", ATTN_CASES, ids=["GQA", "MHA", "MQA"])
@pytest.mark.parametrize("window", [None, 64], ids=["causal", "window64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_reference(heads, window, dtype):
    """B = 2, S = 256, Dh = 32: the port's ``flash_attention`` (causal
    SDPA, or the banded path for the window) and ``flash_attention_ref``
    (with 64-token blocks, so blocks are skipped and wiped) against the
    reference's ``flash_attention``."""
    H, Hkv = heads
    B, S, Dh = 2, 256, 32
    rng = np.random.default_rng(H * 10 + Hkv)
    jq, tq = _pair(rng.standard_normal((B, S, H, Dh)), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, Dh)), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, Dh)), dtype)
    expect = ref_layers.flash_attention(jq, jk, jv, causal=True,
                                        window=window, q_block=64,
                                        kv_block=64)
    layers.reset_sdpa_backends()
    got = layers.flash_attention(tq, tk, tv, causal=True, window=window)
    path = "cpu:" + ("efficient+band" if window else
                     ("efficient" if dtype == "float32" else "flash"))
    n_calls = -(-S // min(layers.BAND_Q_BLOCK, window)) if window else 1
    assert dict(layers.SDPA_BACKENDS) == {path: n_calls}
    plain = layers.flash_attention_ref(tq, tk, tv, causal=True,
                                       window=window, q_block=64,
                                       kv_block=64)
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    for out in (got, plain):
        assert out.dtype == tq.dtype and out.shape == tq.shape
        _close(out, expect, tol)


def test_flash_attention_ref_matches_at_the_default_blocks():
    """The plain version at the reference's 512-token blocks and a query
    offset, against the reference."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, Dh = 1, 1024, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, Dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    kw = dict(causal=True, window=300, q_offset=0)
    expect = ref_layers.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = layers.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, expect, F32_TOL)
    with pytest.raises(ValueError):
        layers.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   q_block=300)


def test_flash_attention_refuses_what_it_cannot_compute():
    q = torch.zeros((1, 8, 3, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        layers.flash_attention(q, kv, kv)                 # 3 % 2 != 0
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError):
        layers.flash_attention(q, kv, kv, causal=False, window=4)


@pytest.mark.parametrize("n_valid,window", [(1, None), (37, None), (48, None),
                                            (48, 16), (20, 32)])
@pytest.mark.parametrize("heads", ATTN_CASES, ids=["GQA", "MHA", "MQA"])
def test_decode_attention_matches_the_reference(n_valid, window, heads):
    H, Hkv = heads
    B, Smax, Dh = 2, 48, 32
    rng = np.random.default_rng(n_valid)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Smax, Hkv, Dh)).astype(np.float32)
              for _ in range(2))
    expect = ref_layers.decode_attention(
        *map(jnp.asarray, (q, kc, vc)), jnp.asarray(n_valid, jnp.int32),
        window=window)
    got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                  n_valid, window=window)
    _close(got, expect, F32_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-20b"],
                         ids=["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_and_mlps_match_the_reference(arch, dtype):
    """Layer 0's attention (its output and the RoPE'd k, v it returns for
    the cache) and its MLP, with the reference's weights: SwiGLU
    (llama3-8b) and the tanh GELU of two matrices (granite-20b)."""
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    jp = ref_build_model(ref_cfg, getattr(jnp, dtype)).init(
        jax.random.PRNGKey(0))
    stacked = jax.tree.map(np.asarray, jp["layers"]["pos0"])
    x = np.random.default_rng(1).standard_normal((2, 48, cfg.d_model))
    jx, tx = _pair(x, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    for part in ("attn", "mlp"):
        jw = {k: jnp.asarray(v[0]) for k, v in stacked[part].items()}
        tw = {k: bridge.tensor_like_array(v[0], "cpu")
              for k, v in stacked[part].items()}
        if part == "attn":
            pos = jnp.broadcast_to(jnp.arange(48), (2, 48))
            jo, (jk, jv) = ref_layers.attention_fwd(jw, jx, ref_cfg, pos)
            to, (tk, tv) = layers.attention_fwd(tw, tx, cfg, torch.arange(48))
            _close(tk, jk, tol)
            _close(tv, jv, tol)
        else:
            assert set(tw) == ({"w_gate", "w_up", "w_down"}
                               if cfg.mlp_style == "swiglu"
                               else {"w_up", "w_down"})
            jo = ref_layers.mlp_fwd(jw, jx, ref_cfg)
            to = layers.mlp_fwd(tw, tx, cfg)
            tol = F32_TOL if dtype == "float32" else BF16_TOL
        assert to.dtype == tx.dtype
        _close(to, jo, tol)


def test_attention_decode_writes_in_place_and_refuses_a_full_cache():
    """``attention_decode`` at slot cur_len with cur_len + 1 valid slots
    (what the reference does with a cache that has room) against the
    reference's; the port writes into the given cache and raises where the
    reference would clamp the slot onto the last token."""
    ref_cfg, cfg = (ref_get_config("llama3-8b").reduced(),
                    get_config("llama3-8b").reduced())
    jp = ref_build_model(ref_cfg, jnp.float32).init(jax.random.PRNGKey(0))
    w = {k: np.array(v[0]) for k, v in jp["layers"]["pos0"]["attn"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shp = (2, 16, cfg.num_kv_heads, cfg.head_dim)
    kc, vc = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    jo, jk, jv = ref_layers.attention_decode(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), ref_cfg,
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(9, jnp.int32))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, ok, ov = layers.attention_decode(
        {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x),
        cfg, tk, tv, 9, slot=9, n_valid=10)
    assert ok is tk and ov is tv
    _close(to, jo, F32_TOL)
    _close(tk, jk, F32_TOL)
    _close(tv, jv, F32_TOL)
    with pytest.raises(ValueError, match="grow the cache"):
        layers.attention_decode(
            {k: torch.from_numpy(v) for k, v in w.items()},
            torch.from_numpy(x), cfg, tk, tv, 16, slot=16, n_valid=16)


# --------------------------------------------------------------------- #
# the reduced models
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    """The reference model and its params, and the port's with the same
    weights, in f32."""
    arch = request.param
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    return jm, jp, pm, pp


def _tokens(seed, S, B=2):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


def test_prefill_logits_and_cache_match_the_reference(models):
    """Prefill of 2 × 96 tokens (past the reduced danube's window of 64:
    its cache is the last 64 entries as a ring): the last logits and
    every cache leaf."""
    jm, jp, pm, pp = models
    toks = _tokens(0, 96)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, F32_TOL)
    assert tc["len"] == int(jc["len"]) == 96
    W = pm.cfg.sliding_window
    for i, layer in enumerate(tc["layers"]):
        assert set(layer) == set(jc["pos0"]) == {"k", "v"}
        for k, v in layer.items():
            assert v.shape[1] == (min(96, W) if W else 96)
            _close(v, jc["pos0"][k][i], F32_TOL)


def _room(cache_tree, extra):
    """The reference's prefill cache with ``extra`` zero slots appended
    (what ``grow_cache`` does; unwrapped caches only)."""
    out = dict(cache_tree)
    out["pos0"] = {k: np.concatenate(
        [np.asarray(v), np.zeros_like(np.asarray(v)[:, :, :extra])], axis=2)
        for k, v in cache_tree["pos0"].items()}
    return out


def test_bridged_cache_decodes_like_the_reference(models):
    """The reference's prefill cache (32 tokens), given room for 4 more,
    carried across by the bridge: 4 greedy decode steps in both packages
    from it — logits and tokens."""
    jm, jp, pm, pp = models
    toks = _tokens(3, 32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    jc = _room(jax.tree.map(np.asarray, jc), 4)
    tc = bridge.cache_from_tree(jc, "cpu")
    assert tc["len"] == 32 and tc["layers"][0]["k"].shape[1] == 36
    jc = jax.tree.map(jnp.asarray, jc)
    step = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl, -1)[:, None]
    tt = torch.from_numpy(np.asarray(jt).astype(np.int64))
    for _ in range(4):
        jl, jc = step(jp, jt, jc)
        tl, tc = pm.decode_step(pp, tt, tc)
        _close(tl, jl, F32_TOL)
        jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["len"] == int(jc["len"]) == 36
    for i, layer in enumerate(tc["layers"]):
        for k, v in layer.items():
            _close(v, jc["pos0"][k][i], F32_TOL)


def test_prefill_equals_token_by_token_decode(models):
    """The reference's own contract (tests/test_models_smoke.py): decode of
    the prompt from an empty cache with room equals prefill, in the port;
    the cache too (the windowed ring once it wraps)."""
    _, _, pm, pp = models
    toks = torch.from_numpy(_tokens(9, 48))
    lp, cp = pm.prefill(pp, {"tokens": toks})
    cache = pm.init_cache(2, 52)
    for t in range(48):
        ld, cache = pm.decode_step(pp, toks[:, t:t + 1], cache)
    torch.testing.assert_close(ld, lp, rtol=1e-4, atol=1e-4)
    for a, b in zip(cp["layers"], cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k][:, :48], rtol=1e-4,
                                       atol=1e-4)
    assert cache["len"] == 48


def test_window_ring_matches_the_full_history():
    """The port's twin of tests/test_models_smoke.py's ring test: reduced
    danube (window 64), S = 2W decoded token by token through a ring of W
    slots, against the reference's prefill of the same S tokens (the
    window mask applied directly) with the same weights."""
    arch = "h2o-danube-1.8b"
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    W = cfg.sliding_window
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(3))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    S = 2 * W
    toks = _tokens(4, S)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    cache = pm.init_cache(2, S)
    assert cache["layers"][0]["k"].shape[1] == W
    tt = torch.from_numpy(toks)
    for t in range(S):
        tl, cache = pm.decode_step(pp, tt[:, t:t + 1], cache)
    _close(tl, jl, F32_TOL)
    # and the port's own prefill's ring is the decoded ring
    _, cp = pm.prefill(pp, {"tokens": tt})
    for a, b in zip(cp["layers"], cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,S", [(a, 32) for a in DENSE]
                         + [("h2o-danube-1.8b", 96)])
def test_serve_continues_like_the_reference_prefill_of_the_longer_prompt(
        arch, S):
    """``launch.serve.serve`` (prefill, ``grow_cache``, greedy decode) of
    2 prompts and 3 new tokens: every token it picks is the argmax of the
    reference's prefill of the prompt and the tokens before it, and the
    last logits are that prefill's.  S = 32 grows a 32-slot cache (under
    danube's window of 64 too); danube's S = 96 starts past the window:
    the ring is kept and wraps."""
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    jm = ref_build_model(ref_cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.float32, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    toks = _tokens(11, S)
    k = 3
    res = serve.serve(pm, pp, torch.from_numpy(toks), k)
    assert res.cache["len"] == S + k - 1
    full = np.concatenate([toks, res.tokens.numpy()], axis=1)
    prefill = jax.jit(jm.prefill)
    for t in range(k):
        jl, _ = prefill(jp, {"tokens": jnp.asarray(full[:, :S + t],
                                                   jnp.int32)})
        np.testing.assert_array_equal(res.tokens[:, t].numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
    _close(res.logits, jl, F32_TOL)


def test_grow_cache_keeps_what_needs_no_room(models):
    _, _, pm, pp = models
    toks = torch.from_numpy(_tokens(5, 96))
    _, cache = pm.prefill(pp, {"tokens": toks})
    grown = pm.grow_cache(cache, 100)
    W = pm.cfg.sliding_window
    for a, b in zip(cache["layers"], grown["layers"]):
        if W:                               # a full window's ring: kept
            assert b["k"] is a["k"] and b["k"].shape[1] == W
        else:
            assert b["k"].shape[1] == 100
            assert torch.equal(b["k"][:, :96], a["k"])
            assert not b["k"][:, 96:].any()
    with pytest.raises(ValueError):
        pm.grow_cache(cache, 95)


def test_bridged_bf16_params_keep_their_dtypes():
    """bf16 attention and MLP weights stay bf16 through
    ``params_from_tree`` and ``tensor_tree_from_params``, the norms f32;
    ``tree_from_params`` gives the reference's tree back."""
    arch = "granite-20b"
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    jp = ref_build_model(ref_cfg, jnp.bfloat16).init(jax.random.PRNGKey(0))
    pm = build_model(cfg, torch.bfloat16, device="cpu")
    pp = bridge.params_from_tree(jax.tree.map(np.asarray, jp), pm)
    lay = pp.layers[1]
    assert lay.attn["wq"].dtype == lay.mlp["w_up"].dtype == torch.bfloat16
    assert lay.norm1.dtype == torch.float32
    assert set(lay.mlp) == {"w_up", "w_down"}
    np.testing.assert_array_equal(
        lay.attn["wk"].detach().float().numpy(),
        np.asarray(jp["layers"]["pos0"]["attn"]["wk"][1].astype(jnp.float32)))
    tree = bridge.tensor_tree_from_params(pp)
    assert tree["layers"]["pos0"]["attn"]["wo"].dtype == torch.bfloat16
    back = jax.tree_util.tree_flatten_with_path(bridge.tree_from_params(pp))[0]
    expect = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(back) == len(expect)
    for path, v in back:
        np.testing.assert_array_equal(
            v, np.asarray(expect[path].astype(jnp.float32)))


def test_port_draws_every_layer_in_its_order():
    """``init`` on a seed: norms of ones, every weight with the
    reference's name and shape, and the same seed the same weights."""
    cfg = get_config("granite-20b").reduced()
    pm = build_model(cfg, torch.float32, device="cpu")
    a = pm.init(torch.Generator().manual_seed(0))
    b = pm.init(torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in a.named_parameters()}
    jp = ref_build_model(ref_get_config("granite-20b").reduced(),
                         jnp.float32).init(jax.random.PRNGKey(0))
    expect = {".".join(str(k.key) for k in path if hasattr(k, "key")): v
              for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for name, shape in shapes.items():
        if name.startswith("layers."):
            i, rest = name.split(".", 2)[1:]
            assert shape == expect["layers.pos0." + rest].shape[1:], name
            assert int(i) < cfg.num_layers
        else:
            assert shape == expect[name].shape, name
    assert len(shapes) == 3 + cfg.num_layers * 8
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert torch.equal(a.layers[0].norm1, torch.ones(cfg.d_model))
    assert a.layers[0].attn["wk"].shape == (256, 64)      # MQA: 1 KV head


def test_serve_main_runs_a_dense_arch_on_the_cpu(capsys):
    serve.main(["--arch", "llama3-8b", "--requests", "2", "--prompt-len",
                "32", "--max-new", "3", "--device", "cpu"])
    assert "llama3-8b-reduced on cpu" in capsys.readouterr().out
