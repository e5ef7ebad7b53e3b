"""The backward of the port's wkv6 on the CPU: ``ref.wkv6_bwd_ref`` (the
plain version of the ``wkv6_bwd`` kernel) against ``torch.autograd``
through ``ref.wkv6_ref`` and against ``jax.vjp`` of the reference's
``models/rwkv._wkv_chunked``, on the same numpy inputs, in both layouts,
from a zero and a given start state, with and without a cotangent of the
final state; and the autograd function that joins the two kernels.

Tolerances: f32 sums of the same terms in other orders (the reverse chunk
walk against autograd's and XLA's): 1e-5 of each gradient's max (observed
≤ 5.3e-7).  Where the decay's cumulative product falls below the 1e-30
clamp, the reference's own f32 VJP of the decay is inf or NaN (it forms
k / max(c, 1e-30)² before the clamp's zero), in JAX and in torch alike;
there the port is held against the reference's VJP in f64 (1e-5 of the
max, observed ≤ 4.3e-7) and must be finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_kernel  # noqa: E402

TOL = 1e-5
NAMES = ("r", "k", "v", "w", "u", "state")


def _inputs(seed, shape, heads=None, strong=False):
    """r, k, v ~ N(0, 1), RWKV-like decays exp(−exp(−6 + N(0, 1))), u ~
    0.1·N(0, 1), a start state, d_out and d_final, as numpy f32; with
    ``strong`` four channels decay at 0.05–0.2 a step, so cumprod(w) falls
    below 1e-30 inside a chunk of 32."""
    rng = np.random.default_rng(seed)
    D = shape[-1]
    r, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.exp(-6 + rng.standard_normal(shape))).astype(np.float32)
    if strong:
        w[..., :4] = rng.uniform(0.05, 0.2, w[..., :4].shape)
    u = (0.1 * rng.standard_normal((shape[0] if heads is None else heads,
                                    D))).astype(np.float32)
    s_shape = shape[:1] + (() if heads is None else (heads,)) + (D, D)
    s0 = (0.5 * rng.standard_normal(s_shape)).astype(np.float32)
    gf = rng.standard_normal(s_shape).astype(np.float32)
    return (r, k, v, w, u), s0, g, gf


def _autograd(x, s0, g, gf, chunk):
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    st = None if s0 is None else torch.tensor(s0, requires_grad=True)
    out, fin = ref.wkv6_ref(*xs, chunk, state=st)
    loss = (out * torch.tensor(g)).sum()
    if gf is not None:
        loss = loss + (fin * torch.tensor(gf)).sum()
    grads = torch.autograd.grad(loss, xs + ([] if st is None else [st]))
    return [t.numpy() for t in grads]


def _jax_vjp(x, s0, g, gf, chunk, heads, dtype=jnp.float32):
    """jax.vjp of the reference's _wkv_chunked, run in its (B, S, Hn, D)
    layout: a (BH, S, D) input is one batch of BH heads."""
    r, k, v, w, u = x
    if heads is None:                       # (BH, S, D) -> (1, S, BH, D)
        r, k, v, w, g = (a.transpose(1, 0, 2)[None] for a in (r, k, v, w, g))
    B, S, Hn, D = r.shape
    state = (np.zeros((B, Hn, D, D), np.float32) if s0 is None
             else s0.reshape(B, Hn, D, D))
    cot = (g, np.zeros_like(state) if gf is None else gf.reshape(state.shape))

    def f(r, k, v, w, u, s):
        return ref_rwkv._wkv_chunked(r, k, v, w, u, s, chunk)

    _, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (r, k, v, w, u,
                                                          state)))
    grads = [np.asarray(a) for a in vjp(tuple(jnp.asarray(a, dtype)
                                              for a in cot))]
    if heads is None:
        grads[:4] = [a[0].transpose(1, 0, 2) for a in grads[:4]]
        grads[5] = grads[5][0]
    return grads if s0 is not None else grads[:5]


def _port(x, s0, g, gf, chunk):
    out = ops.wkv6_bwd(*map(torch.tensor, x), torch.tensor(g), chunk,
                       state=None if s0 is None else torch.tensor(s0),
                       d_state=None if gf is None else torch.tensor(gf))
    *grads, ds = out
    assert (ds is None) == (s0 is None)
    return [t.numpy() for t in grads] + ([] if ds is None else [ds.numpy()])


def _close(name, got, expect, tol=TOL):
    assert got.shape == expect.shape, name
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=tol * np.abs(expect).max(), err_msg=name)


@pytest.mark.parametrize("given", [True, False], ids=["given", "zeros"])
@pytest.mark.parametrize("shape,heads,chunk", [
    ((3, 64, 16), None, 32),        # (BH, S, D), two chunks
    ((2, 96, 8), None, 16),         # six chunks of 16
    ((2, 64, 3, 16), 3, 32),        # the model's (B, S, Hn, D)
    ((1, 32, 4, 64), 4, 32),        # one chunk, D = 64
], ids=["bh-2x32", "bh-6x16", "model-2x32", "model-1x32-d64"])
def test_wkv6_bwd_ref_matches_autograd_and_jax(shape, heads, chunk, given):
    x, s0, g, gf = _inputs(sum(shape), shape, heads)
    if not given:
        s0 = gf = None
    port = _port(x, s0, g, gf, chunk)
    auto = _autograd(x, s0, g, gf, chunk)
    jx = _jax_vjp(x, s0, g, gf, chunk, heads)
    assert len(port) == len(auto) == len(jx) == (6 if given else 5)
    for name, p, a, j in zip(NAMES, port, auto, jx):
        _close(name + " vs autograd", p, a)
        _close(name + " vs jax.vjp", p, j)


@pytest.mark.parametrize("heads", [None, 4], ids=["bh", "model"])
def test_wkv6_bwd_ref_where_the_clamp_fires(heads):
    """cumprod(w) < 1e-30 in some channels: the port's VJP is finite and
    agrees with the reference's own VJP taken in f64; elsewhere it agrees
    with the f32 autograd and jax.vjp, whose decay gradient is not finite
    in the clamped channels."""
    shape = (2, 64, 16) if heads is None else (2, 64, heads, 16)
    x, s0, g, gf = _inputs(7, shape, heads, strong=True)
    c = np.cumprod(x[3].reshape(shape[0], 2, 32, *shape[2:]), axis=2)
    assert (c < 1e-30).any()
    port = _port(x, s0, g, gf, 32)
    assert all(np.isfinite(p).all() for p in port)
    with jax.enable_x64():
        j64 = _jax_vjp(x, s0, g, gf, 32, heads, jnp.float64)
    auto = _autograd(x, s0, g, gf, 32)
    for name, p, j, a in zip(NAMES, port, j64, auto):
        _close(name + " vs f64 jax.vjp", p, j)
        ok = np.isfinite(a)
        np.testing.assert_allclose(p[ok], a[ok], rtol=0,
                                   atol=TOL * np.abs(j).max(),
                                   err_msg=name + " vs autograd")
    assert not np.isfinite(auto[3]).all()   # the f32 reference's dw


def test_ops_wkv6_is_differentiable_on_the_cpu():
    """On the CPU ops.wkv6 is the plain version and autograd differentiates
    it; ops.wkv6_bwd is the plain backward."""
    x, s0, g, gf = _inputs(3, (2, 64, 2, 8), 2)
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    out, fin = ops.wkv6(*xs, 32, state=torch.tensor(s0))
    grads = torch.autograd.grad((out * torch.tensor(g)).sum()
                                + (fin * torch.tensor(gf)).sum(), xs)
    port = _port(x, s0, g, gf, 32)
    for name, a, p in zip(NAMES, grads, port):
        _close(name, p, a.numpy())


def test_wkv6_autograd_function_plumbing(monkeypatch):
    """kernels.wkv6.WKV6 with its two kernels stood in for by their plain
    versions (the kernels run only on the card): the cotangents reach r, k,
    v, w, u and the start state, in u's dtype, a missing cotangent of the
    final state counts as zero, and each kernel is called once."""
    calls = []

    def fwd(*a, **kw):
        calls.append("wkv6")
        return ref.wkv6_ref(*a, **kw)

    def bwd(*a, **kw):
        calls.append("wkv6_bwd")
        return ref.wkv6_bwd_ref(*a, **kw)

    monkeypatch.setattr(wkv6_kernel, "wkv6", fwd)
    monkeypatch.setattr(wkv6_kernel, "wkv6_bwd", bwd)
    x, s0, g, _ = _inputs(5, (2, 64, 2, 8), 2)
    for with_state in (True, False):
        calls.clear()
        xs = [torch.tensor(a, requires_grad=True) for a in x]
        st = torch.tensor(s0, requires_grad=True) if with_state else None
        out, _ = wkv6_kernel.WKV6.apply(*xs, st, 32)
        leaves = xs + ([st] if with_state else [])
        grads = torch.autograd.grad((out * torch.tensor(g)).sum(), leaves)
        assert calls == ["wkv6", "wkv6_bwd"]
        expect = _autograd(x, s0 if with_state else None, g, None, 32)
        for name, a, e in zip(NAMES, grads, expect):
            assert a.dtype == torch.float32
            _close(name, a.numpy(), e)


def test_wkv6_bwd_kernel_wrapper_refuses_cpu_tensors():
    x, s0, g, _ = _inputs(1, (2, 32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel.wkv6_bwd(*map(torch.tensor, x), torch.tensor(g))


@pytest.mark.parametrize("shape,chunk,n,scan_blocks", [
    ((2, 128, 40, 64), 32, 4, 1_280),        # the training path
    ((8, 2_048, 40, 64), 32, 64, 5_120),     # the serving shape
    ((2, 32, 40, 64), 32, 1, 1_280),         # S = L: one chunk
    ((3, 33, 2, 16), 11, 3, 6),              # chunk 11
    ((2, 96, 4, 64), 16, 6, 128),            # chunk 16
    ((2, 64, 3, 1), 32, 2, 1),               # D = 1
    ((2, 64, 3, 32), 32, 2, 24),             # D = 32
], ids=["train", "serve", "one-chunk", "chunk-11", "chunk-16", "d1", "d32"])
def test_wkv6_bwd_launch_plan(shape, chunk, n, scan_blocks):
    """The backward's three launches: a block a (pair, chunk) for the
    chunk terms and the chunk backward, a thread a (pair, i, j) for the
    state scan (256 a block, none idle but in the last block); one f32
    scratch of two (pairs, chunks, D, D) state arrays, c_L a (pair, chunk)
    and last a du row a (pair, chunk)."""
    B, S, Hn, D = shape
    pairs = B * Hn
    p = wkv6_kernel.bwd_plan(pairs, S, D, chunk)
    assert (p.pairs, p.chunks) == (pairs, n)
    assert p.blocks == pairs * n
    assert p.scan_blocks == scan_blocks
    threads = wkv6_kernel.SCAN_THREADS
    assert ((p.scan_blocks - 1) * threads < pairs * D * D
            <= p.scan_blocks * threads)
    assert p.states == (pairs, n, D, D)
    assert p.decays == (pairs, n, D)
    assert p.du_rows == (pairs * n, D)
    assert p.du_offset == 2 * np.prod(p.states) + np.prod(p.decays)
    assert p.scratch == p.du_offset + np.prod(p.du_rows)
    if shape == (8, 2_048, 40, 64):          # 335.5 MB each state array
        assert 4 * np.prod(p.states) == 335_544_320
