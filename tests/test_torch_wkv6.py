"""The port's plain wkv6 (what ``ops.wkv6`` runs on the CPU) against the
reference's token-by-token oracle and its Pallas kernel in interpret mode,
on the same numpy inputs.

Tolerances: against the interpret kernel, which does the same chunk math in
f32, only the summation order differs — 1e-6 of max |ref| + rtol 1e-5
(observed ≤ 4e-7 of max |ref|); against the token oracle the chunk form
reassociates the whole recurrence — the reference's own 3e-4 (atol and
rtol, ``tests/test_wkv6_kernel.py``).  bf16 inputs: the same f32 math,
the output rounded to bf16 on both sides — one bf16 ulp (2^-8 relative)
plus the f32 atol.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _inputs(seed, BH, S, D, spread=1.0):
    """r, k, v ~ N(0, 1); w = exp(−exp(−6 + spread·N(0, 1))), the RWKV
    init's decays; a nonzero bonus u ~ 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(-6.0 + spread * rng.standard_normal((BH, S, D))))
    u = 0.1 * rng.standard_normal((BH, D))
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


def _close(got, expect, rtol, atol_frac):
    expect = np.asarray(expect, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), expect, rtol=rtol,
                               atol=atol_frac * np.abs(expect).max())


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("BH,S,D", [(1, 32, 8), (2, 64, 8), (1, 128, 32),
                                    (2, 64, 64)])
def test_wkv6_plain_matches_reference(BH, S, D, chunk):
    x = _inputs(BH * S + D + chunk, BH, S, D)
    out, state = ops.wkv6(*map(torch.from_numpy, x), chunk)
    assert out.dtype == torch.float32 and state.dtype == torch.float32
    assert out.shape == (BH, S, D) and state.shape == (BH, D, D)
    k_out, k_state = jops.wkv6(*map(jnp.asarray, x), chunk=chunk)
    _close(out, k_out, 1e-5, 1e-6)
    _close(state, k_state, 1e-5, 1e-6)
    o_out, o_state = jref.wkv6_ref(*map(jnp.asarray, x))
    np.testing.assert_allclose(out.numpy(), np.asarray(o_out), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(o_state), rtol=3e-4,
                               atol=3e-4)


def test_wkv6_plain_bf16_inputs():
    """bf16 r, k, v, w (f32 u, as the model passes it): out in bf16, the
    state in f32, both computed in f32."""
    r, k, v, w, u = _inputs(3, 2, 64, 16)
    rb, kb, vb, wb = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (r, k, v, w))
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (rb, kb, vb, wb)]
    out, state = ops.wkv6(*tb, torch.from_numpy(u))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    k_out, k_state = jops.wkv6(rb, kb, vb, wb, jnp.asarray(u))
    assert k_out.dtype == jnp.bfloat16
    _close(out.float(), np.asarray(k_out.astype(jnp.float32)), 8e-3, 1e-6)
    _close(state, k_state, 1e-5, 1e-6)


def test_wkv6_plain_strong_decay():
    """Spread 3.0 drives c_t toward the 1e-30 floor (the reference's
    ``test_chunked_strong_decay_stable``)."""
    x = _inputs(7, 2, 64, 8, spread=3.0)
    out, state = ops.wkv6(*map(torch.from_numpy, x))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    k_out, k_state = jops.wkv6(*map(jnp.asarray, x))
    _close(out, k_out, 1e-5, 1e-6)
    _close(state, k_state, 1e-5, 1e-6)
    o_out, _ = jref.wkv6_ref(*map(jnp.asarray, x))
    np.testing.assert_allclose(out.numpy(), np.asarray(o_out), rtol=5e-3,
                               atol=5e-3)


def test_wkv6_plain_bonus_is_the_diagonal_term():
    """With u = 0 the bonus vanishes; a nonzero u adds rowsum(r⊙u⊙k)·v."""
    r, k, v, w, u = map(torch.from_numpy, _inputs(11, 1, 32, 8))
    zero, _ = ops.wkv6(r, k, v, w, torch.zeros_like(u))
    with_u, _ = ops.wkv6(r, k, v, w, u)
    bonus = (r * u[:, None, :] * k).sum(-1, keepdim=True) * v
    torch.testing.assert_close(with_u - zero, bonus, rtol=1e-5, atol=1e-4)


def test_wkv6_plain_given_state_continues_the_sequence():
    """The plain version's optional start state: two halves with the first
    half's state carried over equal one call on the whole sequence."""
    x = [torch.from_numpy(a) for a in _inputs(5, 2, 64, 8)]
    whole, s_whole = ref.wkv6_ref(*x)
    first, s1 = ref.wkv6_ref(*(a[:, :32] for a in x[:4]), x[4])
    second, s2 = ref.wkv6_ref(*(a[:, 32:] for a in x[:4]), x[4], state=s1)
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s_whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(32, 32), (64, 32), (16, 16)])
def test_wkv6_given_state_matches_reference_chunked(S, chunk):
    """``ops.wkv6`` from a given start state (what the model runs for a
    prompt that continues a cache) against the reference's
    ``models/rwkv._wkv_chunked`` from the same state, in the model's
    (B, S, Hn, D) layout: the same chunk math, 1e-6 of max + rtol 1e-5."""
    B, Hn, D = 2, 2, 16
    r, k, v, w, _ = _inputs(S + chunk, B * Hn, S, D)
    rng = np.random.default_rng(S)
    u = (0.1 * rng.standard_normal((Hn, D))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((B, Hn, D, D))).astype(np.float32)

    def model_layout(a):                      # (B·Hn, S, D) -> (B, S, Hn, D)
        return jnp.asarray(a.reshape(B, Hn, S, D).transpose(0, 2, 1, 3))

    j_out, j_state = jrwkv._wkv_chunked(*map(model_layout, (r, k, v, w)),
                                        jnp.asarray(u), jnp.asarray(s0),
                                        chunk=chunk)
    out, state = ops.wkv6(*map(torch.from_numpy, (r, k, v, w)),
                          torch.from_numpy(np.tile(u, (B, 1))), chunk,
                          state=torch.from_numpy(s0.reshape(B * Hn, D, D)))
    _close(out.reshape(B, Hn, S, D).permute(0, 2, 1, 3),
           np.asarray(j_out), 1e-5, 1e-6)
    _close(state.reshape(B, Hn, D, D), np.asarray(j_state), 1e-5, 1e-6)


@pytest.mark.parametrize("S,chunk", [(33, 32), (48, 32), (8, 3)])
def test_wkv6_ragged_sequence_raises(S, chunk):
    r = torch.zeros((1, S, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.wkv6(r, r, r, r, torch.zeros((1, 8)), chunk)


def _model_layout_inputs(seed, B, S, Hn, D, spread=1.0):
    """The model's (B, S, Hn, D) r, k, v, w, (Hn, D) u and a (B, Hn, D, D)
    start state, drawn as ``_inputs`` draws them."""
    r, k, v, w, _ = _inputs(seed, B * Hn, S, D, spread)
    rng = np.random.default_rng(seed + 1)
    u = (0.1 * rng.standard_normal((Hn, D))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((B, Hn, D, D))).astype(np.float32)
    return [a.reshape(B, Hn, S, D).transpose(0, 2, 1, 3).copy()
            for a in (r, k, v, w)] + [u, s0]


@pytest.mark.parametrize("given", [False, True], ids=["zeros", "given"])
@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "slice"])
@pytest.mark.parametrize("B", [1, 2])
def test_wkv6_model_layout_matches_reference(B, ragged, given):
    """``ops.wkv6`` on the model's (B, S, Hn, D) layout — the whole
    projections, or ``t[:, :64]`` of 72 tokens as the model passes a ragged
    prompt's whole chunks (a strided view) — from zeros or a given state,
    against the reference's ``models/rwkv._wkv_chunked`` on the same
    chunks, and from zeros also against its interpret-mode Pallas kernel
    on the (B·Hn, S, D) transposes: the same chunk math, 1e-6 of max +
    rtol 1e-5."""
    Hn, D, n, chunk = 3, 16, 64, 32
    S = 72 if ragged else n
    *x, u, s0 = _model_layout_inputs(10 * B + ragged, B, S, Hn, D)
    views = [torch.from_numpy(a)[:, :n] for a in x]
    assert views[0].stride()[:2] == (S * Hn * D, Hn * D)
    state = torch.from_numpy(s0) if given else None
    out, st = ops.wkv6(*views, torch.from_numpy(u), chunk, state=state)
    assert out.shape == (B, n, Hn, D) and out.is_contiguous()
    assert st.shape == (B, Hn, D, D) and st.dtype == torch.float32
    j_s0 = s0 if given else np.zeros_like(s0)
    j_out, j_state = jrwkv._wkv_chunked(*(jnp.asarray(a[:, :n]) for a in x),
                                        jnp.asarray(u), jnp.asarray(j_s0),
                                        chunk=chunk)
    _close(out, j_out, 1e-5, 1e-6)
    _close(st, j_state, 1e-5, 1e-6)
    if not given:
        heads = [jnp.asarray(a[:, :n].transpose(0, 2, 1, 3).reshape(
            B * Hn, n, D)) for a in x]
        k_out, k_state = jops.wkv6(*heads, jnp.asarray(np.tile(u, (B, 1))),
                                   chunk=chunk)
        _close(out.permute(0, 2, 1, 3).reshape(B * Hn, n, D), k_out, 1e-5,
               1e-6)
        _close(st.reshape(B * Hn, D, D), k_state, 1e-5, 1e-6)


def test_wkv6_model_layout_bf16_inputs():
    """bf16 (B, S, Hn, D) inputs with an f32 u: out in bf16 and the state
    in f32, against the interpret-mode Pallas kernel on the bf16
    transposes (tolerances of ``test_wkv6_plain_bf16_inputs``)."""
    B, S, Hn, D = 2, 64, 2, 16
    *x, u, _ = _model_layout_inputs(4, B, S, Hn, D)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in x]
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jb]
    out, state = ops.wkv6(*tb, torch.from_numpy(u))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    heads = [a.transpose(0, 2, 1, 3).reshape(B * Hn, S, D) for a in jb]
    k_out, k_state = jops.wkv6(*heads, jnp.asarray(np.tile(u, (B, 1))))
    _close(out.float().permute(0, 2, 1, 3).reshape(B * Hn, S, D),
           np.asarray(k_out.astype(jnp.float32)), 8e-3, 1e-6)
    _close(state.reshape(B * Hn, D, D), k_state, 1e-5, 1e-6)


def test_wkv6_model_layout_strong_decay():
    """Spread 3.0 (c_t toward the 1e-30 floor) in the model's layout,
    against the reference's ``_wkv_chunked`` from a given state."""
    B, S, Hn, D = 2, 64, 2, 8
    *x, u, s0 = _model_layout_inputs(8, B, S, Hn, D, spread=3.0)
    out, state = ops.wkv6(*map(torch.from_numpy, x), torch.from_numpy(u),
                          state=torch.from_numpy(s0))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    j_out, j_state = jrwkv._wkv_chunked(*map(jnp.asarray, x),
                                        jnp.asarray(u), jnp.asarray(s0),
                                        chunk=32)
    _close(out, j_out, 1e-5, 1e-6)
    _close(state, j_state, 1e-5, 1e-6)


def test_wkv6_model_layout_ragged_sequence_raises():
    r = torch.zeros((2, 40, 3, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.wkv6(r, r, r, r, torch.zeros((3, 8)))
