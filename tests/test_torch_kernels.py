"""The port's kernels against the reference's kernels.

On the CPU, ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; it is held against the reference's jnp oracle
(``repro.kernels.ref``) and its Pallas kernel in interpret mode
(``repro.kernels.ops``) on the same numpy inputs, at the sizes and
tolerances of ``tests/test_kernel_parity.py`` (f32: rtol 1e-6 / atol 1e-5;
bf16: 0.05 / 0.5, the rounding of the result).  The CUDA kernels themselves
are held against the plain versions on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import cocoa_sdca as cuda_cocoa_sdca  # noqa: E402
from repro_torch.kernels import dane_update as cuda_dane_update  # noqa: E402
from repro_torch.kernels import fedavg_update as cuda_fedavg_update  # noqa: E402
from repro_torch.kernels import fsvrg_update as cuda_fsvrg_update  # noqa: E402
from repro_torch.kernels import robust_aggregate as cuda_robust  # noqa: E402
from repro_torch.kernels import scaled_aggregate as cuda_aggregate  # noqa: E402
from repro_torch.kernels import wkv6 as cuda_wkv6  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # test_kernel_parity.py's _tol: the f32 / bf16 rounding of the result
    return 1e-6 if name == "f32" else 0.05


def _both(x, name):
    """One numpy array as a jnp and a torch array of the same dtype (bf16
    rounds to nearest even in both)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 127, 999, 1000])
def test_fsvrg_update_matches_reference(d, dtype):
    rng = np.random.default_rng(d)
    arrs = [rng.standard_normal(d).astype(np.float32) for _ in range(5)]
    j, t = zip(*[_both(a, dtype) for a in arrs])
    h = 0.7
    out = ops.fsvrg_update(*t, h)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (d,)
    tol = _tol(dtype)
    for expect in (jref.fsvrg_update_ref(*j, h), jops.fsvrg_update(*j, h)):
        np.testing.assert_allclose(_f32(out), _f32(expect), rtol=tol,
                                   atol=tol * 10)


def test_fsvrg_update_batched_and_broadcast_forms():
    """(R, d) rows with per-row h, and g_old / ḡ / S as shared (d,) rows,
    equal a row-by-row loop over the reference's 1-D oracle."""
    R, d = 6, 257
    rng = np.random.default_rng(7)
    w, s, gn, go, gb = (rng.standard_normal((R, d)).astype(np.float32)
                        for _ in range(5))
    h = rng.uniform(0.1, 1.0, R).astype(np.float32)
    T = torch.tensor
    for s_row, go_row, gb_row in [(False, False, False), (False, True, True),
                                  (True, True, False)]:
        s_in = s[0] if s_row else s
        go_in = go[0] if go_row else go
        gb_in = gb[0] if gb_row else gb
        out = ops.fsvrg_update(T(w), T(s_in), T(gn), T(go_in), T(gb_in), T(h))
        for r in range(R):
            pick = lambda a, shared: a if shared else a[r]
            expect = jref.fsvrg_update_ref(
                jnp.asarray(w[r]), jnp.asarray(pick(s_in, s_row)),
                jnp.asarray(gn[r]), jnp.asarray(pick(go_in, go_row)),
                jnp.asarray(pick(gb_in, gb_row)), float(h[r]))
            np.testing.assert_allclose(out[r].numpy(), np.asarray(expect),
                                       rtol=1e-6, atol=1e-5)
    # a scalar h on a batch is the same h on every row
    out = ops.fsvrg_update(T(w), T(s), T(gn), T(go), T(gb), 0.3)
    rows = torch.stack([ops.fsvrg_update(T(w[r]), T(s[r]), T(gn[r]), T(go[r]),
                                         T(gb[r]), 0.3) for r in range(R)])
    torch.testing.assert_close(out, rows, rtol=0, atol=0)


def test_fsvrg_update_zero_h_rows_are_exact_noops():
    """h = 0 leaves a row bit for bit as it was — how the client pass
    masks padded permutation slots — and ``out=w`` updates in place."""
    R, d = 5, 1000
    rng = np.random.default_rng(3)
    w, s, gn, gb = (torch.tensor(rng.standard_normal((R, d)),
                                 dtype=torch.float32) for _ in range(4))
    h = torch.tensor([0.0, 0.5, 0.0, 0.25, 0.0])
    w0 = w.clone()
    out = ops.fsvrg_update(w, s, gn, torch.zeros(d), gb, h, out=w)
    assert out is w
    for r in (0, 2, 4):
        assert torch.equal(w[r], w0[r])
    for r in (1, 3):
        assert not torch.equal(w[r], w0[r])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 127, 999, 1000])
def test_fedavg_update_matches_reference(d, dtype):
    rng = np.random.default_rng(100 + d)
    (jw, tw), (jg, tg) = (_both(rng.standard_normal(d).astype(np.float32),
                                dtype) for _ in range(2))
    h, lam = 0.3, 0.05
    out = ops.fedavg_update(tw, tg, h, lam)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (d,)
    tol = _tol(dtype)
    for expect in (jref.fedavg_update_ref(jw, jg, h, lam),
                   jops.fedavg_update(jw, jg, h, lam)):
        np.testing.assert_allclose(_f32(out), _f32(expect), rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 127, 999, 1000])
def test_dane_update_matches_reference(d, dtype):
    rng = np.random.default_rng(200 + d)
    j, t = zip(*[_both(rng.standard_normal(d).astype(np.float32), dtype)
                 for _ in range(4)])
    lr, lam, mu = 0.4, 0.03, 0.2
    out = ops.dane_update(*t, lr, lam, mu)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (d,)
    tol = _tol(dtype)
    for expect in (jref.dane_update_ref(*j, lr, lam, mu),
                   jops.dane_update(*j, lr, lam, mu)):
        np.testing.assert_allclose(_f32(out), _f32(expect), rtol=tol,
                                   atol=tol * 10)


def _sdca_inputs(rng, d):
    """test_kernel_parity.py's inputs: β₀ inside the box, m ~ N(0, 1),
    c = |N(0, 1)|/2."""
    return (rng.uniform(0.05, 0.95, d).astype(np.float32),
            rng.standard_normal(d).astype(np.float32),
            (np.abs(rng.standard_normal(d)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 127, 999, 1000])
def test_cocoa_sdca_update_matches_reference(d, dtype):
    j, t = zip(*[_both(x, dtype)
                 for x in _sdca_inputs(np.random.default_rng(300 + d), d)])
    out = ops.cocoa_sdca_update(*t)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (d,)
    tol = _tol(dtype)
    for expect in (jref.cocoa_sdca_update_ref(*j),
                   jops.cocoa_sdca_update(*j)):
        np.testing.assert_allclose(_f32(out), _f32(expect), rtol=tol,
                                   atol=tol * 10)
    assert 0.0 < _f32(out).min() and _f32(out).max() < 1.0


def test_cocoa_sdca_update_padding_and_clip():
    """The reference's padding values (β₀ = ½, m = c = 0) are a fixed point
    at ½; coordinates driven to either clip — |m| up to 40, c from 0 to the
    main path's ≈ 10⁴ — agree with the reference's oracle.  Held at atol
    1e-6: near the clip the Newton steps take log and 1/(β(1−β)) of
    β ≈ 1e-6, where torch's and XLA's log may differ by an ulp (observed:
    2.3e-10; 6.0e-8 on the parity inputs at d = 1000)."""
    pad = torch.tensor([0.5, 0.5]), torch.zeros(2), torch.zeros(2)
    assert torch.equal(ops.cocoa_sdca_update(*pad), torch.full((2,), 0.5))
    rng = np.random.default_rng(17)
    d = 400
    b0 = rng.choice([1e-6, 0.5, 1.0 - 1e-6, 0.3], d).astype(np.float32)
    m = (rng.choice([-1.0, 1.0], d) * rng.uniform(5.0, 40.0, d)).astype(
        np.float32)
    c = rng.choice([0.0, 1e-3, 1.0, 1e4], d).astype(np.float32)
    out = ops.cocoa_sdca_update(torch.tensor(b0), torch.tensor(m),
                                torch.tensor(c))
    expect = jref.cocoa_sdca_update_ref(jnp.asarray(b0), jnp.asarray(m),
                                        jnp.asarray(c))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=0,
                               atol=1e-6)
    near = (out.numpy() < 1e-4) | (out.numpy() > 1.0 - 1e-4)
    assert near.mean() > 0.2
    assert out.min() >= np.float32(1e-6) and out.max() <= np.float32(1 - 1e-6)


def test_fedavg_and_dane_updates_batched_forms():
    """(R, d) rows with per-row h (FedAvg) or a shared w^t row (DANE) equal
    a row-by-row loop over the reference's 1-D oracles; h = 0 rows are
    exact no-ops, and ``out=w`` updates in place."""
    R, d = 6, 257
    rng = np.random.default_rng(8)
    w, g, a, wt = (rng.standard_normal((R, d)).astype(np.float32)
                   for _ in range(4))
    h = rng.uniform(0.1, 1.0, R).astype(np.float32)
    h[::2] = 0.0
    T, J = torch.tensor, jnp.asarray
    lam = 0.05
    out = ops.fedavg_update(T(w), T(g), T(h), lam)
    for r in range(R):
        expect = jref.fedavg_update_ref(J(w[r]), J(g[r]), float(h[r]), lam)
        np.testing.assert_allclose(out[r].numpy(), np.asarray(expect),
                                   rtol=1e-6, atol=1e-6)
    assert torch.equal(out[::2], T(w[::2]))
    tw = T(w)
    assert ops.fedavg_update(tw, T(g), T(h), lam, out=tw) is tw
    assert torch.equal(tw, out)
    lr, mu = 0.3, 3.0
    for shared in (False, True):
        wt_in = wt[0] if shared else wt
        out = ops.dane_update(T(w), T(g), T(a), T(wt_in), lr, lam, mu)
        for r in range(R):
            expect = jref.dane_update_ref(J(w[r]), J(g[r]), J(a[r]),
                                          J(wt_in if shared else wt[r]), lr,
                                          lam, mu)
            np.testing.assert_allclose(out[r].numpy(), np.asarray(expect),
                                       rtol=1e-6, atol=1e-6)
    # lr = 0 is an exact no-op too
    assert torch.equal(ops.dane_update(T(w), T(g), T(a), T(wt[0]), 0.0, lam,
                                       mu), T(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 127, 999, 1000])
@pytest.mark.parametrize("K", [1, 8, 9, 33])
def test_fused_aggregate_matches_reference(K, d, dtype):
    rng = np.random.default_rng(K * 1000 + d)
    wt = rng.standard_normal(d).astype(np.float32)
    deltas = rng.standard_normal((K, d)).astype(np.float32)
    wts = rng.dirichlet(np.ones(K)).astype(np.float32)
    a = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
    scale = 1.3
    jd, td = _both(deltas, dtype)
    out = ops.fused_aggregate(torch.tensor(wt), td, torch.tensor(wts),
                              torch.tensor(a), scale)
    assert out.dtype == torch.float32 and out.shape == (d,)
    tol = 1e-5 if dtype == "f32" else 0.05     # test_kernel_parity.py's
    args = (jnp.asarray(wt), jd, jnp.asarray(wts), jnp.asarray(a), scale)
    for expect in (jref.fused_aggregate_ref(*args), jops.fused_aggregate(*args)):
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_aggregate_wrappers_match_reference(dtype):
    """fused_accumulate, fused_epilogue and scaled_aggregate — the thin
    wrappers over the same kernel — against the reference's."""
    K, d = 9, 999
    rng = np.random.default_rng(11)
    acc = rng.standard_normal(d).astype(np.float32)
    deltas = rng.standard_normal((K, d)).astype(np.float32)
    wts = rng.dirichlet(np.ones(K)).astype(np.float32)
    a = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
    tol = 1e-5 if dtype == "f32" else 0.05
    jd, td = _both(deltas, dtype)
    T, J = torch.tensor, jnp.asarray
    cases = [
        (ops.fused_accumulate(T(acc), td, T(wts)),
         (jref.fused_accumulate_ref(J(acc), jd, J(wts)),
          jops.fused_accumulate(J(acc), jd, J(wts)))),
        (ops.fused_epilogue(T(acc), T(deltas[0]), T(a), 0.8),
         (jref.fused_epilogue_ref(J(acc), J(deltas[0]), J(a), 0.8),
          jops.fused_epilogue(J(acc), J(deltas[0]), J(a), 0.8))),
        (ops.scaled_aggregate(T(acc), td, T(wts), T(a)),
         (jref.scaled_aggregate_ref(J(acc), jd, J(wts), J(a)),
          jops.scaled_aggregate(J(acc), jd, J(wts), J(a)))),
    ]
    for out, expects in cases:
        for expect in expects:
            np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                       rtol=tol, atol=tol)


def test_plain_versions_are_what_ops_runs_on_cpu():
    """On the CPU ops is the plain version exactly, and counts no launch."""
    rng = np.random.default_rng(5)
    x = [torch.tensor(rng.standard_normal((4, 33)), dtype=torch.float32)
         for _ in range(3)]
    wts = torch.tensor(rng.dirichlet(np.ones(4)), dtype=torch.float32)
    before = ops.launch_counts()
    assert torch.equal(ops.fused_aggregate(x[0][0], x[1], wts, x[2][0], 0.5),
                       ref.fused_aggregate_ref(x[0][0], x[1], wts, x[2][0],
                                               0.5))
    assert torch.equal(ops.fused_accumulate(x[0][0], x[1], wts),
                       ref.fused_accumulate_ref(x[0][0], x[1], wts))
    assert torch.equal(ops.fused_epilogue(x[0][0], x[1][0], x[2][0], 0.5),
                       ref.fused_epilogue_ref(x[0][0], x[1][0], x[2][0], 0.5))
    assert torch.equal(
        ops.fsvrg_update(x[0], x[1], x[2], x[0][0], x[1][0], wts),
        ref.fsvrg_update_ref(x[0], x[1], x[2], x[0][0], x[1][0], wts))
    assert torch.equal(ops.fedavg_update(x[0], x[1], wts, 0.1),
                       ref.fedavg_update_ref(x[0], x[1], wts, 0.1))
    assert torch.equal(ops.dane_update(x[0], x[1], x[2], x[0][0], 0.3, 0.1, 2.),
                       ref.dane_update_ref(x[0], x[1], x[2], x[0][0], 0.3,
                                           0.1, 2.))
    b0 = torch.sigmoid(x[0][0])
    assert torch.equal(ops.cocoa_sdca_update(b0, x[1][0], x[2][0].abs()),
                       ref.cocoa_sdca_update_ref(b0, x[1][0], x[2][0].abs()))
    # a bucket of 4 clients × 33 steps, 3 features a row (one repeated)
    idx = torch.as_tensor(rng.integers(0, 5, (4, 33, 3)))
    idx[..., 1] = idx[..., 0]
    val, y = x[1][..., None].expand(4, 33, 3).contiguous(), x[2].sign()
    n_k = torch.tensor([33, 20, 1, 7])
    perms = torch.stack([torch.randperm(33, generator=torch.Generator()
                                        .manual_seed(k)) for k in range(4)])
    r1, r2 = torch.empty(4, 5), torch.empty(4, 5)
    assert torch.equal(
        ops.cocoa_sdca_pass(x[0][0, :5], wts[:, None] * y, idx, val, y, n_k,
                            perms, 4.0, 0.01, 60, r1),
        ref.cocoa_sdca_pass_ref(x[0][0, :5], wts[:, None] * y, idx, val, y,
                                n_k, perms, 4.0, 0.01, 60, r2))
    assert torch.equal(r1, r2)
    valid = torch.tensor([True, False, True, True])
    assert torch.equal(
        ops.robust_aggregate(x[0][0], x[1], valid, x[2][0], 0.25, "median"),
        ref.robust_aggregate_ref(x[0][0], x[1], valid, x[2][0], 0.25,
                                 "median"))
    r, k, v = (t[:, :, None] for t in x)      # BH = 4, S = 33, D = 1
    w, u = torch.sigmoid(v), x[0][:, :1]
    assert all(torch.equal(a, b) for a, b in zip(
        ops.wkv6(r, k, v, w, u, 11), ref.wkv6_ref(r, k, v, w, u, 11)))
    g = x[1][:, :, None]
    got = ops.wkv6_bwd(r, k, v, w, u, g, 11)
    assert got[-1] is None and all(torch.equal(a, b) for a, b in zip(
        got[:-1], ref.wkv6_bwd_ref(r, k, v, w, u, g, 11)[:-1]))
    from repro_torch.kernels.segment_sum import segment_plan
    plan = segment_plan(idx + 5 * torch.arange(4)[:, None, None], 20,
                        keep=val != 0)
    assert torch.equal(ops.segment_sum(plan, x[2], val, torch.empty(4, 5)),
                       ref.segment_sum_ref(plan, x[2], val,
                                           torch.empty(4, 5)))
    # a selective scan of 4 sequences × 33 steps, 16 channels, N = 16
    xs = x[0][:, :, None].expand(4, 33, 16) * x[1][0, :16]
    bc = x[2][:, :, None].expand(4, 33, 32) * x[0][0, :32]
    scan = (xs, x[1], x[2][0, :16], x[0][:, :16].abs().repeat(4, 1),
            bc[..., :16], bc[..., 16:], x[1][0, 16:32])
    assert all(torch.equal(a, b) for a, b in zip(
        ops.selective_scan(*scan), ref.selective_scan_ref(*scan)))
    assert ops.launch_counts() == before
    assert set(before) == {"fused_aggregate", "fused_accumulate",
                           "fused_epilogue", "fsvrg_update", "fedavg_update",
                           "dane_update", "cocoa_sdca_update",
                           "cocoa_sdca_pass", "robust_aggregate", "wkv6",
                           "wkv6_bwd", "segment_sum", "selective_scan"}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: ops, not the wrappers,
    decides that a CPU tensor goes to the plain version."""
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_aggregate.fused_aggregate(v, v[None], torch.ones(1), v)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fsvrg_update.fsvrg_update(v, v, v, v, v, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fedavg_update.fedavg_update(v, v, 0.5, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dane_update.dane_update(v, v, v, v, 0.5, 0.1, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cocoa_sdca.cocoa_sdca_update(v, v, v)
    i3 = torch.zeros((1, 8, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cocoa_sdca.cocoa_sdca_pass(v, v[None], i3, i3.float(), v[None],
                                        torch.ones(1, dtype=torch.int64),
                                        i3[..., 0], 1.0, 0.1, 8, v[None])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_aggregate.fused_epilogue(v, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_robust.robust_aggregate(v, v[None], torch.ones(1, dtype=bool), v)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wkv6.wkv6(v[None, None], v[None, None], v[None, None],
                       v[None, None], v[None])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wkv6.wkv6_bwd(v[None, None], v[None, None], v[None, None],
                           v[None, None], v[None], v[None, None])


def test_aggregate_splits_fill_the_card_at_paper_shape():
    """The grid rule at the paper's K = 10,000, d = 20,002 f32, on 132 SMs
    holding 8 blocks of 8 warps each: float2 lanes, 313 strips × 26 splits
    of 385 rows = 8,138 units of one warp, all in one wave of the 8,448
    resident warps (one more split of every strip would not fit), no split
    empty, no strip wider than it must be; small K is never over-cut."""
    lanes = cuda_aggregate.LANES
    slots = 132 * 8 * (cuda_aggregate.THREADS // lanes)
    p = cuda_aggregate.plan(10_000, 20_002, 2, slots)
    assert (p.vec, p.strips, p.splits, p.rows) == (2, 313, 26, 385)
    assert p.units <= slots < p.units + p.strips
    for K, d, vec in [(9, 999, 1), (10_000, 20_002, 2), (6_478, 20_002, 2),
                      (1, 1, 1), (10_000, 1, 1), (33, 1_000, 2),
                      (300, 20_001, 1), (5, 400_000, 2)]:
        p = cuda_aggregate.plan(K, d, vec, slots)
        assert (p.splits - 1) * p.rows < K <= p.splits * p.rows   # none empty
        assert (p.strips - 1) * lanes * vec < d <= p.strips * lanes * vec
        assert p.units <= slots or p.splits == 1
        assert p.splits <= -(-K // cuda_aggregate.MIN_ROWS)
    assert cuda_aggregate.plan(1, 20_002, 2, slots).splits == 1
    assert cuda_aggregate.plan(33, 1, 1, slots).splits == 2
    # float2 lanes only where every row starts 8-byte aligned
    flat = torch.zeros(4 * 20_003)
    assert cuda_aggregate.vec_for(flat[:3 * 20_002].view(3, 20_002)) == 2
    assert cuda_aggregate.vec_for(flat[1:1 + 3 * 20_002].view(3, 20_002)) == 1
    assert cuda_aggregate.vec_for(flat[:3 * 999].view(3, 999)) == 1
    assert cuda_aggregate.vec_for(
        flat[:3 * 1_002].view(3, 1_002).to(torch.bfloat16)) == 2
