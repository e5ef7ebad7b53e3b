"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; the file
imports neither JAX nor the reference, so it runs on the card's machine:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the aggregation sums K in another order (splits of fused
multiply-adds) than the plain version; the local steps contract into fused
multiply-adds where the plain version rounds each operation; the SDCA
Newton solve takes logf and divisions that may round an ulp apart from
PyTorch's, over 12 steps; the robust aggregation sums its rank window in
another order (atol 1e-6 + rtol 1e-5); wkv6 adds the same f32 terms as
its plain version in FMAs and its own order (1e-6 of max |plain| + rtol
1e-5; a bf16 out one bf16 ulp, rtol 1e-2); wkv6_bwd likewise against
autograd through the plain forward (1e-5 of max |plain| + rtol 1e-5);
selective_scan fuses a·h + b into one multiply-add and sums over the
states in its own order (1e-5 of max |plain| + rtol 1e-5).  The
threefry draws and everything made of them (fleet masks, fault kinds) are
bit-equal to the CPU's.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CoCoAPlus, FedAvg, Trainer,  # noqa: E402
                              build_problem, make_solver)
from repro_torch.configs import get_config, get_logreg_config  # noqa: E402
from repro_torch.data import generate  # noqa: E402
from repro_torch.fleet import (DeltaFaults, FleetTrace,  # noqa: E402
                               TraceParticipation, fleet_masks)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import cocoa_sdca as cs_kernel  # noqa: E402
from repro_torch.kernels import robust_aggregate as ra_kernel  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see README: PyTorch port)")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,d", [(1, 1), (9, 999), (33, 1000), (5, 1002),
                                 (300, 20_002)])
def test_fused_aggregate_matches_plain(cuda, K, d, dtype, tol):
    g = _gen(cuda)
    wt, a = (torch.randn(d, device=cuda, generator=g) for _ in range(2))
    deltas = torch.randn((K, d), device=cuda, generator=g).to(dtype)
    wts = torch.rand(K, device=cuda, generator=g)
    for scale in (0.9, torch.tensor(1.7, device=cuda)):
        before = ops.launch_counts()["fused_aggregate"]
        out = ops.fused_aggregate(wt, deltas, wts, a, scale)
        assert ops.launch_counts()["fused_aggregate"] == before + 1
        torch.testing.assert_close(
            out, ref.fused_aggregate_ref(wt, deltas, wts, a, scale),
            rtol=tol, atol=tol)
    acc = torch.randn(d, device=cuda, generator=g)
    torch.testing.assert_close(ops.fused_accumulate(acc, deltas, wts),
                               ref.fused_accumulate_ref(acc, deltas, wts),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(ops.fused_epilogue(wt, acc, a, 0.5),
                               ref.fused_epilogue_ref(wt, acc, a, 0.5),
                               rtol=tol, atol=tol)
    w_ks = deltas.float() + wt
    torch.testing.assert_close(ops.scaled_aggregate(wt, w_ks, wts, a),
                               ref.scaled_aggregate_ref(wt, w_ks, wts, a),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,d", [(1, 1), (9, 999), (5, 1002), (2_000, 20_002)])
def test_fused_aggregate_is_bit_equal_from_call_to_call(cuda, K, d, dtype):
    """Two calls give the same bits (the splits' partial sums are added in
    a fixed order, no atomics); the epilogue entry counts one launch."""
    g = _gen(cuda, 9)
    wt, a, acc = (torch.randn(d, device=cuda, generator=g) for _ in range(3))
    deltas = torch.randn((K, d), device=cuda, generator=g).to(dtype)
    wts = torch.rand(K, device=cuda, generator=g)
    s = torch.tensor(0.7, device=cuda)
    first = ops.fused_aggregate(wt, deltas, wts, a, s)
    assert torch.equal(ops.fused_aggregate(wt, deltas, wts, a, s), first)
    assert torch.equal(ops.fused_accumulate(acc, deltas, wts),
                       ops.fused_accumulate(acc, deltas, wts))
    before = ops.launch_counts()
    out = ops.fused_epilogue(wt, acc, a, s)
    after = ops.launch_counts()
    assert after["fused_epilogue"] == before["fused_epilogue"] + 1
    assert after["fused_aggregate"] == before["fused_aggregate"]
    torch.testing.assert_close(out, ref.fused_epilogue_ref(wt, acc, a, s),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K,d", [(1, 20_002), (1_024, 20_002),
                                 (784, 20_002), (1, 999)])
def test_fused_accumulate_at_the_streamed_chunk_shapes(cuda, K, d):
    """The streamed round's per-chunk entry at its shapes — one client, a
    full chunk of 1,024 at the §4 width, the last chunk of a bucket
    (10,000 − 9·1,024 = 784 clients) — and the same last chunk padded to
    1,024 with zero-weight rows of large finite values, which add nothing;
    each call counts one fused_accumulate launch and no fused_aggregate."""
    g = _gen(cuda, 11)
    acc = torch.randn(d, device=cuda, generator=g)
    deltas = torch.randn((K, d), device=cuda, generator=g) * 0.01
    wts = torch.rand(K, device=cuda, generator=g) / K
    before = ops.launch_counts()
    out = ops.fused_accumulate(acc, deltas, wts)
    after = ops.launch_counts()
    assert after["fused_accumulate"] == before["fused_accumulate"] + 1
    assert after["fused_aggregate"] == before["fused_aggregate"]
    torch.testing.assert_close(out, ref.fused_accumulate_ref(acc, deltas,
                                                             wts),
                               rtol=1e-5, atol=1e-6)
    if K < 1_024 and d == 20_002:
        pad = 1_024 - K
        padded = torch.cat([deltas, torch.full((pad, d), 3e4, device=cuda)])
        pw = torch.cat([wts, torch.zeros(pad, device=cuda)])
        torch.testing.assert_close(ops.fused_accumulate(acc, padded, pw), out,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_aggregate_at_a_cohorts_shape(cuda, mode):
    """The robust cohort round's stack: the buckets' gathered (cap, d)
    blocks, here cap = 1,104 rows at d = 20,002 with m = 1,000 valid rows
    (the pad slots are invalid)."""
    g = _gen(cuda, 12)
    cap, d, m = 1_104, 20_002, 1_000
    wt = torch.randn(d, device=cuda, generator=g)
    a = torch.rand(d, device=cuda, generator=g) * 3 + 1
    deltas = torch.randn((cap, d), device=cuda, generator=g) * 0.01
    valid = torch.arange(cap, device=cuda) < m
    out = ops.robust_aggregate(wt, deltas, valid, a, 0.1, mode)
    assert ra_kernel.robust_aggregate.last_m == m
    torch.testing.assert_close(
        out, ref.robust_aggregate_ref(wt, deltas, valid, a, 0.1, mode),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (20_002,), (7, 999), (300, 20_002)])
def test_fsvrg_update_matches_plain(cuda, shape, dtype, tol):
    g = _gen(cuda, 1)
    w, s, gn, go, gb = (torch.randn(shape, device=cuda, generator=g).to(dtype)
                        for _ in range(5))
    hs = [0.37]
    if len(shape) == 2:
        h = torch.rand(shape[0], device=cuda, generator=g)
        h[::3] = 0.0
        hs.append(h)
    forms = [(s, go, gb)]
    if len(shape) == 2:                 # S, g_old, ḡ as shared (d,) rows
        forms.append((s[0], go[-1], gb[0]))
    for h in hs:
        for s_in, go_in, gb_in in forms:
            out = ops.fsvrg_update(w, s_in, gn, go_in, gb_in, h)
            expect = ref.fsvrg_update_ref(w, s_in, gn, go_in, gb_in, h)
            assert out.dtype == dtype and out.shape == w.shape
            torch.testing.assert_close(out.float(), expect.float(),
                                       rtol=tol, atol=tol)
            if isinstance(h, torch.Tensor):
                assert torch.equal(out[::3], w[::3])    # h = 0: exact no-op


def test_fsvrg_update_in_place(cuda):
    g = _gen(cuda, 2)
    w, s, gn = (torch.randn((5, 257), device=cuda, generator=g)
                for _ in range(3))
    zero, gb = torch.zeros(257, device=cuda), torch.randn(257, device=cuda)
    h = torch.rand(5, device=cuda, generator=g)
    expect = ref.fsvrg_update_ref(w, s, gn, zero, gb, h)
    assert ops.fsvrg_update(w, s, gn, zero, gb, h, out=w) is w
    torch.testing.assert_close(w, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (20_002,), (7, 999), (300, 20_002)])
def test_fedavg_and_dane_updates_match_plain(cuda, shape, dtype, tol):
    g = _gen(cuda, 3)
    w, gr, a, wt = (torch.randn(shape, device=cuda, generator=g).to(dtype)
                    for _ in range(4))
    lam, mu, lr = 0.05, 3.0, 0.3
    hs = [0.37]
    if len(shape) == 2:
        h = torch.rand(shape[0], device=cuda, generator=g)
        h[::3] = 0.0
        hs.append(h)
    for h in hs:
        out = ops.fedavg_update(w, gr, h, lam)
        assert out.dtype == dtype and out.shape == w.shape
        torch.testing.assert_close(
            out.float(), ref.fedavg_update_ref(w, gr, h, lam).float(),
            rtol=tol, atol=tol)
        if isinstance(h, torch.Tensor):
            assert torch.equal(out[::3], w[::3])        # h = 0: exact no-op
    for wt_in in ([wt, wt[0]] if len(shape) == 2 else [wt]):
        out = ops.dane_update(w, gr, a, wt_in, lr, lam, mu)
        assert out.dtype == dtype and out.shape == w.shape
        torch.testing.assert_close(
            out.float(),
            ref.dane_update_ref(w, gr, a, wt_in, lr, lam, mu).float(),
            rtol=tol, atol=tol)
    w32 = w.float().clone()
    expect = ref.fedavg_update_ref(w32, gr.float(), 0.2, lam)
    assert ops.fedavg_update(w32, gr.float(), 0.2, lam, out=w32) is w32
    torch.testing.assert_close(w32, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 127, 6_478])
def test_cocoa_sdca_update_matches_plain(cuda, n, dtype, tol):
    g = _gen(cuda, 4)
    b0 = (torch.rand(n, device=cuda, generator=g) * 0.9 + 0.05).to(dtype)
    m = (torch.randn(n, device=cuda, generator=g) * 10).to(dtype)
    c = (torch.rand(n, device=cuda, generator=g) * 1e3).to(dtype)
    c[::4] = 0.0
    out = ops.cocoa_sdca_update(b0, m, c)
    assert out.dtype == dtype and out.shape == (n,)
    torch.testing.assert_close(out.float(),
                               ref.cocoa_sdca_update_ref(b0, m, c).float(),
                               rtol=tol, atol=tol)
    pad = torch.full((n,), 0.5, device=cuda, dtype=dtype)
    zero = torch.zeros(n, device=cuda, dtype=dtype)
    assert torch.equal(ops.cocoa_sdca_update(pad, zero, zero), pad)


def _pass_bucket(dev, Kb, m_pad, nnz, d, seed=0):
    """A bucket whose rows repeat features (entry 1 is entry 0's feature;
    every third row holds one feature five times) and whose clients after
    the first have n_k < m_pad (padded slots: idx 0, val 0, y 1), with a
    dual block, an iterate and each client's permutation."""
    g = torch.Generator().manual_seed(seed)
    n_k = torch.randint(1, m_pad + 1, (Kb,), generator=g)
    n_k[0] = m_pad
    idx = torch.randint(0, d, (Kb, m_pad, nnz), generator=g)
    if nnz > 1:
        idx[:, :, 1] = idx[:, :, 0]
    if nnz > 5:
        idx[:, ::3, 1:5] = idx[:, ::3, 5:6]
    val = torch.rand((Kb, m_pad, nnz), generator=g) * 0.95 + 0.05
    y = torch.randint(0, 2, (Kb, m_pad), generator=g).float() * 2 - 1
    pad = torch.arange(m_pad)[None, :] >= n_k[:, None]
    idx[pad], val[pad], y[pad] = 0, 0.0, 1.0
    alpha = y * (torch.rand((Kb, m_pad), generator=g) * 0.9 + 0.05)
    w = torch.randn(d, generator=g) * 0.3
    perms = torch.argsort(torch.rand((Kb, m_pad), generator=g), dim=1)
    return [x.to(dev) for x in (w, alpha, idx, val, y, n_k, perms)]


@pytest.mark.parametrize("Kb,m_pad,nnz,d", [
    (1, 1, 3, 5), (1, 40, 62, 300), (7, 33, 62, 1_000), (3, 17, 1, 50),
    (5, 12, 100, 400), (4, 9, 256, 2_000), (300, 64, 62, 20_002)])
def test_cocoa_sdca_pass_matches_plain(cuda, Kb, m_pad, nnz, d):
    """The pass kernel against its plain version on the card: u and r
    within 1e-5 of their max abs (the kernel reduces each row in another
    order, in FMAs, and adds repeated features in the atomics' order);
    padded coordinates never move; one launch."""
    w, alpha, idx, val, y, n_k, perms = _pass_bucket(cuda, Kb, m_pad, nnz, d)
    n, sigma = int(n_k.sum()) * 3, float(Kb)
    lam = 1.0 / n
    r = torch.full((Kb, d), float("nan"), device=cuda)
    before = ops.launch_counts()
    u = ops.cocoa_sdca_pass(w, alpha, idx, val, y, n_k, perms, sigma, lam, n,
                            r)
    after = ops.launch_counts()
    assert after["cocoa_sdca_pass"] == before["cocoa_sdca_pass"] + 1
    assert after["cocoa_sdca_update"] == before["cocoa_sdca_update"]
    r_ref = torch.empty_like(r)
    u_ref = ref.cocoa_sdca_pass_ref(w, alpha, idx, val, y, n_k, perms, sigma,
                                    lam, n, r_ref)
    for got, expect in ((u, u_ref), (r, r_ref)):
        torch.testing.assert_close(got, expect, rtol=0, atol=1e-5 * max(
            float(expect.abs().max()), 1e-30))
    pad = torch.arange(m_pad, device=cuda)[None, :] >= n_k[:, None]
    assert not u[pad].any()


def test_cocoa_sdca_pass_rejects_what_it_does_not_take(cuda):
    """The pass kernel's wrapper refuses CPU tensors, wrong dtypes,
    non-contiguous and mismatched inputs, and rows wider than 256."""
    w, alpha, idx, val, y, n_k, perms = _pass_bucket(cuda, 3, 8, 5, 40)
    r = torch.empty((3, 40), device=cuda)
    args = dict(w=w, alpha=alpha, idx=idx, val=val, y=y, n_k=n_k,
                perms=perms, r=r)
    big = torch.zeros((3, 8, 257), dtype=torch.int64, device=cuda)
    for name, bad in [("w", w.cpu()), ("alpha", alpha.cpu()),
                      ("idx", idx.int()),
                      ("val", val.double()), ("perms", perms.t().contiguous()
                                              .t()),
                      ("alpha", alpha[:, :7]), ("y", y[:2]),
                      ("n_k", n_k.float()), ("r", r[:, :39]),
                      ("r", r.t().contiguous().t())]:
        with pytest.raises(ValueError):
            cs_kernel.cocoa_sdca_pass(**{**args, name: bad}, sigma=1.0,
                                      lam=0.1, n=24)
    with pytest.raises(ValueError, match="nnz"):
        cs_kernel.cocoa_sdca_pass(**{**args, "idx": big, "val": big.float()},
                                  sigma=1.0, lam=0.1, n=24)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v = torch.zeros(16, device=cuda)
    m = torch.zeros((4, 16), device=cuda)
    wts = torch.ones(4, device=cuda)
    bad = [
        lambda: ops.fused_aggregate(v, m.double(), wts, v),          # dtype
        lambda: ops.fused_aggregate(v, m.t(), wts, v),               # layout
        lambda: ops.fused_aggregate(v, m, wts[:3], v),               # shape
        lambda: ops.fused_aggregate(v.cpu(), m, wts, v),             # device
        lambda: ops.fsvrg_update(m, m, m, m[:, :8], v, 0.1),         # shape
        lambda: ops.fsvrg_update(m, m.half(), m, v, v, 0.1),         # dtype
        lambda: ops.fsvrg_update(m, m, m, v, v, wts[:3]),            # h
        lambda: ops.fsvrg_update(m.t(), m.t(), m.t(), v[:4], v[:4], 0.1),
        lambda: ops.fedavg_update(m, m[:, :8], 0.1, 0.1),            # shape
        lambda: ops.fedavg_update(m, m, wts[:3], 0.1),               # h
        lambda: ops.fedavg_update(m, m.half(), 0.1, 0.1),            # dtype
        lambda: ops.dane_update(m, m, m, v[:8], 0.1, 0.1, 0.1),      # w_t
        lambda: ops.dane_update(m, m, m.cpu(), v, 0.1, 0.1, 0.1),    # device
        lambda: ops.cocoa_sdca_update(m, m, m),                      # 2-D
        lambda: ops.cocoa_sdca_update(v, v[:8], v),                  # length
        lambda: ops.cocoa_sdca_update(v, v.double(), v),             # dtype
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_small_runs_on_the_card(cuda):
    """GD (no draws) for three rounds on the card and on the CPU from the
    same data agrees to rtol 1e-4; FSVRG on the card launches fsvrg_update
    once per local step and fused_aggregate once per round."""
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    ws = []
    for dev in ("cpu", cuda):
        prob = build_problem(ds, device=dev)
        solver = make_solver("gd", prob, device=dev, aggregator="pallas")
        ws.append(Trainer(solver, rounds=3).fit().w.cpu())
    torch.testing.assert_close(ws[1], ws[0], rtol=1e-4,
                               atol=1e-4 * float(ws[0].abs().max()))
    prob = build_problem(ds, device=cuda)
    before = ops.launch_counts()
    res = make_solver("fsvrg", prob, device=cuda,
                      aggregator="pallas").fit(2, seed=0)
    after = ops.launch_counts()
    assert bool(torch.isfinite(res.w).all())
    assert after["fsvrg_update"] - before["fsvrg_update"] == 2 * sum(
        b.m_pad for b in prob.buckets)
    assert after["fused_aggregate"] - before["fused_aggregate"] == 2


def _shared_draws(cls):
    """``cls`` with its permutations drawn on the CPU from one key
    per round and bucket, so the card and the CPU walk the same orders."""

    class SharedDraws(cls):
        def round(self, state, gen):
            self._r = state.round
            return super().round(state, gen)

        def permutations(self, gen, bucket_index, bucket):
            cpu = threefry.PRNGKey(1000 * self._r + bucket_index)
            return super().permutations(cpu, bucket_index, bucket)

    return SharedDraws


@pytest.mark.parametrize("name", ["fedavg", "dane", "cocoa"])
def test_new_solvers_small_runs_on_the_card(cuda, name):
    """FedAvg, DANE (GD) and CoCoA+ for three rounds on the card and on
    the CPU from the same data and draws agree to rtol 1e-4 of max |w|;
    on the card each local step of FedAvg and DANE launches its kernel
    once, CoCoA+'s pass launches its kernel once a bucket, and each round
    launches fused_aggregate once."""
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    cls = {"fedavg": _shared_draws(FedAvg), "cocoa": _shared_draws(CoCoAPlus),
           "dane": None}[name]
    ws, counts = [], None
    for dev in ("cpu", cuda):
        prob = build_problem(ds, device=dev)
        solver = make_solver(name, prob, device=dev, aggregator="pallas")
        if cls is not None:
            cfg = solver.cfg
            solver = (cls(prob, cfg=cfg, device=dev) if name == "cocoa"
                      else cls(prob, cfg, device=dev))
        before = ops.launch_counts()
        ws.append(Trainer(solver, rounds=3).fit().w.cpu())
        after = ops.launch_counts()
        counts = {k: after[k] - before[k] for k in after}
    torch.testing.assert_close(ws[1], ws[0], rtol=1e-4,
                               atol=1e-4 * float(ws[0].abs().max()))
    m_pads = sum(b.m_pad for b in prob.buckets)
    expected = {"fedavg": ("fedavg_update", 3 * 2 * m_pads),
                "dane": ("dane_update", 3 * 25 * len(prob.buckets)),
                "cocoa": ("cocoa_sdca_pass", 3 * len(prob.buckets))}[name]
    assert counts[expected[0]] == expected[1]
    assert counts["cocoa_sdca_update"] == 0
    assert counts["fused_aggregate"] == 3


@pytest.mark.parametrize("name,kw", [
    ("fedavg", dict(client_chunk=3)),
    ("fsvrg", dict(participation=0.5, cohort=4)),
    ("cocoa", dict(participation=0.5, cohort=2, client_chunk=2)),
    ("fsvrg", dict(participation=0.5, cohort=3,
                   aggregator_guard="trimmed_mean"))],
    ids=["fedavg-streamed", "fsvrg-cohort", "cocoa-cohort-streamed",
         "fsvrg-robust-cohort"])
def test_scale_paths_small_runs_on_the_card(cuda, name, kw):
    """Streamed and cohort rounds (each device drawing for itself from the
    same seed) on the card and on the CPU agree to rtol 1e-4 of max |w|
    over 3 rounds; on the card the weighted sum goes through
    fused_accumulate (once a chunk or a cohort bucket) and one
    fused_epilogue a round, never fused_aggregate, and the robust cohort
    through one robust_aggregate a round."""
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    ws, counts = [], None
    for dev in ("cpu", cuda):
        prob = build_problem(ds, device=dev)
        solver = make_solver(name, prob, device=dev, aggregator="pallas",
                             **kw)
        before = ops.launch_counts()
        ws.append(Trainer(solver, rounds=3).fit().w.cpu())
        after = ops.launch_counts()
        counts = {k: after[k] - before[k] for k in after}
    torch.testing.assert_close(ws[1], ws[0], rtol=1e-4,
                               atol=1e-4 * float(ws[0].abs().max()))
    assert counts["fused_aggregate"] == 0
    if "aggregator_guard" in kw:
        assert counts["robust_aggregate"] == 3
        assert counts["fused_accumulate"] == counts["fused_epilogue"] == 0
        return
    assert counts["fused_epilogue"] == 3
    if "cohort" not in kw:
        chunk = kw["client_chunk"]
        assert counts["fused_accumulate"] == 3 * sum(
            -(-b.num_clients // min(chunk, b.num_clients))
            for b in prob.buckets)
    else:
        assert counts["fused_accumulate"] >= 3 * len(prob.buckets)


def _robust_inputs(dev, K, d, dtype, rate, seed=0):
    g = _gen(dev, seed)
    wt = torch.randn(d, device=dev, generator=g)
    a = torch.rand(d, device=dev, generator=g) + 0.5
    deltas = torch.randn((K, d), device=dev, generator=g).to(dtype)
    valid = torch.rand(K, device=dev, generator=g) < rate
    return wt, deltas, valid, a


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,d,rate", [(1, 1, 1.0), (2, 127, 0.5),
                                      (127, 127, 0.7), (999, 999, 0.4),
                                      (999, 1, 1.0), (1, 999, 1.0),
                                      (300, 20_002, 0.4)])
def test_robust_aggregate_matches_plain(cuda, K, d, rate, dtype, mode):
    wt, deltas, valid, a = _robust_inputs(cuda, K, d, dtype, rate)
    for trim in (0.0, 0.1, 0.25, 0.49):
        before = ops.launch_counts()["robust_aggregate"]
        out = ops.robust_aggregate(wt, deltas, valid, a, trim, mode)
        assert ops.launch_counts()["robust_aggregate"] == before + 1
        assert ra_kernel.robust_aggregate.last_m == int(valid.sum())
        torch.testing.assert_close(
            out, ref.robust_aggregate_ref(wt, deltas, valid, a, trim, mode),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_aggregate_edge_cases(cuda, mode):
    """m = 0 leaves w^t bit for bit; m = 1 and 2; heavy ties (mostly zero
    columns); the f32 floor of trim·m (0.42 · 150 rounds to 62.999996, so
    lo = 62); valid rows holding ±inf and NaN sort as jnp.sort sorts."""
    wt, deltas, valid, a = _robust_inputs(cuda, 150, 513, torch.float32, 1.0)
    none = torch.zeros(150, dtype=torch.bool, device=cuda)
    assert torch.equal(ops.robust_aggregate(wt, deltas, none, a, 0.1, mode),
                       wt)
    for m in (1, 2):
        v = torch.zeros(150, dtype=torch.bool, device=cuda)
        v[[7, 100][:m]] = True
        torch.testing.assert_close(
            ops.robust_aggregate(wt, deltas, v, a, 0.1, mode),
            ref.robust_aggregate_ref(wt, deltas, v, a, 0.1, mode),
            rtol=1e-5, atol=1e-6)
    sparse = deltas * (torch.rand(deltas.shape, device=cuda,
                                  generator=_gen(cuda, 5)) < 0.05)
    assert ref.robust_window(150, 0.42, "trimmed_mean") == (62, 88)
    for x, trim in ((sparse, 0.1), (deltas, 0.42), (sparse, 0.42)):
        torch.testing.assert_close(
            ops.robust_aggregate(wt, x, valid, a, trim, mode),
            ref.robust_aggregate_ref(wt, x, valid, a, trim, mode),
            rtol=1e-5, atol=1e-6)
    bad = deltas.clone()
    bad[3, :40] = float("inf")
    bad[4, 20:60] = float("-inf")
    bad[5, 50:90] = float("nan")
    bad[6:9, 0:5] = float("nan")
    for v in (valid, torch.arange(150, device=cuda) % 3 > 0):
        torch.testing.assert_close(
            ops.robust_aggregate(wt, bad, v, a, 0.25, mode),
            ref.robust_aggregate_ref(wt, bad, v, a, 0.25, mode),
            rtol=1e-5, atol=1e-6, equal_nan=True)


def _cohort(dev, K, m, g):
    valid = torch.zeros(K, dtype=torch.bool, device=dev)
    valid[torch.randperm(K, device=dev, generator=g)[:m]] = True
    return valid


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
@pytest.mark.parametrize("m", [3922, 10_000])
def test_robust_aggregate_at_the_main_shape(cuda, m, mode):
    """K = 10,000 × d = 20,002 f32 deltas ≈ N(0, 0.01²), at the faulted
    cells' m (≈ 3,922 clients return) and at m = K."""
    K, d = 10_000, 20_002
    g = _gen(cuda, 3)
    wt = torch.randn(d, device=cuda, generator=g)
    a = torch.rand(d, device=cuda, generator=g) * 3 + 1
    deltas = torch.randn((K, d), device=cuda, generator=g) * 0.01
    valid = _cohort(cuda, K, m, g)
    out = ops.robust_aggregate(wt, deltas, valid, a, 0.1, mode)
    assert ra_kernel.robust_aggregate.last_m == m
    torch.testing.assert_close(
        out, ref.robust_aggregate_ref(wt, deltas, valid, a, 0.1, mode),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_aggregate_at_capacity(cuda, mode):
    """m = MAX_VALID valid rows (one column a block) at a narrow d."""
    K, d = ra_kernel.MAX_VALID, 37
    wt, deltas, valid, a = _robust_inputs(cuda, K, d, torch.float32, 1.0)
    out = ops.robust_aggregate(wt, deltas, valid, a, 0.1, mode)
    assert ra_kernel.robust_aggregate.last_m == K
    torch.testing.assert_close(
        out, ref.robust_aggregate_ref(wt, deltas, valid, a, 0.1, mode),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_aggregate_select_hard_cases(cuda, mode):
    """Ties straddling both window edges (7 values a column), heavy tails
    (2 % of the rows scaled ×100, as the scale fault does), the same in
    bf16; and two calls on the same inputs give the same bits."""
    K, d = 3000, 1003
    g = _gen(cuda, 4)
    wt = torch.randn(d, device=cuda, generator=g)
    a = torch.rand(d, device=cuda, generator=g) + 0.5
    valid = torch.rand(K, device=cuda, generator=g) < 0.7
    ties = torch.randint(-3, 4, (K, d), device=cuda, generator=g) * 0.01
    heavy = torch.randn((K, d), device=cuda, generator=g) * 0.01
    heavy[torch.randperm(K, device=cuda, generator=g)[:K // 50]] *= 100
    for x, trim in ((ties, 0.1), (ties, 0.25), (heavy, 0.1),
                    (heavy.to(torch.bfloat16), 0.1)):
        out = ops.robust_aggregate(wt, x, valid, a, trim, mode)
        torch.testing.assert_close(
            out, ref.robust_aggregate_ref(wt, x, valid, a, trim, mode),
            rtol=1e-5, atol=1e-6)
        assert torch.equal(out, ops.robust_aggregate(wt, x, valid, a, trim,
                                                     mode))


def test_robust_aggregate_rejects_what_it_does_not_take(cuda):
    v = torch.zeros(16, device=cuda)
    m = torch.zeros((4, 16), device=cuda)
    ok = torch.ones(4, dtype=torch.bool, device=cuda)
    for call in [lambda: ops.robust_aggregate(v, m.double(), ok, v),
                 lambda: ops.robust_aggregate(v, m.t(), ok, v),
                 lambda: ops.robust_aggregate(v, m, ok[:3], v),
                 lambda: ops.robust_aggregate(v[:8], m, ok, v),
                 lambda: ops.robust_aggregate(v, m, ok, v, 0.5),
                 lambda: ops.robust_aggregate(v, m, ok, v, 0.1, "mean")]:
        with pytest.raises(ValueError):
            call()
    K = ra_kernel.MAX_VALID + 1
    big = torch.zeros((K, 2), device=cuda)
    with pytest.raises(ValueError, match="capacity"):
        ops.robust_aggregate(torch.zeros(2, device=cuda), big,
                             torch.ones(K, dtype=torch.bool, device=cuda),
                             torch.ones(2, device=cuda))


def test_threefry_and_fleet_on_the_card_equal_the_cpu(cuda):
    """fold_in, uniform, the fleet masks and the fault kinds and payloads
    at K = 10,000 on the card are the CPU's, bit for bit."""
    ids = torch.arange(10_000, dtype=torch.int64)
    key = threefry.fold_in(threefry.PRNGKey(7), 3)
    kc, kg = threefry.fold_in(key, ids), threefry.fold_in(key, ids.to(cuda))
    assert all(torch.equal(x, y.cpu()) for x, y in zip(kc, kg))
    for shape, lo, hi in (((), 0.0, 1.0), ((33,), -1.0, 1.0)):
        assert torch.equal(threefry.uniform(kc, shape, lo, hi),
                           threefry.uniform(kg, shape, lo, hi).cpu())
    trace = FleetTrace(seed=0)
    faults = DeltaFaults(seed=0, nan_rate=0.01, sign_rate=0.05,
                         scale_rate=0.02, replay_rate=0.02)
    deltas = torch.randn((10_000, 64), generator=torch.Generator()
                         .manual_seed(0))
    for r in (0, 1, 7):
        mc = fleet_masks(trace, r, ids)
        mg = fleet_masks(trace, r, ids.to(cuda))
        assert torch.equal(mc.returned, mg.returned.cpu())
        assert torch.equal(mc.available, mg.available.cpu())
        assert torch.equal(faults.kinds(r, ids),
                           faults.kinds(r, ids.to(cuda)).cpu())
        torch.testing.assert_close(
            faults.apply(deltas.to(cuda), r, ids.to(cuda)).cpu(),
            faults.apply(deltas, r, ids), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n", [1_625, 1_626, 8_192])
def test_threefry_draws_on_the_card_equal_the_cpu(cuda, n):
    """split, randint (spans on both sides of 2¹⁶), permutation (one and
    two sorting rounds) and gumbel (its logs from ``floatmath``) on a
    batch of 64 keys: the card's are the CPU's bit for bit."""
    kc = threefry.split(threefry.fold_in(threefry.PRNGKey(5), n), 64)
    kg = threefry.as_key(kc, cuda)
    assert all(torch.equal(x.cpu(), y) for x, y in
               zip(threefry.split(kg, 3), threefry.split(kc, 3)))
    span = torch.tensor([1, 2, 97, 6_750, 65_536, 65_537, 2 ** 31 - 1, n]
                        * 8, dtype=torch.int64)
    assert torch.equal(threefry.randint(kg, (50,), 0, span.to(cuda)).cpu(),
                       threefry.randint(kc, (50,), 0, span))
    assert torch.equal(threefry.permutation(kg, n).cpu(),
                       threefry.permutation(kc, n))
    assert torch.equal(threefry.gumbel(kg, (n,)).cpu(),
                       threefry.gumbel(kc, (n,)))


def test_floatmath_on_the_card_equals_the_cpu(cuda):
    """log, pow, sigmoid and the left-to-right sums: the same bits."""
    from repro_torch.utils import floatmath
    g = torch.Generator().manual_seed(3)
    x = torch.rand(1_000_000, generator=g) * 50 + 2.0 ** -126
    z = torch.randn(1_000_000, generator=g) * 20
    rows = torch.rand((1_000, 400), generator=g)
    for fn, arg in ((floatmath.log_f32, x), (floatmath.sigmoid_f32, z),
                    (lambda v: floatmath.pow_f32(v, 1.0 / 0.3), x),
                    (floatmath.sum_f32, rows), (floatmath.cumsum_f32, rows)):
        assert torch.equal(fn(arg.to(cuda)).cpu(), fn(arg))


def test_faulted_small_run_on_the_card(cuda):
    """FSVRG with a trace, delta faults and the trimmed-mean guard for
    three rounds on the card and on the CPU from the same data and draws
    agrees to rtol 1e-4 of max |w|, with one robust_aggregate a round and
    no fused_aggregate."""
    from repro_torch.core import FSVRG
    ds = generate(get_logreg_config().scaled(0.002), 0, device="cpu")
    kw = dict(participation_model=TraceParticipation(FleetTrace(seed=0)),
              fault_model=DeltaFaults(seed=0, nan_rate=0.1, sign_rate=0.1,
                                      scale_rate=0.1, replay_rate=0.1),
              aggregator_guard="trimmed_mean", aggregator="pallas")
    ws, counts = [], None
    for dev in ("cpu", cuda):
        prob = build_problem(ds, device=dev)
        cfg = make_solver("fsvrg", prob, device=dev, **kw).cfg
        solver = _shared_draws(FSVRG)(prob, cfg, device=dev)
        before = ops.launch_counts()
        ws.append(Trainer(solver, rounds=3).fit().w.cpu())
        after = ops.launch_counts()
        counts = {k: after[k] - before[k] for k in after}
    torch.testing.assert_close(ws[1], ws[0], rtol=1e-4,
                               atol=1e-4 * float(ws[0].abs().max()))
    assert counts["robust_aggregate"] == 3
    assert counts["fused_aggregate"] == 0


def _wkv6_inputs(dev, BH, S, D, dtype=torch.float32, spread=1.0, seed=0):
    g = _gen(dev, seed)
    r, k, v = (torch.randn((BH, S, D), device=dev, generator=g)
               for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + spread * torch.randn(
        (BH, S, D), device=dev, generator=g)))
    u = torch.randn((BH, D), device=dev, generator=g) * 0.1
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


@pytest.mark.parametrize("BH,S,D,chunk,dtype,spread", [
    (2, 32, 8, 32, torch.float32, 1.0), (2, 64, 8, 32, torch.float32, 1.0),
    (3, 96, 8, 32, torch.float32, 1.0), (1, 128, 32, 32, torch.float32, 1.0),
    (2, 64, 64, 32, torch.float32, 1.0), (2, 64, 64, 16, torch.float32, 1.0),
    (2, 16, 64, 16, torch.float32, 1.0), (1, 64, 33, 32, torch.float32, 1.0),
    (320, 2048, 64, 32, torch.float32, 1.0),
    (4, 128, 64, 32, torch.bfloat16, 1.0),
    (4, 128, 64, 32, torch.float32, 3.0)],
    ids=["8x32", "8x64", "8x96", "32x128", "64x64", "64x64c16", "64x16c16",
         "33x64", "serving", "bf16", "strong-decay"])
def test_wkv6_matches_plain(cuda, BH, S, D, chunk, dtype, spread):
    x = _wkv6_inputs(cuda, BH, S, D, dtype, spread)
    before = ops.launch_counts()["wkv6"]
    out, state = ops.wkv6(*x, chunk)
    assert ops.launch_counts()["wkv6"] == before + 1
    torch.cuda.synchronize()
    p_out, p_state = ref.wkv6_ref(*x, chunk)
    assert out.dtype == dtype and state.dtype == torch.float32
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(
        out.float(), p_out.float(), rtol=rtol,
        atol=1e-6 * float(p_out.float().abs().max()))
    torch.testing.assert_close(state, p_state, rtol=1e-5,
                               atol=1e-6 * float(p_state.abs().max()))


@pytest.mark.parametrize("S,chunk,dtype", [
    (64, 32, torch.float32), (16, 16, torch.float32),
    (2048, 32, torch.float32), (128, 32, torch.bfloat16)],
    ids=["64", "16c16", "2048", "bf16"])
def test_wkv6_from_a_given_state_matches_plain(cuda, S, chunk, dtype):
    """The kernel's optional start state (a prompt that continues a cache)
    against the plain version from the same state; tolerances as above."""
    BH, D = 8, 64
    x = _wkv6_inputs(cuda, BH, S, D, dtype, seed=S)
    s0 = 0.5 * torch.randn((BH, D, D), device=cuda, generator=_gen(cuda, 1))
    out, state = ops.wkv6(*x, chunk, state=s0)
    torch.cuda.synchronize()
    p_out, p_state = ref.wkv6_ref(*x, chunk, state=s0)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(
        out.float(), p_out.float(), rtol=rtol,
        atol=1e-6 * float(p_out.float().abs().max()))
    torch.testing.assert_close(state, p_state, rtol=1e-5,
                               atol=1e-6 * float(p_state.abs().max()))


def test_wkv6_rejects_what_it_does_not_take(cuda):
    r, k, v, w, u = _wkv6_inputs(cuda, 2, 64, 8)
    bad = [
        lambda: ops.wkv6(*(t[:, :33].contiguous() for t in (r, k, v, w)),
                         u),                                         # ragged S
        lambda: ops.wkv6(r, k, v, w, u[:1]),                         # u shape
        lambda: ops.wkv6(r, k, v, w, u[:, :4]),
        lambda: ops.wkv6(r, k.double(), v, w, u),                    # dtype
        lambda: ops.wkv6(r, k, v[:, :32], w, u),                     # shape
        lambda: ops.wkv6(r, k, v, w.cpu(), u),                       # device
        lambda: ops.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2),
                         k, v, w, u),                                # layout
        lambda: ops.wkv6(r, k, v, w, u, 64),                         # chunk
        lambda: ops.wkv6(*_wkv6_inputs(cuda, 1, 32, 65)),            # D
        lambda: ops.wkv6(r, k, v, w, u, state=torch.zeros(
            (2, 8, 4), device=cuda)),                                # state
        lambda: ops.wkv6(r, k, v, w, u, state=torch.zeros(
            (2, 8, 8), device=cuda, dtype=torch.bfloat16)),
        lambda: ops.wkv6(r, k, v, w, u, state=torch.zeros((2, 8, 8))),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    from repro_torch.kernels import wkv6 as wkv6_kernel
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel.wkv6(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())


def _wkv6_model_inputs(dev, B, S, Hn, D, dtype=torch.float32, spread=1.0,
                       seed=0):
    """(B, S, Hn, D) r, k, v, w drawn as ``_wkv6_inputs`` draws them, an
    (Hn, D) u and a (B, Hn, D, D) start state."""
    g = _gen(dev, seed)
    r, k, v = (torch.randn((B, S, Hn, D), device=dev, generator=g)
               for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + spread * torch.randn(
        (B, S, Hn, D), device=dev, generator=g)))
    u = torch.randn((Hn, D), device=dev, generator=g) * 0.1
    s0 = 0.5 * torch.randn((B, Hn, D, D), device=dev, generator=g)
    return [x.to(dtype) for x in (r, k, v, w)], u, s0


@pytest.mark.parametrize("B,S,n,dtype,spread,given", [
    (1, 2048, 2048, torch.float32, 1.0, False),
    (8, 2048, 2048, torch.float32, 1.0, False),
    (8, 2048, 2048, torch.float32, 1.0, True),
    (8, 2047, 2016, torch.float32, 1.0, False),
    (8, 2047, 2016, torch.float32, 1.0, True),
    (1, 256, 224, torch.float32, 1.0, True),
    (8, 256, 256, torch.bfloat16, 1.0, True),
    (8, 255, 224, torch.bfloat16, 1.0, False),
    (8, 256, 256, torch.float32, 3.0, True)],
    ids=["b1", "b8", "b8-given", "b8-slice", "b8-slice-given",
         "b1-slice-given", "bf16-given", "bf16-slice", "strong-decay"])
def test_wkv6_model_layout_matches_plain(cuda, B, S, n, dtype, spread, given):
    """The kernel on the model's (B, S, Hn, D) layout with Hn = 40, D = 64
    — whole tensors, or the first n tokens of S (a ragged prompt's whole
    chunks: the batch stride of S tokens) — from zeros or a given state,
    against the plain version on the same views; one launch; tolerances
    as above."""
    Hn, D = 40, 64
    x, u, s0 = _wkv6_model_inputs(cuda, B, S, Hn, D, dtype, spread, seed=n)
    views = [t[:, :n] for t in x]
    state = s0 if given else None
    before = ops.launch_counts()["wkv6"]
    out, st = ops.wkv6(*views, u, state=state)
    assert ops.launch_counts()["wkv6"] == before + 1
    torch.cuda.synchronize()
    assert out.shape == (B, n, Hn, D) and out.is_contiguous()
    assert out.dtype == dtype and st.shape == (B, Hn, D, D)
    p_out, p_st = ref.wkv6_ref(*views, u, state=state)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(
        out.float(), p_out.float(), rtol=rtol,
        atol=1e-6 * float(p_out.float().abs().max()))
    torch.testing.assert_close(st, p_st, rtol=1e-5,
                               atol=1e-6 * float(p_st.abs().max()))


def test_wkv6_model_layout_rejects_what_it_does_not_take(cuda):
    x, u, s0 = _wkv6_model_inputs(cuda, 2, 64, 3, 8)
    r, k, v, w = x
    bad = [
        lambda: ops.wkv6(r, k, v, w, u[:, :4]),                      # u shape
        lambda: ops.wkv6(r, k, v, w, u.repeat(2, 1)),                # (BH, D) u
        lambda: ops.wkv6(r, k[..., :4], v, w, u),                    # shape
        lambda: ops.wkv6(*(t.transpose(2, 3) for t in x),
                         torch.zeros((8, 3), device=cuda)),          # layout
        lambda: ops.wkv6(r[:, :32], k[:, :32].contiguous(), v[:, :32],
                         w[:, :32], u),                              # strides
        lambda: ops.wkv6(r, k, v, w, u, state=s0.reshape(6, 8, 8)),  # state
        lambda: ops.wkv6(r, k, v, w, u, state=s0.transpose(2, 3)),
        lambda: ops.wkv6(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("S", [64, 47])
def test_small_serve_on_the_card_matches_the_cpu(cuda, S):
    """The reduced rwkv6-3b in f32 with the same weights on the card and
    the CPU: prefill (one wkv6 launch a layer on the card, also for a
    ragged 47-token prompt, whose tail of 15 runs the sequential WKV) and 4
    greedy decode steps (none) give the same tokens and logits to 1e-4 of
    their max (f32 sums in other orders)."""
    cfg = get_config("rwkv6-3b").reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(1))
    on_cpu = serve(m_cpu, p_cpu, prompt, 5)
    ops.reset_launch_counts()
    on_dev = serve(m_dev, p_dev, prompt.to(cuda), 5)
    assert ops.launch_counts()["wkv6"] == cfg.num_layers
    assert torch.equal(on_dev.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_dev.logits.cpu(), on_cpu.logits, rtol=1e-4,
                               atol=1e-4 * float(on_cpu.logits.abs().max()))
    for a, b in zip(on_dev.cache["layers"], on_cpu.cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-4,
                                       atol=1e-4 * float(b[k].abs().max()))


def _wkv6_cotangents(dev, shape, heads, seed):
    """d_out of ``shape`` and a final-state cotangent of the state's shape."""
    g = _gen(dev, seed + 100)
    D = shape[-1]
    s_shape = shape[:1] + (() if heads is None else (heads,)) + (D, D)
    return (torch.randn(shape, device=dev, generator=g),
            torch.randn(s_shape, device=dev, generator=g),
            0.5 * torch.randn(s_shape, device=dev, generator=g))


def _wkv6_autograd(x, s0, d_out, d_fin):
    xs = [t.detach().clone().requires_grad_() for t in x]
    st = None if s0 is None else s0.clone().requires_grad_()
    out, fin = ref.wkv6_ref(*xs, state=st)
    outs, cots = [out], [d_out]
    if d_fin is not None:
        outs.append(fin)
        cots.append(d_fin)
    return torch.autograd.grad(outs, xs + ([] if st is None else [st]), cots)


@pytest.mark.parametrize("given", [True, False], ids=["given", "zeros"])
@pytest.mark.parametrize("shape,heads", [
    ((3, 64, 16), None), ((80, 128, 64), None), ((2, 96, 8), None),
    ((2, 64, 4, 64), 4), ((2, 128, 40, 64), 40), ((1, 32, 3, 33), 3)],
    ids=["bh-16", "bh-train", "bh-8", "model-4", "model-train", "model-33"])
def test_wkv6_bwd_matches_autograd_through_plain(cuda, shape, heads, given):
    """wkv6_bwd in both layouts, from zeros or a given start state with a
    cotangent of the final state, against autograd through the plain
    forward: 1e-5 of each cotangent's max + rtol 1e-5 (f32 sums of the same
    terms in other orders); one launch a call; two calls bit-equal."""
    if heads is None:
        x = _wkv6_inputs(cuda, shape[0], shape[1], shape[2], seed=shape[1])
    else:
        x4, u, _ = _wkv6_model_inputs(cuda, *shape[:2], heads, shape[3],
                                      seed=shape[1])
        x = x4 + [u]
    d_out, d_fin, s0 = _wkv6_cotangents(cuda, shape, heads, shape[1])
    if not given:
        d_fin = s0 = None
    before = ops.launch_counts()["wkv6_bwd"]
    got = ops.wkv6_bwd(*x, d_out, state=s0, d_state=d_fin)
    again = ops.wkv6_bwd(*x, d_out, state=s0, d_state=d_fin)
    assert ops.launch_counts()["wkv6_bwd"] == before + 2
    torch.cuda.synchronize()
    assert (got[5] is None) == (not given)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    plain = _wkv6_autograd(x, s0, d_out, d_fin)
    for a, p in zip(got, plain):
        assert a.shape == p.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("shape,chunk", [
    ((2, 32, 40, 64), 32), ((2, 128, 4, 64), 16), ((2, 96, 3, 32), 32),
    ((8, 2048, 40, 64), 32)], ids=["one-chunk", "chunk-16", "d32", "serve"])
def test_wkv6_bwd_chunks_through_the_scan(cuda, shape, chunk):
    """The backward's three launches (chunk terms, state scan, chunk
    backward) from a given start state with a cotangent of the final
    state: one chunk (nothing to scan), chunks of 16, D = 32, and the
    serving shape's 64 chunks a pair through the scan, against autograd
    through the plain forward at 1e-5 of each cotangent's max + rtol 1e-5
    (f32 sums in other orders); the counter goes up by one a call; two
    calls bit-equal."""
    B, S, Hn, D = shape
    x4, u, s0 = _wkv6_model_inputs(cuda, B, S, Hn, D, seed=S + D)
    d_out, d_fin, _ = _wkv6_cotangents(cuda, shape, Hn, S + D)
    before = ops.launch_counts()["wkv6_bwd"]
    got = ops.wkv6_bwd(*x4, u, d_out, chunk, state=s0, d_state=d_fin)
    assert ops.launch_counts()["wkv6_bwd"] == before + 1
    again = ops.wkv6_bwd(*x4, u, d_out, chunk, state=s0, d_state=d_fin)
    assert ops.launch_counts()["wkv6_bwd"] == before + 2
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xs = [t.clone().requires_grad_() for t in x4 + [u]]
    st = s0.clone().requires_grad_()
    out, fin = ref.wkv6_ref(*xs, chunk, state=st)
    plain = torch.autograd.grad([out, fin], xs + [st], [d_out, d_fin])
    for a, p in zip(got, plain):
        assert a.shape == p.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


def test_wkv6_bwd_where_the_clamp_fires(cuda):
    """Four channels decay at 0.05–0.2 a step, so cumprod(w) < 1e-30 inside
    a chunk: the kernel's cotangents are finite and agree with the plain
    backward ref.wkv6_bwd_ref (autograd's dw is NaN there: it forms
    k / max(c, 1e-30)² before the clamp's zero), bit-equal from call to
    call."""
    x4, u, s0 = _wkv6_model_inputs(cuda, 2, 128, 4, 64, seed=3)
    x4[3][..., :4] = 0.05 + 0.15 * torch.rand(x4[3][..., :4].shape,
                                              device=cuda,
                                              generator=_gen(cuda, 4))
    c = torch.cumprod(x4[3].reshape(2, 4, 32, 4, 64), dim=2)
    assert bool((c < 1e-30).any())
    d_out, d_fin, _ = _wkv6_cotangents(cuda, (2, 128, 4, 64), 4, 3)
    got = ops.wkv6_bwd(*x4, u, d_out, state=s0, d_state=d_fin)
    again = ops.wkv6_bwd(*x4, u, d_out, state=s0, d_state=d_fin)
    torch.cuda.synchronize()
    plain = ref.wkv6_bwd_ref(*x4, u, d_out, state=s0, d_state=d_fin)
    for a, b, p in zip(got, again, plain):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))
    assert not bool(torch.isfinite(_wkv6_autograd(x4 + [u], s0, d_out,
                                                  d_fin)[3]).all())


def test_wkv6_bwd_on_a_strided_slice_and_through_autograd(cuda):
    """The first 96 of 100 tokens (the strides of a ragged prompt's whole
    chunks) read in place, and ops.wkv6 differentiated by autograd on the
    card: one forward and one backward launch, the cotangents of the
    slice's base where autograd puts them."""
    x4, u, _ = _wkv6_model_inputs(cuda, 2, 100, 3, 16, seed=9)
    xs = [t.clone().requires_grad_() for t in x4 + [u]]
    g = torch.randn((2, 96, 3, 16), device=cuda, generator=_gen(cuda, 9))
    ops.reset_launch_counts()
    out, _ = ops.wkv6(*(t[:, :96] for t in xs[:4]), xs[4])
    grads = torch.autograd.grad(out, xs, g)
    counts = ops.launch_counts()
    assert counts["wkv6"] == 1 and counts["wkv6_bwd"] == 1
    plain = _wkv6_autograd([t[:, :96] for t in x4] + [u], None, g, None)
    for a, p in zip(grads[:4], plain[:4]):
        assert a.shape == (2, 100, 3, 16) and bool((a[:, 96:] == 0).all())
        torch.testing.assert_close(a[:, :96], p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))
    torch.testing.assert_close(grads[4], plain[4], rtol=1e-5,
                               atol=1e-5 * float(plain[4].abs().max()))
    from repro_torch.kernels import wkv6 as wkv6_kernel
    with pytest.raises(ValueError):          # the backward takes f32 only
        wkv6_kernel.wkv6_bwd(*(t.detach().bfloat16() for t in x4), u,
                             g.bfloat16())


@pytest.mark.parametrize("algorithm", ["fsvrg", "fedavg"])
def test_small_training_round_on_the_card_matches_the_cpu(cuda, algorithm):
    """One round of the reduced rwkv6-3b in f32 (C = 2, T = 2, 2 × 64
    tokens a client) with the same weights and batches on the card and the
    CPU: every leaf within 1e-3 of max |w| and |∇f| within 1e-3 (f32 sums
    in other orders, through a gradient that is badly conditioned at a
    sequence's first tokens: on the CPU a 1e-7 relative perturbation of
    these weights moves the round by 3.5e-4 of max |w| and |∇f| by 1.0e-4,
    tests/test_torch_train.py; the card's round differs from the CPU's by
    2.5e-4 and 6.5e-5); on the card 2 wkv6 launches (the forward and its
    recompute) and 1 wkv6_bwd a layer and pass."""
    import numpy as np

    from repro_torch.core import neural
    from repro_torch.launch import train
    cfg = get_config("rwkv6-3b").reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    batch = train.synthetic_batch(np.random.default_rng(0), cfg, 2, 2, 2, 64,
                                  "cpu")
    fed = neural.FedNeuralConfig(stepsize=0.3, local_steps=2,
                                 algorithm=algorithm)
    new_c, met_c = neural.make_fsvrg_round(m_cpu, fed)(p_cpu, batch)
    ops.reset_launch_counts()
    new_d, met_d = neural.make_fsvrg_round(m_dev, fed)(
        p_dev, {k: v.to(cuda) for k, v in batch.items()})
    passes = 2 * 2 * (3 if algorithm == "fsvrg" else 2)
    counts = ops.launch_counts()
    assert counts["wkv6"] == 2 * cfg.num_layers * passes
    assert counts["wkv6_bwd"] == cfg.num_layers * passes
    scale = max(float(p.detach().abs().max()) for p in new_c.parameters())
    for a, b in zip(new_d.parameters(), new_c.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=1e-3 * scale)
    gn = float(met_c["full_grad_norm"])
    assert abs(float(met_d["full_grad_norm"]) - gn) <= 1e-3 * gn


# --------------------------------------------------------------------- #
# checkpoints and the fleet campaign on the card
# --------------------------------------------------------------------- #


def test_checkpoints_restore_onto_the_card(cuda, tmp_path):
    """A tree saved from the CPU (f32, int32 and bf16 leaves) restores onto
    the card bit for bit, and a bf16 tree saved from the card restores
    onto the CPU bit for bit."""
    from repro_torch import checkpoint
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(33, generator=g),
            "aux": (torch.randn(4, 5, generator=g).to(torch.bfloat16),),
            "round": torch.tensor(3, dtype=torch.int32)}
    checkpoint.save(str(tmp_path / "cpu"), tree, step=3)
    got, info = checkpoint.restore(str(tmp_path / "cpu"), cuda)
    assert info["step"] == 3 and got["w"].device.type == "cuda"
    assert torch.equal(got["w"].cpu(), tree["w"])
    assert torch.equal(got["round"].cpu(), tree["round"])
    assert got["aux"][0].dtype == torch.bfloat16
    assert torch.equal(got["aux"][0].cpu().view(torch.int16),
                       tree["aux"][0].view(torch.int16))
    checkpoint.save(str(tmp_path / "card"), got, step=4)
    back, _ = checkpoint.restore(str(tmp_path / "card"), "cpu")
    assert torch.equal(back["aux"][0].view(torch.int16),
                       tree["aux"][0].view(torch.int16))


def test_campaign_smoke_on_the_card(cuda, tmp_path, capsys):
    """The campaign command's ``--smoke`` on the card: a crash, a resume
    and the bit-identity check pass."""
    from repro_torch.experiments import campaign
    assert campaign.main(["--smoke", "--out", str(tmp_path / "smoke")]) == 0
    assert "resume verification: PASS" in capsys.readouterr().out


def test_fixed_order_sums_are_bit_equal_on_the_card(cuda):
    """``utils.scatter``: the same sums from call to call (CUDA's atomic
    ``index_add_`` would not), within f32 rounding of an f64 sum; the 1-D
    sum over more than one slice of terms."""
    from repro_torch.utils import scatter
    from repro_torch.utils.scatter import index_add, scatter_add_rows
    g = _gen(cuda)
    n = scatter.SLICE + 200_000
    big = torch.randint(0, 50, (n,), device=cuda, generator=g)
    terms = torch.randn(n, device=cuda, generator=g)
    e, f = (index_add(torch.zeros(50, device=cuda), big, terms)
            for _ in range(2))
    assert torch.equal(e, f)
    want = torch.zeros(50, dtype=torch.float64, device=cuda).index_add_(
        0, big, terms.double())
    torch.testing.assert_close(e.double(), want, rtol=1e-5, atol=1e-2)
    idx, src = big[:200_000], terms[:200_000]
    a, b = (index_add(torch.zeros(50, device=cuda), idx, src)
            for _ in range(2))
    assert torch.equal(a, b)
    want = torch.zeros(50, dtype=torch.float64).index_add_(
        0, idx.cpu(), src.cpu().double())
    torch.testing.assert_close(a.cpu().double(), want, rtol=1e-5, atol=1e-3)
    idx2, src2 = idx.reshape(40, -1) % 30, src.reshape(40, -1)
    c, d = (scatter_add_rows(torch.zeros(40, 30, device=cuda), idx2, src2)
            for _ in range(2))
    assert torch.equal(c, d)
    want = torch.zeros(40, 30, dtype=torch.float64).scatter_add_(
        1, idx2.cpu(), src2.cpu().double())
    torch.testing.assert_close(c.cpu().double(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", ["gd", "fsvrg", "svrg_naive"])
def test_full_gradient_solvers_repeat_bit_for_bit_on_the_card(cuda, name):
    """Two runs of a solver whose round sums full gradients give the same
    iterate bit for bit: what a campaign's kill and resume stands on."""
    prob = build_problem(generate(get_logreg_config().scaled(0.002), 0,
                                  device=cuda), device=cuda)
    ws = [Trainer(make_solver(name, prob), rounds=2, seed=0).fit().w
          for _ in range(2)]
    assert torch.equal(ws[0], ws[1])


# --------------------------------------------------------------------- #
# the dense attention family
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("heads", [(8, 2), (4, 4), (4, 1)],
                         ids=["GQA", "MHA", "MQA"])
@pytest.mark.parametrize("window", [None, 64], ids=["causal", "window64"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4),
                                              (torch.bfloat16, 3e-3, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_flash_attention_on_the_card_matches_plain(cuda, heads, window, dtype,
                                                   atol, rtol):
    """SDPA on its named backend (flash for bf16, efficient for f32, the
    banded efficient path under a binding window) against the reference's
    blocked online softmax in torch operations (``flash_attention_ref``):
    atol + rtol·|plain| (f32 sums in other orders; bf16 outputs an ulp
    apart, ≤ 2^-7 of |x|, and probabilities rounded with other running
    maxima, which needed ≤ 1.3e-3 absolute at chip_smoke.py's shapes)."""
    from repro_torch.models import layers as L
    H, Hkv = heads
    g = _gen(cuda, H + Hkv)
    q = torch.randn((2, 256, H, 64), device=cuda, generator=g).to(dtype)
    k, v = (torch.randn((2, 256, Hkv, 64), device=cuda, generator=g)
            .to(dtype) for _ in range(2))
    L.reset_sdpa_backends()
    got = L.flash_attention(q, k, v, causal=True, window=window)
    want = ("efficient+band" if window else
            "flash" if dtype == torch.bfloat16 else "efficient")
    assert set(L.SDPA_BACKENDS) == {want}
    ref_out = L.flash_attention_ref(q, k, v, causal=True, window=window,
                                    q_block=64, kv_block=64)
    torch.testing.assert_close(got.float(), ref_out.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("heads", [(8, 2), (4, 4), (4, 1)],
                         ids=["GQA", "MHA", "MQA"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4),
                                              (torch.bfloat16, 3e-3, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_decode_attention_on_the_card_matches_plain(cuda, heads, dtype, atol,
                                                    rtol):
    """``decode_attention`` (the served decode step's SDPA: ``decode:flash``
    in bf16, ``decode:efficient`` in f32) against a plain softmax over the
    whole cache with the slots at or past n_valid masked, at the
    reference's precision; those slots hold large keys and values, so one
    of them counted would show.  Tolerances as for the prefill above."""
    from repro_torch.models import layers as L
    H, Hkv = heads
    B, Smax, Dh = 2, 300, 64
    g = _gen(cuda, 10 * H + Hkv)
    q = torch.randn((B, 1, H, Dh), device=cuda, generator=g).to(dtype)
    kc, vc = (torch.randn((B, Smax, Hkv, Dh), device=cuda, generator=g)
              .to(dtype) for _ in range(2))
    for n in (1, 37, 257, Smax):
        k, v = kc.clone(), vc.clone()
        k[:, n:], v[:, n:] = 30.0, 300.0
        L.reset_sdpa_backends()
        got = L.decode_attention(q, k, v, n)
        assert dict(L.SDPA_BACKENDS) == {
            "decode:" + ("flash" if dtype == torch.bfloat16
                         else "efficient"): 1}
        s = torch.einsum("bhgd,bshd->bhgs",
                         q.reshape(B, Hkv, H // Hkv, Dh).float(),
                         k.float()) * Dh ** -0.5
        s = s.masked_fill(torch.arange(Smax, device=cuda) >= n, -1e30)
        p = torch.softmax(s, dim=-1).to(dtype).float()
        want = torch.einsum("bhgs,bshd->bhgd", p, v.float())
        torch.testing.assert_close(got.float(), want.reshape(B, 1, H, Dh)
                                   .to(dtype).float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch,S", [("llama3-8b", 64), ("granite-20b", 64),
                                    ("h2o-danube-1.8b", 96)])
def test_small_dense_serve_on_the_card_matches_the_cpu(cuda, arch, S):
    """The reduced dense configs in f32 with the same weights on the card
    and the CPU: ``serve`` (prefill, ``grow_cache``, 4 decode steps; danube's
    96 tokens past its window of 64) gives the same tokens, and logits and
    caches to 1e-4 of their max (f32 sums in other orders)."""
    cfg = get_config(arch).reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(1))
    on_cpu = serve(m_cpu, p_cpu, prompt, 5)
    on_dev = serve(m_dev, p_dev, prompt.to(cuda), 5)
    assert torch.equal(on_dev.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_dev.logits.cpu(), on_cpu.logits, rtol=1e-4,
                               atol=1e-4 * float(on_cpu.logits.abs().max()))
    for a, b in zip(on_dev.cache["layers"], on_cpu.cache["layers"]):
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-4,
                                       atol=1e-4 * float(b[k].abs().max()))


def test_dense_loss_and_gradients_on_the_card_match_the_cpu(cuda):
    """Reduced danube (window 64) in f32 on 2 × 96 tokens: the loss to
    1e-5 relative and every gradient leaf to 1e-3 of its max (SDPA's
    backward on the card against the CPU's)."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((2, 96))}
    out = []
    for m, p, dev in ((m_cpu, p_cpu, "cpu"), (m_dev, p_dev, cuda)):
        loss, _ = m.loss(p, {k: x.to(dev) for k, x in batch.items()})
        names, leaves = zip(*p.named_parameters())
        out.append((float(loss.detach()),
                    dict(zip(names, torch.autograd.grad(loss, leaves)))))
    (lc, gc), (ld, gd) = out
    assert abs(ld - lc) <= 1e-5 * abs(lc)
    for n in gc:
        err = float((gd[n].cpu() - gc[n]).abs().max())
        assert err <= 1e-3 * float(gc[n].abs().max()), n


# --------------------------------------------------------------------- #
# the fixed-order segment sum (DANE's local gradient) and the MoE family
# --------------------------------------------------------------------- #


def _segment_case(case, dev, g):
    """(slots, n_slots, a, b, keep) of a case of the kernel test: runs of
    one length (in scattered term positions), a mix like the §4 buckets',
    runs on the units' edges, no runs, or −0 products."""
    from repro_torch.kernels.segment_sum import TILE
    n_slots, group = 10_000, 1
    lengths = {"runs-1": 1, "runs-2": 2, "runs-32": 32, "runs-33-group-4": 33,
               "runs-2000-group-62": 2_000}
    if case in lengths:
        run = lengths[case]
        group = {33: 4, 2_000: 62}.get(run, 1)
        used = torch.randperm(n_slots, device=dev, generator=g)[:500]
        slots = used.repeat_interleave(run)
    elif case == "mix":
        # two runs in three of one term, one in ten of two, one in five of
        # 3–32, the rest of 33–7,000 (the §4 buckets' longest is 6,750);
        # groups of 62 terms (a §4 row)
        group = 62
        n_slots = 2_000 * 20_002 // 100
        used = torch.randperm(n_slots, device=dev, generator=g)[:30_000]
        u = torch.rand(used.numel(), device=dev, generator=g)
        run = torch.where(u < 0.656, 1, torch.where(u < 0.758, 2, torch.where(
            u < 0.953, torch.randint(3, 33, u.shape, device=dev, generator=g),
            torch.randint(33, 7_001, u.shape, device=dev, generator=g))))
        slots = used.repeat_interleave(run)
    elif case == "unit-edges":
        # units of TILE slots over 3 TILE + 1 slots (the last unit one
        # slot), runs of 1, 5 and 40 terms on each unit's first and last
        # slot
        n_slots = 3 * TILE + 1
        edges = torch.arange(0, n_slots, TILE, device=dev)
        used = torch.cat([edges, (edges + TILE - 1).clamp(max=n_slots - 1)])
        run = torch.tensor([1, 5, 40], device=dev).repeat(used.numel())[
            :used.numel()]
        slots = used.repeat_interleave(run)
    elif case in ("no-runs", "negative-zero"):
        slots = torch.randint(0, n_slots, (5_000,), device=dev, generator=g)
    slots = slots[torch.randperm(slots.numel(), device=dev, generator=g)]
    n = slots.numel() - slots.numel() % group
    slots = slots[:n]
    a = torch.randn(n // group, device=dev, generator=g)
    b = torch.randn(n, device=dev, generator=g)
    keep = b.abs() > 0.05
    if case == "no-runs":
        keep[:] = False
    elif case == "negative-zero":
        # every kept term's product −0 (or +0): each sum is +0
        a = -a.abs()
        b = torch.where(b > 0, 0.0, -0.0)
        keep[:] = True
    return slots, n_slots, a, b, keep


@pytest.mark.parametrize("case", ["runs-1", "runs-2", "runs-32",
                                  "runs-33-group-4", "runs-2000-group-62",
                                  "mix", "unit-edges", "no-runs",
                                  "negative-zero"])
def test_segment_sum_matches_plain_bit_for_bit(cuda, case):
    """The kernel against its plain version (the same lanes, the same
    butterfly: the same bits), twice, ``out`` filled with NaN before each
    call and, in the unit-edge case, 4 B past a 16-byte boundary; every
    slot without a run zeroed, +0 where every product is −0."""
    from repro_torch.kernels import segment_sum as ss
    slots, n_slots, a, b, keep = _segment_case(case, cuda, _gen(cuda))
    plan = ss.segment_plan(slots, n_slots, keep=keep)
    lengths = plan.run_start[1:] - plan.run_start[:-1]
    if case.startswith("runs-"):
        assert int(lengths.max()) <= int(case.split("-")[1])
    if case in ("mix", "unit-edges"):
        assert int(lengths.min()) == 1 and int(lengths.max()) > ss.LANES
    assert (plan.n_runs == 0) == (case == "no-runs")
    before = ops.launch_counts()["segment_sum"]
    got = []
    for _ in range(2):
        buf = torch.full((n_slots + 4,), float("nan"), device=cuda)
        out = buf[1:n_slots + 1] if case == "unit-edges" else buf[:n_slots]
        got.append(ops.segment_sum(plan, a, b, out).clone())
    assert ops.launch_counts()["segment_sum"] == before + 2
    want = ref.segment_sum_ref(plan, a, b, torch.empty(n_slots, device=cuda))
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], want)
    assert not got[0][~torch.isin(torch.arange(n_slots, device=cuda),
                                  plan.run_slot.long())].any()
    assert not torch.signbit(got[0][got[0] == 0]).any()
    if case == "negative-zero":
        assert plan.n_runs > 0 and not got[0].any()


def test_dane_rounds_repeat_bit_for_bit_on_the_card(cuda):
    """Two runs of DANE (the GD solver: 26 segment sums a bucket and round)
    give the same iterate bit for bit, and agree with the CPU's run."""
    prob = build_problem(generate(get_logreg_config().scaled(0.002), 0,
                                  device=cuda), device=cuda)
    before = ops.launch_counts()["segment_sum"]
    ws = [Trainer(make_solver("dane", prob), rounds=2, seed=0).fit().w
          for _ in range(2)]
    assert ops.launch_counts()["segment_sum"] > before
    assert torch.equal(ws[0], ws[1])
    cpu = build_problem(generate(get_logreg_config().scaled(0.002), 0,
                                 device="cpu"), device="cpu")
    wc = Trainer(make_solver("dane", cpu, device="cpu"), rounds=2,
                 seed=0).fit().w
    torch.testing.assert_close(ws[0].cpu(), wc, rtol=1e-4,
                               atol=1e-4 * float(wc.abs().max()))


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_moe_fwd_on_the_card_matches_the_cpu(cuda, cf, dtype, tol):
    """``moe_fwd`` at reduced phi3.5 with E = 8, top-2 (tokens dropped at
    cf 0.5): the same dispatch (equal token indices), the output to tol of
    its max (f32: sums in other orders; bf16: an ulp of the products and
    of the combine), the aux loss to 1e-6."""
    import dataclasses
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                              moe=MoEConfig(8, 2))
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, cfg, dtype)
    x = torch.randn((2, 64, cfg.d_model), generator=g).to(dtype)
    oc, ac = moe.moe_fwd(p, x, cfg, capacity_factor=cf)
    pd = {k: v.to(cuda) for k, v in p.items()}
    od, ad = moe.moe_fwd(pd, x.to(cuda), cfg, capacity_factor=cf)
    C = moe.capacity(64, cfg, cf)
    wc = moe.route_topk(x.float() @ p["router"], 2)[0]
    wd = moe.route_topk(x.to(cuda).float() @ pd["router"], 2)[0]
    assert torch.equal(moe.dispatch(wd, C)[1].cpu(), moe.dispatch(wc, C)[1])
    assert od.dtype == dtype
    torch.testing.assert_close(od.cpu().float(), oc.float(), rtol=tol,
                               atol=tol * float(oc.float().abs().max()))
    assert abs(float(ad) - float(ac)) <= 1e-6 * abs(float(ac))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "dbrx-132b"])
def test_small_moe_serve_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MoE configs in f32 with the same weights on the card
    and the CPU: ``serve`` of 2 × 64 tokens and 4 decode steps gives the
    same tokens, logits to 1e-4 of their max; no custom kernel runs."""
    cfg = get_config(arch).reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    on_cpu = serve(m_cpu, p_cpu, prompt, 5)
    before = ops.launch_counts()
    on_dev = serve(m_dev, p_dev, prompt.to(cuda), 5)
    assert ops.launch_counts() == before
    assert torch.equal(on_dev.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_dev.logits.cpu(), on_cpu.logits, rtol=1e-4,
                               atol=1e-4 * float(on_cpu.logits.abs().max()))


def _scan_inputs(dev, B, S, di, dtype, seed=0, given=True):
    """selective_scan's inputs as mamba_fwd passes them: x (B, S, di) in
    ``dtype``, dt_pre a (B, S, 1) column's view, B and C the halves of one
    (B, S, 32) tensor, a_log near log(1..16), a start state or None."""
    g = _gen(dev, seed)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    x = randn(B, S, di).to(dtype)
    dt_pre = randn(B, S, 1)[..., 0]
    bc = randn(B, S, 32)
    a_log = (torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
             .repeat(di, 1) + 0.1 * randn(di, 16))
    h0 = randn(B, di, 16) if given else None
    return (x, dt_pre, 0.5 * randn(di), a_log, bc[..., :16], bc[..., 16:],
            1 + 0.1 * randn(di), h0)


def _scan_close(got, want):
    """The kernel fuses a·h + b into one multiply-add and sums Σ_n h·C in
    order, where the plain version rounds each operation and torch's sum
    takes its own order: 1e-5 of max |plain| + rtol 1e-5 for y and the
    last state."""
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        torch.testing.assert_close(g_, w_, rtol=1e-5,
                                   atol=1e-5 * float(w_.abs().max()))


@pytest.mark.parametrize("given", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_selective_scan_matches_plain_at_full_width(cuda, dtype, given):
    """One Jamba layer's width (di 8,192, N 16) at B 2, S 512: one launch,
    counted."""
    args = _scan_inputs(cuda, 2, 512, 8192, dtype, given=given)
    before = ops.launch_counts()["selective_scan"]
    got = ops.selective_scan(*args)
    assert ops.launch_counts()["selective_scan"] == before + 1
    _scan_close(got, ref.selective_scan_ref(*args))


@pytest.mark.parametrize("S", [1, 100, 64], ids=["decode", "ragged", "tile"])
def test_selective_scan_at_a_step_and_a_ragged_tile(cuda, S):
    """S = 1 (a decode step), S = 100 (no multiple of the 64-step tile) and
    one whole tile, at di = 8,192 + 40 (a ragged last block) from h0."""
    args = _scan_inputs(cuda, 3, S, 8232, torch.bfloat16, seed=S)
    _scan_close(ops.selective_scan(*args), ref.selective_scan_ref(*args))


def test_selective_scan_repeats_bit_for_bit(cuda):
    args = _scan_inputs(cuda, 2, 300, 4096, torch.float32, seed=7)
    y1, h1 = ops.selective_scan(*args)
    y2, h2 = ops.selective_scan(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_selective_scan_rejects_what_it_does_not_take(cuda):
    x, dt_pre, dt_bias, a_log, b, c, d_skip, h0 = _scan_inputs(
        cuda, 2, 8, 256, torch.float32)
    with pytest.raises(ValueError, match="state size"):
        ops.selective_scan(x, dt_pre, dt_bias, a_log[:, :8], b[..., :8],
                           c[..., :8], d_skip)
    with pytest.raises(ValueError, match="channels contiguous"):
        ops.selective_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                           dt_pre, dt_bias, a_log, b, c, d_skip)
    with pytest.raises(ValueError, match="one strides"):
        ops.selective_scan(x, dt_pre, dt_bias, a_log, b.contiguous(), c,
                           d_skip)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(x, dt_pre, dt_bias, a_log, b, c, d_skip,
                           h0.transpose(1, 2))
    with pytest.raises(NotImplementedError, match="A11"):
        ops.selective_scan(x.requires_grad_(True), dt_pre, dt_bias, a_log,
                           b, c, d_skip)


def test_small_hybrid_serve_on_the_card_matches_the_cpu(cuda):
    """The reduced jamba-v0.1-52b in f32 with the same weights on the card
    and the CPU: ``serve`` of 2 × 64 tokens and 4 decode steps gives the
    same tokens, logits to 1e-4 of their max; ``selective_scan`` runs once
    a Mamba layer (7) in the prefill and in each decode step."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    m_cpu = build_model(cfg, torch.float32, device="cpu")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    m_dev = build_model(cfg, torch.float32)
    p_dev = copy.deepcopy(p_cpu).to(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    on_cpu = serve(m_cpu, p_cpu, prompt, 5)
    before = ops.launch_counts()
    on_dev = serve(m_dev, p_dev, prompt.to(cuda), 5)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"selective_scan": 7 * 5}
    assert torch.equal(on_dev.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_dev.logits.cpu(), on_cpu.logits, rtol=1e-4,
                               atol=1e-4 * float(on_cpu.logits.abs().max()))
