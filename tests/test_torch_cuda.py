"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; the file
imports neither JAX nor the reference, so it runs on the card's machine:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the aggregation sums K in another order (splits of fused
multiply-adds) than the plain version; the local steps contract into fused
multiply-adds where the plain version rounds each operation; the SDCA
Newton solve takes logf and divisions that may round an ulp apart from
PyTorch's, over 12 steps.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CoCoAPlus, FedAvg, Trainer,  # noqa: E402
                              build_problem, make_solver)
from repro_torch.configs import get_logreg_config  # noqa: E402
from repro_torch.data import generate  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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
@pytest.mark.parametrize("K,d", [(1, 1), (9, 999), (33, 1000), (300, 20_002)])
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
    """``cls`` with its permutations drawn on the CPU from one generator
    per round and bucket, so the card and the CPU walk the same orders."""

    class SharedDraws(cls):
        def round(self, state, gen):
            self._r = state.round
            return super().round(state, gen)

        def permutations(self, gen, bucket_index, bucket):
            cpu = torch.Generator().manual_seed(1000 * self._r + bucket_index)
            return super().permutations(cpu, bucket_index, bucket)

    return SharedDraws


@pytest.mark.parametrize("name", ["fedavg", "dane", "cocoa"])
def test_new_solvers_small_runs_on_the_card(cuda, name):
    """FedAvg, DANE (GD) and CoCoA+ for three rounds on the card and on
    the CPU from the same data and draws agree to rtol 1e-4 of max |w|;
    on the card each local step launches its kernel once and each round
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
                "cocoa": ("cocoa_sdca_update", 3 * m_pads)}[name]
    assert counts[expected[0]] == expected[1]
    assert counts["fused_aggregate"] == 3
