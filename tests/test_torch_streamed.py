"""The port's streamed round (``client_chunk``) against the reference's.

The same problem goes into both packages, and each engine runs its
streamed round over the same per-client-keyed pass: a client's delta is
``(uniform(key, (d,)) − 0.5)·(1 + 0.1·n_k)``, a function of its own key
and n_k only — the port's threefry ``uniform`` is bit-equal to JAX's — so
the two rounds differ only in summation order (rtol 1e-5, the reference's
calibration).  Chunks of 1, 3 and ≥ Kb cover the ragged last chunk and the
one-chunk bucket; the three weightings, p ∈ {1.0, 0.5} and both
aggregators are covered, and the state round threads and freezes state
exactly.  A chunk's clients get the entries of the whole bucket's
``split(kb, Kb)``, never a new split over the chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.engine import RoundEngine as RefRoundEngine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import dataset_from_arrays  # noqa: E402
from repro_torch.core import FedAvg, FedAvgConfig, build_problem  # noqa: E402
from repro_torch.core.problem import ClientBucket  # noqa: E402
from repro_torch.core.engine import EngineConfig, RoundEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.utils import threefry  # noqa: E402


@pytest.fixture(scope="module")
def problems(small_problem, small_dataset):
    return small_problem, build_problem(
        dataset_from_arrays(small_dataset, device="cpu"), device="cpu")


def ref_keyed(w, bucket, keys):
    def one(n_k, ck):
        return ((jax.random.uniform(ck, w.shape) - 0.5)
                * (1.0 + 0.1 * n_k.astype(jnp.float32)))
    return jax.vmap(one)(bucket.n_k, keys)


def port_keyed(w, bucket, keys, out):
    u = threefry.uniform(keys, (w.shape[0],))
    out.copy_((u - 0.5) * (1.0 + 0.1 * bucket.n_k.to(torch.float32))[:, None])


def ref_chunk_pass(w, bi, cb, keys):
    return ref_keyed(w, cb, keys)


def port_chunk_pass(w, bi, cb, keys, out):
    port_keyed(w, cb, keys, out)


def _a_diag(d):
    return np.asarray(jnp.abs(jax.random.normal(jax.random.PRNGKey(2), (d,)))
                      + 0.5)


def test_fused_accumulate_chunks_compose_to_the_one_shot_aggregate():
    """Folding a stack through fused_accumulate chunk by chunk, then
    fused_epilogue, is the reference's one-shot fused_aggregate oracle."""
    rng = np.random.default_rng(6)
    K, d, chunk = 12, 515, 5
    wt, a = rng.standard_normal(d), np.abs(rng.standard_normal(d)) + 0.5
    deltas = rng.standard_normal((K, d))
    wts = rng.random(K)
    wt, a, deltas, wts = (x.astype(np.float32) for x in (wt, a, deltas, wts))
    acc = torch.zeros(d)
    for c0 in range(0, K, chunk):
        acc = ops.fused_accumulate(acc, torch.tensor(deltas[c0:c0 + chunk]),
                                   torch.tensor(wts[c0:c0 + chunk]))
    out = ops.fused_epilogue(torch.tensor(wt), acc, torch.tensor(a), 1.3)
    expect = jref.fused_aggregate_ref(jnp.asarray(wt), jnp.asarray(deltas),
                                      jnp.asarray(wts), jnp.asarray(a), 1.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk,weighting,participation,aggregator", [
    (1, "nk", 1.0, "dense"),
    (3, "nk", 0.5, "pallas"),
    (3, "uniform", 1.0, "pallas"),
    (None, "uniform", 0.5, "dense"),
    (3, "sum", 0.5, "dense"),
    (None, "sum", 1.0, "pallas"),
], ids=["c1-nk-p1-dense", "c3-nk-p0.5-pallas", "c3-uniform-p1-pallas",
        "cK-uniform-p0.5-dense", "c3-sum-p0.5-dense", "cK-sum-p1-pallas"])
def test_streamed_round_matches_reference_streamed_round(
        problems, chunk, weighting, participation, aggregator):
    rp, pp = problems
    chunk = rp.num_clients if chunk is None else chunk
    a = _a_diag(rp.d)
    kw = dict(weighting=weighting, participation=participation,
              server_scaling="diag", aggregator=aggregator, client_chunk=chunk)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw), a_diag=jnp.asarray(a))
    port = RoundEngine(pp, EngineConfig(**kw), a_diag=torch.tensor(a))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (rp.d,)) * 0.1)
    expect = ref.round_streamed(jnp.asarray(w), jax.random.PRNGKey(3),
                                ref_chunk_pass)
    got = port.round_streamed(torch.tensor(w), threefry.PRNGKey(3),
                              port_chunk_pass)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("aggregator", ["dense", "pallas"])
def test_streamed_round_launches_one_accumulate_a_chunk(problems, aggregator,
                                                        monkeypatch):
    """Under "pallas" every chunk goes through fused_accumulate and the
    round ends with one fused_epilogue; one (chunk, d) block is passed at
    a time."""
    _, pp = problems
    calls = {"acc": [], "epi": 0}
    real_acc, real_epi = ops.fused_accumulate, ops.fused_epilogue

    def acc(a, deltas, wts):
        calls["acc"].append(tuple(deltas.shape))
        return real_acc(a, deltas, wts)

    def epi(*args):
        calls["epi"] += 1
        return real_epi(*args)

    monkeypatch.setattr(ops, "fused_accumulate", acc)
    monkeypatch.setattr(ops, "fused_epilogue", epi)
    chunk = 3
    eng = RoundEngine(pp, EngineConfig(client_chunk=chunk,
                                       aggregator=aggregator))
    eng.round_streamed(torch.zeros(pp.d), threefry.PRNGKey(0),
                       port_chunk_pass)
    if aggregator == "dense":
        assert calls == {"acc": [], "epi": 0}
        return
    expect = sum(-(-b.num_clients // min(chunk, b.num_clients))
                 for b in pp.buckets)
    assert len(calls["acc"]) == expect and calls["epi"] == 1
    assert {s[1] for s in calls["acc"]} == {pp.d}
    assert max(s[0] for s in calls["acc"]) <= chunk


@pytest.mark.parametrize("chunk,participation", [(1, 0.5), (3, 1.0),
                                                 (3, 0.5)])
def test_streamed_state_round_matches_reference(problems, chunk,
                                                participation):
    """Deltas, state threading and the frozen-state masking under the
    round's one draw: states equal the reference's bit for bit, the
    iterate to rtol 1e-5."""
    rp, pp = problems
    kw = dict(weighting="sum", participation=participation,
              client_chunk=chunk)
    ref = RefRoundEngine(rp, RefEngineConfig(**kw))
    port = RoundEngine(pp, EngineConfig(**kw))

    # the new state is exact in f32 (no product to contract into an FMA)
    # and a function of each client's old state and own key
    def ref_pass(w, bi, cb, s_c, keys):
        tag = (keys[:, 1] % 7).astype(jnp.float32)[:, None]
        return ref_keyed(w, cb, keys), 2.0 * s_c + tag

    def port_pass(w, bi, cb, s_c, keys, out):
        port_keyed(w, cb, keys, out)
        return 2.0 * s_c + (keys[1] % 7).to(torch.float32)[:, None]

    rng = np.random.default_rng(0)
    states = [rng.standard_normal((b.num_clients, 3)).astype(np.float32)
              for b in rp.buckets]
    w_ref, st_ref = ref.round_streamed_with_state(
        jnp.zeros(rp.d), [jnp.asarray(s) for s in states],
        jax.random.PRNGKey(5), ref_pass)
    w_port, st_port = port.round_streamed_with_state(
        torch.zeros(pp.d), [torch.tensor(s) for s in states],
        threefry.PRNGKey(5), port_pass)
    np.testing.assert_allclose(w_port.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-5)
    for s_p, s_r in zip(st_port, st_ref):
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))


def test_chunk_keys_are_the_whole_buckets_split(problems):
    """A chunk's keys are its entries of split(kb, Kb): drawn for a slice
    or gathered at any positions, never a new split over the chunk."""
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(client_chunk=3))
    kb = threefry.fold_in(threefry.PRNGKey(7), 11)
    whole = eng.client_keys(kb, 17)
    part = eng.client_keys(kb, 5, start=9)
    for x, y in zip(part, whole):
        assert torch.equal(x, y[9:14])
    rows = torch.tensor([16, 2, 2, 0])
    for x, y in zip(eng.gathered_keys(kb, rows), whole):
        assert torch.equal(x, y[rows])
    ref = np.asarray(jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(7), 11), 17))
    np.testing.assert_array_equal(
        np.stack([p.numpy() for p in part], axis=1), ref[9:14])


def test_a_chunks_clients_draw_from_their_own_keys(problems):
    """FedAvg's streamed chunks give each client the delta the plain pass
    gives it, bit for bit; permuting the clients of one chunk (rows and
    keys) permutes their deltas and moves no other client's — a client's
    delta comes from its own rows and its entry of split(kb, Kb)."""
    _, pp = problems
    solver = FedAvg(pp, FedAvgConfig(client_chunk=4, local_epochs=2),
                    device="cpu")
    eng = solver.engine
    bi = max(range(len(pp.buckets)), key=lambda i: pp.buckets[i].num_clients)
    b = pp.buckets[bi]
    Kb = b.num_clients
    assert Kb >= 5
    kb = threefry.fold_in(threefry.PRNGKey(2), eng._offsets[bi])
    w = torch.linspace(-0.1, 0.1, pp.d)
    seen = []

    def record(w_, bi_, cb, keys, out):
        solver._chunk_pass(w_, bi_, cb, keys, out)
        seen.append(out.clone())

    wts = torch.ones(Kb)
    eng._stream_bucket(w, bi, b, kb, wts, record, ())
    base = torch.cat(seen)[:Kb]
    plain = torch.empty((Kb, pp.d))
    solver._pass(w, bi, b, kb, plain)
    assert torch.equal(base, plain)
    seen.clear()
    order = torch.cat([torch.tensor([2, 0, 3, 1]), torch.arange(4, Kb)])
    moved_bucket = ClientBucket(b.idx[order], b.val[order], b.y[order],
                                b.n_k[order])
    keys = eng.client_keys(kb, Kb)
    eng._stream_bucket(w, bi, moved_bucket, kb, wts, record, (),
                       keys=tuple(k[order] for k in keys))
    assert torch.equal(torch.cat(seen)[:Kb], base[order])


def test_streamed_pad_clients_drop_out_even_with_nonzero_deltas(problems):
    """A pad client (weight 0, n_k 0) whose delta is not zero adds
    nothing: the streamed sum equals the sum over the real clients."""
    _, pp = problems
    eng = RoundEngine(pp, EngineConfig(client_chunk=4, aggregator="pallas",
                                       weighting="sum"))
    bi = max(range(len(pp.buckets)), key=lambda i: pp.buckets[i].num_clients)
    b = pp.buckets[bi]
    assert b.num_clients % 4 != 0
    kb = threefry.fold_in(threefry.PRNGKey(4), eng._offsets[bi])

    def ones_pass(w, bi_, cb, keys, out):
        out.fill_(1.0)

    acc, _ = eng._stream_bucket(torch.zeros(pp.d), bi, b, kb,
                                torch.ones(b.num_clients), ones_pass, ())
    assert torch.equal(acc, torch.full((pp.d,), float(b.num_clients)))


def test_engine_config_streamed_requires():
    """round_streamed and its state twin need client_chunk; compile with a
    chunk needs a chunk pass."""
    from repro.configs import get_logreg_config
    from repro_torch.data import generate
    ds = generate(get_logreg_config().scaled(0.001), seed=3, device="cpu")
    prob = build_problem(ds, device="cpu")
    eng = RoundEngine(prob, EngineConfig())
    with pytest.raises(ValueError, match="round_streamed requires "
                       "cfg.client_chunk"):
        eng.round_streamed(torch.zeros(prob.d), threefry.PRNGKey(0),
                           port_chunk_pass)
    with pytest.raises(ValueError, match="round_streamed_with_state requires"):
        eng.round_streamed_with_state(torch.zeros(prob.d), [],
                                      threefry.PRNGKey(0), port_chunk_pass)
    chunked = RoundEngine(prob, EngineConfig(client_chunk=2))
    with pytest.raises(ValueError, match="no chunk_pass was supplied"):
        chunked.compile(lambda *a: None)
    assert chunked.round_path() == "streamed"
    assert chunked.round_path(compiled=False) == "plain"
