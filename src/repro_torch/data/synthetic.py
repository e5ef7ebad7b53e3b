"""Synthetic federated sparse-logreg data with the paper's §4 statistics —
the port of the reference's ``data/synthetic.py``.

The O(K) size draw and the O(d) ground truth come from numpy exactly as in
the reference (:func:`_power_law_sizes` and :func:`train_split_sizes` are
copied verbatim, drawn from ``np.random.default_rng(seed)`` in the same
order), so client sizes and ``w_true`` are bit-equal to the reference's.

Every row comes from the reference's keyed sampler, batched on the device,
with JAX's threefry (:mod:`repro_torch.utils.threefry`):

* client k's key is ``ck = fold_in(PRNGKey(seed), k)``;
* its vocabulary is the Gumbel top-V of the global log popularity,
  ``top_k(log_pop + gumbel(fold_in(ck, VOCAB), (d − 2,)), V)`` — weighted
  sampling without replacement, in descending score order;
* its mixture over the vocabulary is a normalized Weibull(0.3) draw from
  ``fold_in(ck, MIX)``, its label bias a logistic draw of std 1.5 from
  ``fold_in(ck, BIAS)``;
* row p is drawn from ``rk = fold_in(fold_in(ck, ROWS), p)``: ``n_own``
  inverse-CDF draws from the client's mixture (``fold_in(rk, OWN)``) and
  ``nnz − n_own`` from the global zipf popularity (``fold_in(rk, GLOB)``),
  after the always-on bias (0) and unknown-word (1) features; repeated
  features in a row get value 0; the label is
  Bernoulli(sigmoid(0.7·margin + bias)) (``fold_in(rk, LABEL)``);
* the chronological 75/25 split per client.

The uniforms are the reference's bits.  The logs, the power and the
sigmoid are :mod:`repro_torch.utils.floatmath`'s, the same bits on the CPU
and on the card, and within an ulp or two of XLA's, so the integer arrays
equal the reference's except where a near tie of two Gumbel scores or a
uniform within an ulp of an edge of the mixture falls the other way.

Because every draw is keyed by (client, row position), any client's rows
regenerate on their own: :class:`VirtualDataset` is the O(K + d) spec
(:func:`data_spec`'s draws plus the base key ``PRNGKey(seed)``) and
:meth:`VirtualDataset.client_rows_padded` regenerates a batch of clients'
rows into the round engine's padded bucket layout, bit-equal to the same
rows of :func:`generate` — which is ``materialize_dataset(virtual_dataset(
cfg, seed))``, as in the reference.  :func:`drifted_dataset` is an
epoch's view of that spec (concept drift and resampled clients), its rows
bit-equal to the reference's epoch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import floatmath, threefry
from repro_torch.utils.device import DeviceLike, resolve_device

#: fold_in tags off the client key ck = fold_in(PRNGKey(seed), k)
_ROWS_TAG, _VOCAB_TAG, _MIX_TAG, _BIAS_TAG = 0, 1, 2, 3
#: fold_in tags off the row key rk = fold_in(fold_in(ck, ROWS), p)
_OWN_TAG, _GLOB_TAG, _LABEL_TAG = 0, 1, 2

#: logistic(0, s) has std s·π/√3 — this scale gives the label bias std 1.5
_BIAS_SCALE = 1.5 * math.sqrt(3.0) / math.pi

#: folded off the base key to root drift resampling
_DRIFT_TAG = 0xD41F7

#: clients per batch of the vocabulary draw (a (block, d) score matrix)
_PARAM_BLOCK = 2048
#: rows per batch of the row sampler
_ROW_BLOCK = 1 << 16


@dataclasses.dataclass
class FederatedDataset:
    """Sparse design matrix in fixed-nnz row format, partitioned by client
    and stored client-contiguous; row tensors live on one device."""

    idx: torch.Tensor           # (n, nnz) int64 feature indices
    val: torch.Tensor           # (n, nnz) float32 (0 marks a repeat)
    y: torch.Tensor             # (n,) float32 in {-1, +1}
    client_of: torch.Tensor     # (n,) int64
    client_sizes: np.ndarray    # (K,) int32 train sizes (host)
    num_features: int

    test_idx: torch.Tensor
    test_val: torch.Tensor
    test_y: torch.Tensor
    test_client_of: torch.Tensor

    @property
    def num_clients(self) -> int:
        return len(self.client_sizes)

    @property
    def num_examples(self) -> int:
        return int(self.y.shape[0])


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What :func:`generate` draws with numpy before the per-client sampler:
    the reference's ``VirtualDataset`` fields less its JAX key."""

    full_sizes: np.ndarray     # (K,) int64, train + test rows per client
    client_sizes: np.ndarray   # (K,) int32, train rows per client
    w_true: np.ndarray         # (d,) float32 ground-truth weights
    log_pop: np.ndarray        # (d-2,) float32 log zipf popularity
    global_cdf: np.ndarray     # (d-2,) float32 zipf CDF
    num_features: int
    nnz: int
    vocab_size: int
    n_own: int


def _power_law_sizes(rng, K, n_total, n_min, n_max, alpha=1.6):
    """Power-law client sizes with Σ n_k == clip(n_total, K·n_min, K·n_max).

    The clipped mass is redistributed over the unsaturated clients
    (largest-first for a deficit, smallest-first for a surplus) and the float
    sizes are integerized largest-remainder style, so the realized total is
    exact whenever ``K·n_min <= n_total <= K·n_max``.
    """
    target = float(np.clip(n_total, K * n_min, K * n_max))
    raw = np.clip((rng.pareto(alpha, size=K) + 1.0) * n_min, n_min, n_max)
    sizes = np.clip(raw / raw.sum() * target, n_min, n_max)
    gap = target - sizes.sum()
    order = np.argsort(-sizes if gap > 0 else sizes, kind="stable")
    for k in order:
        if abs(gap) < 0.5:
            break
        if gap > 0:
            take = min(gap, n_max - sizes[k])
        else:
            take = max(gap, n_min - sizes[k])
        sizes[k] += take
        gap -= take

    base = np.clip(np.floor(sizes).astype(np.int64), n_min, n_max)
    rem = int(round(target)) - int(base.sum())
    frac_order = np.argsort(-(sizes - base), kind="stable")
    step = 1 if rem > 0 else -1
    while rem != 0:
        adjustable = False
        for k in frac_order:
            if rem == 0:
                break
            if n_min <= base[k] + step <= n_max:
                base[k] += step
                rem -= step
                adjustable = True
        if not adjustable:      # every client saturated: nearest feasible
            break
    return base


def train_split_sizes(sizes) -> np.ndarray:
    """The chronological 75/25 split: train gets ``max(1, floor(0.75 n_k))``
    capped at n_k − 1, so every client with n_k >= 2 keeps at least one
    train and one test example."""
    sizes = np.asarray(sizes, np.int64)
    tr = np.maximum(1, (0.75 * sizes).astype(np.int64))
    return np.where(sizes >= 2, np.minimum(tr, sizes - 1), tr)


def data_spec(cfg, seed: int = 0) -> DataSpec:
    """The numpy draws of :func:`generate`, in the reference's order."""
    rng = np.random.default_rng(seed)
    K, d = cfg.num_clients, cfg.num_features
    nnz = min(cfg.nnz_per_example, d - 2)

    sizes = _power_law_sizes(rng, K, cfg.num_examples,
                             cfg.min_client_examples, cfg.max_client_examples)
    # ground-truth weights: heavy-tailed so rare features carry signal
    w_true = rng.standard_normal(d) * (rng.random(d) < 0.3)
    # global feature popularity (zipf over non-special features)
    ranks = np.arange(2, d)
    global_pop = 1.0 / ranks ** 1.1
    global_pop /= global_pop.sum()
    gcdf = np.cumsum(global_pop)
    gcdf[-1] = 1.0
    return DataSpec(
        full_sizes=sizes.astype(np.int64),
        client_sizes=train_split_sizes(sizes).astype(np.int32),
        w_true=w_true.astype(np.float32),
        log_pop=np.log(global_pop).astype(np.float32),
        global_cdf=gcdf.astype(np.float32),
        num_features=d, nnz=nnz,
        vocab_size=min(max(8, int(0.02 * d)), d - 2),
        n_own=int(0.8 * nnz),
    )


def client_params(base_key: threefry.Key, client_ids: torch.Tensor,
                  log_pop: torch.Tensor, vocab_size: int):
    """The clients' (vocab, mixture CDF, label bias, rows key): the
    reference's ``_client_params`` for a batch of client ids.

    ``top_k`` is a stable sort of the scores, descending: equal scores keep
    the lower feature first, as ``lax.top_k`` does, and the mixture's CDF
    is aligned to that order."""
    ck = threefry.fold_in(base_key, client_ids)
    scores = log_pop + threefry.gumbel(threefry.fold_in(ck, _VOCAB_TAG),
                                       (log_pop.shape[0],))
    top = torch.sort(scores, dim=1, descending=True, stable=True).indices
    vocab = top[:, :vocab_size] + 2
    u = threefry.uniform(threefry.fold_in(ck, _MIX_TAG), (vocab_size,),
                         1e-7, 1.0)
    raw = floatmath.pow_f32(-floatmath.log_f32(u), 1.0 / 0.3)
    cdf = floatmath.cumsum_f32(raw / floatmath.sum_f32(raw)[:, None])
    cdf[:, -1] = 1.0
    ub = threefry.uniform(threefry.fold_in(ck, _BIAS_TAG), (), 1e-6,
                          1.0 - 1e-6)
    scale = torch.full((), _BIAS_SCALE, dtype=torch.float32, device=ub.device)
    bias = scale * floatmath.log_f32(ub / (1.0 - ub))
    return vocab, cdf, bias, threefry.fold_in(ck, _ROWS_TAG)


def _rows(rows_key: threefry.Key, pos: torch.Tensor, vocab, cdf, bias,
          w_true, global_cdf, nnz: int, n_own: int):
    """One batch of rows (idx, val, y): row i is row ``pos[i]`` of the
    client whose rows key, vocabulary, CDF and bias are row i of
    ``rows_key``, ``vocab``, ``cdf`` and ``bias``."""
    m = pos.shape[0]
    dev = pos.device
    V = vocab.shape[1]
    rk = threefry.fold_in(rows_key, pos)
    u_own = threefry.uniform(threefry.fold_in(rk, _OWN_TAG), (n_own,))
    at = torch.searchsorted(cdf, u_own, right=True).clamp_(max=V - 1)
    own = vocab.gather(1, at)
    dg = global_cdf.shape[0]
    u_glob = threefry.uniform(threefry.fold_in(rk, _GLOB_TAG), (nnz - n_own,))
    glob = torch.searchsorted(global_cdf, u_glob, right=True).clamp_(
        max=dg - 1)
    special = torch.arange(2, device=dev).expand(m, 2)
    idx = torch.cat([special, own, glob + 2], dim=1)
    # repeated features within a row keep their slot with value 0: in
    # stable sorted order every repeat after the first is flagged, then the
    # flags are sent back to the original positions (the reference's two
    # stable argsorts)
    srt, order = torch.sort(idx, dim=1, stable=True)
    dup = torch.zeros_like(idx, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    repeat = torch.zeros_like(dup).scatter_(1, order, dup)
    val = (~repeat).to(torch.float32)
    margin = floatmath.sum_f32(val * w_true[idx])
    # XLA contracts 0.7·margin + bias into one fused multiply-add
    logit = threefry.fma_f32(torch.full_like(margin, 0.7), margin, bias)
    p = floatmath.sigmoid_f32(logit)
    u_y = threefry.uniform(threefry.fold_in(rk, _LABEL_TAG), ())
    y = torch.where(u_y < p, 1.0, -1.0).to(torch.float32)
    return idx, val, y


@dataclasses.dataclass(frozen=True)
class VirtualDataset:
    """The O(K + d) spec from which any client's rows regenerate on demand:
    the reference's ``VirtualDataset``, i.e. :func:`data_spec`'s draws plus
    the base key ``PRNGKey(seed)``, with the d-sized tables as tensors on
    one device (where every regenerated row is drawn).  ``client_sizes``
    are the train sizes; a client's test rows are the chronological tail
    ``[client_sizes[k], full_sizes[k])``."""

    base_key: threefry.Key     # PRNGKey(seed), words on the device
    full_sizes: np.ndarray     # (K,) int64, train + test rows per client
    client_sizes: np.ndarray   # (K,) int32, train rows per client
    w_true: torch.Tensor       # (d,) f32 ground-truth weights
    log_pop: torch.Tensor      # (d-2,) f32 log zipf popularity
    global_cdf: torch.Tensor   # (d-2,) f32 zipf CDF
    num_features: int
    nnz: int
    vocab_size: int
    n_own: int

    @property
    def device(self) -> torch.device:
        return self.w_true.device

    @property
    def num_clients(self) -> int:
        return len(self.client_sizes)

    @property
    def num_examples(self) -> int:
        """Train examples (``FederatedDataset.num_examples``)."""
        return int(self.client_sizes.sum())

    def params(self, client_ids: torch.Tensor):
        """(vocab, cdf, bias, rows-key words) of a batch of clients, in
        blocks of ``_PARAM_BLOCK`` (the (block, d) Gumbel scores bound the
        memory)."""
        parts = [client_params(self.base_key,
                               client_ids[k0:k0 + _PARAM_BLOCK],
                               self.log_pop, self.vocab_size)
                 for k0 in range(0, client_ids.shape[0], _PARAM_BLOCK)]
        return tuple(torch.cat(p) for p in zip(
            *[(v, c, b, rk[0], rk[1]) for v, c, b, rk in parts]))

    def rows(self, params, client: torch.Tensor, pos: torch.Tensor):
        """Rows ``pos[i]`` of the clients at ``params`` index ``client[i]``
        (``params`` from :meth:`params`), in blocks of ``_ROW_BLOCK``:
        (idx (m, nnz + 2) int64, val f32, y (m,) f32)."""
        vocab, cdf, bias, rk0, rk1 = params
        n, dev = pos.shape[0], pos.device
        width = self.nnz + 2
        idx = torch.empty((n, width), dtype=torch.int64, device=dev)
        val = torch.empty((n, width), dtype=torch.float32, device=dev)
        y = torch.empty((n,), dtype=torch.float32, device=dev)
        for i0 in range(0, n, _ROW_BLOCK):
            i1 = min(i0 + _ROW_BLOCK, n)
            c = client[i0:i1]
            idx[i0:i1], val[i0:i1], y[i0:i1] = _rows(
                (rk0[c], rk1[c]), pos[i0:i1], vocab[c], cdf[c], bias[c],
                self.w_true, self.global_cdf, self.nnz, self.n_own)
        return idx, val, y

    def client_rows_padded(self, client_ids: torch.Tensor,
                           n_k: torch.Tensor, m_pad: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """A batch of C clients' first ``n_k`` rows in the engine's padded
        bucket layout: (C, m_pad, nnz + 2) idx int64 and val f32, (C,
        m_pad) y f32; positions >= n_k hold the padding (idx 0, val 0,
        y 1).  Only the C·n_k real rows are drawn: a row's draws depend on
        its (client, position) alone, so they are the same bits as in
        :func:`generate`."""
        dev = self.device
        cids = client_ids.to(dev, torch.int64)
        nk = n_k.to(dev, torch.int64)
        C, width = cids.shape[0], self.nnz + 2
        idx = torch.zeros((C, m_pad, width), dtype=torch.int64, device=dev)
        val = torch.zeros((C, m_pad, width), dtype=torch.float32, device=dev)
        y = torch.ones((C, m_pad), dtype=torch.float32, device=dev)
        keep = (torch.arange(m_pad, device=dev)[None, :] < nk[:, None])
        client, pos = keep.nonzero(as_tuple=True)
        if client.numel():
            live = (nk > 0).nonzero().flatten()
            slot = torch.full((C,), -1, dtype=torch.int64, device=dev)
            slot[live] = torch.arange(live.shape[0], device=dev)
            idx[client, pos], val[client, pos], y[client, pos] = self.rows(
                self.params(cids[live]), slot[client], pos)
        return idx, val, y


def virtual_dataset(cfg, seed: int = 0, *,
                    device: DeviceLike = None) -> VirtualDataset:
    """The virtual twin of :func:`generate`: the same cfg and seed give the
    same data, in O(K + d) memory on ``device`` (default: the CUDA card) —
    :func:`data_spec`'s numpy draws and the base key ``PRNGKey(seed)``."""
    dev = resolve_device(device)
    spec = data_spec(cfg, seed)
    return VirtualDataset(
        base_key=threefry.as_key(threefry.PRNGKey(seed), dev),
        full_sizes=spec.full_sizes, client_sizes=spec.client_sizes,
        w_true=torch.as_tensor(spec.w_true, device=dev),
        log_pop=torch.as_tensor(spec.log_pop, device=dev),
        global_cdf=torch.as_tensor(spec.global_cdf, device=dev),
        num_features=spec.num_features, nnz=spec.nnz,
        vocab_size=spec.vocab_size, n_own=spec.n_own)


def make_client_batch(vds: VirtualDataset, k: int,
                      num_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Client ``k``'s first ``num_rows`` chronological rows (default: all
    of them, train + test) regenerated from its key on the dataset's
    device — bit-equal to client ``k``'s rows of :func:`generate` on the
    same config and seed."""
    if num_rows is None:
        num_rows = int(vds.full_sizes[k])
    dev = vds.device
    params = vds.params(torch.tensor([int(k)], device=dev))
    return vds.rows(params, torch.zeros(num_rows, dtype=torch.int64,
                                        device=dev),
                    torch.arange(num_rows, device=dev))


def generate(cfg, seed: int = 0, *,
             device: DeviceLike = None) -> FederatedDataset:
    """cfg: a ``repro_torch.configs.LogRegConfig`` (possibly ``.scaled()``).

    The reference's ``generate(cfg, seed)``, drawn on ``device`` (default:
    the CUDA card): ``materialize_dataset(virtual_dataset(cfg, seed))``."""
    return materialize_dataset(virtual_dataset(cfg, seed, device=device))


def materialize_dataset(vds: VirtualDataset) -> FederatedDataset:
    """Every client's rows from a virtual spec, on its device: client
    parameters in blocks of ``_PARAM_BLOCK`` clients, rows in blocks of
    ``_ROW_BLOCK`` — the keyed draws make the batching invisible — then the
    chronological 75/25 split (:func:`train_split_sizes`)."""
    dev = vds.device
    K = vds.num_clients
    params = vds.params(torch.arange(K, device=dev))
    sizes = torch.as_tensor(vds.full_sizes, dtype=torch.int64, device=dev)
    n = int(vds.full_sizes.sum())
    client_of = torch.repeat_interleave(
        torch.arange(K, dtype=torch.int64, device=dev), sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(n, device=dev) - starts[client_of]
    idx, val, y = vds.rows(params, client_of, pos)

    # chronological split: a client's first client_sizes[k] rows train
    tr_sizes = torch.as_tensor(vds.client_sizes, dtype=torch.int64,
                               device=dev)
    tr = pos < tr_sizes[client_of]
    te = ~tr
    return FederatedDataset(
        idx=idx[tr], val=val[tr], y=y[tr], client_of=client_of[tr],
        client_sizes=vds.client_sizes, num_features=vds.num_features,
        test_idx=idx[te], test_val=val[te], test_y=y[te],
        test_client_of=client_of[te],
    )


# --------------------------------------------------------------------- #
# distribution drift: epoch-indexed views of the virtual spec
# --------------------------------------------------------------------- #


def pow_f32(x: float, n: int) -> np.float32:
    """``jnp.float32(x) ** n`` for an int ``n >= 1``, bit for bit: XLA
    forms an integer power by repeated squaring (``lax.integer_pow``),
    rounding to f32 after each product, and so does this.  ``0.8 ** 4``
    is 0.40960005 so, not the correctly rounded 0.40960002."""
    base, acc = np.float32(x), None
    while n > 0:
        if n & 1:
            acc = base if acc is None else np.float32(acc * base)
        n >>= 1
        if n > 0:
            base = np.float32(base * base)
    return acc


def drifted_dataset(vds: VirtualDataset, epoch: int, *,
                    w_true_scale: float = 1.0,
                    resample_clients: bool = False) -> VirtualDataset:
    """Epoch ``epoch``'s view of the fleet's data distribution — the
    reference's ``drifted_dataset``, a pure function of ``(vds, epoch)``:

      * ``w_true_scale`` — concept drift: the ground truth scales by
        ``float32(w_true_scale) ** epoch`` (:func:`pow_f32`), so label
        noise grows (< 1) or falls (> 1) while every client keeps its
        vocabulary and feature marginals;
      * ``resample_clients`` — the base key is re-rooted at
        ``fold_in(fold_in(base_key, _DRIFT_TAG), epoch)``, redrawing every
        client's vocabulary, mixture and bias (same sizes, same w_true).

    Epoch 0 is the identity (``vds`` itself); a negative epoch raises.
    Client count and sizes never change, so neither does any engine
    shape."""
    if epoch < 0:
        raise ValueError("epoch must be >= 0")
    if epoch == 0:
        return vds
    out = vds
    if w_true_scale != 1.0:
        factor = torch.tensor(pow_f32(w_true_scale, epoch),
                              dtype=torch.float32, device=vds.device)
        out = dataclasses.replace(out, w_true=vds.w_true * factor)
    if resample_clients:
        out = dataclasses.replace(out, base_key=threefry.fold_in(
            threefry.fold_in(vds.base_key, _DRIFT_TAG), epoch))
    return out
