"""Federated finite-sum problem (eq. 1/7/8): sparse L2-regularized logistic
regression in fixed-nnz sparse row format, partitioned over clients — the
port of the reference's ``core/problem.py``.

It provides the flat (all-data) objective and gradient, used for evaluation
and FSVRG's full-gradient prelude, and a *bucketed* per-client layout:
clients are grouped by ceil(log2 n_k) so each bucket pads to its own
largest client, and a local pass runs over all of a bucket's clients at
once with the client axis written out as the batch dimension.  The grouping
(:func:`_equal_runs`, :func:`_split_by_rows`, :func:`_level_groups`) is the
reference's numpy code, so both packages produce the same buckets in the
same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.scatter import index_add


@dataclasses.dataclass(frozen=True)
class LogRegProblem:
    """Flat sparse dataset + lambda, as tensors on one device."""

    idx: torch.Tensor   # (n, nnz) int64
    val: torch.Tensor   # (n, nnz) f32
    y: torch.Tensor     # (n,) f32 {-1,+1}
    lam: float
    num_features: int

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def margins(self, w: torch.Tensor) -> torch.Tensor:
        return (self.val * w[self.idx]).sum(dim=1)

    def loss(self, w: torch.Tensor) -> torch.Tensor:
        z = self.y * self.margins(w)
        return F.softplus(-z).mean() + 0.5 * self.lam * torch.dot(w, w)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        z = self.y * self.margins(w)
        g_scalar = -self.y * torch.sigmoid(-z) / self.n         # (n,)
        g = index_add(torch.zeros_like(w), self.idx.reshape(-1),
                      (g_scalar[:, None] * self.val).reshape(-1))
        return g + self.lam * w

    def error_rate(self, w: torch.Tensor) -> torch.Tensor:
        # a zero margin predicts +1, as in the reference
        preds = torch.where(self.margins(w) >= 0, 1.0, -1.0)
        return (preds != self.y).to(torch.float32).mean()


@dataclasses.dataclass(frozen=True)
class ClientBucket:
    """Clients padded to a common example count m_pad.

    idx/val: (Kb, m_pad, nnz); y: (Kb, m_pad); n_k: (Kb,) true sizes.
    Padded rows have idx 0, val 0 and y 1, and are masked in local passes.
    """

    idx: torch.Tensor
    val: torch.Tensor
    y: torch.Tensor
    n_k: torch.Tensor

    @property
    def num_clients(self) -> int:
        return int(self.n_k.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.y.shape[1])


@dataclasses.dataclass(frozen=True)
class VirtualBucket:
    """A bucket of *virtual* clients: who they are and how many train rows
    they have, but no rows — those regenerate on demand from the client
    ids (:class:`VirtualLayout`).  It has :class:`ClientBucket`'s
    ``num_clients``, ``m_pad`` and ``n_k``, so the engine's bookkeeping
    (weights, offsets, masks) does not depend on the layout."""

    client_ids: torch.Tensor    # (Kb,) int64 global client ids
    n_k: torch.Tensor           # (Kb,) int64 train sizes
    m_pad: int

    @property
    def num_clients(self) -> int:
        return int(self.n_k.shape[0])


@dataclasses.dataclass(frozen=True)
class VirtualLayout:
    """From virtual buckets to the rows the client passes eat: wraps the
    :class:`~repro_torch.data.synthetic.VirtualDataset`, so the engine can
    regenerate one chunk's (or one gathered cohort's) rows right before
    its pass."""

    vds: Any    # repro_torch.data.synthetic.VirtualDataset

    def materialize(self, client_ids: torch.Tensor, n_k: torch.Tensor,
                    m_pad: int) -> ClientBucket:
        idx, val, y = self.vds.client_rows_padded(client_ids, n_k, m_pad)
        return ClientBucket(idx, val, y, n_k.to(idx.device, torch.int64))

    def realize(self, vb: VirtualBucket) -> ClientBucket:
        return self.materialize(vb.client_ids, vb.n_k, vb.m_pad)


class VirtualFlat:
    """The flat view over virtual data, streamed in client chunks.

    It gives what the solvers and :mod:`~repro_torch.core.scaling` read of
    a :class:`LogRegProblem` — ``lam``, ``n``, ``num_features``, ``grad``,
    ``loss``, ``error_rate`` — and the exact ``feature_counts`` and
    ``omega``, each by regenerating ``eval_chunk`` clients at a time (one
    (chunk, m_pad, nnz) block of rows live, never the (n, nnz) arrays).
    Per-row quantities use :class:`LogRegProblem`'s expressions
    (``g_scalar = −y·σ(−z)/n`` before the scatter), so only the summation
    order across rows differs from the materialized view; the counts are
    integer sums and exact."""

    def __init__(self, layout: VirtualLayout, buckets: List[VirtualBucket],
                 lam: float, num_features: int, n: int,
                 eval_chunk: int = 256):
        self.layout = layout
        self.buckets = buckets
        self.lam = float(lam)
        self.num_features = int(num_features)
        self._n = int(n)
        self.eval_chunk = int(eval_chunk)

    @property
    def n(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self.layout.vds.device

    def margins(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "VirtualFlat has no materialized row axis; use loss/grad/"
            "error_rate, which stream over regenerated client chunks.")

    def _chunks(self):
        """Each bucket's clients, ``eval_chunk`` at a time, regenerated:
        (rows, valid-row mask (C, m_pad) f32)."""
        for vb in self.buckets:
            chunk = min(self.eval_chunk, vb.num_clients)
            for c0 in range(0, vb.num_clients, chunk):
                nk = vb.n_k[c0:c0 + chunk]
                cb = self.layout.materialize(vb.client_ids[c0:c0 + chunk],
                                             nk, vb.m_pad)
                mask = (torch.arange(vb.m_pad, device=nk.device)[None, :]
                        < nk[:, None]).to(torch.float32)
                yield cb, mask

    def _stats(self, w: torch.Tensor):
        g = torch.zeros((self.num_features,), dtype=w.dtype,
                        device=w.device)
        ls = torch.zeros((), dtype=torch.float32, device=w.device)
        err = torch.zeros((), dtype=torch.float32, device=w.device)
        for cb, mask in self._chunks():
            margins = (cb.val * w[cb.idx]).sum(dim=-1)
            z = cb.y * margins
            g_scalar = -cb.y * torch.sigmoid(-z) / self._n
            index_add(g, cb.idx.reshape(-1),
                      ((g_scalar * mask)[..., None] * cb.val).reshape(-1))
            ls = ls + (F.softplus(-z) * mask).sum()
            preds = torch.where(margins >= 0, 1.0, -1.0)
            err = err + ((preds != cb.y).to(torch.float32) * mask).sum()
        return g, ls, err

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        return self._stats(w)[0] + self.lam * w

    def loss(self, w: torch.Tensor) -> torch.Tensor:
        return (self._stats(w)[1] / self._n
                + 0.5 * self.lam * torch.dot(w, w))

    def error_rate(self, w: torch.Tensor) -> torch.Tensor:
        return self._stats(w)[2] / self._n

    def _counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.num_features
        cnt = torch.zeros((d,), dtype=torch.float32, device=self.device)
        om = torch.zeros((d,), dtype=torch.float32, device=self.device)
        for cb, _ in self._chunks():
            nz = (cb.val != 0).to(torch.float32)
            cnt.index_add_(0, cb.idx.reshape(-1), nz.reshape(-1))
            C = cb.num_clients
            pres = torch.zeros((C, d), dtype=torch.float32,
                               device=self.device).scatter_add_(
                1, cb.idx.reshape(C, -1), nz.reshape(C, -1))
            om += (pres > 0).sum(dim=0).to(torch.float32)
        return cnt, om

    def feature_counts(self) -> torch.Tensor:
        """#examples with feature j: ``scaling.global_feature_counts`` of
        the materialized view, streamed (exact)."""
        return self._counts()[0]

    def omega(self) -> torch.Tensor:
        """#clients with feature j: ``scaling.omega`` of the materialized
        view, streamed (exact)."""
        return self._counts()[1]


@dataclasses.dataclass(frozen=True)
class FederatedLogReg:
    """The problem as the algorithms see it: flat view + client buckets.

    With ``virtual`` set (:func:`build_virtual_problem`), ``flat`` is a
    :class:`VirtualFlat` and ``buckets`` hold :class:`VirtualBucket` specs;
    the engine regenerates rows through ``virtual`` under
    ``EngineConfig.virtual_data``."""

    flat: LogRegProblem
    buckets: List[ClientBucket]
    client_weights: torch.Tensor    # (K,) n_k / n, bucket-concatenated order
    num_clients: int
    virtual: Optional[VirtualLayout] = None

    @property
    def d(self) -> int:
        return self.flat.num_features

    @property
    def device(self) -> torch.device:
        return self.flat.device


def _equal_runs(order, sorted_keys) -> List[List[int]]:
    """Contiguous runs of equal key in a stably key-sorted index order."""
    if len(order) == 0:
        return []
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
    ends = np.r_[starts[1:], len(order)]
    return [[int(k) for k in order[s:e]] for s, e in zip(starts, ends)]


def _split_by_rows(groups: List[List[int]], sizes,
                   max_bucket_rows: Optional[int]) -> List[List[int]]:
    """Split any group whose padded row count Kb·m_pad would exceed
    ``max_bucket_rows`` into consecutive sub-groups under the cap (a single
    client is never split).  Member order is preserved."""
    if max_bucket_rows is None:
        return groups
    out: List[List[int]] = []
    for members in groups:
        cur: List[int] = []
        cur_pad = 0
        for k in members:
            m_pad = max(cur_pad, int(sizes[k]))
            if cur and (len(cur) + 1) * m_pad > max_bucket_rows:
                out.append(cur)
                cur, cur_pad = [k], int(sizes[k])
            else:
                cur.append(k)
                cur_pad = m_pad
        if cur:
            out.append(cur)
    return out


def _level_groups(sizes, max_bucket_rows: Optional[int]) -> List[List[int]]:
    """The canonical client grouping: stable-sort by ceil(log2 n_k), one
    group per level, split under ``max_bucket_rows``."""
    levels = np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
    order = np.argsort(levels, kind="stable")
    return _split_by_rows(_equal_runs(order, levels[order]), sizes,
                          max_bucket_rows)


def _bucket(flat: LogRegProblem, starts: torch.Tensor, n_k: torch.Tensor,
            m_pad: int) -> ClientBucket:
    """Gather the rows of clients starting at flat rows ``starts`` (with
    ``n_k`` rows each) into a bucket padded to ``m_pad``."""
    dev = flat.device
    pos = torch.arange(m_pad, dtype=torch.int64, device=dev)
    keep = pos[None, :] < n_k[:, None]                      # (Kb, m_pad)
    rows = torch.where(keep, starts[:, None] + pos[None, :], 0)
    idx = torch.where(keep[..., None], flat.idx[rows], 0)
    val = torch.where(keep[..., None], flat.val[rows], 0.0)
    y = torch.where(keep, flat.y[rows], 1.0)
    return ClientBucket(idx, val, y, n_k)


def build_problem(ds, lam: Optional[float] = None, *,
                  max_bucket_rows: Optional[int] = None,
                  device: DeviceLike = None) -> FederatedLogReg:
    """ds: a ``repro_torch.data.FederatedDataset``; the problem's tensors
    live on ``device`` (default: the CUDA card).

    ``max_bucket_rows`` caps each bucket's padded row count Kb·m_pad by
    splitting oversized groups, as in the reference."""
    dev = resolve_device(device)
    n = ds.num_examples
    lam = (1.0 / n) if lam is None else lam
    flat = LogRegProblem(
        idx=ds.idx.to(dev, torch.int64), val=ds.val.to(dev, torch.float32),
        y=ds.y.to(dev, torch.float32), lam=float(lam),
        num_features=int(ds.num_features))

    sizes = np.asarray(ds.client_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    buckets: List[ClientBucket] = []
    weights: List[np.ndarray] = []
    for members in _level_groups(sizes, max_bucket_rows):
        mem = np.asarray(members, np.int64)
        buckets.append(_bucket(
            flat, torch.as_tensor(starts[mem], device=dev),
            torch.as_tensor(sizes[mem], device=dev), int(sizes[mem].max())))
        weights.append(sizes[mem] / n)

    return FederatedLogReg(
        flat=flat, buckets=buckets,
        client_weights=torch.as_tensor(
            np.concatenate(weights).astype(np.float32), device=dev),
        num_clients=int(ds.num_clients),
    )


def build_virtual_problem(vds, lam: Optional[float] = None, *,
                          max_bucket_rows: Optional[int] = None,
                          eval_chunk: int = 256) -> FederatedLogReg:
    """vds: a ``repro_torch.data.VirtualDataset``; the problem lives on its
    device.

    The virtual twin of :func:`build_problem`: the same grouping
    (:func:`_level_groups` over the train sizes), the same weights and the
    same default λ, but the buckets carry only (client ids, n_k, m_pad)
    and the flat view streams (:class:`VirtualFlat`), so the build is
    O(K) whatever Σ n_k.  Rounds on it need
    ``EngineConfig(virtual_data=True)``."""
    dev = vds.device
    sizes = np.asarray(vds.client_sizes, np.int64)
    n = int(sizes.sum())
    lam = (1.0 / n) if lam is None else lam
    layout = VirtualLayout(vds)
    buckets: List[VirtualBucket] = []
    weights: List[np.ndarray] = []
    for members in _level_groups(sizes, max_bucket_rows):
        mem = np.asarray(members, np.int64)
        buckets.append(VirtualBucket(
            client_ids=torch.as_tensor(mem, device=dev),
            n_k=torch.as_tensor(sizes[mem], device=dev),
            m_pad=int(sizes[mem].max())))
        weights.append(sizes[mem] / n)
    flat = VirtualFlat(layout, buckets, lam=float(lam),
                       num_features=vds.num_features, n=n,
                       eval_chunk=eval_chunk)
    return FederatedLogReg(
        flat=flat, buckets=buckets,
        client_weights=torch.as_tensor(
            np.concatenate(weights).astype(np.float32), device=dev),
        num_clients=int(vds.num_clients), virtual=layout)


def build_dense_problem(Xs, ys, lam: float, *,
                        device: DeviceLike = None) -> FederatedLogReg:
    """Dense per-client data (X_k: (d, m_k), y_k: (m_k,), numpy arrays or
    tensors) as a bucketed :class:`FederatedLogReg` on ``device`` (default:
    the CUDA card), so the ridge algorithms (DANERidge and the Appendix-A
    primal and dual methods) run on the round engine's layout.

    Each example row holds its dense feature vector (idx = arange(d),
    val = x_i): the fixed-nnz format degenerates to dense, and idx is one
    broadcast view, not d copies.  Clients are grouped into one bucket per
    distinct m_k (stable, so equal-size clients keep their input order),
    and every client of a bucket has exactly m_k rows — no padding.  The
    data keeps its dtype (the ridge methods run in f64); ``client_weights``
    stay f32, as the reference's do.  The flat view's loss and gradient are
    logistic and mean nothing for ridge data: the ridge algorithms read
    only the buckets, ``client_weights``, ``flat.n`` and ``flat.lam``."""
    dev = resolve_device(device)
    Xs = [torch.as_tensor(X, device=dev) for X in Xs]
    ys = [torch.as_tensor(y, device=dev) for y in ys]
    d = int(Xs[0].shape[0])
    sizes = np.asarray([int(y.shape[0]) for y in ys], np.int64)
    n = int(sizes.sum())
    dtype = Xs[0].dtype
    for X in Xs[1:]:
        dtype = torch.promote_types(dtype, X.dtype)
    cols = torch.arange(d, dtype=torch.int64, device=dev)

    order = np.argsort(sizes, kind="stable")
    buckets: List[ClientBucket] = []
    weights: List[float] = []
    for members in _equal_runs(order, sizes[order]):
        m = int(sizes[members[0]])
        buckets.append(ClientBucket(
            idx=cols.expand(len(members), m, d),
            val=torch.stack([Xs[k].to(dtype).T for k in members]),
            y=torch.stack([ys[k].to(dtype) for k in members]),
            n_k=torch.full((len(members),), m, dtype=torch.int64,
                           device=dev)))
        weights.extend(int(sizes[k]) / n for k in members)

    flat = LogRegProblem(
        idx=cols.expand(n, d),
        val=torch.cat([X.to(dtype).T for X in Xs]),
        y=torch.cat([y.to(dtype) for y in ys]),
        lam=float(lam), num_features=d)
    return FederatedLogReg(
        flat=flat, buckets=buckets,
        client_weights=torch.as_tensor(np.array(weights, np.float32),
                                       device=dev),
        num_clients=len(Xs))


def build_test_problem(ds, lam: Optional[float] = None, *,
                       device: DeviceLike = None) -> LogRegProblem:
    dev = resolve_device(device)
    n = ds.num_examples
    lam = (1.0 / n) if lam is None else lam
    return LogRegProblem(
        idx=ds.test_idx.to(dev, torch.int64),
        val=ds.test_val.to(dev, torch.float32),
        y=ds.test_y.to(dev, torch.float32), lam=float(lam),
        num_features=int(ds.num_features))
