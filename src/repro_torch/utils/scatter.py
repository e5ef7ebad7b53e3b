"""Sums into indexed slots in an order fixed by the inputs, on either
device.

CUDA's ``index_add_`` and ``scatter_add_`` add with atomics, so the terms
that meet in one slot are summed in whatever order the threads arrive, and
two runs of the same round differ in the last bits: a campaign killed and
resumed would not reproduce the uninterrupted run.  On CUDA these helpers
call ``index_put_(..., accumulate=True)``, which sorts the slot indices
stably and sums each slot's run in a fixed order.  Its kernel walks a run
of equal indices from one thread, so a 1-D sum first adds each block of
``BLOCK`` terms into a partial row of its own (a run is then at most
``BLOCK`` long: the full gradient's bias feature, one term a row, would
otherwise be a run of n) and then sums the partial rows, a fixed-order
reduction; it goes ``SLICE`` terms at a time, which bounds the sort's
temporaries.  On the CPU they call ``index_add_`` / ``scatter_add_``,
which add in index order.
"""
from __future__ import annotations

import torch

#: terms a partial row of :func:`fixed_order_index_add` sums, and the
#: terms of one of its sorts (a multiple of BLOCK)
BLOCK, SLICE = 1 << 16, 1 << 24


def fixed_order_index_add(out: torch.Tensor, index: torch.Tensor,
                          src: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += src[i]`` in place for 1-D tensors, in an order
    fixed by the inputs on any device (CUDA's path; see the module
    docstring); returns ``out``."""
    n, d = index.shape[0], out.shape[0]
    if n <= BLOCK:
        return out.index_put_((index,), src, accumulate=True)
    for s0 in range(0, n, SLICE):
        idx, val = index[s0:s0 + SLICE], src[s0:s0 + SLICE]
        m = idx.shape[0]
        part = torch.zeros((-(-m // BLOCK), d), dtype=out.dtype,
                           device=out.device)
        block = torch.arange(m, device=out.device) // BLOCK
        part.view(-1).index_put_((block * d + idx,), val, accumulate=True)
        out.add_(part.sum(0))
    return out


def index_add(out: torch.Tensor, index: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += src[i]`` in place for 1-D ``out``, ``index`` and
    ``src``; returns ``out``."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, src)
    return fixed_order_index_add(out, index, src)


def scatter_add_rows(out: torch.Tensor, index: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """``out.scatter_add_(1, index, src)`` in place for a contiguous 2-D
    ``out`` and (rows, L) ``index`` and ``src``; returns ``out``.  A run of
    equal slots is at most L long."""
    if out.device.type == "cpu":
        return out.scatter_add_(1, index, src)
    if not out.is_contiguous():
        raise ValueError("scatter_add_rows needs a contiguous out")
    base = torch.arange(index.shape[0], device=out.device)[:, None]
    out.view(-1).index_put_(((index + base * out.shape[1]).reshape(-1),),
                            src.reshape(-1), accumulate=True)
    return out
