"""CUDA wrapper of the RWKV-6 chunk-parallel WKV (``csrc/wkv6.cu``; it
replaces the reference's TPU kernel ``kernels/wkv6.py:wkv6``).

From a given start state or zeros, per (batch, head) pair and chunk of
length ``chunk``:

    out = [(r_t k_tᵀ) ⊙ strict-lower] v + rowsum(r ⊙ u ⊙ k) v + r_t S
    S  ← diag(c_L) (S + k_tᵀ v)

with c = cumprod(w) along the chunk, r_t = r ⊙ c_prev and
k_t = k / max(c, 1e-30) (:func:`ref.wkv6_ref` is the plain version).  Two
layouts, one kernel:

* (BH, S, D) contiguous, u (BH, D), state (BH, D, D) — the TPU kernel's;
* (B, S, Hn, D), the model's, with D contiguous and any batch, token and
  head strides (a slice ``t[:, :n]`` of the projections is read in place),
  u (Hn, D), state (B, Hn, D, D); out is a new contiguous (B, S, Hn, D).

Its backward, ``csrc/wkv6_bwd.cu`` (:func:`wkv6_bwd`, three launches
cut by :func:`bwd_plan`), takes the same f32 inputs and the cotangents;
:class:`WKV6` joins the two into an autograd function.  Each call is
counted in ``wkv6.launches`` or
``wkv6_bwd.launches``.  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
versions.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels.ref import WKV_CHUNK

_NAME = "wkv6"
_BWD = "wkv6_bwd"

#: the kernel's limits (csrc/wkv6.cu: DC, LC)
MAX_HEAD_DIM = 64
MAX_CHUNK = 32


def _require(cond: bool, msg: Union[str, Callable[[], str]]) -> None:
    _args.require(_NAME, cond, msg)


class _Layout(NamedTuple):
    B: int
    Hn: int
    S: int
    D: int
    strides: Tuple[int, int, int]     # batch, token and head, in elements
    u_bstride: int
    s_shape: Tuple[int, ...]


def _layout(r, k, v, w, u, chunk, state, dtypes) -> _Layout:
    """Check the forward's inputs (shared by both kernels) and read their
    layout."""
    _require(isinstance(r, torch.Tensor) and r.is_cuda,
             "r must be a CUDA tensor")
    _require(r.dtype in dtypes,
             lambda: "r must be "
             + " or ".join(str(t).split(".")[-1] for t in dtypes)
             + f", got {r.dtype}")
    _require(r.dim() in (3, 4) and r.numel() > 0,
             lambda: "r must be a non-empty (BH, S, D) or (B, S, Hn, D) "
             f"tensor, got {tuple(r.shape)}")
    if r.dim() == 3:
        _require(r.is_contiguous(),
                 lambda: "a (BH, S, D) r must be contiguous")
        B, S, D = r.shape
        Hn = 1
        u_shape, s_shape = (B, D), (B, D, D)
        strides, u_bstride = (S * D, D, D), D
    else:
        B, S, Hn, D = r.shape
        sb, ts, sh, sd = _args.strides(r)
        _require(sd in (0, 1), "a (B, S, Hn, D) r must have D contiguous")
        u_shape, s_shape = (Hn, D), (B, Hn, D, D)
        strides, u_bstride = (sb, ts, sh), 0
    for name, x in (("k", k), ("v", v), ("w", w)):
        _require(isinstance(x, torch.Tensor) and x.device == r.device
                 and x.dtype == r.dtype and x.shape == r.shape
                 and _args.strides(x) == _args.strides(r),
                 lambda name=name: f"{name} must be a {r.dtype} tensor of "
                 f"r's shape {tuple(r.shape)} and strides {r.stride()} on "
                 f"{r.device}")
    _require(isinstance(u, torch.Tensor) and u.device == r.device
             and u.dtype in (torch.float32, r.dtype) and u.shape == u_shape,
             lambda: f"u must be a {u_shape} float32 or {r.dtype} tensor "
             f"on {r.device}, got {tuple(u.shape)}")
    _require(state is None or _is_state(state, s_shape, r.device),
             lambda: f"state must be a contiguous {s_shape} float32 tensor "
             f"on {r.device} or None")
    _require(D <= MAX_HEAD_DIM, f"head dimension {D} exceeds {MAX_HEAD_DIM}")
    _require(1 <= chunk <= MAX_CHUNK, f"chunk must be in [1, {MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    return _Layout(B, Hn, S, D, strides, u_bstride, s_shape)


def _is_state(x, shape, device) -> bool:
    return (isinstance(x, torch.Tensor) and x.device == device
            and x.dtype == torch.float32 and x.shape == shape
            and x.is_contiguous())


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int = WKV_CHUNK, *,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: CUDA tensors of one dtype (f32 or bf16) and one shape
    and strides, either contiguous (BH, S, D) with u (BH, D) and ``state``
    (BH, D, D), or (B, S, Hn, D) with D contiguous, u (Hn, D) and
    ``state`` (B, Hn, D, D); D ≤ 64.  u: f32 or r's dtype; ``state``: the
    start state, a contiguous f32 tensor, or None for zeros.  S must be a
    multiple of ``chunk`` ≤ 32 (``ValueError``).  Returns new tensors: out
    in r's layout (contiguous) and dtype, and the final state in f32."""
    lay = _layout(r, k, v, w, u, chunk, state, _args.DTYPES)
    u32 = u.to(torch.float32).contiguous()
    out = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    final = torch.empty(lay.s_shape, dtype=torch.float32, device=r.device)
    launch = _build.launcher(_NAME)
    with _args.on_card(r.device):
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u32.data_ptr(), lay.u_bstride, _ptr(state),
                     _args.DTYPES[r.dtype], out.data_ptr(), final.data_ptr(),
                     lay.B, lay.Hn, lay.S, lay.D, chunk, *lay.strides,
                     _args.stream(r))
    _build.check(err, _NAME)
    wkv6.launches += 1
    return out, final


wkv6.launches = 0


class BwdPlan(NamedTuple):
    """How one :func:`wkv6_bwd` call is cut into its three launches
    (``csrc/wkv6_bwd.cu``): the chunk terms and the chunk backward run
    ``blocks`` blocks of 256 threads, a block a (pair, chunk); the state
    scan ``scan_blocks`` of SCAN_THREADS, a thread a (pair, i, j).  One
    f32 scratch of ``scratch`` floats holds, in this order, the two state
    arrays of shape ``states`` (the increments, turned by the scan into
    each chunk's start state and its end cotangent), c_L of shape
    ``decays`` and, from ``du_offset``, the partial du of shape
    ``du_rows`` (a row a (pair, chunk), summed by the wrapper)."""

    pairs: int
    chunks: int
    blocks: int
    scan_blocks: int
    states: Tuple[int, int, int, int]
    decays: Tuple[int, int, int]
    du_rows: Tuple[int, int]
    du_offset: int
    scratch: int


#: threads a block of the state scan (csrc/wkv6_bwd.cu: SCAN_THREADS)
SCAN_THREADS = 256


def bwd_plan(pairs: int, S: int, D: int, chunk: int) -> BwdPlan:
    """The launch plan of a backward over ``pairs`` (batch, head) pairs of
    S tokens, head dimension D and chunk length ``chunk``."""
    n = S // chunk
    du_offset = pairs * n * (2 * D * D + D)
    return BwdPlan(pairs, n, pairs * n, -(-pairs * D * D // SCAN_THREADS),
                   (pairs, n, D, D), (pairs, n, D), (pairs * n, D),
                   du_offset, du_offset + pairs * n * D)


def _bwd_call(r, k, v, w, u, d_out, chunk, state, d_state):
    """Check :func:`wkv6_bwd`'s inputs and allocate its outputs and
    scratch: returns a function that runs the launches named by its
    ``parts`` bits (1 the chunk terms, 2 the state scan, 4 the chunk
    backward) on PyTorch's current stream, raising if one fails, and a
    function that returns the outputs once all three ran."""
    lay = _layout(r, k, v, w, u, chunk, state, (torch.float32,))
    _require(isinstance(d_out, torch.Tensor) and d_out.device == r.device
             and d_out.dtype == torch.float32 and d_out.shape == r.shape,
             lambda: f"d_out must be a float32 tensor of r's shape "
             f"{tuple(r.shape)} on {r.device}")
    _require(d_state is None or _is_state(d_state, lay.s_shape, r.device),
             lambda: f"d_state must be a contiguous {lay.s_shape} float32 "
             f"tensor on {r.device} or None")
    plan = bwd_plan(lay.B * lay.Hn, lay.S, lay.D, chunk)
    d_out = d_out.contiguous()
    u32 = u.to(torch.float32).contiguous()
    grads = torch.empty((4, *r.shape), dtype=torch.float32, device=r.device)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=r.device)
    d_start = (None if state is None else
               torch.empty(lay.s_shape, dtype=torch.float32, device=r.device))
    dr, dk, dv, dw = grads.unbind(0)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), lay.u_bstride, _ptr(state), d_out.data_ptr(),
            _ptr(d_state), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dw.data_ptr(), _ptr(d_start), scratch.data_ptr(), lay.B, lay.Hn,
            lay.S, lay.D, chunk, *lay.strides, plan.blocks, plan.scan_blocks)

    def launch(parts):
        with _args.on_card(r.device):
            err = _build.launcher(_BWD)(*args, parts, _args.stream(r))
        _build.check(err, _BWD)

    def outputs():
        du = scratch[plan.du_offset:].view(lay.B, lay.Hn, plan.chunks, lay.D)
        du = du.sum((0, 2) if r.dim() == 4 else 2).view(u.shape)
        return dr, dk, dv, dw, du, d_start

    return launch, outputs


def bwd_launches(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, d_out: torch.Tensor,
                 chunk: int = WKV_CHUNK, *,
                 state: Optional[torch.Tensor] = None,
                 d_state: Optional[torch.Tensor] = None
                 ) -> Tuple[List[Callable[[], None]], Callable[[], tuple]]:
    """:func:`wkv6_bwd` cut into its launches, for timing each apart: its
    inputs checked and its outputs and scratch allocated once; returns a
    function a launch (the chunk terms, the state scan, the chunk
    backward, to be run in that order: the scan turns the terms' scratch
    into states in place), each on PyTorch's current stream when it runs,
    and a function that returns the outputs.  Not counted in
    ``wkv6_bwd.launches``."""
    launch, outputs = _bwd_call(r, k, v, w, u, d_out, chunk, state, d_state)
    return [functools.partial(launch, bit) for bit in (1, 2, 4)], outputs


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, d_out: torch.Tensor,
             chunk: int = WKV_CHUNK, *, state: Optional[torch.Tensor] = None,
             d_state: Optional[torch.Tensor] = None):
    """The VJP of :func:`wkv6` (``csrc/wkv6_bwd.cu``: the chunk terms, the
    state scan and the chunk backward, three launches from one call of
    the launcher, counted as one): r, k, v, w, u, ``chunk`` and ``state``
    as the forward took them, in f32; ``d_out`` the cotangent of out (r's
    shape, any strides: made contiguous) and ``d_state`` that of the
    final state (a contiguous f32 tensor of the state's shape, or None for
    zero).  Returns new f32 tensors: dr, dk, dv, dw (contiguous, r's
    shape), du (u's shape: summed over the batch and the chunks from one
    row a (pair, chunk), in a fixed order) and the start state's
    cotangent (None when ``state`` is None).  :func:`ref.wkv6_bwd_ref` is
    the plain version."""
    launch, outputs = _bwd_call(r, k, v, w, u, d_out, chunk, state, d_state)
    launch(7)
    wkv6_bwd.launches += 1
    return outputs()


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """:func:`wkv6` made differentiable on the card: the forward kernel,
    then :func:`wkv6_bwd` for the cotangents of r, k, v, w, u and the start
    state (autograd hands an unused output's cotangent in as zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        out, final = wkv6(r, k, v, w, u, chunk, state=state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk = chunk
        return out, final

    @staticmethod
    def backward(ctx, d_out, d_final):
        r, k, v, w, u, state = ctx.saved_tensors
        dr, dk, dv, dw, du, d_start = wkv6_bwd(
            r, k, v, w, u, d_out.float(), ctx.chunk, state=state,
            d_state=d_final.float().contiguous())
        return dr, dk, dv, dw, du.to(u.dtype), d_start, None
