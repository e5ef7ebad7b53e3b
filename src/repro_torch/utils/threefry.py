"""JAX's threefry2x32 counter-based generator in PyTorch, bit for bit.

The part of ``jax.random`` that the reference's data, round engine,
solvers and fleet layer draw from (with ``jax_threefry_partitionable=True``,
JAX's default since 0.5):

  * :func:`PRNGKey` — ``PRNGKey(seed)`` for a seed in [0, 2³²);
  * :func:`fold_in` — ``fold_in(key, data)``, also vectorised over a tensor
    of ids (then the key is a pair of tensors, one key per id);
  * :func:`split` — ``split(key, n)``: key i is ``fold_in(key, i)``;
  * :func:`random_bits` — 32-bit ``bits(key, shape)`` for shapes ``()``,
    ``(n,)`` and ``(n, d)``, from one key or from one key per leading index;
  * :func:`uniform` — ``uniform(key, shape, float32, minval, maxval)``;
  * :func:`randint` — ``randint(key, shape, minval, maxval)`` (int32
    bounds, which may be tensors), with its uint32 arithmetic;
  * :func:`permutation` — ``permutation(key, n)``, the stable sorts by
    fresh 32-bit keys;
  * :func:`gumbel` — ``gumbel(key, shape)`` in its default ``"low"`` mode.

A key is a pair ``(k1, k2)`` of 32-bit words: Python ints for one key, or
int64 tensors of equal shape ``B`` for a batch of keys, and every function
above maps a batch of keys to a batch of draws (leading shape ``B``).
Words are carried in ``int64`` and masked to 32 bits after every add,
multiply and shift, because ``torch.uint32`` lacks shifts and adds on some
backends: the same code is then exact on the CPU and on CUDA.  The draws
run on the device the key's words live on (:func:`as_key` places them).

Only :func:`gumbel` is not bit-equal to JAX: it takes the logs of the
bit-equal uniforms with :func:`repro_torch.utils.floatmath.log_f32`, which
rounds correctly and gives the same bits on the CPU and on CUDA, while
XLA's ``log`` rounds about one input in seven an ulp away.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.utils.floatmath import log_f32

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000       # 1.0f: mantissa bits | this lie in [1, 2)
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
#: the smallest normal f32, ``gumbel``'s floor of its uniforms
_TINY_F32 = 2.0 ** -126


def PRNGKey(seed: int) -> Key:  # noqa: N802 - JAX's name
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & M)``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError("seed must be in [0, 2**32)")
    return 0, seed


def as_key(key: Key, device=None) -> Key:
    """``key`` with its words as int64 tensors on ``device`` (a key of
    Python ints becomes two 0-d tensors), so that its draws run there."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return tuple(w.to(dev) if isinstance(w, torch.Tensor)
                 else _scalar(int(w) & MASK32, dev) for w in key)


def _scalar(value, device, dtype=torch.int64) -> torch.Tensor:
    """A 0-d tensor on ``device``, written there by a fill kernel: unlike
    ``torch.tensor(value, device=...)``, no copy from the host that waits
    for the device."""
    return torch.full((), value, dtype=dtype, device=device)


def _batch_shape(key: Key) -> Tuple[int, ...]:
    return tuple(key[0].shape) if isinstance(key[0], torch.Tensor) else ()


def _key_device(key: Key) -> torch.device:
    return (key[0].device if isinstance(key[0], torch.Tensor)
            else torch.device("cpu"))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: Word, x1: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under ``key``; all operands broadcast together.  Returns two int64
    tensors of 32-bit words."""
    k0, k1 = key
    dev = next((t.device for t in (k0, k1, x0, x1)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    as_word = lambda v: v if isinstance(v, torch.Tensor) else _scalar(
        int(v), dev)
    k0, k1, x0, x1 = (as_word(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & MASK32
    b = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``(0, data)``.  ``data`` may be an int or an integer tensor of uint32
    values (one folded key per element)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    return threefry2x32(key, 0, data)


def split(key: Key, n: int) -> Key:
    """``jax.random.split(key, n)`` (the foldlike split of the
    partitionable layout): key i is the hash of the counter ``(0, i)``,
    i.e. ``fold_in(key, i)``.  A batch of keys of shape ``B`` gives keys of
    shape ``B + (n,)``."""
    k0, k1 = key
    ids = torch.arange(int(n), dtype=torch.int64, device=_key_device(key))
    if _batch_shape(key):
        k0, k1 = k0.unsqueeze(-1), k1.unsqueeze(-1)
    return threefry2x32((k0, k1), 0, ids)


def take(key: Key, i) -> Key:
    """Key ``i`` along the last axis of a batch of keys (``split``'s
    output): ``(k1[..., i], k2[..., i])``."""
    return key[0][..., i], key[1][..., i]


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 words.

    ``shape`` is ``()``, ``(n,)`` or ``(n, d)``: the counter of element i
    (row-major) is the 64-bit i, split into its high and low words.  A
    batched key (tensors of shape ``B``) gives bits of shape
    ``B + shape``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) > 2:
        raise ValueError("random_bits takes shapes (), (n,) or (n, d)")
    k0, k1 = key
    batch = k0.shape if isinstance(k0, torch.Tensor) else ()
    dev = k0.device if isinstance(k0, torch.Tensor) else torch.device("cpu")
    if shape:
        count = torch.arange(int(torch.tensor(shape).prod()),
                             dtype=torch.int64, device=dev).reshape(shape)
        hi, lo = count >> 32, count & MASK32
        if batch:
            view = batch + (1,) * len(shape)
            k0, k1 = k0.reshape(view), k1.reshape(view)
    else:
        hi = lo = 0
    a, b = threefry2x32((k0, k1), hi, lo)
    return a ^ b


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a·b + c`` of f32 tensors rounded once to f32, as a fused
    multiply-add rounds it.  The product is exact in f64 (24 + 24 bits);
    the f64 sum's own rounding error is recovered exactly (TwoSum) and
    decides the one case where rounding to f64 and then to f32 would
    differ from rounding once: an f64 sum that lies on an f32 midpoint."""
    x = a.double() * b.double()
    c = c.double()
    s = x + c
    bp = s - x
    err = (x - (s - bp)) + (c - bp)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    # s on the midpoint between r and its neighbour towards s
    nb = torch.where(s > r.double(), up, down)
    tie = (s - r.double()) == (nb.double() - s)
    fix = tie & (err != 0)
    want = torch.where(err > 0, torch.maximum(r, nb), torch.minimum(r, nb))
    return torch.where(fix, want, r)


def uniform(key: Key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0, *, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of each word as the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval) and floored at minval.  XLA contracts the
    scale and shift into one fused multiply-add, and so does this
    (:func:`fma_f32`).  ``device`` places the draw of a plain (int) key."""
    if device is not None and not isinstance(key[0], torch.Tensor):
        key = as_key(key, device)
    bits = random_bits(key, shape)
    f = (((bits >> 9) | _ONE_F32_BITS).to(torch.int32)
         .view(torch.float32) - 1.0)
    lo = _scalar(minval, f.device, torch.float32)
    hi = _scalar(maxval, f.device, torch.float32)
    return torch.maximum(lo, fma_f32(f, hi - lo, lo))


def _bound(v, batch: Tuple[int, ...], ndim: int,
           device: torch.device) -> torch.Tensor:
    """An int32 bound of :func:`randint` as int64: an int, or a tensor of
    the keys' batch shape (one bound per key, broadcast over the draw's
    shape), clipped to the int32 range as JAX clips it."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=torch.int64)
        if batch and tuple(v.shape) == batch:
            v = v.reshape(batch + (1,) * ndim)
    else:
        v = _scalar(int(v), device)
    return v.clamp(_INT32_MIN, _INT32_MAX)


def randint(key: Key, shape: Sequence[int], minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), as int64.

    Two words a draw, from the keys ``split(key, 2)``: with
    span = maxval − minval (1 where maxval ≤ minval) and
    mult = (2¹⁶ mod span)² mod span, the draw is
    minval + ((hi mod span)·mult + lo mod span) mod span, every product
    and sum a uint32 operation that wraps mod 2³² (for span > 2¹⁶,
    (2¹⁶)² wraps to 0).  ``minval`` and ``maxval`` are ints or tensors of
    the keys' batch shape."""
    shape = tuple(int(s) for s in shape)
    batch, dev = _batch_shape(key), _key_device(key)
    ks = split(key, 2)
    hi = random_bits(take(ks, 0), shape)
    lo = random_bits(take(ks, 1), shape)
    lo_b = _bound(minval, batch, len(shape), dev)
    hi_b = _bound(maxval, batch, len(shape), dev)
    span = torch.where(hi_b <= lo_b, torch.ones_like(hi_b),
                       (hi_b - lo_b) & MASK32)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span
    offset = (((hi % span) * mult) & MASK32) + lo % span
    offset = (offset & MASK32) % span
    # minval + offset as an int32 sum, which wraps
    return ((lo_b + offset - _INT32_MIN) & MASK32) + _INT32_MIN


def permutation(key: Key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64: ``num_rounds`` stable
    sorts of the running order by fresh 32-bit keys, where num_rounds =
    ceil(3·ln(max(1, n)) / ln(2³² − 1)) — 1 for n ≤ 1,625, 2 up to
    n ≈ 2.6·10⁶ — and each round draws ``key, sub = split(key, 2)`` and
    sorts by ``bits(sub, (n,))``.  A stable sort keeps equal keys in their
    previous order, as ``lax.sort_key_val`` does; the words hold uint32
    values, so int64 order is their order.  A batch of keys of shape ``B``
    gives ``B + (n,)``."""
    n = int(n)
    batch, dev = _batch_shape(key), _key_device(key)
    order = torch.arange(n, dtype=torch.int64, device=dev).expand(
        batch + (n,))
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        ks = split(key, 2)
        key, sub = take(ks, 0), take(ks, 1)
        sort_keys = random_bits(sub, (n,))
        idx = torch.argsort(sort_keys, dim=-1, stable=True)
        order = order.gather(-1, idx)
    return order.contiguous()


def gumbel(key: Key, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in f32, mode ``"low"``:
    −log(−log(u)) of u = ``uniform(key, shape, tiny, 1)``, each log rounded
    to f32.  The uniforms are JAX's bits; the logs are ``log_f32``'s (see
    the module's docstring), the same on the CPU and on CUDA."""
    u = uniform(key, shape, _TINY_F32, 1.0)
    return -log_f32(-log_f32(u))
