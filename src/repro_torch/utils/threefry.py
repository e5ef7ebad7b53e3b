"""JAX's threefry2x32 counter-based generator in PyTorch, bit for bit.

The part of ``jax.random`` the fleet layer draws from (with
``jax_threefry_partitionable=True``, JAX's default since 0.5):

  * :func:`PRNGKey` — ``PRNGKey(seed)`` for a seed in [0, 2³²);
  * :func:`fold_in` — ``fold_in(key, data)``, also vectorised over a tensor
    of ids (then the key is a pair of tensors, one key per id);
  * :func:`random_bits` — 32-bit ``bits(key, shape)`` for shapes ``()``,
    ``(n,)`` and ``(n, d)``, from one key or from one key per leading index;
  * :func:`uniform` — ``uniform(key, shape, float32, minval, maxval)``.

A key is a pair ``(k1, k2)`` of 32-bit words: Python ints for one key, or
int64 tensors of equal shape for a batch.  Words are carried in ``int64``
and masked to 32 bits after every add and shift, because ``torch.uint32``
lacks shifts and adds on some backends: the same code is then exact on the
CPU and on CUDA.

``split``, ``randint``, ``permutation``, ``bernoulli`` and ``gumbel`` are
not here yet; the solvers' round streams stay ``torch.Generator`` draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000       # 1.0f: mantissa bits | this lie in [1, 2)


def PRNGKey(seed: int) -> Key:  # noqa: N802 - JAX's name
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & M)``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError("seed must be in [0, 2**32)")
    return 0, seed


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
    as_word = lambda v: (v if isinstance(v, torch.Tensor)
                         else torch.tensor(int(v), dtype=torch.int64,
                                           device=dev))
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
        key = tuple(torch.tensor(int(k), dtype=torch.int64, device=device)
                    for k in key)
    bits = random_bits(key, shape)
    f = (((bits >> 9) | _ONE_F32_BITS).to(torch.int32)
         .view(torch.float32) - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, fma_f32(f, hi - lo, lo))
