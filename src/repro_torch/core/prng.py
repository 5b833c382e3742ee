"""Counter-based ``threefry2x32`` draws on torch tensors (PyTorch port).

The JAX package's device search draws all its randomness from
``jax.random`` under one ``PRNGKey(seed)``.  This module reproduces the
slice of ``jax.random`` it uses, bit for bit, with JAX's
``jax_threefry_partitionable`` layout (the default of the JAX the
reference runs on):

* :func:`PRNGKey`, :func:`split` (the fold-like split: the threefry hash
  of a 64-bit iota as (high, low) words), :func:`fold_in`;
* :func:`random_bits` (32-bit draws are ``bits1 ^ bits2``, 64-bit ones
  ``bits1 << 32 | bits2``), :func:`randint` (int32: higher and lower
  bits from a two-way split, reduced with the span and multiplier
  arithmetic mod 2**32) and :func:`uniform` (float64: 52 mantissa bits
  under ``1.0``'s exponent, minus ``1.0``).

Torch's unsigned types support few operations, so every 32-bit word is
carried in ``int64`` holding a value in ``[0, 2**32)``: additions are
masked with ``0xFFFFFFFF``, and shifts never reach the sign bit.  A key
is an ``int64`` tensor of shape ``(2,)`` (a stack of keys ``(n, 2)``) on
the host.  Key derivation (split, fold-in) stays there, in Python
integers, and only the bulk draws run on the requested device, so the
host and the card draw the same bits.

:func:`draw_streams` hashes many (key, count) streams in one pass, so a
generation's draws cost one threefry pass on the card.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000          # float64 1.0
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of count words ``(x1, x2)`` under key words
    ``(k1, k2)``: 20 rounds with a key injection after every four, as
    JAX's unrolled lowering.  Arguments are ``int64`` tensors (or Python
    ints) holding uint32 values; they broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + ks[0]) & MASK
    y1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & MASK
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & MASK
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return y0, y1


def _words(key) -> tuple[int, int]:
    """A key (a ``(2,)`` tensor or a pair of ints) as two Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX runs by default (x64 off, as the
    device search calls it): the seed is a 32-bit integer, the key ``(0,
    seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def split_words(key, num: int = 2) -> list[tuple[int, int]]:
    """:func:`split` on Python ints (key derivation is a handful of
    hashes, cheaper in plain integers than as tensor operations)."""
    k1, k2 = _words(key)
    return [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(int(num))]


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(num, 2)`` keys: the fold-like
    split, the hash of a 64-bit iota as (high, low) count words."""
    return torch.tensor(split_words(key, num), dtype=torch.int64)


def fold_in_words(key, data: int) -> tuple[int, int]:
    """:func:`fold_in` on Python ints."""
    k1, k2 = _words(key)
    return threefry2x32(k1, k2, 0, int(data) & MASK)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, data)`` (``threefry_seed`` of the uint32 datum)."""
    return torch.tensor(fold_in_words(key, data), dtype=torch.int64)


def draw_streams(keys, sizes, device=None):
    """Hash ``len(sizes)`` streams in one pass: stream ``s`` is the
    partitionable threefry of ``keys[s]`` (a ``(n, 2)`` tensor or a list
    of pairs) over the iota of ``sizes[s]``.  Returns the flat ``(bits1,
    bits2)`` words of all streams, stream after stream, on ``device``."""
    device = torch.device(device or "cpu")
    sizes = [int(n) for n in sizes]
    total = sum(sizes)
    kd = torch.as_tensor(keys, dtype=torch.int64).reshape(-1, 2).to(device)
    counts = torch.tensor(sizes, dtype=torch.int64, device=device)
    start = torch.cumsum(counts, 0) - counts
    sid = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), counts,
        output_size=total)
    idx = torch.arange(total, dtype=torch.int64, device=device) - start[sid]
    return threefry2x32(kd[sid, 0], kd[sid, 1], idx >> 32, idx & MASK)


def _bits64(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``b1 << 32 | b2`` as the int64 with the same bit pattern."""
    hi = torch.where(b1 >= 2 ** 31, b1 - 2 ** 32, b1)
    return hi * 2 ** 32 + b2


def _uniform_from(b1, b2):
    """float64 ``uniform``'s bit recipe on [0, 1) from the 64-bit draw
    ``(b1, b2)``: its top 52 bits as the mantissa of a number in [1, 2),
    minus 1 (JAX's scaling to [0, 1) is then exact)."""
    mant = (b1 << 20) | (b2 >> 12)
    return (mant | _ONE_BITS).view(torch.float64) - 1.0


def _span(minval: int, maxval: int) -> tuple[int, int, int]:
    """``randint``'s (minval, span, multiplier) for int32 draws in
    [minval, maxval): bounds clipped to int32, the span as uint32 (1 when
    empty, one larger when maxval lies past int32), and ``2**32 % span``
    folded as ``(2**16 % span)**2 % span`` with a uint32 product."""
    lo = min(max(int(minval), _INT32_MIN), _INT32_MAX)
    hi = min(max(int(maxval), _INT32_MIN), _INT32_MAX)
    span = (hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif int(maxval) > _INT32_MAX:
        span = (span + 1) & MASK
    if span == 0:               # a full 2**32 span: remainders vanish
        return lo, 0, 0
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    return lo, span, mult


def _randint_from(higher, lower, minval: int, maxval: int):
    lo, span, mult = _span(minval, maxval)
    if span == 0:                   # XLA's x % 0 is x
        off = lower
    else:
        off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
        off = off % span
    v = (lo + off + 2 ** 31) & MASK                 # int32 wrap-around
    return (v - 2 ** 31).to(torch.int32)


def random_bits(key: torch.Tensor, bit_width: int, shape, device=None):
    """``jax.random.bits``-style raw draws: 32-bit ones as int64 values in
    [0, 2**32), 64-bit ones as the int64 with the draw's bit pattern."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = draw_streams([_words(key)], [math.prod(shape)], device)
    if bit_width == 32:
        return (b1 ^ b2).reshape(shape)
    if bit_width == 64:
        return _bits64(b1, b2).reshape(shape)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    b1, b2 = draw_streams(split_words(key), [n, n], device)
    bits = b1 ^ b2
    return _randint_from(bits[:n], bits[n:], minval, maxval).reshape(shape)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float64)`` on [0, 1)."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = draw_streams([_words(key)], [math.prod(shape)], device)
    return _uniform_from(b1, b2).reshape(shape)
