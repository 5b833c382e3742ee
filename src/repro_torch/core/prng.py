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
  arithmetic mod 2**32), :func:`uniform` (float64: 52 mantissa bits
  under ``1.0``'s exponent, minus ``1.0``) and float32 :func:`normal`
  (the trainer's weight init; see there for how close it comes);
* float32 :func:`uniform_f32` on ``[minval, maxval)``, :func:`gumbel` and
  :func:`categorical` (the serving engine's temperature sampling);
* float32 :func:`truncated_normal` (the LM stack's weight init) through
  XLA's float32 ``erf`` (:func:`_erf`) and ``erf_inv``.

Torch's unsigned types support few operations, so every 32-bit word is
carried in ``int64`` holding a value in ``[0, 2**32)``: additions are
masked with ``0xFFFFFFFF``, and shifts never reach the sign bit.  A key
is an ``int64`` tensor of shape ``(2,)`` (a stack of keys ``(n, 2)``) on
the host.  Key derivation (split, fold-in) stays there, in Python
integers, and only the bulk draws run on the requested device, so the
host and the card draw the same bits.

:func:`draw_streams` hashes many (key, count) streams in one pass, so a
generation's draws cost one threefry pass on the card.  The element draws
take a ``start``: they return elements ``[start, start + prod(shape))``
of the flat draw (the threefry of the flat iota does not depend on the
shape), so a large leaf is drawn in chunks with the one-pass draw's bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000          # float64 1.0
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of count words ``(x1, x2)`` under key words
    ``(k1, k2)``: 20 rounds with a key injection after every four, as
    JAX's unrolled lowering.  Arguments are ``int64`` tensors (or Python
    ints) holding uint32 values; they broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # y0 and y1 are new tensors (or ints) of one shape: the rounds update
    # them in place (on the host each new large tensor costs page faults)
    y0 = (x1 + ks[0]) & MASK
    y1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 += y1
            y0 &= MASK
            hi = y1 << r
            y1 >>= 32 - r
            y1 |= hi
            y1 &= MASK
            y1 ^= y0
        y0 += ks[(i + 1) % 3]
        y0 &= MASK
        y1 += ks[(i + 2) % 3] + (i + 1)
        y1 &= MASK
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


def draw_streams(keys, sizes, device=None, start: int = 0):
    """Hash ``len(sizes)`` streams in one pass: stream ``s`` is the
    partitionable threefry of ``keys[s]`` (a ``(n, 2)`` tensor or a list
    of pairs) over the iota ``[start, start + sizes[s])``.  Returns the
    flat ``(bits1, bits2)`` words of all streams, stream after stream, on
    ``device``."""
    device = torch.device(device or "cpu")
    sizes = [int(n) for n in sizes]
    total = sum(sizes)
    kd = torch.as_tensor(keys, dtype=torch.int64).reshape(-1, 2)
    if len(sizes) == 1:         # one key: its words broadcast as scalars
        idx = torch.arange(start, start + total, dtype=torch.int64,
                           device=device)
        k1, k2 = kd[0].tolist()
        return threefry2x32(k1, k2, idx >> 32, idx & MASK)
    kd = kd.to(device)
    counts = torch.tensor(sizes, dtype=torch.int64, device=device)
    first = torch.cumsum(counts, 0) - counts
    sid = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), counts,
        output_size=total)
    idx = torch.arange(total, dtype=torch.int64, device=device) \
        - first[sid] + int(start)
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


def random_bits(key: torch.Tensor, bit_width: int, shape, device=None,
                start: int = 0):
    """``jax.random.bits``-style raw draws: 32-bit ones as int64 values in
    [0, 2**32), 64-bit ones as the int64 with the draw's bit pattern
    (elements from flat index ``start`` on)."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = draw_streams([_words(key)], [math.prod(shape)], device, start)
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


# ------------------------------------------------------------ float32 normal
# XLA's float32 ``ErfInv`` (the polynomial of M. Giles, "Approximating the
# erfinv function", in ``w = -log1p(-x*x)``) and the CPU ``log1p`` it calls:
# a Cephes rational for |x| < sqrt(2) - 1, else the Cephes/Eigen ``log``
# of 1 + x.  Coefficients are float32 constants, highest degree first.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``v`` as a 0-d tensor beside ``like``."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` as XLA contracts it into one FMA: the product
    exact in float64, the sum rounded to float32 (through float64).  An
    operand may come in float64 already (a float32 value widened once)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p, xd = torch.zeros_like(x), x.double()
    for c in coeffs:
        p = _fma(p, xd, _f32(c, x))
    return p


def _log_cephes(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` of positive ``x`` as XLA's CPU backend computes it:
    ``x = m * 2**e`` with ``m`` in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial in ``m - 1``, then ``e * ln 2`` added in two parts."""
    tiny = torch.tensor(0x00800000, dtype=torch.int32).view(torch.float32)
    xi = torch.maximum(x, tiny.to(x.device)).view(torch.int32)
    e = ((xi >> 23) & 0xFF).float() - 126.0
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _f32(0.707106781186547524, m)
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = x * x
    xd, x3 = x.double(), (x2 * x).double()
    p = _LOG_P
    y = _fma(xd, _f32(p[0], x), _f32(p[1], x))
    y1 = _fma(xd, _f32(p[3], x), _f32(p[4], x))
    y2 = _fma(xd, _f32(p[6], x), _f32(p[7], x))
    y = _fma(y, xd, _f32(p[2], x))
    y1 = _fma(y1, xd, _f32(p[5], x))
    y2 = _fma(y2, xd, _f32(p[8], x))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1, x) * e)
    x = (x - _f32(0.5, x) * x2) + y
    return x + _f32(_LOG_Q2, x) * e


def _log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(_f32(-0.5, x), x2, (x * x2) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log_cephes(x + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` on (-1, 1), its FMAs contracted."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    # float32 sqrt on CUDA is not correctly rounded; the float64 root,
    # rounded once to float32, is (on every device)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    wd = w.double()
    coeff = lambda i: torch.where(lt, _f32(_ERFINV_W_LT_5[i], x).double(),
                                  _f32(_ERFINV_W_GE_5[i], x).double())
    p = coeff(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = _fma(p, wd, coeff(i))
    return torch.where(x.abs() == 1.0,
                       x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: a uniform draw on
    ``[nextafter(-1, 0), 1)`` (23 random mantissa bits under ``1.0``'s
    exponent, minus 1, scaled and shifted as XLA's FMA does, then clamped
    below), through XLA's ``erf_inv``, times ``sqrt(2)``.

    Against JAX 0.9.0 on the CPU, 2**18 draws under each of three seeds
    differ in at most 20 values, all in the far tails (``|u| > 0.9966``,
    where ``-log1p(-u*u) >= 5``) and by at most 2 ulp
    (``tests/test_torch_train_sparse.py``); the other draws are equal bit
    for bit.  Every step is a correctly rounded float32 or float64
    operation (the root is taken in float64: CUDA's float32 ``sqrt`` is
    not correctly rounded), so the card draws the host's bits."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(key, 32, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), f)
    # (f - 1) * (1 - lo) + lo: 1 - lo rounds to 2.0 in float32, so the
    # product is exact and the FMA a plain multiply and add
    u = torch.maximum(lo, _fma(f, _f32(2.0, f), lo))
    return _f32(float(np.float32(np.sqrt(2.0))), u) * _erf_inv(u)


# --------------------------------------------------- float32 truncated normal
# XLA's float32 ``Erf`` as its CPU backend emits it: ``x`` clamped to
# [-3.7439213, 3.7439213], then an odd rational in ``x``, numerator and
# denominator each a Horner chain of FMAs in ``x * x`` (float32
# constants, highest degree first).
_ERF_CLAMP = 3.7439212799072266
_ERF_ALPHA = (0.00022905065270606428, 0.0034082909114658833,
              0.050955694168806076, 0.18520832061767578, 1.1283791065216064)
_ERF_BETA = (-1.1791603071742429e-07, 2.354796561121475e-05,
             0.0010179625824093819, 0.01407046988606453,
             0.11098504811525345, 0.4974692463874817, 1.0)
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# XLA compiles ``x / sqrt2`` as a product with the float32 reciprocal
_RSQRT2_F32 = float(np.float32(1.0) / np.float32(np.sqrt(2.0)))


def _erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf``, its FMAs contracted."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = _fma(x2, _f32(_ERF_ALPHA[0], x), _f32(_ERF_ALPHA[1], x))
    for c in _ERF_ALPHA[2:]:
        p = _fma(p, x2, _f32(c, x))
    q = _fma(x2, _f32(_ERF_BETA[0], x), _f32(_ERF_BETA[1], x))
    for c in _ERF_BETA[2:]:
        q = _fma(q, x2, _f32(c, x))
    return (x * p) / q


def _nextafter_f32(v: float, toward: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(toward)))


def truncated_normal(key, lower: float, upper: float, shape, device=None,
                     start: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32
    (elements from flat index ``start`` on), step by step as JAX computes
    it: ``a = erf(lower / sqrt2)``, ``b = erf(upper / sqrt2)`` in float32,
    ``u`` uniform on ``[a, b)``, ``sqrt2 * erf_inv(u)``, clamped to
    ``(nextafter(lower, inf), nextafter(upper, -inf))``.  Every step is a
    correctly rounded float32 or float64 operation, so the card draws the
    host's bits."""
    lo, hi = float(np.float32(lower)), float(np.float32(upper))
    bounds = torch.tensor([lo, hi], dtype=torch.float32)
    a, b = _erf(bounds * _f32(_RSQRT2_F32, bounds)).tolist()
    u = uniform_f32(key, shape, a, b, device, start)
    out = _f32(_SQRT2_F32, u) * _erf_inv(u)
    return torch.clamp(out, _nextafter_f32(lo, np.inf),
                       _nextafter_f32(hi, -np.inf))


# ------------------------------------------------- float32 uniform, Gumbel
def uniform_f32(key: torch.Tensor, shape, minval: float = 0.0,
                maxval: float = 1.0, device=None,
                start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``: 23
    random mantissa bits under ``1.0``'s exponent, minus 1, scaled and
    shifted with XLA's fused multiply-add, then clamped below at
    ``minval`` (elements from flat index ``start`` on)."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(key, 32, shape, device, start)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, f), _f32(maxval, f)
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def gumbel(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (the default "low"
    mode): ``-log(-log(u))`` for ``u`` uniform on ``[tiny, 1)``, through
    XLA's CPU ``log``."""
    tiny = float(torch.finfo(torch.float32).tiny)
    u = uniform_f32(key, shape, tiny, 1.0, device)
    return -_log_cephes(-_log_cephes(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: the Gumbel-max trick, the first index of the largest
    ``gumbel + logits``."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1)
