"""``jax.random`` as flax's ``model.init`` uses it, in numpy.

The JAX package draws its initial weights with ``jax.random`` (the
threefry2x32 generator) under a key that flax derives for each
parameter. This module computes the same draws on the host, with no
JAX, so that the port's ``--seed`` gives the JAX package's weights:

- :func:`threefry2x32`: the Threefry-2x32 block cipher, 20 rounds with
  JAX's rotations (``jax/_src/prng.py``, ``_threefry2x32_lowering``);
- :func:`prng_key`: ``jax.random.PRNGKey(seed)`` of an integer seed with
  64-bit types off (``_threefry_seed``: the seed's low 32 bits after a 0);
- :func:`fold_in`: ``jax.random.fold_in`` (``_threefry_fold_in``);
- :func:`random_bits`: 32-bit draws in the layout of
  ``jax_threefry_partitionable`` (on by default since JAX 0.5): element i
  of a shape hashes the 64-bit counter i, split in two words, and is the
  XOR of the two output words (``_threefry_random_bits_partitionable``);
- :func:`uniform` and :func:`truncated_normal` in float32
  (``jax/_src/random.py``, ``_uniform``, ``_truncated_normal``);
- :func:`erf`, :func:`erf_inv`, :func:`log1p` and :func:`log`: XLA's
  float32 approximations on the CPU (a rational one for erf; M. Giles,
  "Approximating the erfinv function", GPU Computing Gems, 2010, for
  erf_inv, in ``w = -log1p(-x^2)``; Cephes' log1p and logf, S. L.
  Moshier's Cephes Mathematical Library), their polynomials evaluated
  with fused multiply-adds as XLA's CPU code contracts them;
- :func:`static_fold` and :func:`param_key`: flax's per-parameter key
  (``flax/core/scope.py``, ``_fold_in_static``, ``Scope.make_rng``):
  ``fold_in(root, h)``, where h is the first 4 bytes, big-endian, of the
  SHA-1 of the names of the parameter's scope path, from the root down,
  followed by the scope's ``make_rng`` counter (1 for the scope's first
  parameter), the names UTF-8, the counter in its fewest big-endian
  bytes, with no separator (``flax_fix_rng_separator`` off, its default);
- :func:`lecun_normal` and :func:`xavier_uniform`:
  ``jax.nn.initializers.variance_scaling`` (``jax/_src/nn/initializers.py``)
  with flax's fans (``_compute_fans``: the kernel's last axis is its
  output, the one before its input, the rest its receptive field).

Every function is bit for bit ``jax.random``'s (and ``jax.lax``'s) on
JAX 0.9's CPU backend, which ``tests/test_torch_jax_random.py`` holds.
Every function works on a whole array at once: the headline model's
2,727,202 parameters take 0.38-0.45 s on one core of an Intel Xeon
(``python -m prtp_tpu_torch.utils.convert``).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

U32, F32, F64 = np.uint32, np.float32, np.float64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key`` (two
    uint32): returns the two output words, arrays of ``x0``'s shape."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, U32) + U32(ks[0])
    x1 = np.asarray(x1, U32) + U32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << U32(r)) | (x1 >> U32(32 - r))
            x1 ^= x0
        x0 += U32(ks[(i + 1) % 3])
        x1 += U32((ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``(0, data)``."""
    x0, x1 = threefry2x32(key, np.zeros(1, U32),
                          np.array([int(data) & 0xFFFFFFFF], U32))
    return np.array([x0[0], x1[0]], U32)


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    n = math.prod(shape)
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(U32)
    b0, b1 = threefry2x32(key, hi, count.astype(U32))
    b0 ^= b1
    return b0.reshape(shape)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, for results in float32's normal
    range. The product of two float32 is exact in float64, so the float64
    sum is rounded once already; rounding it again to float32 is exact
    unless it fell on a float32 midpoint (its 29 bits below float32's
    mantissa are 1 and 28 zeros), where the sum's rounding error (TwoSum)
    picks the side."""
    p = np.asarray(np.multiply(a, b, dtype=F64))
    s = np.asarray(p + c)
    r = s.astype(F32)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(1 << 28)
    if np.any(tie):
        p, s, c = p[tie], s[tie], np.broadcast_to(c, r.shape)[tie]
        bp = s - p
        err = (p - (s - bp)) + (c - bp)
        rt = r[tie]
        across = (err != 0) & ((s > rt) == (err > 0))
        toward_s = np.where(s > rt, F32(np.inf), F32(-np.inf))
        r[tie] = np.where(across, np.nextafter(rt, toward_s), rt)
    return r


def _horner(x, coefficients):
    """The polynomial ``coefficients[0] x^n + ... + coefficients[n]`` in
    float32, one fused multiply-add a step."""
    p = np.full(np.shape(x), coefficients[0], F32)
    for c in coefficients[1:]:
        p = _fma(p, x, F32(c))
    return p


_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def erf(x) -> np.ndarray:
    """XLA's float32 ``erf``: ``x * P(x^2) / Q(x^2)`` on ``x`` clamped to
    +-3.7439211627767994, the erfinv of 1 less half an ulp."""
    c = F32(3.7439211627767994)
    x = np.clip(np.asarray(x, F32), -c, c)
    x2 = x * x
    return (x * _horner(x2, _ERF_ALPHA)) / _horner(x2, _ERF_BETA)


# XLA's float32 log (Cephes' logf): the mantissa m in [sqrt(1/2), sqrt(2))
# less 1, a polynomial in it, and the exponent's ln 2 in two parts
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p below |x| = sqrt(2) - 1 (Cephes' log1p):
# x - x^2 / 2 + x^3 P(x) / Q(x)
_LOG1P_P = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_Q = (1.0, 1.5062909083469192198129E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log(x) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU for positive normal ``x`` (Cephes'
    logf, as Eigen and XLA's CPU backend evaluate it)."""
    x = np.maximum(np.asarray(x, F32), np.array(0x00800000, U32).view(F32))
    bits = x.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(F32) + F32(1)
    m = ((bits & ~0x7F800000) | np.array(0.5, F32).view(np.int32)).view(F32)
    low = m < F32(0.707106781186547524)
    e -= np.where(low, F32(1), F32(0))
    m = (m - F32(1)) + np.where(low, m, F32(0))
    m2 = m * m
    m3 = m2 * m
    p = [_fma(m, F32(_LOG_P[i]), F32(_LOG_P[i + 1])) for i in (0, 3, 6)]
    p = [_fma(q, m, F32(_LOG_P[i + 2])) for q, i in zip(p, (0, 3, 6))]
    y = _fma(_fma(p[0], m3, p[1]), m3, p[2])
    y = _fma(y, m3, F32(_LOG_Q1) * e)
    return _fma(F32(_LOG_Q2), e, _fma(F32(-0.5), m2, m) + y)


def log1p(x) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU: Cephes' rational form below
    |x| = sqrt(2) - 1, :func:`log` of ``1 + x`` above."""
    x = np.asarray(x, F32)
    out = np.empty_like(x)
    near = np.abs(x) < F32(0.41421356237309504880)
    xn = x[near]
    x2 = xn * xn
    r = (xn * x2) * (_horner(xn, _LOG1P_P) / _horner(xn, _LOG1P_Q))
    out[near] = xn + _fma(F32(-0.5), x2, r)
    with np.errstate(divide="ignore", invalid="ignore"):
        out[~near] = log(F32(1) + x[~near])
    return out


# Giles (2010), single precision: w = -log(1 - x^2) below 5, and above it
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (Giles' polynomials in ``w = -log1p(-x^2)``,
    shifted by 2.5 below w = 5, by 3 in ``sqrt(w)`` above); +-inf at +-1."""
    x = np.asarray(x, F32)
    w = -log1p(-(x * x))
    small = w < F32(5)
    w = np.where(small, w - F32(2.5), np.sqrt(w) - F32(3))
    p = np.where(small, F32(_ERFINV_SMALL[0]), F32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, F32(cs), F32(cl)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == F32(1), x * F32(np.inf), p * x)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under the exponent of 1.0, less 1, scaled and
    shifted by one fused multiply-add, then held at ``minval``."""
    minval, maxval = F32(minval), F32(maxval)
    bits = random_bits(key, shape) >> U32(32 - 23)
    floats = (bits | np.array(1.0, F32).view(U32)).view(F32) - F32(1)
    return np.maximum(minval, _fma(floats, maxval - minval, minval))


def truncated_normal(key, lower, upper, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    a uniform between the float32 ``erf`` of the bounds over sqrt 2,
    through ``sqrt2 * erf_inv``, clipped to the open interval."""
    sqrt2 = F32(np.sqrt(2))
    lower, upper = F32(lower), F32(upper)
    a, b = erf(lower / sqrt2), erf(upper / sqrt2)
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, F32(np.inf)),
                   np.nextafter(upper, F32(-np.inf)))


def _fans(shape):
    """flax's ``(fan_in, fan_out)`` of a kernel: its last axis is the
    output, the one before the input, the others the receptive field."""
    field = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * field, shape[-1] * field


def lecun_normal(key, shape) -> np.ndarray:
    """``flax.linen.initializers.lecun_normal()(key, shape)``: a normal
    truncated at two deviations, of variance ``1 / fan_in``."""
    variance = F32(1.0 / _fans(shape)[0])
    stddev = np.sqrt(variance) / F32(.87962566103423978)
    return truncated_normal(key, -2, 2, shape) * stddev


def xavier_uniform(key, shape) -> np.ndarray:
    """``flax.linen.initializers.xavier_uniform()(key, shape)``: uniform on
    +-sqrt(3 * variance), the variance ``2 / (fan_in + fan_out)``."""
    fan_in, fan_out = _fans(shape)
    variance = F32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1) * np.sqrt(F32(3) * variance)


def static_fold(key, data) -> np.ndarray:
    """flax's ``_fold_in_static(key, data)`` of names (str) and counters
    (int)."""
    if not data:
        return np.asarray(key, U32)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root, scope_path, counter: int) -> np.ndarray:
    """The key flax's ``init`` under ``root`` gives the parameter that a
    module at ``scope_path`` (names from the root's child down; empty for
    the root module) makes with its ``counter``-th ``make_rng('params')``."""
    return static_fold(root, tuple(scope_path) + (counter,))
