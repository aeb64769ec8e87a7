"""The two ``jax.random`` draws of ``sod_tpu``'s spectral clustering, in numpy.

``sod_tpu/data/clusterings.py`` seeds k-means++ with
``jax.random.randint(jax.random.key(seed), (), 0, n)`` (``:36``) and starts
its subspace iteration from ``jax.random.normal(jax.random.key(0), (n, m))``
(``:120``).  The port's labels can equal ``sod_tpu``'s only if its first
k-means++ pick is the same node, so both draws are written here again, as
the default threefry2x32 generator of jax 0.9 with
``jax_threefry_partitionable`` on draws them:

* a key from seed s is the pair (0, s & 0xffffffff) (jax without x64, as
  ``sod_tpu`` runs, keeps a seed's low 32 bits);
* ``split(key, n)[i]`` = threefry2x32(key, (0, i));
* 32 random bits at flat index i = x ^ y of threefry2x32(key, (i >> 32, i));
* ``randint(key, (), lo, hi)`` splits the key in two, draws 32 bits from
  each and folds the 64 bits into [lo, hi) with jax's multiplier rule, in
  its wrapping uint32 arithmetic;
* ``normal`` draws uniforms in (-1, 1) from the top 23 bits and returns
  sqrt(2) * erfinv(u), erfinv by Giles' single-precision polynomial (what
  XLA compiles ``lax.erf_inv`` to).

``randint`` and the uniforms are jax's bit for bit (integer arithmetic).
``normal`` matches to a few f32 ulps, not bit for bit: XLA's CPU backend
evaluates the polynomial's ``log1p`` with its own approximation, and
numpy's differs from it in the last bits.  The subspace start only needs to
span a generic subspace, so this does not move a label.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.array(x0, np.uint32), np.array(x1, np.uint32)]
    with np.errstate(over="ignore"):
        x[0] += ks[0]
        x[1] += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] += x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] += ks[(i + 1) % 3]
            x[1] += ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)``'s threefry key data (32-bit jax)."""
    return 0, seed & 0xFFFFFFFF


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(k: Tuple[int, int], n: int = 2):
    """``jax.random.split(k, n)`` as a list of keys."""
    a, b = threefry2x32(k, *_counters(n))
    return [(int(a[i]), int(b[i])) for i in range(n)]


def random_bits(k: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    a, b = threefry2x32(k, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (a ^ b).reshape(shape)


def randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.key(seed), (), 0, n))``, 0 < n < 2^31."""
    k1, k2 = split(key(seed))
    hi, lo = int(random_bits(k1, ())), int(random_bits(k2, ()))
    m32 = 0xFFFFFFFF                               # jax's uint32 arithmetic wraps
    mult = ((2 ** 16 % n) ** 2 & m32) % n
    return (((hi % n) * mult & m32) + lo % n & m32) % n


def uniform_pm1(seed: int, shape) -> np.ndarray:
    """``jax.random.uniform(key(seed), shape, minval=nextafter(-1, 0),
    maxval=1)`` in f32: the draw under ``jax.random.normal``."""
    bits = random_bits(key(seed), shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.maximum(lo, f * (np.float32(1.0) - lo) + lo).astype(np.float32)


_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Giles' single-precision erfinv, as XLA writes ``erf_inv`` for f32."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(small, c_lt, c_ge) + p * w).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.key(seed), shape)`` in f32, to a few
    ulps (see the module docstring)."""
    return (np.float32(np.sqrt(2.0)) * erfinv_f32(uniform_pm1(seed, shape))).astype(np.float32)
