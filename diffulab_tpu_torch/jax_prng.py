"""JAX's default random number generator in NumPy, so that the port can draw
the weights the JAX package defines by a seed without importing JAX.

``FixedViT`` (``networks/repa/fixed.py``) builds its encoder from
``nnx.Rngs(seed)``: the REPA alignment target is whatever JAX's random
stream draws for that seed. This module reproduces that stream:

- the key of ``jax.random.key(seed)`` and ``jax.random.fold_in`` are the
  threefry2x32 block cipher (20 rounds, Salmon et al. 2011) on uint32 words;
- ``random_bits`` follows the partitionable layout (``jax_threefry_partitionable``,
  the default since JAX 0.5): element ``i`` of a row-major array encrypts the
  64-bit counter ``i`` split into its high and low words, and a 32-bit draw is
  the XOR of the two output words;
- ``uniform``, ``normal`` and ``truncated_normal`` map the bits as
  ``jax.random`` does in float32, the inverse error function by XLA's float32
  polynomial (its ``ErfInv32``) with fused multiply-adds: the bits and the
  uniforms are exact, the normals within 2 float32 ulps (99% exact; XLA's own
  ``log1p`` makes the rest);
- ``variance_scaling`` / ``lecun_normal`` are ``jax.nn.initializers``';
- :class:`Rngs` is ``nnx.Rngs(seed)``'s ``params`` stream: one counter shared
  by every draw, each draw ``fold_in(key(seed), counter)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
#: 1 / stddev of the standard normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNCATED_STDDEV = 0.87962566103423978


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 cipher of JAX's PRNG: ``key`` two uint32 words,
    ``x0``/``x1`` uint32 arrays of one shape; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]
        x1 = x1 + np.uint32(i + 1)  # array + scalar: wraps without a scalar-overflow warning
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s two words under JAX's default 32-bit mode
    (``jax_enable_x64`` off): 0 and the seed modulo 2**32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the key encrypting the counter (0, data)."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)`` under the partitionable layout."""
    n = math.prod(shape)
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(k, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(k: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under the
    exponent of 1.0, minus 1, then ``floats * (maxval - minval) + minval`` as
    one fused multiply-add (as XLA compiles it), floored at minval."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(32 - 23)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(maxval - minval) + np.float64(minval)).astype(np.float32)
    return np.maximum(minval, scaled)


#: XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function"), for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv as XLA computes it: w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x. Each Horner step
    is a fused multiply-add, here a float64 product of float32 values (exact)
    plus a float32 coefficient, rounded once."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(lo), np.float32(hi)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return p * x


def normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """float32 ``jax.random.normal``: sqrt(2) erfinv(u), u uniform on (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv(uniform(k, shape, lo, 1.0))


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape: Sequence[int]) -> np.ndarray:
    """float32 ``jax.random.truncated_normal`` on (lower, upper)."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    out = sqrt2 * _erfinv(uniform(k, shape, a, b))
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)), np.nextafter(upper, np.float32(-np.inf)))


def variance_scaling(k: np.ndarray, shape: Sequence[int], scale: float = 1.0) -> np.ndarray:
    """``jax.nn.initializers.variance_scaling(scale, "fan_in", "truncated_normal")``
    in float32 for a kernel whose last two axes are (in, out): fan_in is
    ``shape[-2]`` times the receptive field (every leading axis)."""
    variance = np.float32(scale / (math.prod(shape) // shape[-1]))
    stddev = np.sqrt(variance) / np.float32(_TRUNCATED_STDDEV)
    return truncated_normal(k, -2, 2, shape) * stddev


def lecun_normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.nn.initializers.lecun_normal()``, the default kernel init of
    ``nnx.Linear`` and ``nnx.Conv``."""
    return variance_scaling(k, shape, 1.0)


class Rngs:
    """``nnx.Rngs(seed)``'s ``params`` stream: each :meth:`params` call is
    ``fold_in(key(seed), n)`` with ``n`` one counter over every draw."""

    def __init__(self, seed: int):
        self._key = key(seed)
        self.count = 0

    def params(self) -> np.ndarray:
        k = fold_in(self._key, self.count)
        self.count += 1
        return k
