"""
JAX's normal and Rademacher draws in numpy, so that a seed starts the port
where it starts ``gpim_tpu``.

``gpim_tpu`` draws random initial parameters with
``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)`` (the correlated
``vreconstructor``'s task factor, ``gpim_tpu/gpreg/vgpr.py:122-124``). This
module reproduces that draw bit for bit up to the inverse error function:
the threefry2x32 block cipher on the flat element index, as JAX does with
``jax_threefry_partitionable`` (its default), and a 64-bit seed, as
``gpim_tpu`` enables ``jax_enable_x64``.

- key: ``(seed >> 32, seed & 0xffffffff)`` of the seed's 64-bit pattern;
- counters: each element's C-order flat index, split into hi and lo words;
- bits: ``b1 ^ b2`` for float32, ``b1 << 32 | b2`` for float64;
- uniform on ``[nextafter(-1, 0), 1)`` by the mantissa trick, in ``dtype``;
- value: ``sqrt(2) * erfinv(u)``, the inverse error function taken in
  float64 and rounded to ``dtype``. XLA's float32 ``erf_inv`` is a
  polynomial, so float32 draws agree to a few float32 ulps, float64 draws to
  round-off.

The off-lattice SKI predictor starts its Lanczos variance from
``jax.random.rademacher(jax.random.PRNGKey(seed), (n,))``
(``gpim_tpu/ops/ski.py:1183``): ``2 bernoulli(0.5) - 1``, where bernoulli is
``uniform < 0.5`` with the uniform in float64 (the probability's type under
64-bit mode). The mantissa-trick uniform is below 0.5 exactly when the top
bit of its 64 random bits is 0, so the draw is exact.
"""

import numpy as np
import torch

__all__ = ["jax_normal", "jax_rademacher"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, on uint32 arrays."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _random_bits(seed, n, bits):
    pattern = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0 = np.uint32(pattern >> 32)
    k1 = np.uint32(pattern & 0xFFFFFFFF)
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(k0, k1, (idx >> np.uint64(32)).astype(
            np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if bits == 32:
        return b0 ^ b1
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


def jax_normal(seed, shape, dtype=np.float64):
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)`` as a
    numpy array of ``dtype`` (float32 or float64)."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError("jax_normal draws float32 or float64, got %s"
                        % dtype)
    shape = tuple(int(s) for s in shape)
    nbits = 8 * dtype.itemsize
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = _random_bits(seed, int(np.prod(shape)), nbits)
    nmant = np.finfo(dtype).nmant
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - nmant)) | one).view(dtype) - dtype.type(1)
    lo = np.nextafter(dtype.type(-1), dtype.type(0))
    hi = dtype.type(1)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    z = np.sqrt(2.0) * torch.special.erfinv(
        torch.from_numpy(u.astype(np.float64))).numpy()
    return z.astype(dtype).reshape(shape)


def jax_rademacher(seed, shape, dtype=np.float64):
    """``jax.random.rademacher(jax.random.PRNGKey(seed), shape)`` cast to
    ``dtype``, as a numpy array of +1 and -1: +1 where the top bit of the
    element's 64 random bits is 0."""
    shape = tuple(int(s) for s in shape)
    bits = _random_bits(seed, int(np.prod(shape)), 64)
    return np.where(bits >> np.uint64(63), -1, 1).astype(dtype).reshape(shape)
