"""The JAX package's seeded initial weights, drawn without JAX.

``TimbreTrap(seed=s)`` of the JAX package initialises its network with
``net.init(jax.random.PRNGKey(s), ...)``: every kernel is flax's
``lecun_normal`` (a normal truncated to two standard deviations, variance
1/fan_in), every bias zero, ``skip_weights`` ones. This module repeats that
draw in numpy, step by step as JAX and flax take it:

* flax keys each parameter by folding the SHA-1 of its module path and the
  module's draw counter into the root key (``flax/core/scope.py``:
  ``LazyRng``, ``_fold_in_static``; kernels are a module's first draw);
* JAX's ``fold_in`` and ``random_bits`` are the Threefry-2x32 hash (20
  rounds), the bits counter-based over the flat index
  (``jax_threefry_partitionable``, JAX's default);
* ``truncated_normal`` maps 32 random bits to a uniform float32 between
  erf(-sqrt 2) and erf(sqrt 2) and takes XLA's float32 ``erf_inv``
  polynomial.

The port's own models draw their weights with torch's generator
(``modules.init_weights``); this module gives the JAX package's instead,
for comparisons that must start from the JAX package's seeded weights:
the keys and random bits are exact, and about 1 % of the weights lie one
float32 unit in the last place from JAX's, where numpy's ``log1p``
rounds apart from XLA's.
"""

import hashlib
import math

import numpy as np

__all__ = ["jax_package_params"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The standard deviation of a unit normal truncated to [-2, 2].
_TRUNCATED_STD = np.float32(0.87962566103423978)
# XLA's float32 erf_inv: Giles' polynomials in w = -log1p(-x^2), below and
# above w = 5.
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _rotl(v, d):
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def _threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the counter words (x0, x1) under the key
    (k1, k2), as JAX's ``threefry2x32`` computes it."""
    with np.errstate(over="ignore"):
        ks = [np.uint32(k1), np.uint32(k2),
              np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA)]
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _fold_in(key, data):
    """``jax.random.fold_in(key, uint32 data)``."""
    y0, y1 = _threefry2x32(key[0], key[1], np.uint32(0), np.uint32(data))
    return np.uint32(y0), np.uint32(y1)


def _flax_key(root, path, counter):
    """The key flax hands the ``counter``-th draw of the module at
    ``path`` (``_fold_in_static`` of the names and the counter)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return _fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _random_bits(key, shape):
    """32 random bits an element (``jax.random.bits``)."""
    n = int(np.prod(shape))
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32(key[0], key[1],
                           (lo >> np.uint64(32)).astype(np.uint32),
                           (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def _fma(x, y, z):
    """float32 ``x * y + z`` rounded once, as XLA's fused multiply-adds do
    (the float32 product is exact in float64)."""
    return (np.asarray(x, np.float64) * np.asarray(y, np.float64)
            + np.asarray(z, np.float64)).astype(np.float32)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` polynomial, its steps fused as XLA fuses
    them on the CPU (edge cases |x| = 1 do not occur here)."""
    w = -np.log1p(-(x * x).astype(np.float64)).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, c_lt, c_ge))
    return (p * x).astype(np.float32)


def _lecun_normal(key, shape):
    """flax's ``lecun_normal`` (fans of the HWIO / (in, out) layout)."""
    sqrt2 = np.float32(np.sqrt(2))
    a = np.float32(math.erf(float(np.float32(-2.0) / sqrt2)))
    b = np.float32(math.erf(float(np.float32(2.0) / sqrt2)))
    bits = _random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = np.maximum(a, _fma(floats - np.float32(1.0), b - a, a))
    out = sqrt2 * _erf_inv(u)
    out = np.clip(out, np.nextafter(np.float32(-2.0), np.float32(np.inf)),
                  np.nextafter(np.float32(2.0), np.float32(-np.inf)))
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNCATED_STD
    return (out * stddev).astype(np.float32)


def jax_package_params(tree, seed=0):
    """The JAX package's ``TimbreTrapNet`` parameters for ``seed``, on the
    flax-layout ``tree`` of a net of the same configuration
    (``interop.hwio_params(net)``: names and shapes are read from it):
    numpy, ready for ``TimbreTrap.load_jax_params``."""
    root = (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))

    def draw(node, path):
        out = {}
        for name, value in node.items():
            if isinstance(value, dict):
                out[name] = draw(value, path + (name,))
            elif name == "kernel":
                key = _flax_key(root, path, 1)    # a module's first draw
                out[name] = _lecun_normal(key, tuple(value.shape))
            elif name == "skip_weights":
                out[name] = np.ones(tuple(value.shape), np.float32)
            else:
                out[name] = np.zeros(tuple(value.shape), np.float32)
        return out

    return draw(tree, ())
