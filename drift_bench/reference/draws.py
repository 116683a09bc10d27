"""The random draws a forecast makes, reproduced with numpy (frozen copies).

The draws are part of what a forecast computes: the reference has to make
the same ones to follow each element.  The algorithms are copied from
``opendrift_tpu_torch/rng.py`` and ``opendrift_tpu_torch/ops/mixing.py`` at
commit 6f1980e1cee06c33f9f539f1b9a6d1e50f17f533, which define them as
``jax.random``'s (threefry-2x32 in partitionable mode, its uniform and
normal transforms) and the mixing kernels' SplitMix32 walk draws:

* keys: ``PRNGKey(seed) = (0, seed mod 2**32)``; ``fold_in(key, d)`` is the
  threefry block of the counter pair (0, d);
* ``bits(key, shape)``: element ``c`` of the flattened shape hashes the
  counter pair (0, c), the word is the xor of the block's two words;
* ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform in (-1, 1) from
  the top 23 bits, ``erfinv`` Giles' float32 polynomial;
* a mixing substep ``i`` of element ``ID`` draws
  ``splitmix32(splitmix32(ID + seed * 0x9e3779b9) + i * 0x85ebca6b)``,
  whose top 24 bits give a uniform in [-1, 1).
"""

import numpy as np

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block on uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x1 = np.asarray(x1, np.uint32) + ks[0]
    x2 = np.asarray(x2, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for block in range(5):
            for r in _ROT[block % 2]:
                x1 = (x1 + x2).astype(np.uint32)
                x2 = _rotl(x2, r) ^ x1
            x1 = (x1 + ks[(block + 1) % 3]).astype(np.uint32)
            x2 = (x2 + ks[(block + 2) % 3]
                  + np.uint32(block + 1)).astype(np.uint32)
    return x1, x2


def prng_key(seed):
    return (0, int(seed) & M32)


def fold_in(key, data):
    a, b = threefry2x32(key[0], key[1], np.uint32(0),
                        np.uint32(int(data) & M32))
    return (int(a), int(b))


def scalar_bits(key):
    a, b = threefry2x32(key[0], key[1], np.uint32(0), np.uint32(0))
    return int(a ^ b)


def bits_at(key, counters):
    """``bits(key, shape)`` at the given flat counters."""
    a, b = threefry2x32(key[0], key[1], np.zeros_like(counters, np.uint32),
                        np.asarray(counters, np.uint32))
    return a ^ b


_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x):
    """float32 erfinv (Giles), each Horner step rounded once to float32."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(x * -x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    lt, ge = np.array(_ERFINV_W_LT_5), np.array(_ERFINV_W_GE_5)
    p = np.where(small, lt[0], ge[0]).astype(np.float32).astype(np.float64)
    for i in range(1, len(lt)):
        c = np.where(small, np.float32(lt[i]), np.float32(ge[i]))
        p = (c.astype(np.float64) + p * w).astype(np.float32) \
            .astype(np.float64)
    p = p.astype(np.float32)
    return np.where(np.abs(x) == 1.0, np.float32(np.inf) * x, p * x)


def normal_at(key, counters):
    """``jax.random.normal(key, shape)`` (float32) at the flat counters."""
    b = bits_at(key, counters)
    unit = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = float(np.float32(1.0) - lo)
    u = (unit.astype(np.float64) * span + float(lo)).astype(np.float32)
    u = np.maximum(u, lo)
    return np.float32(np.sqrt(2.0)) * _erfinv32(u)


def _splitmix32(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(0x7feb352d)).astype(np.uint32)
        x = x ^ (x >> np.uint32(15))
        x = (x * np.uint32(0x846ca68b)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def walk_base(ids, seed):
    """Per-element base of the mixing walk's draws."""
    with np.errstate(over="ignore"):
        s = np.uint32((int(seed) & M32) * 0x9e3779b9 & M32)
        return _splitmix32((np.asarray(ids, np.uint32) + s).astype(np.uint32))


def walk_draw(base, i):
    """Substep ``i``'s uniform draw in [-1, 1) (float32)."""
    with np.errstate(over="ignore"):
        h = _splitmix32((base + np.uint32(i * 0x85ebca6b & M32))
                        .astype(np.uint32))
    return (h >> np.uint32(8)).astype(np.float32) \
        * np.float32(2.0 / 16777216.0) - np.float32(1.0)
