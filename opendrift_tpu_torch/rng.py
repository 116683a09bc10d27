"""Threefry-2x32 and rbg keys, bit-equal to ``jax.random`` (partitionable
mode).

The JAX engine derives every random number from one base key by
``jax.random.fold_in`` per (interval, step, use) and draws with
``jax.random.bits``/``normal``.  This module is the counterpart: the same
hash (Salmon et al. 2011, Random123) with the same key schedule, counter
layout and float conversion as ``jax._src.prng`` under
``jax_threefry_partitionable=True`` (the setting of the test suite), so
the per-step mixing seed — and with it every mixing draw — is bit-equal
to the JAX package's, and whole runs can be compared element by element.

Keys are tiny and live on the host as :class:`Key` (two Python ints);
only :func:`normal`/:func:`uniform`/:func:`exponential` work on device
tensors.  uint32 arithmetic is carried in int64 tensors masked with
``& 0xFFFFFFFF``: CPU torch lacks most uint32 operators.  ``normal``
evaluates XLA's float32 inverse error function on the same uniforms as
JAX; ``log1p`` of the two libraries may differ by an ulp, so normals may
differ by a few float32 ulp (``tests/test_torch_rng.py`` states the
bound).

Particle sharding (``parallel/mesh.py``) splits the element axis over
tiles, and the JAX package draws over the global axis with partitionable
threefry, where the counter of element (c, j) of a (C, N) draw is
``c * N + j``.  A shard that holds elements [offset, offset + n) of N
draws the counters of those global slots: :func:`bits` takes the
``partition=(offset, N)`` of its last axis, and inside
:func:`element_partition` every draw whose last axis is the shard's
length takes it from there, so the model code draws unchanged.

``general:rng='rbg'`` (:func:`rbg_key`) gives :class:`RbgKey`, the four
words of ``jax.random.key(seed, impl="rbg")``.  Its seed, ``fold_in`` and
``split`` are threefry's on each half (jax ``prng.py`` ``_rbg_seed``,
``_rbg_fold_in``, ``_rbg_split``); its bits are the Philox4x32-10 stream
that XLA's CPU and GPU backends give ``RngBitGenerator`` (a TPU's hardware
generator gives other bits), drawn by the kernel of ``ops/philox.py`` on
the card.  A partitioned rbg draw is the slice of the global draw too,
as the JAX package's particle-sharded runs draw it.  Every function here
takes either key, so the model code draws unchanged.
"""

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .ops import philox

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class Key:
    """A threefry2x32 key: two uint32 words held as Python ints."""
    k1: int
    k2: int

    def __iter__(self):
        return iter((self.k1, self.k2))


@dataclass(frozen=True)
class RbgKey:
    """An rbg key: four uint32 words held as Python ints, as
    ``jax.random.key_data`` gives them; two threefry halves (w0, w1) and
    (w2, w3) for ``fold_in`` and ``split``, the Philox state for bits."""
    w0: int
    w1: int
    w2: int
    w3: int

    def __iter__(self):
        return iter((self.w0, self.w1, self.w2, self.w3))

    def halves(self):
        return Key(self.w0, self.w1), Key(self.w2, self.w3)


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block (jax ``_threefry2x32_lowering``).

    Works on Python ints and on int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & _M32
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & _M32
    return x1, x2


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)`` with JAX's default 32-bit mode: the
    seed's low word, any integer (negative seeds wrap)."""
    return Key(0, int(seed) & _M32)


def rbg_key(seed):
    """``jax.random.key(seed, impl="rbg")``: the threefry seed twice."""
    k = PRNGKey(seed)
    return RbgKey(k.k1, k.k2, k.k1, k.k2)


def fold_in(key, data):
    """``jax.random.fold_in``: hash the counter pair (0, data); an rbg key
    folds each half."""
    if isinstance(key, RbgKey):
        h0, h1 = (fold_in(h, data) for h in key.halves())
        return RbgKey(*h0, *h1)
    return Key(*threefry2x32(key.k1, key.k2, 0, int(data) & _M32))


def split(key, num=2):
    """``jax.random.split``: under ``jax_threefry_partitionable`` the i-th
    key is the hash of the counter pair (0, i), which is
    ``fold_in(key, i)``; for an rbg key on each half."""
    return tuple(fold_in(key, i) for i in range(num))


_partition = threading.local()


@contextlib.contextmanager
def element_partition(offset, n_local, n_global):
    """Draws of this thread whose last axis has ``n_local`` entries take
    the counters of elements [offset, offset + n_local) of a global axis
    of ``n_global`` (one shard of a particle-sharded run)."""
    old = getattr(_partition, "value", None)
    _partition.value = (int(offset), int(n_local), int(n_global))
    try:
        yield
    finally:
        _partition.value = old


def _active_partition(shape):
    value = getattr(_partition, "value", None)
    if value is not None and len(shape) and shape[-1] == value[1]:
        return value[0], value[2]
    return None


def bits(key, shape=(), device=None, partition=None):
    """``jax.random.bits(key, shape, dtype=uint32)``.  The empty shape
    returns a Python int; any other shape an int64 tensor of uint32
    values on ``device``.  ``partition=(offset, n_global)``: the last
    axis is elements [offset, offset + shape[-1]) of an axis of
    ``n_global``, and the values are those of that slice of the global
    draw (default: the active :func:`element_partition`, if any).  An rbg
    key draws through :func:`ops.philox.philox_bits` (its kernel on a CUDA
    device)."""
    rbg = isinstance(key, RbgKey)
    if shape == ():
        if rbg:
            words = tuple(key)
            return philox.philox4x32(*words[:2],
                                     *philox.counter_words(words, 0))[0]
        b1, b2 = threefry2x32(key.k1, key.k2, 0, 0)
        return b1 ^ b2
    shape = tuple(int(s) for s in shape)
    if partition is None:
        partition = _active_partition(shape)
    if rbg:
        # an unpartitioned draw is the partition (0, shape[-1]): row r
        # starts at word r * shape[-1], the row-major stream
        lead = int(np.prod(shape[:-1]))
        return philox.philox_bits(tuple(key), lead, shape[-1],
                                  *(partition or (0, shape[-1])),
                                  device=device).reshape(shape)
    if partition is None:
        n = int(np.prod(shape))
        if n >= 1 << 32:
            raise ValueError("the port's counters are 32-bit")
        lo = torch.arange(n, dtype=torch.int64, device=device)
    else:
        offset, n_global = partition
        lead = int(np.prod(shape[:-1]))
        if lead * n_global >= 1 << 32:
            raise ValueError("the port's counters are 32-bit")
        row = torch.arange(lead, dtype=torch.int64, device=device)
        col = torch.arange(shape[-1], dtype=torch.int64, device=device)
        lo = (row[:, None] * n_global + offset + col[None, :]).reshape(-1)
    b1, b2 = threefry2x32(key.k1, key.k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(shape)


def _unit_floats(key, shape, device):
    """float32 in [0, 1) from the top 23 bits, as jax ``_uniform``."""
    b = bits(key, shape, device)
    one = int(np.array(1.0, np.float32).view(np.uint32))
    return ((b >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0, device=None):
    """``jax.random.uniform`` in float32 (``maxval - minval`` rounded to
    float32 first, as JAX does).  XLA contracts ``u * span + minval``
    into one fused multiply-add; the float64 evaluation below is that
    rounding (the float32 product is exact in float64)."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    u = (_unit_floats(key, shape, device).double() * span
         + float(lo)).float()
    return torch.clamp_min(u, float(lo))


# Giles' single-precision inverse error function, the polynomial XLA
# lowers ``erf_inv`` to for float32 (chlo_legalize_to_hlo.cc)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """float32 erfinv as XLA evaluates it; each Horner step ``c + p * w``
    is one fused multiply-add there, reproduced by a float64 evaluation
    rounded once to float32."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(small, _ERFINV_W_LT_5[i],
                           _ERFINV_W_GE_5[i]).double()
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef(i) + p * w).float().double()
    p = p.float()
    return torch.where(torch.abs(x) == 1.0, float("inf") * x, p * x)


def normal(key, shape, device=None):
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0, device)
    return float(np.float32(np.sqrt(2.0))) * erfinv(u)


def exponential(key, shape, device=None):
    """``jax.random.exponential`` in float32: -log1p(-u) of the same
    uniforms.  XLA's CPU ``log1p`` is its own polynomial, not the
    correctly rounded value, so a draw may differ from the JAX package's
    by an ulp (``tests/test_torch_zoo.py`` states the bound)."""
    u = uniform(key, shape, device=device)
    return -torch.log1p(-u)
