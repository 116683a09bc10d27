"""The draws of ``draws.py``, in torch, for a whole population at once.

The same formulas (threefry-2x32 keyed draws, jax's uniform and normal
transforms, the SplitMix32 walk draws) on int64 tensors holding uint32
values, so that one draw for each of millions of elements is a few dozen
tensor operations on any device.  Keys and scalar bits stay ``draws.py``'s
(Python ints): :func:`draws.fold_in`, :func:`draws.scalar_bits`.
"""

import numpy as np
import torch

from . import draws

M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block; ``k1``, ``k2`` Python ints,
    ``x1``, ``x2`` int64 tensors of uint32 values."""
    ks = (k1 & M32, k2 & M32, (k1 ^ k2 ^ 0x1BD11BDA) & M32)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for block in range(5):
        for r in draws._ROT[block % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & M32
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & M32
    return x1, x2


def bits(key, n, device):
    """``bits(key, (n,))``: the words of counters 0 to n - 1."""
    counters = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(counters),
                        counters)
    return a ^ b


def _erfinv32(x):
    """float32 erfinv (Giles), each Horner step rounded once to float32."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt = np.float32(draws._ERFINV_W_LT_5)
    ge = np.float32(draws._ERFINV_W_GE_5)
    p = torch.where(small, float(lt[0]), float(ge[0])).double()
    for i in range(1, len(lt)):
        c = torch.where(small, float(lt[i]), float(ge[i])).double()
        p = (c + p * w).float().double()
    p = p.float()
    return torch.where(torch.abs(x) == 1.0, float("inf") * x, p * x)


def normal(key, n, device):
    """``jax.random.normal(key, (n,))`` in float32."""
    b = bits(key, n, device)
    unit = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = float(np.float32(1.0) - lo)
    u = (unit.double() * span + float(lo)).float()
    u = torch.clamp_min(u, float(lo))
    return float(np.float32(np.sqrt(2.0))) * _erfinv32(u)


def _mul32(x, c):
    """(x * c) mod 2**32 for uint32 values in int64, without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def splitmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    return x ^ (x >> 16)


def walk_base(ids, seed):
    """Per-element base of the mixing walk's draws (``ids`` int64)."""
    s = (int(seed) & M32) * 0x9e3779b9 & M32
    return splitmix32((ids + s) & M32)


def substep_bits(base, i):
    """Substep ``i``'s word of the per-element base."""
    return splitmix32((base + (i * 0x85ebca6b & M32)) & M32)


def unit(word):
    """The top 24 bits of a word as a uniform in [0, 1) (float32)."""
    return (word >> 8).to(torch.float32) * (1.0 / 16777216.0)
