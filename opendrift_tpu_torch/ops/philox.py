"""Philox4x32-10 bits of an rbg key: the CUDA kernel's wrapper and its plain
version.

``general:rng='rbg'`` keys (``rng.RbgKey``) draw from the stream XLA's CPU
and GPU backends expand ``RngBitGenerator`` into, which is what the JAX
package draws under ``jax.random.key(seed, impl="rbg")`` (the layout is in
the note of ``csrc/philox.cu``).  :func:`philox_bits` launches the kernel of
``csrc/philox.cu`` for a CUDA device and takes :func:`philox_bits_plain`
for the CPU; there is no fallback: a kernel that fails to build or launch
raises.  ``philox_bits.launches`` counts its launches.  No Pallas kernel is
replaced: the JAX package draws these bits outside any kernel.

The library is compiled with ``nvcc`` on first use into
``opendrift_tpu_torch/_build/`` (git-ignored) and loaded with ctypes.
"""

import ctypes
import threading

import torch

from .cuda_build import ARCH_FLAGS, SHARED_FLAGS, build, check_launch, \
    count_launch

NVCC_FLAGS = [*ARCH_FLAGS, *SHARED_FLAGS]

_M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_BUMP = (0x9E3779B9, 0xBB67AE85)

_lib = None
_lib_lock = threading.Lock()
# the compiler's report (registers, spills) of the last build, or None
build_log = None


def build_library():
    """Compile ``csrc/philox.cu`` (once per source content) and return the
    path of the shared library."""
    global build_log
    so, report = build("philox.cu", NVCC_FLAGS)
    if report is not None:
        build_log = report
    return so


def load_library():
    """The loaded kernel library (building it on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            u, q, p = ctypes.c_uint32, ctypes.c_longlong, ctypes.c_void_p
            lib.philox_bits_launch.argtypes = [u, u, u, u, q, q, q, q, p, p]
            lib.philox_bits_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _mulhilo(x, m):
    """(high, low) 32-bit words of x * m, for x uint32 values in an int64
    tensor (or a Python int) and m a uint32 constant.  The product can
    reach 2^64 and int64 would overflow, so m is split into 16-bit halves:
    x * (m & 0xFFFF) and x * (m >> 16) are below 2^48, their sum aligned
    below 2^49, and every step is exact."""
    lo = x * (m & 0xFFFF)
    hi = x * (m >> 16)
    s = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (s >> 32), s & _M32


def philox4x32(k0, k1, x0, x1, x2, x3):
    """The ten Philox4x32 rounds on a counter (x0, x1, x2, x3) under key
    (k0, k1); uint32 words as Python ints or int64 tensors."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, _MUL[0])
        hi1, lo1 = _mulhilo(x2, _MUL[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _BUMP[0]) & _M32
        k1 = (k1 + _BUMP[1]) & _M32
    return x0, x1, x2, x3


def counter_words(words, i):
    """The Philox counter of counter index ``i`` (a non-negative int64
    tensor or Python int) for key words ``words`` = (w0, w1, w2, w3):
    (lo c, hi c, lo h, hi h) with c = s1 + i mod 2^64 and h = s0 plus the
    carry of that sum, carried in 32-bit limbs."""
    w0, w1, w2, w3 = words
    lo = w2 + (i & _M32)
    hi = w3 + (i >> 32) + (lo >> 32)
    h_lo = w0 + (hi >> 32)
    h_hi = w1 + (h_lo >> 32)
    return lo & _M32, hi & _M32, h_lo & _M32, h_hi & _M32


def counters_per_row(last):
    """The counters a row of ``last`` words spans at most (a row may start
    inside a counter), as the kernel's launcher counts them."""
    return (last + 3) // 4 + 1


def philox_bits_plain(words, lead, last, offset, n_global, device=None):
    """Plain torch version of the kernel: the (lead, last) int64 block of
    uint32 words whose row r holds global words [r * n_global + offset,
    r * n_global + offset + last) of the key's stream."""
    w0, w1 = words[0], words[1]
    start = torch.arange(lead, dtype=torch.int64, device=device) \
        * n_global + offset
    per_row = counters_per_row(last)
    ctr = (start >> 2)[:, None] + torch.arange(per_row, dtype=torch.int64,
                                               device=device)[None]
    block = torch.stack(philox4x32(w0, w1, *counter_words(words, ctr)), -1)
    col = (start & 3)[:, None] + torch.arange(last, dtype=torch.int64,
                                              device=device)[None]
    return torch.gather(block.reshape(lead, per_row * 4), 1, col)


def philox_bits(words, lead, last, offset=0, n_global=None, device=None):
    """The (lead, last) int64 block of uint32 words of the rbg stream of
    key ``words`` (four uint32 ints), row r holding global words
    [r * n_global + offset, r * n_global + offset + last) (``n_global``
    defaults to ``last``).  A row may run past ``n_global`` into the next
    row's words, as the last shard of a padded particle-sharded run does
    (its padding is never released).  A CUDA ``device`` launches the kernel
    on its current stream; the CPU takes :func:`philox_bits_plain`."""
    words = tuple(int(w) & _M32 for w in words)
    lead, last, offset = int(lead), int(last), int(offset)
    n_global = last if n_global is None else int(n_global)
    if min(lead, last, offset, n_global) < 0:
        raise ValueError(f"not a partition: lead {lead}, last {last}, "
                         f"offset {offset}, n_global {n_global}")
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu":
        return philox_bits_plain(words, lead, last, offset, n_global, dev)
    if dev.type != "cuda":
        raise ValueError(f"philox_bits runs on cuda or cpu, not {dev}")
    out = torch.empty((lead, last), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    rc = load_library().philox_bits_launch(
        *words, lead, last, offset, n_global, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "philox_bits")
    count_launch(philox_bits)
    return out


philox_bits.launches = 0
