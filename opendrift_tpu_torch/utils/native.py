"""ctypes bindings of the host field pipeline (``csrc/fieldpipe.cpp``).

The port's copy of ``opendrift_tpu/utils/native.py``: the same C++ source,
built with the same ``g++ -O3 -shared -fPIC -pthread`` on first use, so the
NaN fills of the two packages are the same machine code and agree bit for
bit.  The library goes into ``opendrift_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and flags, written under a temporary name
and renamed, so processes that build it at once do not load a half-written
file.  Where g++ fails the callers fall back to scipy/numpy, as the JAX
package does; that is logged at WARNING and reported by
``ops.interp.fill_route()`` and :func:`decode_route`.  ``decode_i16`` is the
int16 CF decode of the NetCDF reader (``utils/ncio.py`` ``cf_unpack``).
"""

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fieldpipe.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_LIB = None
_TRIED = False


def _build():
    """Path of the built library, compiling it if needed."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR,
                      f"libfieldpipe_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, so)
    logger.info("Built the native field pipeline: %s", so)
    return so


def get_lib():
    """The loaded library, building it on first use; None where it cannot
    be built or loaded (logged once at WARNING)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("Could not build or load the native field pipeline "
                       "(%s); NaN fills take the scipy/numpy fallback", e)
        return None
    for name in ("fill_nearest", "fill_seafloor"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int]
        fn.restype = None
    lib.decode_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_int16,
        ctypes.c_int]
    lib.decode_i16.restype = None
    _LIB = lib
    return _LIB


def decode_route():
    """Which int16 CF decode ``cf_unpack`` takes: 'native' (``decode_i16``
    of ``csrc/fieldpipe.cpp``, as in the JAX package) or 'numpy' (the
    fallback where g++ failed)."""
    return "native" if get_lib() is not None else "numpy"


def decode_i16(raw, scale, offset, fill=None):
    """int16 -> float32 CF unpack, ``raw * scale + offset`` in float32 with
    ``fill`` -> NaN; None where the library cannot be built."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    out = np.empty(raw.shape, dtype=np.float32)
    lib.decode_i16(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   raw.size, float(scale), float(offset),
                   np.int16(fill) if fill is not None else 0,
                   1 if fill is not None else 0)
    return out


def _call(name, field):
    lib = get_lib()
    if lib is None:
        return False
    if field.dtype != np.float32 or not field.flags["C_CONTIGUOUS"] \
            or not field.flags["WRITEABLE"] or field.ndim < 2:
        raise ValueError(f"{name} needs a writeable C-contiguous float32 "
                         f"array of 2 or more dimensions, got {field.dtype} "
                         f"{field.shape}")
    ny, nx = field.shape[-2:]
    nz = int(np.prod(field.shape[:-2]))
    getattr(lib, name)(field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       nz, ny, nx)
    return True


def fill_nearest(field):
    """In place: each NaN of every (Y, X) layer of ``field`` becomes the
    value of its nearest finite cell by the two-pass chamfer transform; a
    layer without one becomes 0.  True if the native path ran."""
    return _call("fill_nearest", field)


def fill_seafloor(block):
    """In place: a (Z, Y, X) block's NaNs take the value above them, from
    the surface down.  True if the native path ran."""
    if block.ndim != 3:
        raise ValueError(f"fill_seafloor needs a (Z, Y, X) block, got "
                         f"{block.shape}")
    return _call("fill_seafloor", block)
