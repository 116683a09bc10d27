"""The packed-row gather: the CUDA kernels' wrappers and plain version.

``out[e, :] = packed[clamp(idx[e], 0, R - 1), :]`` is the row fetch under
every sample of the packed-row sampler (``ops/interp.py`` ``take_rows``,
JAX ``jnp.take(..., mode='clip')``).  Two kernels written by hand for
Hopper in ``csrc/row_gather.cu`` compute it (the source note there says
what bounds them on an H100), the counterparts of the two Pallas kernels
of the JAX package's A/B tool ``tools/gather_ab.py``:

* :func:`gather_rows_async` — every warp keeps a ring of stages of rows in
  flight from device memory into shared memory and writes each landed
  stage out contiguously; replaces ``_pallas_dma_gather`` (gather_ab.py:45,
  ``pallas_call`` at :94).  Two routes, by :func:`gather_route`: rows of
  whole 16-byte units, ``BULK_MIN_ROW_BYTES`` or wider, at 16-byte aligned
  addresses take one bulk asynchronous copy a row in and one a stage out
  (``cp.async.bulk`` with mbarriers), any other row the ``NBUF``-stage
  ring of ``cp.async`` unit copies;
* :func:`gather_rows_smem` — the whole table is copied into a persistent
  block's dynamic shared memory once and rows are read from there;
  replaces ``_pallas_vmem_gather`` (gather_ab.py:101, ``pallas_call`` at
  :133).  Like the TPU kernel it is valid only while the table fits: the
  wrapper raises ``ValueError`` beyond ``SMEM_TABLE_MAX_BYTES``.

As in the JAX package, the run path's ``take_rows`` stays the framework's
own gather (:func:`gather_rows_plain`, one ``index_select``); the two
kernels are driven by ``opendrift_tpu_torch.tools.gather_ab``.

Tables are contiguous ``(R, C)`` tensors of a 2- or 4-byte element type
(float32, float16, bfloat16, int32, int16: the element size decides the
copy width, bits pass through untouched), indices int32 or int64, any
``C``.  A CUDA tensor launches the kernel on the current stream; a CPU
tensor takes the plain version.  There is no fallback: a kernel that fails
to build or launch raises.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""

import ctypes
import threading

import torch

from .cuda_build import ARCH_FLAGS, SHARED_FLAGS, build, check_launch

NBUF = 8                            # stages of the async ring (csrc kNBuf)
# narrower rows take the ring even where they could take the bulk copies,
# whose fixed cost a copy outweighs their bytes (csrc kBulkMinRow)
BULK_MIN_ROW_BYTES = 48
SMEM_TABLE_MAX_BYTES = 232_448      # dynamic shared memory of one block
SECTOR_BYTES = 32                   # device-memory access granularity
NVCC_FLAGS = [*ARCH_FLAGS, *SHARED_FLAGS]

_lib = None
_lib_lock = threading.Lock()
# the compiler's report (registers, spills) of the last build, or None
build_log = None


def build_library():
    """Compile ``csrc/row_gather.cu`` (once per source content) and return
    the path of the shared library."""
    global build_log
    so, report = build("row_gather.cu", NVCC_FLAGS)
    if report is not None:
        build_log = report
    return so


def load_library():
    """The loaded kernel library (building it on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for fn in (lib.gather_rows_async_launch,
                       lib.gather_rows_smem_launch):
                fn.argtypes = [p, p, p, ll, ll, i, i, i, p]
                fn.restype = i
            _lib = lib
    return _lib


def gather_rows_plain(packed, idx):
    """Plain torch version of both kernels: one ``index_select`` with the
    indices clamped into the table."""
    return packed.index_select(0, idx.clamp(0, packed.shape[0] - 1))


def unit_bytes(row_bytes, *addresses):
    """The copy width the kernels use: the widest of 16, 8, 4 and 2 bytes
    that divides a row's bytes and every base address."""
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and all(a % w == 0 for a in addresses):
            return w
    raise ValueError(f"rows of {row_bytes} bytes at {addresses} have no "
                     "copy width")


def gather_route(row_bytes, *addresses):
    """The route :func:`gather_rows_async` takes for rows of ``row_bytes``
    at these base addresses (the table's and the output's): "bulk" where
    the copy width is 16 bytes (the row's bytes and every address a
    multiple of 16) and the row is at least ``BULK_MIN_ROW_BYTES`` wide,
    "ring" otherwise."""
    return "bulk" if row_bytes >= BULK_MIN_ROW_BYTES and unit_bytes(
        row_bytes, *addresses) == 16 else "ring"


def _checked(packed, idx, name):
    """Raise on what the kernels do not take; returns (rows, row bytes)."""
    if not (torch.is_tensor(packed) and torch.is_tensor(idx)):
        raise TypeError(f"{name}: packed and idx must be tensors")
    if packed.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"{name}: packed must be (R, C) and idx (N,), got "
                         f"{tuple(packed.shape)} and {tuple(idx.shape)}")
    if packed.element_size() not in (2, 4) or packed.is_complex():
        raise TypeError(f"{name}: element type {packed.dtype} is not 2 or 4 "
                        "bytes wide")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx must be int32 or int64, not "
                        f"{idx.dtype}")
    if packed.device != idx.device:
        raise ValueError(f"{name}: packed is on {packed.device}, idx on "
                         f"{idx.device}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {packed.device}")
    if not packed.is_contiguous() or not idx.is_contiguous():
        raise ValueError(f"{name}: packed and idx must be contiguous")
    rows, cols = packed.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"{name}: empty table {tuple(packed.shape)}")
    return rows, cols * packed.element_size()


def _launch(entry, packed, idx, rows, row_bytes, name, lib=None):
    """Launch ``entry`` of ``lib`` (default: the package's library) into a
    new output; returns (output, whether a kernel was launched)."""
    out = torch.empty((idx.shape[0], packed.shape[1]), dtype=packed.dtype,
                      device=packed.device)
    if idx.shape[0] == 0:
        return out, False
    width = unit_bytes(row_bytes, packed.data_ptr(), out.data_ptr())
    rc = getattr(lib or load_library(), entry)(
        packed.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
        idx.shape[0], row_bytes, width, idx.element_size(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    check_launch(rc, name)
    return out, True


def gather_rows_async(packed, idx):
    """``packed[clamp(idx)]`` through the asynchronous-copy kernel (its
    bulk or its ring route, :func:`gather_route`).

    packed: contiguous (R, C), 2- or 4-byte elements; idx: contiguous (N,)
    int32 or int64 on the same device.  Returns (N, C) of packed's type.
    Rows wider than an eighth of a block's shared memory are refused: the
    ring holds ``NBUF`` of them (the bulk route's ring, three stages of at
    least a row a warp, takes them as well)."""
    rows, row_bytes = _checked(packed, idx, "gather_rows_async")
    if row_bytes * NBUF > SMEM_TABLE_MAX_BYTES:
        raise ValueError(
            f"gather_rows_async: a ring of {NBUF} rows of {row_bytes} bytes "
            f"exceeds a block's {SMEM_TABLE_MAX_BYTES} bytes of shared "
            "memory")
    if packed.device.type == "cpu":
        return gather_rows_plain(packed, idx)
    out, launched = _launch("gather_rows_async_launch", packed, idx, rows,
                            row_bytes, "gather_rows_async")
    gather_rows_async.launches += int(launched)
    return out


gather_rows_async.launches = 0


def gather_rows_smem(packed, idx):
    """``packed[clamp(idx)]`` with the table resident in shared memory.

    Arguments as :func:`gather_rows_async`.  Raises ``ValueError`` when the
    table is larger than the shared memory one block can have."""
    rows, row_bytes = _checked(packed, idx, "gather_rows_smem")
    if rows * row_bytes > SMEM_TABLE_MAX_BYTES:
        raise ValueError(
            f"gather_rows_smem: the table of {rows * row_bytes} bytes "
            f"exceeds a block's {SMEM_TABLE_MAX_BYTES} bytes of shared "
            "memory")
    if packed.device.type == "cpu":
        return gather_rows_plain(packed, idx)
    out, launched = _launch("gather_rows_smem_launch", packed, idx, rows,
                            row_bytes, "gather_rows_smem")
    gather_rows_smem.launches += int(launched)
    return out


gather_rows_smem.launches = 0


def gather_bound_bytes(packed, idx):
    """The bytes a gather of these indices must move at least: the indices
    and each distinct row read once (rows in whole 32-byte sectors of the
    table, a sector shared by two rows counted once), the output written
    once.  Also ``traffic``: what a kernel moves that reads a row again for
    every index naming it, ``N * (index bytes + 2 * row bytes)``."""
    rows, cols = packed.shape
    rb = cols * packed.element_size()
    n = idx.shape[0]
    used = torch.unique(idx.clamp(0, rows - 1).to(torch.int64))
    first = used * rb // SECTOR_BYTES
    last = (used * rb + rb - 1) // SECTOR_BYTES
    n_sectors = (rows * rb + SECTOR_BYTES - 1) // SECTOR_BYTES
    # +1 where a row's sectors begin, -1 after they end: covered where the
    # running sum is positive
    edge = torch.zeros(n_sectors + 1, dtype=torch.int64, device=idx.device)
    ones = torch.ones_like(first)
    edge.index_add_(0, first, ones)
    edge.index_add_(0, last + 1, -ones)
    sectors = int((torch.cumsum(edge[:-1], 0) > 0).sum())
    index_bytes = n * idx.element_size()
    return {"index_bytes": index_bytes,
            "table_bytes": sectors * SECTOR_BYTES,
            "out_bytes": n * rb,
            "total": index_bytes + sectors * SECTOR_BYTES + n * rb,
            "traffic": n * (idx.element_size() + 2 * rb),
            "distinct_rows": int(used.shape[0])}
