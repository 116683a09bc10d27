"""A forcing window's row tables assembled from frames: the CUDA kernel's
wrapper, its plain version, and the window a structured reader hands over.

A structured reader's row table (``fields/grid.py``, the layout of
``ops/interp.PackedSampler``) is, for every (member, z, y, x) cell, each
base column (a variable at a window frame, or a static field) at the cell
and at its stencil neighbours.  The reader hands each window over as a
:class:`PackWindow`: the window's decoded frames, which base column reads
which frame, the pair mode and the storage type.  Where the window goes to
a device, the frames that device does not hold yet go up (a reader's
:class:`ResidentFrames`) and the tables are assembled there: by the kernel
of ``csrc/pack_window.cu`` on a CUDA device (:func:`pack_window`), by
:func:`assemble_rows_plain` on the CPU.  From one window to the next only
the new frames move.  The storages a consumer needs built on the host
(compensated and split tables, a decomposed run's bands) take
:func:`assemble_rows_plain` on host tensors: one layout for every path.

The kernel replaces no Pallas kernel (the JAX package packs on the host);
its source note says what bounds it.  ``pack_window.launches`` counts its
launches; a CUDA tensor launches it or raises, there is no fallback.  The
library is compiled with ``nvcc`` on first use into
``opendrift_tpu_torch/_build/`` (git-ignored) and loaded with ctypes.
"""

import ctypes
import threading

import numpy as np
import torch

from .cuda_build import ARCH_FLAGS, SHARED_FLAGS, build, check_launch, \
    count_launch

NVCC_FLAGS = [*ARCH_FLAGS, *SHARED_FLAGS]
STORE_BYTES = 16                    # a thread's store (csrc Vec)

_lib = None
_lib_lock = threading.Lock()
# the compiler's report (registers, spills) of the last build, or None
build_log = None


def build_library():
    """Compile ``csrc/pack_window.cu`` (once per source content) and return
    the path of the shared library."""
    global build_log
    so, report = build("pack_window.cu", NVCC_FLAGS)
    if report is not None:
        build_log = report
    return so


def load_library():
    """The loaded kernel library (building it on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pack_window_launch.argtypes = [i, i, i, p, p, i, p, p, i,
                                               i, i, i, i, i, p]
            lib.pack_window_launch.restype = i
            _lib = lib
    return _lib


def _planes(src, Z, ny, nx):
    """A frame as (Z, ny, nx): a 3D frame's first Z planes, a 2D frame
    repeated on every plane (a view)."""
    if src.dim() == 3:
        return src[:Z]
    return src.reshape(1, ny, nx).expand(Z, ny, nx)


def assemble_rows_plain(srcs, cols, Z, ny, nx, k, dtype):
    """The plain version of the kernel: the (M*Z*ny*nx, Cb*k) table whose
    member m's base column c reads ``srcs[cols[m][c]]`` (float32 (Z', ny,
    nx) with Z' >= Z, or (ny, nx)); columns [base | x+1] ('x', k=2), then
    [y+1 | x+1,y+1] ('xy', k=4), then the same four at z+1 ('xyz', k=8),
    the last row, column and plane repeating (the clamp of the stencil).
    Cast to ``dtype`` last, which rounds to nearest even."""
    def shift_x(a):
        return torch.cat([a[:, :, 1:], a[:, :, -1:]], dim=2)

    def shift_y(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    blocks = []
    for member in cols:
        base = torch.stack([_planes(srcs[i], Z, ny, nx) for i in member],
                           dim=-1)
        variants = [base]
        if k >= 2:
            variants.append(shift_x(base))
        if k >= 4:
            variants += [shift_y(base), shift_x(shift_y(base))]
        table = torch.cat(variants, dim=-1)
        if k == 8:
            table = torch.cat(
                [table, torch.cat([table[1:], table[-1:]], dim=0)], dim=-1)
        blocks.append(table.reshape(Z * ny * nx, -1))
    out = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    return out.to(dtype)


def _check_sources(srcs, Z, ny, nx, device):
    for s in srcs:
        if s.device != device or s.dtype != torch.float32 \
                or not s.is_contiguous():
            raise ValueError("pack_window takes contiguous float32 frames "
                             f"on {device}, not {s.dtype} on {s.device}")
        if tuple(s.shape[-2:]) != (ny, nx) or s.dim() not in (2, 3) or (
                s.dim() == 3 and s.shape[0] < Z):
            raise ValueError(f"a frame of shape {tuple(s.shape)} in a "
                             f"window of ({Z}, {ny}, {nx})")


def pack_window(srcs, tables, Z, ny, nx, k, dtype):
    """Every table of a window from the same frames: ``tables`` lists, per
    table, the members' base-column sources (``cols`` of
    :func:`assemble_rows_plain`, at most two tables).  Frames on a CUDA
    device launch one kernel on its current stream for all the tables;
    the CPU takes :func:`assemble_rows_plain`."""
    device = srcs[0].device
    if device.type == "cpu":
        return [assemble_rows_plain(srcs, cols, Z, ny, nx, k, dtype)
                for cols in tables]
    if device.type != "cuda":
        raise ValueError(f"pack_window runs on cuda or cpu, not {device}")
    if dtype not in (torch.float32, torch.float16):
        raise ValueError(f"pack_window writes float32 or float16, not {dtype}")
    if not 1 <= len(tables) <= 2 or k not in (1, 2, 4, 8):
        raise ValueError(f"{len(tables)} tables, {k} variants")
    _check_sources(srcs, Z, ny, nx, device)
    M = len(tables[0])
    outs, args = [], []
    for cols in tables:
        cb = len(cols[0])
        if len(cols) != M or any(len(c) != cb for c in cols) or cb == 0:
            raise ValueError("every member of a table needs the same "
                             "number of base columns")
        ptrs = [srcs[i].data_ptr() for member in cols for i in member]
        zs = [ny * nx if srcs[i].dim() == 3 else 0
              for member in cols for i in member]
        # the pointer table goes up from pinned memory without a wait
        src = torch.tensor(ptrs + zs, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
        outs.append(torch.empty((M * Z * ny * nx, cb * k), dtype=dtype,
                                device=device))
        args.append((src, cb))
    elem = outs[0].element_size()
    vec = STORE_BYTES // elem
    while any((o.shape[1] % vec) or (o.data_ptr() % (vec * elem))
              for o in outs):
        vec //= 2
    jobs = [(o.data_ptr(), src.data_ptr(), cb)
            for o, (src, cb) in zip(outs, args)]
    jobs += [(0, 0, 0)] * (2 - len(jobs))
    rc = load_library().pack_window_launch(
        int(dtype == torch.float16), vec, len(outs), *jobs[0], *jobs[1],
        M, Z, ny, nx, k, torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "pack_window")
    count_launch(pack_window)
    return outs


pack_window.launches = 0


def _device_key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _host_tensor(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class ResidentFrames:
    """A reader's frames held on each device.  A frame of a window is a
    triple (key, owner, array): ``key`` names it (variable, frame index,
    member, planes), ``owner`` is the host array the reader's frame cache
    handed out and ``array`` the part of it the tables read.  A held frame
    serves while its key comes with the same owner (a frame the cache read
    again is a new array, and goes up again); a window drops the frames it
    does not use.  Used from the thread that takes windows to the device."""

    def __init__(self):
        self._held = {}          # device -> {key: (owner, tensor)}

    def take(self, device, frames):
        """The tensors of ``frames`` on ``device``, in order, and (frames,
        bytes) copied there for them: the held ones serve as they are, the
        missing ones are copied; every other frame held there is
        dropped."""
        device = _device_key(device)
        held = self._held.get(device, {})
        keep = {}
        sent = nbytes = 0
        for key, owner, array in frames:
            got = held.get(key)
            if got is None or got[0] is not owner:
                host = _host_tensor(array)
                got = (owner, host.to(device))
                sent += 1
                nbytes += host.numel() * host.element_size()
            keep[key] = got
        self._held[device] = keep
        return [keep[f[0]][1] for f in frames], (sent, nbytes)


class PackWindow:
    """A window's tables as their frames and layout: ``frames`` the
    window's (key, owner, host float32 array) triples (a 3D frame cut to
    its first Z planes; :class:`ResidentFrames`), ``tables`` per table the
    members' base-column indices into ``frames`` (the full table first,
    then the u/v companion if any), ``k`` the stencil variants and
    ``dtype`` the storage type.  Made on the host, on any thread;
    :meth:`table` assembles on a device (from ``store``, the reader's
    :class:`ResidentFrames`), :meth:`host_table` on the host.  ``sent``:
    the (frames, bytes) its last assembly on a device copied there."""

    def __init__(self, store, frames, tables, Z, ny, nx, k, dtype):
        self.store = store
        self.frames = frames
        self.tables = tables
        self.Z, self.ny, self.nx, self.k = Z, ny, nx, k
        self.dtype = dtype
        self.sent = None
        self._made = {}

    def shape(self, i):
        cols = self.tables[i]
        return (len(cols) * self.Z * self.ny * self.nx,
                len(cols[0]) * self.k)

    def table(self, device, i):
        """Table ``i`` on ``device``: the window's first table asked for
        there uploads the missing frames and assembles every table; each is
        handed out once."""
        key = _device_key(device)
        made = self._made.get(key)
        if made is None or made[i] is None:
            srcs, self.sent = self.store.take(key, self.frames)
            made = pack_window(srcs, self.tables, self.Z, self.ny, self.nx,
                               self.k, self.dtype)
            self._made[key] = made
        table, made[i] = made[i], None
        if all(t is None for t in made):
            del self._made[key]
        return table

    def host_table(self, i):
        """Table ``i`` assembled on the host (:func:`assemble_rows_plain`),
        as numpy."""
        srcs = [_host_tensor(a) for _, _, a in self.frames]
        return assemble_rows_plain(srcs, self.tables[i], self.Z, self.ny,
                                   self.nx, self.k, self.dtype).numpy()


class WindowTable:
    """One table of a :class:`PackWindow` in a reader's host state: goes to
    a device with :meth:`to` (``interop.device_state_from_numpy``), and is
    assembled on the host where it is read as an array."""

    def __init__(self, window, index):
        self.window = window
        self.index = index

    @property
    def shape(self):
        return self.window.shape(self.index)

    @property
    def dtype(self):
        return np.dtype(str(self.window.dtype).replace("torch.", ""))

    def to(self, device):
        return self.window.table(device, self.index)

    def __array__(self, dtype=None, copy=None):
        a = self.window.host_table(self.index)
        return a if dtype is None else a.astype(dtype)
