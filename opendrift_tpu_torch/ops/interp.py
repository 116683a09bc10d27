"""Packed-row field sampling and host-side field preparation.

Port of ``opendrift_tpu/ops/interp.py``.  The host packs, for every
(z, y, x) cell of a reader's grid, all variables x all window frames plus
the neighbour cells of the interpolation stencil into one row of a
(Z*Y*X, C*k) table (``fields/grid.py``); a sample is then a few row
gathers and a blend.  The four tiers, chosen from the table's bytes:

* 'xyz' (k = 8): the row holds the full trilinear stencil, x+1/y+1/z+1
  included, so a 3D sample is ONE gather;
* 'xy' (k = 4): the bilinear stencil, one gather per bracketing z-plane;
* 'x' (k = 2): the x pair, one gather per (z-plane, y row): 4;
* 'none' (k = 1): one gather per corner: 8.

A corner block (:meth:`PackedSampler.gather_corner_block`) is the z-blended
2x2 stencil of a cell gathered once and evaluated again at nearby
positions with no further gather: the single-fetch RK stages and the
'block' coastline probes.

Storage: a plain float32 or float16 tensor, a :class:`CompensatedTable`
(pairs of float16, float32 accuracy to ~2^-21) or a :class:`SplitTable`
(the same bits in narrower integer columns); :func:`take_rows` gathers and
reassembles.  The gather itself stays the framework's (``index_select``,
``ops/gather.gather_rows_plain``), as the JAX package leaves it to XLA;
the hand-written gathers of ``ops/gather.py`` are measured against it by
``tools/gather_ab.py`` (a fused Hopper sampler is ROADMAP D.1).

Frame times stay on the host: the step time ``t`` is one float32 scalar,
so the bracketing frame and its weight are computed there in float32
(:func:`time_weights`), exactly as the JAX package computes them.
"""

import os

import numpy as np
import torch

from .gather import gather_rows_plain
from ..utils import native

# The JAX package's thresholds, kept so that both packages build the same
# tables from the same forcing: rows from which a 4-byte table counts as
# large (a warning, or compensated storage where a reader opts in), the
# column bytes under which a table is never split, and the row count up to
# which a split goes to single bytes.  They are storage decisions only; how
# fast this card gathers each storage is measured by tools/gather_ab.py.
GATHER_FAST_MAX_ROWS = 1 << 15
_CLIFF_COL_BYTES = 1 << 20
_U8_MAX_ROWS = 660_000

_TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
             "int32": torch.int32, "int16": torch.int16}


def _tensor_on(a, device):
    return a.to(device) if torch.is_tensor(a) \
        else torch.as_tensor(np.ascontiguousarray(a), device=device)


class SplitTable:
    """A (rows, C) packed table stored bit-split as (rows, C*factor) of a
    narrower integer type; :func:`take_rows` reassembles the original rows
    bit for bit after the gather.  Presents the LOGICAL shape and dtype.

    ``data`` holds the bits as int16 or uint8 (the JAX package stores
    uint16/uint8: torch has few uint16 kernels, and the bits are equal),
    as a host array until :meth:`to` puts it on a device; ``dtype`` is the
    logical type's name ('float32', 'float16', ...)."""

    def __init__(self, data, factor, dtype):
        self.data = data
        self.factor = int(factor)
        self.dtype_name = str(np.dtype(dtype)) if not isinstance(dtype, str) \
            else dtype

    @classmethod
    def from_array(cls, arr, store):
        """``store``: 'u16' or 'u8'."""
        arr = np.ascontiguousarray(arr)
        store_dtype = {"u16": np.int16, "u8": np.uint8}[store]
        factor = arr.dtype.itemsize // np.dtype(store_dtype).itemsize
        if factor < 1:
            raise ValueError(f"cannot split {arr.dtype} into {store}")
        return cls(arr.view(store_dtype).reshape(arr.shape[0], -1), factor,
                   arr.dtype)

    @property
    def shape(self):
        return (self.data.shape[0], self.data.shape[1] // self.factor)

    @property
    def dtype(self):
        return _TORCH_OF[self.dtype_name]

    def to(self, device):
        return SplitTable(_tensor_on(self.data, device), self.factor,
                          self.dtype_name)


def maybe_split_table(arr, force=None):
    """Wrap a host packed table in :class:`SplitTable`.  ``force``:
    'u16'/'u8' always split, False never; with ``force=None`` the JAX
    package's thresholds decide (never called automatically by the
    sampler, as there)."""
    if force is False or os.environ.get("OPENDRIFT_NO_SPLIT_TABLE") == "1":
        return arr
    if force in ("u16", "u8"):
        return SplitTable.from_array(arr, force)
    rows = arr.shape[0]
    isz = arr.dtype.itemsize
    if rows * isz < _CLIFF_COL_BYTES:
        return arr
    if isz >= 4 and rows * 2 <= _CLIFF_COL_BYTES:
        return SplitTable.from_array(arr, "u16")
    if rows <= _U8_MAX_ROWS:
        return SplitTable.from_array(arr, "u8")
    return arr


class CompensatedTable:
    """A (rows, C) float32 packed table stored as (rows, 2C) float16 in
    ``[hi | lo]`` block layout, ``hi = f16(x)`` and ``lo = f16(x - hi)``:
    the bytes of float32 in 2-byte elements.  Reconstruction after the
    gather is one widen-add; the representation error is about
    2^-21 x |x|.  Opt in per reader: ``reader.packed_dtype = 'float16x2'``.

    ``data`` and ``scale`` ((1, C) float32, exact powers of two) are host
    arrays until :meth:`to` puts them on a device."""

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    @classmethod
    def from_array(cls, arr):
        """Columns are pre-scaled by an exact power of two into [0, ~1024]
        so that fields far outside float16's range keep the full relative
        accuracy; power-of-two scaling is error-free."""
        arr = np.asarray(arr, dtype=np.float32)
        with np.errstate(all="ignore"):
            colmax = np.nanmax(np.abs(arr), axis=0)
        colmax = np.where(np.isfinite(colmax) & (colmax > 0), colmax, 1.0)
        scale = np.exp2(np.ceil(np.log2(colmax)) - 10.0).astype(
            np.float32)[None, :]
        scaled = (arr / scale).astype(np.float32)
        with np.errstate(over="ignore"):
            hi = scaled.astype(np.float16)
            lo = (scaled - hi.astype(np.float32)).astype(np.float16)
        return cls(np.concatenate([hi, lo], axis=1), scale)

    @property
    def shape(self):
        return (self.data.shape[0], self.data.shape[1] // 2)

    @property
    def dtype(self):
        return torch.float32

    def to(self, device):
        return CompensatedTable(_tensor_on(self.data, device),
                                _tensor_on(self.scale, device))


def take_rows(packed, lin):
    """The packed-table row gather, indices clamped like ``mode='clip'``,
    plus, for :class:`SplitTable` / :class:`CompensatedTable` storage, the
    reassembly of the original rows."""
    if isinstance(packed, CompensatedTable):
        g = gather_rows_plain(packed.data, lin)
        C = packed.data.shape[1] // 2
        # the JAX order, in float32: (hi + lo) * scale
        return (g[:, :C].to(torch.float32)
                + g[:, C:].to(torch.float32)) * packed.scale
    if isinstance(packed, SplitTable):
        # the gather's output is contiguous, so the view regroups each
        # run of ``factor`` storage elements into one logical element
        return gather_rows_plain(packed.data, lin).view(packed.dtype)
    return gather_rows_plain(packed, lin)


def time_weights(times, t, F):
    """Bracketing frame index (int) and linear weight (float32) for the
    host time ``t`` in the host float32 ``times`` (clamped)."""
    times = np.asarray(times, dtype=np.float32)
    t = np.float32(t)
    ti = int(np.clip(np.searchsorted(times, t, side="right") - 1, 0,
                     max(F - 2, 0)))
    if F < 2:
        return ti, np.float32(0.0)
    denom = times[ti + 1] - times[ti]
    tw = (t - times[ti]) / denom if denom != 0 else np.float32(0.0)
    return ti, np.float32(np.clip(tw, 0.0, 1.0))


def _xy_cell(xi, yi, X, Y):
    """Cell index and in-cell fractions (N, 1) of fractional indices."""
    x0 = torch.clamp(torch.floor(xi).to(torch.int32), 0, max(X - 2, 0))
    y0 = torch.clamp(torch.floor(yi).to(torch.int32), 0, max(Y - 2, 0))
    fx = torch.clamp(xi - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(yi - y0, 0.0, 1.0)[:, None]
    return x0, y0, fx, fy


def _z_bracket(depth, depths, Z, like):
    """Upper bracketing level and weight (N, 1) of ``depth`` in the
    ascending ``depths``; (zeros, None) for a single level."""
    if Z > 1:
        z0 = torch.clamp(torch.searchsorted(depths, depth, right=True) - 1,
                         0, Z - 2)
        dz = depths[z0 + 1] - depths[z0]
        fz = torch.where(dz != 0, (depth - depths[z0]) / dz, 0.0)
        return z0, torch.clamp(fz, 0.0, 1.0)[:, None]
    return torch.zeros_like(like), None


def interp_xyzt(blocks, times, xi, yi, depth, depths, t):
    """Interpolate a stacked 3D block group: 16 corner gathers.

    blocks: float32 (V, F, Z, Y, X); times: host float32 (F,); depths:
    float32 (Z,) ascending; xi, yi: fractional indices (N,); depth: (N,)
    positive down; t: host scalar.  Returns float32 (V, N)."""
    V, F, Z, Y, X = blocks.shape
    ti, tw = time_weights(times, t, F)
    x0, y0, fx, fy = _xy_cell(xi, yi, X, Y)
    fx, fy = fx[:, 0], fy[:, 0]
    z0, fz = _z_bracket(depth, depths, Z, x0)
    fz = torch.zeros_like(fx) if fz is None else fz[:, 0]
    x1 = torch.clamp_max(x0 + 1, X - 1)
    y1 = torch.clamp_max(y0 + 1, Y - 1)
    z1 = torch.clamp_max(z0 + 1, Z - 1)
    flat = blocks.reshape(V, F * Z * Y * X)

    def gather(tt, zz, yy, xx):
        lin = ((tt * Z + zz.to(torch.int64)) * Y + yy) * X + xx
        return flat.index_select(1, lin)

    wt1 = float(tw)
    wt0 = float(np.float32(1.0) - tw)
    out = torch.zeros((V,) + tuple(xi.shape), dtype=blocks.dtype,
                      device=blocks.device)
    for tt, wt in ((ti, wt0), (min(ti + 1, F - 1), wt1)):
        for zz, wz in ((z0, 1.0 - fz), (z1, fz)):
            acc = (gather(tt, zz, y0, x0) * ((1.0 - fy) * (1.0 - fx))
                   + gather(tt, zz, y0, x1) * ((1.0 - fy) * fx)
                   + gather(tt, zz, y1, x0) * (fy * (1.0 - fx))
                   + gather(tt, zz, y1, x1) * (fy * fx))
            out = out + acc * (wz * wt)
    return out


def interp_nearest_xyt(blocks, times, xi, yi, t):
    """Nearest-neighbour sample of a (V, F, Y, X) block group, for
    discrete masks (reference interpolation/structured.py:117-119)."""
    V, F, Y, X = blocks.shape
    ti, tw = time_weights(times, t, F)
    if tw > 0.5:
        ti = min(ti + 1, F - 1)
    x0 = torch.clamp(torch.round(xi).to(torch.int64), 0, X - 1)
    y0 = torch.clamp(torch.round(yi).to(torch.int64), 0, Y - 1)
    return blocks.reshape(V, F * Y * X).index_select(
        1, (ti * Y + y0) * X + x0)


class PackedSampler:
    """Static metadata + gathers for the packed-row layout (see the module
    docstring).  ``col_of``: variable -> (first column, kind) with kind
    't' (one column per frame), 'static' (one column, bilinear) or 'near'
    (one column, nearest corner).  ``pair_mode``: 'xyz' | 'xy' | 'x' |
    'none', chosen by the host packer from the table's bytes."""

    PAIR_FACTOR = {"none": 1, "x": 2, "xy": 4, "xyz": 8}

    def __init__(self, Z, Y, X, n_frames, col_of, pair_mode):
        if pair_mode is True or pair_mode is False:      # legacy bool
            pair_mode = "x" if pair_mode else "none"
        if pair_mode not in self.PAIR_FACTOR:
            raise ValueError(f"unknown packed tier {pair_mode!r}")
        self.Z, self.Y, self.X = Z, Y, X
        self.F = n_frames
        self.col_of = col_of
        self.pair_mode = pair_mode
        self._cols = {}

    def _lin(self, zz, yy, xx, row_offset):
        return (zz.to(torch.int64) * self.Y + yy) * self.X + xx + row_offset

    def _column_index(self, cols, device):
        """The column subset as a tensor on ``device`` (kept: the subset
        is the same every step)."""
        key = (tuple(cols), str(device))
        if key not in self._cols:
            self._cols[key] = torch.as_tensor(np.asarray(cols, np.int64),
                                              device=device)
        return self._cols[key]

    def gather_rows(self, packed, xi, yi, depth, depths, row_offset=0,
                    nearest_cols=None):
        """Gather and spatially interpolate rows -> (N, C/k) with the
        vertical bracketing applied: 1 ('xyz'), 2 ('xy'), 4 ('x') or 8
        ('none') row gathers.  ``row_offset``: per-element row offset into
        ``packed``.  ``nearest_cols``: columns also returned nearest-corner
        sampled (masks), from the same gathers; then returns
        (rows, {col: float32[N]})."""
        Z, Y, X = self.Z, self.Y, self.X
        x0, y0, fx, fy = _xy_cell(xi, yi, X, Y)
        z0, fz = _z_bracket(depth, depths, Z, x0)
        q = packed.shape[-1] // self.PAIR_FACTOR[self.pair_mode]
        near = {}

        def near_select(g_y0_a, g_y0_b, g_y1_a, g_y1_b):
            # nearest corner of the 2x2 stencil (x halves a/b per y row)
            for c in (nearest_cols or ()):
                gy0 = torch.where(fx[:, 0] > 0.5, g_y0_b[:, c], g_y0_a[:, c])
                gy1 = torch.where(fx[:, 0] > 0.5, g_y1_b[:, c], g_y1_a[:, c])
                near[c] = torch.where(fy[:, 0] > 0.5, gy1, gy0).to(
                    torch.float32)

        if self.pair_mode in ("xyz", "xy"):
            def blend(h):
                row_y0 = h[:, :q] * (1.0 - fx) + h[:, q:2 * q] * fx
                row_y1 = h[:, 2 * q:3 * q] * (1.0 - fx) \
                    + h[:, 3 * q:4 * q] * fx
                return row_y0 * (1.0 - fy) + row_y1 * fy

            g = take_rows(packed, self._lin(z0, y0, x0, row_offset))
            near_select(g[:, :q], g[:, q:2 * q], g[:, 2 * q:3 * q],
                        g[:, 3 * q:4 * q])
            out = blend(g[:, :4 * q])
            if Z > 1:
                if self.pair_mode == "xyz":
                    upper = blend(g[:, 4 * q:])
                else:
                    upper = blend(take_rows(packed, self._lin(
                        torch.clamp_max(z0 + 1, Z - 1), y0, x0, row_offset)))
                out = out * (1.0 - fz) + upper * fz
            return (out, near) if nearest_cols else out

        y1 = torch.clamp_max(y0 + 1, Y - 1)
        if self.pair_mode == "x":
            def corner_raw(zz, yy):
                g = take_rows(packed, self._lin(zz, yy, x0, row_offset))
                return g[:, :q], g[:, q:]
        else:
            x1 = torch.clamp_max(x0 + 1, X - 1)

            def corner_raw(zz, yy):
                return (take_rows(packed, self._lin(zz, yy, x0, row_offset)),
                        take_rows(packed, self._lin(zz, yy, x1, row_offset)))

        def corner_of(raw):
            return raw[0] * (1.0 - fx) + raw[1] * fx

        raw00 = corner_raw(z0, y0)
        raw01 = corner_raw(z0, y1)
        near_select(raw00[0], raw00[1], raw01[0], raw01[1])
        out = corner_of(raw00) * (1.0 - fy) + corner_of(raw01) * fy
        if Z > 1:
            z1 = torch.clamp_max(z0 + 1, Z - 1)
            rz1 = corner_of(corner_raw(z1, y0)) * (1.0 - fy) \
                + corner_of(corner_raw(z1, y1)) * fy
            out = out * (1.0 - fz) + rz1 * fz
        return (out, near) if nearest_cols else out

    def gather_corner_block(self, packed, xi, yi, depth, depths,
                            row_offset=0, keep_vars=None):
        """Gather the z-blended 2x2 (y x x-pair) stencil at the cell of
        (xi, yi) WITHOUT applying the x/y interpolation: rows that
        :meth:`eval_corner_block` re-evaluates at nearby positions with no
        further gather.  Needs pair_mode 'x', 'xy' or 'xyz'; gathers per
        block: 'x' 2 per z-plane, 'xy' 1 per z-plane, 'xyz' 1.  Returns
        (g_y0, g_y1, x0, y0, block_col_of), each g (N, 2 * kept columns)
        laid out [base | x+1].

        ``keep_vars``: keep only these variables' columns in the held
        block (the gather still reads full rows)."""
        if self.pair_mode not in ("x", "xy", "xyz"):
            raise ValueError("corner blocks need x-paired rows, not tier "
                             f"{self.pair_mode!r}")
        Z, Y, X = self.Z, self.Y, self.X
        x0, y0, _, _ = _xy_cell(xi, yi, X, Y)
        z0, fz = _z_bracket(depth, depths, Z, x0)
        q = packed.shape[-1] // self.PAIR_FACTOR[self.pair_mode]
        if keep_vars is not None:
            sub_cols = []
            block_col_of = {}
            for v in keep_vars:
                c0, kind = self.col_of[v]
                block_col_of[v] = (len(sub_cols), kind)
                n = 1 if kind in ("static", "near") else self.F
                sub_cols.extend(range(c0, c0 + n))
            cols = sub_cols + [c + q for c in sub_cols]   # base + x+1 halves
        else:
            cols = None
            block_col_of = self.col_of

        def halves(g, off):
            """The [base | x+1] and [y+1 | x+1,y+1] halves of an xy block
            starting at column ``off``, subset to the kept columns."""
            if cols is not None:
                idx = self._column_index(cols, g.device)
                return (g.index_select(1, idx + off),
                        g.index_select(1, idx + (off + 2 * q)))
            return g[:, off:off + 2 * q], g[:, off + 2 * q:off + 4 * q]

        def zblend(lo, hi):
            return lo * (1.0 - fz) + hi * fz

        if self.pair_mode == "xyz":
            g = take_rows(packed, self._lin(z0, y0, x0, row_offset))
            g_y0, g_y1 = halves(g, 0)
            if Z > 1:
                h_y0, h_y1 = halves(g, 4 * q)
                g_y0, g_y1 = zblend(g_y0, h_y0), zblend(g_y1, h_y1)
            return g_y0, g_y1, x0, y0, block_col_of
        if self.pair_mode == "xy":
            g_y0, g_y1 = halves(
                take_rows(packed, self._lin(z0, y0, x0, row_offset)), 0)
            if Z > 1:
                h_y0, h_y1 = halves(
                    take_rows(packed, self._lin(z0 + 1, y0, x0, row_offset)),
                    0)
                g_y0, g_y1 = zblend(g_y0, h_y0), zblend(g_y1, h_y1)
            return g_y0, g_y1, x0, y0, block_col_of

        y1 = torch.clamp_max(y0 + 1, Y - 1)

        def corner(zz, yy):
            g = take_rows(packed, self._lin(zz, yy, x0, row_offset))
            if cols is not None:
                return g.index_select(1, self._column_index(cols, g.device))
            return g[:, :2 * q]
        if Z == 1:
            # no vertical bracketing: the held block keeps the packed type
            g_y0 = corner(z0, y0)
            g_y1 = corner(z0, y1)
        else:
            g_y0 = zblend(corner(z0, y0), corner(z0 + 1, y0))
            g_y1 = zblend(corner(z0, y1), corner(z0 + 1, y1))
        return g_y0, g_y1, x0, y0, block_col_of

    def eval_corner_block(self, block, xi, yi, times, t, varnames):
        """Evaluate a gathered corner block at (xi, yi): blends only, no
        gathers.  Positions outside the gathered cell are clamped to its
        edge (bounded extrapolation; RK stage displacements are well under
        one cell).  Variables of kind 'near' (masks) are corner-selected
        from the raw halves, like the nearest sampling of gather_rows."""
        g_y0, g_y1, x0, y0, block_col_of = block
        q = g_y0.shape[1] // 2
        fx = torch.clamp(xi - x0, 0.0, 1.0)[:, None]
        fy = torch.clamp(yi - y0, 0.0, 1.0)[:, None]
        near = [v for v in varnames if block_col_of[v][1] == "near"]
        rest = [v for v in varnames if block_col_of[v][1] != "near"]
        out = {}
        if rest:
            # blend only the requested columns: RK stages ask for u/v out
            # of a block that also carries the rest of the environment
            sel = []
            sub_col_of = {}
            for v in rest:
                c0, kind = block_col_of[v]
                n = 1 if kind in ("static", "near") else self.F
                sub_col_of[v] = (len(sel), kind)
                sel.extend(range(c0, c0 + n))
            if sel == list(range(sel[0], sel[0] + len(sel))):
                lo, hi = sel[0], sel[0] + len(sel)     # one run: slices
                a0, b0 = g_y0[:, lo:hi], g_y0[:, q + lo:q + hi]
                a1, b1 = g_y1[:, lo:hi], g_y1[:, q + lo:q + hi]
            else:
                idx = self._column_index(sel, g_y0.device)
                a0, b0 = g_y0.index_select(1, idx), \
                    g_y0.index_select(1, idx + q)
                a1, b1 = g_y1.index_select(1, idx), \
                    g_y1.index_select(1, idx + q)
            row0 = a0 * (1.0 - fx) + b0 * fx
            row1 = a1 * (1.0 - fx) + b1 * fx
            rows = row0 * (1.0 - fy) + row1 * fy
            # the sub-table is passed, not swapped into self.col_of: a
            # sampler is shared with the thread that packs the next window
            out.update(self.values(rows, times, t, rest, col_of=sub_col_of))
        for v in near:
            c = block_col_of[v][0]
            gy0 = torch.where(fx[:, 0] > 0.5, g_y0[:, q + c], g_y0[:, c])
            gy1 = torch.where(fx[:, 0] > 0.5, g_y1[:, q + c], g_y1[:, c])
            out[v] = torch.where(fy[:, 0] > 0.5, gy1, gy0).to(torch.float32)
        return out

    def values(self, rows, times, t, varnames, col_of=None):
        """Blend the bracketing frame columns per variable (``col_of``:
        the column table of ``rows`` where it is not the sampler's)."""
        col_of = self.col_of if col_of is None else col_of
        F = self.F
        ti, tw = time_weights(times, t, F)
        w0, w1 = float(np.float32(1.0) - tw), float(tw)
        out = {}
        for v in varnames:
            col, kind = col_of[v]
            if kind == "static":
                out[v] = rows[:, col]
            else:
                v0 = rows[:, col + ti]
                v1 = rows[:, col + min(ti + 1, F - 1)]
                out[v] = v0 * w0 + v1 * w1
        return out


# ------------------------------------------------------------ host prep --

def fill_route():
    """Which NaN fill the host takes: 'native' (the chamfer transform of
    ``csrc/fieldpipe.cpp``, built on first use, as in the JAX package) or
    'scipy' (the fallback where g++ failed; logged at WARNING)."""
    return "native" if native.get_lib() is not None else "scipy"


def fill_invalid(field):
    """Replace NaNs with the nearest valid value (2D horizontal fill, per
    slice), host side at frame load.  Returns (filled, any_valid).

    As the JAX package's: the native chamfer fill (a slice with no valid
    value becomes 0), and only where it cannot be built (:func:`fill_route`)
    scipy's Euclidean fill (which leaves such a slice NaN and picks another
    nearest cell where distances differ little)."""
    out = np.ascontiguousarray(field, dtype=np.float32).copy()
    any_valid = bool(np.isfinite(out).any())
    if not np.isfinite(out).all() and not native.fill_nearest(out):
        from scipy.ndimage import distance_transform_edt
        flat = out.reshape(-1, *out.shape[-2:])
        for i in range(flat.shape[0]):
            sl = flat[i]
            mask = ~np.isfinite(sl)
            if mask.all() or not mask.any():
                continue
            idx = distance_transform_edt(mask, return_distances=False,
                                         return_indices=True)
            flat[i] = sl[tuple(idx)]
    return out, any_valid


def fill_towards_seafloor(block):
    """Propagate the deepest valid value downward along z (reference
    interpolation/structured.py:50-71); ``block`` is (Z, Y, X) with z
    index 0 at the surface."""
    out = np.ascontiguousarray(block, dtype=np.float32).copy()
    if native.fill_seafloor(out):
        return out
    for k in range(1, out.shape[0]):
        nan = ~np.isfinite(out[k])
        out[k][nan] = out[k - 1][nan]
    return out
