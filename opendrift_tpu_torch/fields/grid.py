"""Structured (regular-grid) readers: host packing + device sampling.

Port of ``opendrift_tpu/fields/grid.py`` (reference: opendrift/readers/
basereader/structured.py:15-628, interpolation/structured.py:12-186):

* Host side: a subclass reads raw frames (``_read_frame``); the base
  scrubs, NaN-fills and subsets them to the simulation extent with a
  speed-derived halo, and hands a fixed-shape window of frames over in the
  row layout of ``ops/interp.PackedSampler`` — the same tier choice,
  column layout and neighbour packing as the JAX package, so both build
  equal tables.  The tables are assembled where they go
  (``ops/pack.py``): on the card by a kernel, from the frames the card
  holds already and the window's new ones, so a window sends only its new
  frames; the storages a consumer needs built on the host (compensated,
  split, a decomposed run's) are assembled on the host.
* Device side: ``sample`` projects positions to fractional grid indices
  and gathers/blends rows; ``corner_block`` gathers a cell's stencil once
  for ``sample_from_block`` / ``uv_from_block`` to evaluate at displaced
  positions (single-fetch RK, 'block' coastline probes);
  ``sample_profiles`` samples fixed z-levels.

Storage per reader: ``packed_dtype`` 'float32' (default), 'float16' (half
the bytes, relative error ~1e-3) or 'float16x2' (compensated float16
pairs, ~2^-21); ``packed_auto_compensate`` lets a reader take the
compensated storage for large tables by itself.  Ensemble forcing packs
its members one after the other and serves them round-robin by element ID
(the ``member`` channel).  ``set_convolution_kernel`` smooths frames on
the host at load.

Domain decomposition (``parallel/tiled.py``): a tiled reader keeps its
packed table on the host (``_dd_keep_host``) for the run to split into
per-tile core bands, or, with ``_dd_defer_pack`` (several processes, or
``OPENDRIFT_DD_PER_HOST_READS=1``), builds no full table at all: each
process reads only its bands through :meth:`packed_rows`.  Inside a tile
the sampler's geometry is the tile's extended band, and ``_local_idx``
shifts global grid indices by the tile's ``y_off``/``x_off``.
"""

import logging
import os
from datetime import timedelta

import numpy as np
import torch

from .base import BaseReader, STANDARD_NAMES
from ..ops.interp import (fill_invalid, fill_towards_seafloor, PackedSampler,
                          CompensatedTable, GATHER_FAST_MAX_ROWS,
                          maybe_split_table, take_rows)
from ..ops.pack import PackWindow, ResidentFrames, WindowTable
from ..utils.xp import tnp

logger = logging.getLogger(__name__)

# variables sampled with nearest-neighbour rather than bilinear
NEAREST_VARIABLES = {"land_binary_mask"}
# variables with no time dependence (sampled from frame 0)
STATIC_VARIABLES = {"land_binary_mask", "sea_floor_depth_below_sea_level"}
# the row-table budget that picks the packing tier (grid.py:336-363 of the
# JAX package; the same number keeps the two packages' tables equal)
ROW_BUDGET_BYTES = 256e6
UV = ("x_sea_water_velocity", "y_sea_water_velocity")
TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16}


def choose_pair_mode(Z, ny, nx, C, want_xy):
    """The neighbour-packing tier of a (Z, ny, nx) grid with C columns a
    cell: the widest tier whose table stays under the row budget ('xyz'
    and 'xy' only where the model asked for them with ``want_xy``)."""
    base_bytes = Z * ny * nx * max(C, 1) * 4
    if C > 0 and Z > 1 and base_bytes * 8 < ROW_BUDGET_BYTES and want_xy:
        return "xyz"
    if C > 0 and base_bytes * 4 < ROW_BUDGET_BYTES and want_xy:
        return "xy"
    if C > 0 and base_bytes * 2 < ROW_BUDGET_BYTES:
        return "x"
    return "none"


class StructuredGridReader(BaseReader):
    """Base for readers on regular (equidistant x/y) grids.

    Subclasses set, before ``super().__init__()``: ``self.x``, ``self.y``
    (1D, equidistant), ``self.times`` (datetimes), ``self.depths`` (1D
    positive-down ascending, or None), ``self.proj4``, ``self.variables``
    and ``self._var_has_z``, and implement ``_read_frame(stdname,
    time_index, zslice, yslice, xslice)`` returning (Z, y, x) or (y, x).
    """

    def __init__(self):
        x = np.asarray(self.x, dtype=np.float64)
        y = np.asarray(self.y, dtype=np.float64)
        self._flip_x = x[0] > x[-1] if len(x) > 1 else False
        self._flip_y = y[0] > y[-1] if len(y) > 1 else False
        if self._flip_x:
            x = x[::-1]
        if self._flip_y:
            y = y[::-1]
        for name, ax in (("x", x), ("y", y)):
            if len(ax) > 1:
                d = np.diff(ax)
                if d.max() - d.min() > 0.01 * abs(d.mean()):
                    raise ValueError(
                        f"{self.name}: {name} axis is not equidistant")
        self.x = x
        self.y = y
        self.delta_x = float(x[1] - x[0]) if len(x) > 1 else 1.0
        self.delta_y = float(y[1] - y[0]) if len(y) > 1 else 1.0
        self.xmin, self.xmax = float(x[0]), float(x[-1])
        self.ymin, self.ymax = float(y[0]), float(y[-1])
        self.times = list(self.times)
        self.start_time = self.times[0]
        self.end_time = self.times[-1]
        if len(self.times) > 1:
            deltas = [(b - a).total_seconds()
                      for a, b in zip(self.times[:-1], self.times[1:])]
            self.time_step = timedelta(seconds=min(deltas))
        else:
            self.time_step = None
        if getattr(self, "depths", None) is not None:
            self.depths = np.asarray(self.depths, dtype=np.float32)
        self._window_frames = 2
        self._ix = slice(0, len(x))
        self._iy = slice(0, len(y))
        self._frame_cache = {}
        self._max_cached_frames = 64
        self._group3 = [v for v in self.variables
                        if self._var_has_z.get(v)
                        and v not in STATIC_VARIABLES]
        self._group2 = [v for v in self.variables
                        if not self._var_has_z.get(v)
                        and v not in STATIC_VARIABLES]
        self._groups = [v for v in self.variables if v in STATIC_VARIABLES]
        super().__init__()

    # ------------------------------------------------------------ prepare
    def prepare(self, extent=None, start_time=None, end_time=None,
                max_speed=None, interval_seconds=None, variables=None):
        """Subset the grid to the simulation extent with a halo, restrict
        the loaded variables to those required, and fix the per-window
        frame count."""
        if variables is not None:
            wanted = [v for v in self.variables if v in variables]
            self._group3 = [v for v in self._group3 if v in wanted]
            self._group2 = [v for v in self._group2 if v in wanted]
            self._groups = [v for v in self._groups if v in wanted]
        if extent is not None and max_speed is not None:
            lonmin, latmin, lonmax, latmax = extent
            lons = np.array([lonmin, lonmax, lonmin, lonmax,
                             (lonmin + lonmax) / 2, lonmin, lonmax,
                             (lonmin + lonmax) / 2])
            lats = np.array([latmin, latmin, latmax, latmax, latmin,
                             (latmin + latmax) / 2, (latmin + latmax) / 2,
                             latmax])
            xs, ys = self.lonlat2xy(lons, lats)
            xs = np.asarray(xs, dtype=np.float64)
            ys = np.asarray(ys, dtype=np.float64)
            if not np.isfinite(xs).all() or not np.isfinite(ys).all():
                xs = np.concatenate([xs[np.isfinite(xs)],
                                     [self.x[0], self.x[-1]]])
                ys = np.concatenate([ys[np.isfinite(ys)],
                                     [self.y[0], self.y[-1]]])
            dt_r = (self.time_step.total_seconds()
                    if self.time_step else 3600.0)
            halo_x = int(abs(max_speed * dt_r / self.delta_x)) + 2
            halo_y = int(abs(max_speed * dt_r / self.delta_y)) + 2
            ix0 = int(np.clip((np.nanmin(xs) - self.x[0]) / self.delta_x
                              - halo_x, 0, len(self.x) - 2))
            ix1 = int(np.clip((np.nanmax(xs) - self.x[0]) / self.delta_x
                              + halo_x + 2, ix0 + 2, len(self.x)))
            iy0 = int(np.clip((np.nanmin(ys) - self.y[0]) / self.delta_y
                              - halo_y, 0, len(self.y) - 2))
            iy1 = int(np.clip((np.nanmax(ys) - self.y[0]) / self.delta_y
                              + halo_y + 2, iy0 + 2, len(self.y)))
            new_ix, new_iy = slice(ix0, ix1), slice(iy0, iy1)
            if (new_ix, new_iy) != (self._ix, self._iy):
                self._frame_cache.clear()
            self._ix = new_ix
            self._iy = new_iy
        if interval_seconds is not None and self.time_step is not None:
            self._window_frames = min(
                len(self.times),
                int(np.ceil(interval_seconds
                            / self.time_step.total_seconds())) + 2)
        else:
            self._window_frames = min(len(self.times), 2)

    # ----------------------------------------------------------- windows -
    def _frame_indices(self, window_start, window_end):
        F = self._window_frames
        n = len(self.times)
        if window_start is None:
            i0 = 0
        else:
            i0 = np.searchsorted(
                np.array([t.timestamp() for t in self.times]),
                window_start.timestamp(), side="right") - 1
        i0 = int(np.clip(i0, 0, max(n - F, 0)))
        return list(range(i0, min(i0 + F, n)))

    def set_convolution_kernel(self, convolve):
        """Smooth every loaded frame with a convolution kernel: an int N
        (N x N box) or a 2D array (reference structured.py:163-192), on the
        host at frame load, before packing."""
        if convolve is None:
            self._convolve_kernel = None
        else:
            if isinstance(convolve, (int, np.integer)):
                kernel = np.ones((int(convolve), int(convolve)))
            else:
                kernel = np.asarray(convolve, dtype=np.float64)
            self._convolve_kernel = kernel / kernel.sum()
        self._frame_cache.clear()

    def _load_frame(self, std, ti, member=0):
        """Scrubbed, NaN-filled frame (host, cached)."""
        key = (std, ti, member)
        if key in self._frame_cache:
            return self._frame_cache[key]
        if getattr(self, "ensemble_size", 1) > 1:
            raw = self._read_frame(std, ti, slice(None), self._iy, self._ix,
                                   member)
        else:
            raw = self._read_frame(std, ti, slice(None), self._iy, self._ix)
        arr = np.asarray(raw, dtype=np.float32)
        if self._flip_x:
            arr = arr[..., ::-1]
        if self._flip_y:
            arr = arr[..., ::-1, :]
        arr = self._scrub_frame(std, arr)
        if len(self._frame_cache) > self._max_cached_frames:
            self._frame_cache.clear()
        self._frame_cache[key] = arr
        return arr

    def _load_frame_rows(self, std, ti, member, r0, r1, ctx=8):
        """Per-process band read: load, scrub and return only subset rows
        [r0, r1) of a frame (indices relative to the ``_iy`` subset, in
        ascending-y orientation).  ``ctx`` context rows either side let
        the nearest-valid NaN fill see its neighbourhood before the crop.
        ``r1`` may pass the grid (tile padding): the band is then
        edge-replicated to ``r1 - r0`` rows."""
        iy = self._iy
        ny = iy.stop - iy.start
        if r0 >= ny:                      # band entirely past the grid
            last = self._load_frame_rows(std, ti, member, ny - 1, ny, ctx)
            return np.repeat(last, r1 - r0, axis=-2)
        rr1 = min(r1, ny)
        c0, c1 = max(0, r0 - ctx), min(ny, rr1 + ctx)
        if self._flip_y:
            # ascending rows [c0, c1) are source rows [ny - c1, ny - c0)
            ys = slice(iy.start + ny - c1, iy.start + ny - c0)
        else:
            ys = slice(iy.start + c0, iy.start + c1)
        if getattr(self, "ensemble_size", 1) > 1:
            raw = self._read_frame(std, ti, slice(None), ys, self._ix,
                                   member)
        else:
            raw = self._read_frame(std, ti, slice(None), ys, self._ix)
        arr = np.asarray(raw, dtype=np.float32)
        if self._flip_x:
            arr = arr[..., ::-1]
        if self._flip_y:
            arr = arr[..., ::-1, :]
        arr = self._scrub_frame(std, arr)
        band = arr[..., r0 - c0:rr1 - c0, :]
        if rr1 < r1:                      # pad past the grid edge
            reps = np.repeat(band[..., -1:, :], r1 - rr1, axis=-2)
            band = np.concatenate([band, reps], axis=-2)
        return band

    def _scrub_frame(self, std, arr):
        """Valid-range scrub, NaN fill and the optional convolution
        (reference interpolation/structured.py:50-71,
        variables.py:630-668)."""
        rng = STANDARD_NAMES.get(std)
        if std in NEAREST_VARIABLES:
            return np.nan_to_num(arr, nan=1.0)  # unknown -> land
        if rng is not None:
            bad = (arr < rng["valid_min"]) | (arr > rng["valid_max"])
            arr = np.where(bad, np.nan, arr)
        if arr.ndim == 3:
            arr = fill_towards_seafloor(arr)
        arr, _ = fill_invalid(arr)
        arr = np.nan_to_num(arr, nan=0.0)
        kernel = getattr(self, "_convolve_kernel", None)
        if kernel is not None:
            from scipy import ndimage
            if arr.ndim == 2:
                arr = ndimage.convolve(arr, kernel, mode="nearest")
            else:
                arr = np.stack([ndimage.convolve(a, kernel, mode="nearest")
                                for a in arr])
            arr = arr.astype(np.float32)
        return arr

    def device_state(self, window_start=None, window_end=None):
        """The window's host state: 'packed' (Z*y*x, C*k), with the 'xy' and
        'xyz' pairs the narrow u/v companion 'packed_uv', 'times' (float32
        seconds from the run epoch) and 'depths'.  The tables are
        :class:`~opendrift_tpu_torch.ops.pack.WindowTable`: the window's
        decoded frames and their layout, assembled on the device they go to
        from the frames it holds already and the new ones.  The storages
        built on the host (compensated and split tables, a decomposed
        run's) come as host tables."""
        tidx = self._frame_indices(window_start, window_end)
        F = len(tidx)
        ny = self._iy.stop - self._iy.start
        nx = self._ix.stop - self._ix.start
        Z = len(self.depths) if (self._group3 and
                                 getattr(self, "depths", None) is not None) \
            else 1
        # depth truncation (reference environment.py:554-562)
        trunc = getattr(self, "truncate_depth", None)
        if Z > 1 and trunc is not None:
            d = np.asarray(self.depths, dtype=np.float32)
            Z = max(1, min(int(np.searchsorted(d, float(trunc),
                                               side="left")) + 1, Z))
        col_of = {}
        col = 0
        for v in self._group3 + self._group2:
            col_of[v] = (col, "t")
            col += F
        self._static_packed = [v for v in self._groups
                               if v not in NEAREST_VARIABLES]
        self._static_near = [v for v in self._groups
                             if v in NEAREST_VARIABLES]
        for v in self._static_packed:
            col_of[v] = (col, "static")
            col += 1
        for v in self._static_near:
            col_of[v] = (col, "near")
            col += 1
        C = col
        # neighbour-packing tier from the row-table budget; the model asks
        # for the wide tiers with pair_hint='xy', and OPENDRIFT_XY_PAIR=1/0
        # overrides the hint for standalone use (as in the JAX package)
        env_xy = os.environ.get("OPENDRIFT_XY_PAIR")
        want_xy = (env_xy == "1"
                   or (env_xy != "0"
                       and getattr(self, "pair_hint", None) == "xy"))
        pair_mode = choose_pair_mode(Z, ny, nx, C, want_xy)
        sampler = PackedSampler(Z, ny, nx, F, col_of, pair_mode)
        dd_host = getattr(self, "_dd_keep_host", False)
        dd_defer = getattr(self, "_dd_defer_pack", False)
        if dd_host or dd_defer:
            # domain decomposition: the steps sample with the tile's
            # geometry, which the run sets from this one (``retile``); a
            # prefetching thread must not overwrite it mid-interval
            self._dd_full_sampler = sampler
        else:
            self._sampler = sampler
        M = getattr(self, "ensemble_size", 1)
        k = PackedSampler.PAIR_FACTOR[pair_mode]
        self._pack_plan = {
            "tidx": tidx, "col_of": col_of, "Z": Z, "C": C, "Cf": C * k,
            "pair_mode": pair_mode, "M": M, "ny": ny, "nx": nx}
        out = {}
        if C > 0 and dd_defer:
            # domain decomposition with per-process reads: the full-grid
            # table is never built; the run reads each process's bands
            # through packed_rows()
            out["packed_deferred"] = True
        elif C > 0:
            dtype, compensated = self._storage(M * Z * ny * nx, pair_mode,
                                               dd_host)
            # the narrow u/v companion for the RK stage refetches: the same
            # stencil layout, only the u/v frame columns (none for a tile)
            uv = (not dd_host and pair_mode in ("xy", "xyz")
                  and all(v in col_of for v in UV))
            frames, tables = self._window_sources(
                tidx, Z, M, uv, self._load_frame)
            window = PackWindow(
                self.__dict__.setdefault("_resident", ResidentFrames()),
                frames, tables, Z, ny, nx, k, TORCH_DTYPES[dtype])
            split = os.environ.get("OPENDRIFT_SPLIT_TABLE")
            split = split if split in ("u16", "u8") else None
            if dd_host:
                # the run splits the host table into per-tile core bands,
                # so only the bands reach a device (as in the JAX package,
                # no compensated storage and no u/v companion for a tile)
                out["packed"] = window.host_table(0)
            elif compensated:
                out["packed"] = CompensatedTable.from_array(
                    window.host_table(0))
            elif split:
                out["packed"] = maybe_split_table(window.host_table(0),
                                                  force=split)
            else:
                out["packed"] = WindowTable(window, 0)
            if uv:
                # beside a compensated table the companion stays float32,
                # as in the JAX package (ROADMAP C records the decision)
                out["packed_uv"] = (window.host_table(1)
                                    if compensated or split
                                    else WindowTable(window, 1))
                self._sampler_uv = PackedSampler(
                    Z, ny, nx, F, {UV[0]: (0, "t"), UV[1]: (F, "t")},
                    pair_mode)
        epoch = self._run_epoch
        out["times"] = np.asarray(
            [(self.times[ti] - epoch).total_seconds() for ti in tidx],
            dtype=np.float32)
        if getattr(self, "depths", None) is not None:
            out["depths"] = np.asarray(self.depths, dtype=np.float32)[:Z] \
                if self._group3 else np.asarray(self.depths, np.float32)
        else:
            out["depths"] = np.zeros((1,), dtype=np.float32)
        return out

    def _storage(self, rows, pair_mode, dd_host):
        """The table's element type ('float32' or 'float16') and whether it
        is stored as compensated float16 pairs (element type float32 then),
        from ``packed_dtype`` and ``packed_auto_compensate``; a decomposed
        run's table is never compensated."""
        dtype = getattr(self, "packed_dtype", None)
        # a reader whose sampling is approximate anyway may opt into
        # compensated storage for large tables; an explicit packed_dtype
        # always wins (the JAX package's rule keeps 'xyz' exact)
        auto_comp = (dtype is None and not dd_host and pair_mode != "xyz"
                     and getattr(self, "packed_auto_compensate", False))
        dtype = dtype or "float32"
        compensated = dtype in ("float16x2", "f16x2")
        if compensated:
            dtype = "float32"
            compensated = not dd_host
        if dtype not in TORCH_DTYPES:
            raise ValueError(
                f"{self.name}: packed_dtype {dtype!r} is not one of "
                "'float32', 'float16', 'float16x2'")
        if auto_comp and rows >= GATHER_FAST_MAX_ROWS:
            compensated = True
            logger.info(
                "Packed table of reader %s has %d rows, at or beyond "
                "the JAX package's threshold of 2^15; using compensated "
                "float16-pair storage (~2^-21 relative error; set "
                "reader.packed_dtype='float32' to force exact rows).",
                self.name, rows)
        return dtype, compensated

    def _window_sources(self, tidx, Z, M, uv, load):
        """The frames a window's tables read and, per table, the members'
        base-column indices into them (``PackWindow``): every variable at
        every window frame (3D ones cut to Z planes), then the static
        fields at frame 0, in the order of the table's columns; with
        ``uv`` also the u/v companion's.  ``load(v, ti, m)`` gives a
        frame."""
        frames, index = [], {}

        def source(v, ti, m):
            planes = Z if v in self._group3 else 0
            key = (v, ti, m, planes)
            if key not in index:
                owner = load(v, ti, m)
                array = owner[:Z] if planes else owner.reshape(
                    owner.shape[-2:])
                index[key] = len(frames)
                frames.append((key, owner, array))
            return index[key]
        statics = self._static_packed + self._static_near
        tables = [[[source(v, ti, m) for v in self._group3 + self._group2
                    for ti in tidx] + [source(v, 0, m) for v in statics]
                   for m in range(M)]]
        if uv:
            tables.append([[source(v, ti, m) for v in UV for ti in tidx]
                           for m in range(M)])
        return frames, tables

    def packed_rows(self, r0, r1):
        """A per-process band read for domain decomposition: the packed
        rows [r0, r1) of the current window, (M*Z, r1-r0, nx, Cf), read
        from the source with a small context margin only; the y-neighbour
        columns take one context row, so the band equals the full-grid
        table's.  Needs a preceding ``device_state()`` (which records the
        window's pack plan); ``r1`` may pass the grid for tile padding."""
        plan = self._pack_plan
        Z, M, nx = plan["Z"], plan["M"], plan["nx"]
        pad_y = 1 if plan["pair_mode"] in ("xy", "xyz") else 0
        frames, tables = self._window_sources(
            plan["tidx"], Z, M, False,
            lambda v, ti, m: self._load_frame_rows(v, ti, m, r0,
                                                   r1 + pad_y))
        dtype, _ = self._storage(0, plan["pair_mode"], True)
        band = PackWindow(
            None, frames, tables, Z, r1 - r0 + pad_y, nx,
            PackedSampler.PAIR_FACTOR[plan["pair_mode"]],
            TORCH_DTYPES[dtype]).host_table(0)
        band = band.reshape(M * Z, r1 - r0 + pad_y, nx, plan["Cf"])
        return np.ascontiguousarray(band[:, :r1 - r0])

    # ---------------------------------------------------------- sampling -
    def _grid_consts(self, device):
        """The subset's origin and the cell size as float32 tensors on
        ``device`` (made once per subset and device): a tensor divisor
        keeps the index a true float32 division on the card, where
        PyTorch's division by a host scalar can multiply by its
        reciprocal instead."""
        key = (device, self._ix.start, self._iy.start)
        cache = self.__dict__.setdefault("_grid_const_cache", {})
        if key not in cache:
            cache[key] = tuple(
                torch.tensor(np.float32(v), device=device)
                for v in (self.x[self._ix][0], self.y[self._iy][0],
                          self.delta_x, self.delta_y))
        return cache[key]

    def _grid_indices(self, lon, lat):
        x, y = self.crs.fwd(tnp, lon, lat)
        if getattr(self.crs, "is_latlon", False):
            x = torch.where(x > self.xmax, x - 360.0, x)
            x = torch.where(x < self.xmin, x + 360.0, x)
        x0, y0, dx, dy = self._grid_consts(x.device)
        return (x - x0) / dx, (y - y0) / dy

    def _local_idx(self, dev_state, xi, yi, covers=None):
        """Domain decomposition: shift global fractional grid indices into
        the tile's extended band (``y_off``/``x_off`` of the tile's device
        state, set by ``DDContext.local_dev_states``) and restrict the
        coverage to the cells the tile holds: an element beyond its halo
        would read clamped cells, which count as not covered.  ``x_off``
        exists only under a 2D (Y x X) tiling."""
        if not isinstance(dev_state, dict):
            return xi, yi, covers
        y_off = dev_state.get("y_off")
        if y_off is not None:
            yi = yi - y_off
            if covers is not None:
                covers = covers & (yi >= 0) & (yi <= self._sampler.Y - 1)
        x_off = dev_state.get("x_off")
        if x_off is not None:
            xi = xi - x_off
            if covers is not None:
                covers = covers & (xi >= 0) & (xi <= self._sampler.X - 1)
        return xi, yi, covers

    def _row_offset(self, member):
        """Per-element first row of the element's ensemble member (round
        robin on the element ID), or 0 for a single member."""
        M = getattr(self, "ensemble_size", 1)
        if M > 1 and member is not None:
            s = self._sampler
            return (member.to(torch.int64) % M) * (s.Z * s.Y * s.X)
        return 0

    def _covers_idx(self, xi, yi, eps=1e-2):
        """In-grid test with a small index tolerance for float32 edge
        rounding (boundary nodes count as covered)."""
        nx = self._ix.stop - self._ix.start
        ny = self._iy.stop - self._iy.start
        return ((xi >= -eps) & (xi <= nx - 1 + eps)
                & (yi >= -eps) & (yi <= ny - 1 + eps))

    def _time_covered(self, times, t):
        """Temporal coverage with one reader step of slack either side."""
        if self.time_step is None:
            return True
        slack = self.time_step.total_seconds()
        t = np.float32(t)
        return bool((t >= times[0] - slack) & (t <= times[-1] + slack))

    def sample(self, dev_state, varnames, t, lon, lat, z, member=None):
        xi, yi = self._grid_indices(lon, lat)
        covers = self._covers_idx(xi, yi)
        xi, yi, covers = self._local_idx(dev_state, xi, yi, covers)
        times = dev_state["times"]
        if not self._time_covered(times, t):
            covers = torch.zeros_like(covers)
        depth = torch.clamp_min(-z, 0.0)
        s = self._sampler
        row_offset = self._row_offset(member)
        values = {}
        want_t = [v for v in varnames
                  if v in self._group3 or v in self._group2
                  or v in self._static_packed]
        want_n = [v for v in varnames if v in self._static_near]
        if want_n and not want_t:
            # mask-only fetch: one rounded-index gather of plane 0
            x0 = torch.clamp(torch.round(xi).to(torch.int64), 0, s.X - 1)
            y0 = torch.clamp(torch.round(yi).to(torch.int64), 0, s.Y - 1)
            g = take_rows(dev_state["packed"], y0 * s.X + x0 + row_offset)
            for v in want_n:
                values[v] = g[:, s.col_of[v][0]].to(torch.float32)
            return values, covers
        uv_sampler = getattr(self, "_sampler_uv", None)
        if (not want_n and uv_sampler is not None
                and "packed_uv" in dev_state
                and set(want_t) <= set(uv_sampler.col_of)):
            # RK stage refetch: u/v from the narrow companion table (same
            # stencil layout and arithmetic, bit-identical values)
            rows = uv_sampler.gather_rows(dev_state["packed_uv"], xi, yi,
                                          depth, dev_state["depths"],
                                          row_offset=row_offset)
            values.update(uv_sampler.values(rows, times, t, want_t))
        elif want_t or want_n:
            ncols = [s.col_of[v][0] for v in want_n]
            res = s.gather_rows(dev_state["packed"], xi, yi, depth,
                                dev_state["depths"], row_offset=row_offset,
                                nearest_cols=ncols or None)
            if ncols:
                rows, near = res
                for v, c in zip(want_n, ncols):
                    values[v] = near[c]
            else:
                rows = res
            if want_t:
                values.update(s.values(rows, times, t, want_t))
        if not self.crs.is_latlon:
            gamma = self.crs.convergence(tnp, lon, lat)
            values = self.rotate_vectors_sampled(values, varnames, gamma)
        return values, covers


    # ------------------------------------------------- single-fetch RK --
    def supports_uv_block(self):
        """True when u/v ride x-paired packed rows, so RK stages can
        re-evaluate one gathered corner block instead of refetching
        (drift:advection_single_fetch)."""
        s = getattr(self, "_sampler", None)
        served = self._group3 + self._group2
        return (s is not None and s.pair_mode in ("x", "xy", "xyz")
                and all(v in served for v in UV))

    def corner_block(self, dev_state, lon, lat, z, member=None,
                     keep_vars=None):
        """Gather the stage-reusable corner block at the given positions;
        also returns the position coverage mask.  ``keep_vars`` defaults
        to the current components; with every variable this reader serves
        the whole start-position environment rides the same gathers."""
        if keep_vars is None:
            keep_vars = list(UV)
        xi, yi = self._grid_indices(lon, lat)
        covers = self._covers_idx(xi, yi)
        xi, yi, covers = self._local_idx(dev_state, xi, yi, covers)
        block = self._sampler.gather_corner_block(
            dev_state["packed"], xi, yi, torch.clamp_min(-z, 0.0),
            dev_state["depths"], row_offset=self._row_offset(member),
            keep_vars=keep_vars)
        return block, covers

    def uv_corner_block(self, dev_state, lon, lat, z, member=None):
        """Corner block holding only u/v (single-fetch RK stages)."""
        return self.corner_block(dev_state, lon, lat, z, member=member)

    def sample_from_block(self, dev_state, block, t, lon, lat, varnames):
        """Evaluate kept variables from a gathered corner block at
        (possibly displaced) positions, with no gather.  Equals ``sample``
        up to the order of the linear blends where the position is the
        block's gather position.  Returns (values, temporal coverage)."""
        xi, yi = self._grid_indices(lon, lat)
        xi, yi, _ = self._local_idx(dev_state, xi, yi)
        vals = self._sampler.eval_corner_block(
            block, xi, yi, dev_state["times"], t, varnames)
        if not self.crs.is_latlon:
            gamma = self.crs.convergence(tnp, lon, lat)
            vals = self.rotate_vectors_sampled(vals, varnames, gamma)
        covers_t = torch.full_like(
            lon, self._time_covered(dev_state["times"], t), dtype=torch.bool)
        return vals, covers_t

    def uv_from_block(self, dev_state, block, t, lon, lat):
        """u/v from a gathered block at (possibly displaced) stage
        positions: blends and the rotation, no gather."""
        vals, _ = self.sample_from_block(dev_state, block, t, lon, lat,
                                         list(UV))
        return vals[UV[0]], vals[UV[1]]

    def sample_profiles(self, dev_state, varnames, t, lon, lat, zlevels):
        """Profiles at the fixed ``zlevels`` (host float32, 0 downwards):
        one packed-row sample per level for the 3D variables, (L, N) each;
        other variables are sampled once and repeated.  Returns
        (values, position coverage)."""
        want3 = [v for v in varnames if v in self._group3]
        out = {}
        xi, yi = self._grid_indices(lon, lat)
        covers = self._covers_idx(xi, yi)
        xi, yi, covers = self._local_idx(dev_state, xi, yi, covers)
        if want3:
            res = {v: [] for v in want3}
            for level in zlevels:
                depth = torch.full_like(xi, max(-float(level), 0.0))
                rows = self._sampler.gather_rows(
                    dev_state["packed"], xi, yi, depth, dev_state["depths"])
                vals = self._sampler.values(rows, dev_state["times"], t,
                                            want3)
                for v in want3:
                    res[v].append(vals[v])
            for v in want3:
                out[v] = torch.stack(res[v])
        rest = [v for v in varnames if v not in want3]
        if rest:
            vals, covers = self.sample(dev_state, rest, t, lon, lat,
                                       torch.zeros_like(lon))
            for v in rest:
                out[v] = vals[v].expand(len(zlevels), -1)
        return out, covers


class ArrayReader(StructuredGridReader):
    """Structured forcing from in-memory numpy arrays.

    ``data``: {standard_name: ndarray} of shape (F, Y, X), (F, Z, Y, X),
    or (Y, X) for static fields (landmask, bathymetry)."""

    def __init__(self, data, x, y, times, proj4="+proj=latlong",
                 depths=None, name=None):
        self._data = {k: np.asarray(v, dtype=np.float32)
                      for k, v in data.items()}
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.times = list(times)
        self.proj4 = proj4
        self.depths = depths
        self.variables = list(self._data)
        self._var_has_z = {k: v.ndim == 4 for k, v in self._data.items()}
        for k, v in self._data.items():
            static2d = k in STATIC_VARIABLES and v.ndim == 2
            if not static2d and v.ndim not in (3, 4):
                raise ValueError(
                    f"ArrayReader: {k} must be (F,Y,X), (F,Z,Y,X) or "
                    f"static (Y,X); got shape {v.shape}")
        if name:
            self.name = name
        super().__init__()

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        a = self._data[std]
        if a.ndim == 2:          # static (Y, X)
            return a[yslice, xslice]
        if a.ndim == 4:
            return a[ti][zslice, yslice, xslice]
        return a[ti][yslice, xslice]
