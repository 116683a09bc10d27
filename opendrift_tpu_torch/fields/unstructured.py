"""Unstructured-mesh readers: Telemac Selafin, SCHISM, SHYFEM, FVCOM/UGRID.

Port of ``opendrift_tpu/fields/unstructured.py`` (reference:
opendrift/readers/basereader/unstructured.py:10-186,
reader_telemac_selafin.py, reader_schism_native.py,
unstructured/shyfem.py, reader_netCDF_CF_unstructured.py).  Two device
paths:

* ``sampling='regrid'`` (default): each frame is regridded once at load
  time through precomputed Delaunay barycentric weights (fields/regrid.py)
  onto a regular lon/lat grid, after which the device samples the same
  packed-row table as every structured reader.
* ``sampling='native'``: the mesh itself is sampled on the device with
  barycentric interpolation through a precomputed triangle-lookup grid
  (fields/mesh.py), which keeps the mesh's variable resolution and, where
  the file carries element connectivity, its coastline holes.  The window's
  node values sit in one host-packed table of node rows (all variables x
  frames x z-levels), as in the JAX package; a sample gathers only the
  values each variable needs (two frames x two levels x three nodes) and
  blends them in the JAX package's order (barycentric, then time, then
  vertical), where the JAX package blends whole node rows first.

The host side (file parsing, z-slicing, scrubbing, NaN fill, regridding)
is the JAX package's, unchanged.
"""

import logging
from datetime import datetime, timedelta

import numpy as np
import torch

from .base import STANDARD_NAMES
from .grid import StructuredGridReader
from .regrid import DelaunayRegridder
from ..ops.interp import time_weights
from ..utils import ncio
from ..utils import crs as crslib

logger = logging.getLogger(__name__)


class UnstructuredReader(StructuredGridReader):
    """Base: subclasses provide node coordinates and per-frame node
    values; this class owns the regridding and the structured fast path.

    Subclass contract (before ``super().__init__()``):
      self._node_lon, self._node_lat : (n_nodes,)
      self.times : list of datetimes
      self.variables, self._var_has_z (all False in this base)
    and implement ``_node_values(std, time_index) -> (n_nodes,)``
    (or, for z-resolved native sampling, ``_node_frame`` returning
    ``(Z, n_nodes)``).  Optionally set ``self._mesh_triangles`` from the
    file's element connectivity before calling ``super().__init__()``.
    """

    def __init__(self, resolution_deg=None, sampling="regrid"):
        if sampling not in ("regrid", "native"):
            raise ValueError("sampling must be 'regrid' or 'native'")
        self._sampling = sampling
        self._regrid = DelaunayRegridder(self._node_lon, self._node_lat,
                                         resolution_deg=resolution_deg)
        self.x = self._regrid.lons
        self.y = self._regrid.lats
        self.proj4 = "+proj=latlong"
        if sampling == "regrid":
            # regrid values are approximate by construction; post-cliff
            # tables default to compensated f16-pair storage (error
            # ~2^-21; grid.py device_state)
            self.packed_auto_compensate = True
        if not hasattr(self, "depths"):
            self.depths = None
        super(UnstructuredReader, self).__init__()
        self._mesh = None
        self._node_frame_cache = {}
        if sampling == "native":
            from .mesh import MeshSampler
            self._mesh = MeshSampler(
                self._node_lon, self._node_lat,
                triangles=getattr(self, "_mesh_triangles", None))

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        if std == "land_binary_mask":
            # outside the mesh hull = land-ish; inside = ocean
            land = np.where(self._regrid.outside.reshape(
                self._regrid.shape), 1.0, 0.0).astype(np.float32)
            return land[yslice, xslice]
        vals = self._node_values(std, ti)
        out = self._regrid(vals)
        if out.ndim == 3:
            return out[zslice, yslice, xslice]
        return out[yslice, xslice]

    # ------------------------------------------------- native mesh path --
    def _node_frame(self, std, ti):
        """Raw node values for one frame: (n_nodes,) or (Z, n_nodes)."""
        return self._node_values(std, ti)

    def _nearest_valid_nodes(self, good, bad):
        from scipy.spatial import cKDTree
        pts = np.column_stack([self._node_lon, self._node_lat])
        tree = cKDTree(pts[good])
        _, idx = tree.query(pts[bad])
        return idx

    def _load_node_frame(self, std, ti):
        """Scrubbed, NaN-filled node frame (host, cached): valid-range
        scrub per standard name (reference variables.py:630-668), seafloor
        downward fill along z (reference interpolation/structured.py:50-71)
        and nearest-valid-node horizontal fill."""
        key = (std, ti)
        if key in self._node_frame_cache:
            return self._node_frame_cache[key]
        vals = np.array(self._node_frame(std, ti), dtype=np.float32,
                        copy=True)
        rng = STANDARD_NAMES.get(std)
        if rng is not None:
            outside = (vals < rng["valid_min"]) | (vals > rng["valid_max"])
            vals[outside] = np.nan
        flat = np.atleast_2d(vals)
        for k in range(1, flat.shape[0]):          # towards seafloor
            nan = ~np.isfinite(flat[k])
            flat[k][nan] = flat[k - 1][nan]
        for k in range(flat.shape[0]):             # nearest valid node
            bad = ~np.isfinite(flat[k])
            if bad.any():
                good = ~bad
                if good.any():
                    flat[k][bad] = flat[k][good][
                        self._nearest_valid_nodes(good, bad)]
                else:
                    flat[k][bad] = 0.0
        out = flat if vals.ndim > 1 else flat[0]
        if len(self._node_frame_cache) > 256:
            self._node_frame_cache.clear()
        self._node_frame_cache[key] = out
        return out

    def device_state(self, window_start=None, window_end=None):
        """Native sampling: the window's node rows (host float32 (n_nodes,
        C): per node, every variable x frame (x z-level)), 'times' and
        'depths'; the mesh's static tables go to the device once
        (``MeshSampler.tables``)."""
        if self._sampling != "native":
            return super().device_state(window_start, window_end)
        tidx = self._frame_indices(window_start, window_end)
        F = len(tidx)
        Z = len(self.depths) if (self._group3 and
                                 self.depths is not None) else 1
        # packed node rows: per node, all vars x frames (x z-levels)
        cols = {}
        c = 0
        for v in self._group3:
            cols[v] = (c, "t3")
            c += Z * F
        for v in self._group2:
            cols[v] = (c, "t")
            c += F
        for v in self._groups:
            if v == "land_binary_mask":
                continue  # served from mesh coverage, not node data
            cols[v] = (c, "static")
            c += 1
        self._mesh_cols = cols
        self._mesh_F = F
        self._mesh_Z = Z
        rows = np.zeros((self._mesh.n_nodes, max(c, 1)), dtype=np.float32)
        for v, (c0, kind) in cols.items():
            if kind == "t3":
                for fi, ti in enumerate(tidx):
                    fr = np.atleast_2d(self._load_node_frame(v, ti))
                    for zi in range(Z):
                        rows[:, c0 + zi * F + fi] = \
                            fr[min(zi, fr.shape[0] - 1)]
            elif kind == "t":
                for fi, ti in enumerate(tidx):
                    rows[:, c0 + fi] = \
                        np.atleast_2d(self._load_node_frame(v, ti))[0]
            else:
                rows[:, c0] = np.atleast_2d(self._load_node_frame(v, 0))[0]
        out = {"node_rows": rows}
        epoch = self._run_epoch
        out["times"] = np.asarray(
            [(self.times[ti] - epoch).total_seconds() for ti in tidx],
            dtype=np.float32)
        if self.depths is not None:
            out["depths"] = np.asarray(self.depths, dtype=np.float32)
        else:
            out["depths"] = np.zeros((1,), dtype=np.float32)
        return out

    def _mesh_values(self, dev_state, t, w, nidx, want, depth):
        """The node values of ``want`` at barycentric weights ``w`` over
        nodes ``nidx``, blended in time (and vertically for z-resolved
        variables; ``depth`` positive down, (N,)).  Each variable gathers
        only its columns: frames ``ti``, ``ti + 1`` (x levels ``z0``,
        ``z0 + 1``) x the three nodes."""
        F, Z = self._mesh_F, self._mesh_Z
        rows = dev_state["node_rows"]
        ti, tw = time_weights(dev_state["times"], t, F)
        t1 = min(ti + 1, F - 1)
        tw = float(tw)
        tw0 = float(np.float32(1.0) - np.float32(tw))

        def bary(col):
            return self._mesh.blend_columns(rows, w, nidx, col)

        def in_time(col):
            return bary(col + ti) * tw0 + bary(col + t1) * tw
        out = {}
        z0 = fz = None
        for v in want:
            c0, kind = self._mesh_cols[v]
            if kind == "static":
                out[v] = bary(c0)
            elif kind == "t" or Z == 1:
                out[v] = in_time(c0)
            else:
                if z0 is None:
                    depths = dev_state["depths"]
                    z0 = torch.clamp(torch.searchsorted(
                        depths, depth.contiguous(), right=True) - 1,
                        0, Z - 2)
                    dz = depths[z0 + 1] - depths[z0]
                    fz = torch.clamp(torch.where(
                        dz != 0, (depth - depths[z0]) / dz, 0.0), 0.0, 1.0)
                v_lo = in_time(c0 + z0 * F)
                v_hi = in_time(c0 + (z0 + 1) * F)
                out[v] = v_lo * (1.0 - fz) + fz * v_hi
        return out

    def sample(self, dev_state, varnames, t, lon, lat, z, member=None):
        if self._sampling != "native":
            return super().sample(dev_state, varnames, t, lon, lat, z,
                                  member)
        tid, w, nidx, inside, covers = self._mesh.locate_device(lon, lat)
        if not self._time_covered(dev_state["times"], t):
            covers = torch.zeros_like(covers)
        values = {}
        want_rows = [v for v in varnames if v in self._mesh_cols]
        if want_rows:
            values.update(self._mesh_values(
                dev_state, t, w, nidx, want_rows, torch.clamp_min(-z, 0.0)))
        if "land_binary_mask" in varnames:
            values["land_binary_mask"] = (~inside).to(torch.float32)
        return values, covers

    def sample_profiles(self, dev_state, varnames, t, lon, lat, zlevels):
        if self._sampling != "native":
            return super().sample_profiles(dev_state, varnames, t, lon,
                                           lat, zlevels)
        tid, w, nidx, inside, covers = self._mesh.locate_device(lon, lat)
        want_rows = [v for v in varnames if v in self._mesh_cols]
        out = {}
        L = len(zlevels)
        if want_rows:
            # one triangle lookup serves every profile level
            res = {v: [] for v in want_rows}
            for level in zlevels:
                depth = torch.full_like(lon, max(-float(level), 0.0))
                vals = self._mesh_values(dev_state, t, w, nidx, want_rows,
                                         depth)
                for v in want_rows:
                    res[v].append(vals[v])
            for v in want_rows:
                out[v] = torch.stack(res[v])
        if "land_binary_mask" in varnames:
            out["land_binary_mask"] = (~inside).to(torch.float32).expand(
                L, -1)
        return out, covers


class TelemacReader(UnstructuredReader):
    """Telemac Selafin results (own binary parser, utils/selafin.py).

    Telemac files carry no CRS; pass the model's ``proj4``.  For 3D
    results (NPLAN vertical planes) the surface plane is served; full
    sigma-plane support requires the ELEVATION Z variable."""

    VARIABLE_MAP = {
        "VELOCITY U": "x_sea_water_velocity",
        "VELOCITY V": "y_sea_water_velocity",
        "VELOCITY W": "upward_sea_water_velocity",
        "FREE SURFACE": "sea_surface_height",
        "WATER DEPTH": "sea_floor_depth_below_sea_level",
        "TEMPERATURE": "sea_water_temperature",
        "SALINITY": "sea_water_salinity",
    }
    # variables that live on a single plane even in 3D results
    _2D_VARS = {"sea_surface_height", "sea_floor_depth_below_sea_level",
                "land_binary_mask"}

    def __init__(self, filename, proj4, start_time=None,
                 resolution_deg=None, name=None, sampling="regrid"):
        from ..utils.selafin import SelafinFile
        self._slf = SelafinFile(filename)
        self.name = name or filename
        nplan = max(self._slf.iparam[6], 1)
        self._nplan = nplan
        self._npoin2d = self._slf.n_nodes // nplan
        # surface plane is the last (Telemac planes are bottom-up)
        surf = slice((nplan - 1) * self._npoin2d, nplan * self._npoin2d)
        self._surf = surf
        mesh_crs = crslib.from_proj4(proj4)
        lon, lat = mesh_crs.inv(np, self._slf.x[surf], self._slf.y[surf])
        self._node_lon = lon
        self._node_lat = lat
        self._mesh_crs = mesh_crs
        self._gamma_nodes = None
        self._uv_cache = {}
        self._mesh_triangles = self._surface_triangles()
        if start_time is None:
            if self._slf.date is not None:
                d = self._slf.date
                start_time = datetime(*[max(v, 1) if i < 3 else v
                                        for i, v in enumerate(d[:6])])
            else:
                start_time = datetime(1970, 1, 1)
        self.times = [start_time + timedelta(seconds=s)
                      for s in self._slf.times_seconds]
        self._name_index = {}
        self.variables = []
        for i, raw in enumerate(self._slf.variable_names):
            std = self.VARIABLE_MAP.get(raw)
            if std is not None:
                self._name_index[std] = i
                self.variables.append(std)
        self.variables.append("land_binary_mask")
        # 3D results (NPLAN sigma planes, bottom-up) with ELEVATION Z:
        # node columns are zsliced onto fixed target depths at load,
        # mirroring the reference's nearest-layer selection from the
        # same variable (reference reader_telemac_selafin.py:222-236)
        self._use_3d = (nplan > 1
                        and "ELEVATION Z" in self._slf.variable_names)
        if self._use_3d:
            self._z_idx = self._slf.variable_names.index("ELEVATION Z")
            z0 = self._plane_values(self._z_idx, 0)
            hmax = float(-np.nanmin(z0[0]))
            from .roms import DEFAULT_DEPTHS
            cut = int(np.searchsorted(DEFAULT_DEPTHS,
                                      max(hmax, 5.0))) + 1
            self.depths = DEFAULT_DEPTHS[:max(cut, 2)]
            self._var_has_z = {v: v not in self._2D_VARS
                               for v in self.variables}
        else:
            self._var_has_z = {v: False for v in self.variables}
        super().__init__(resolution_deg=resolution_deg, sampling=sampling)

    def _plane_values(self, raw_idx, ti):
        """(nplan, npoin2) node values of one raw variable (planes
        bottom-up, Telemac plane-major node numbering)."""
        vals = self._slf.read_variable(raw_idx, ti)
        return np.asarray(vals, np.float64).reshape(self._nplan,
                                                    self._npoin2d)

    def _surface_triangles(self):
        """2D triangulation from the file's IKLE connectivity; for 3D
        prism meshes (ndp=6, plane-major node numbering) the bottom faces
        of the first element layer.  None -> Delaunay fallback."""
        conn = getattr(self._slf, "connectivity", None)
        if conn is None or conn.ndim != 2:
            return None
        ndp = conn.shape[1]
        if ndp == 3:
            tris = np.asarray(conn, dtype=np.int64)
        elif ndp == 6 and self._nplan > 1:
            nelem2d = conn.shape[0] // (self._nplan - 1)
            tris = np.asarray(conn[:nelem2d, :3],
                              dtype=np.int64) % self._npoin2d
        else:
            return None
        if tris.min() < 0 or tris.max() >= self._npoin2d:
            return None
        # sanity: reject if many degenerate (mis-derived) triangles
        x, y = self._node_lon, self._node_lat
        a = ((x[tris[:, 1]] - x[tris[:, 0]])
             * (y[tris[:, 2]] - y[tris[:, 0]])
             - (x[tris[:, 2]] - x[tris[:, 0]])
             * (y[tris[:, 1]] - y[tris[:, 0]]))
        if (np.abs(a) < 1e-14).mean() > 0.01:
            return None
        return tris.astype(np.int32)

    def _zslice_planes(self, data, ti):
        """(nplan, npoin2) plane data -> (L, npoin2) at self.depths via
        the frame's ELEVATION Z columns (roms.zslice_columns)."""
        from .roms import zslice_columns
        zcor = self._plane_values(self._z_idx, ti)
        return zslice_columns(np.asarray(data, np.float32), zcor,
                              self.depths)

    def _node_values(self, std, ti):
        uvs = ("x_sea_water_velocity", "y_sea_water_velocity")
        use3d = getattr(self, "_use_3d", False)
        if std in uvs and all(v in self._name_index for v in uvs):
            # velocities are along the mesh projection's axes — rotate to
            # east/north by the grid convergence, as the reference's
            # rotate_vectors does (reference variables.py:59-109)
            if ti not in self._uv_cache:
                if use3d:
                    u = self._plane_values(self._name_index[uvs[0]], ti)
                    v = self._plane_values(self._name_index[uvs[1]], ti)
                else:
                    u = self._slf.read_variable(
                        self._name_index[uvs[0]], ti)[self._surf]
                    v = self._slf.read_variable(
                        self._name_index[uvs[1]], ti)[self._surf]
                if self._gamma_nodes is None:
                    self._gamma_nodes = self._mesh_crs.convergence(
                        np, self._node_lon, self._node_lat)
                ue, vn = crslib.rotate_to_eastnorth(np, u, v,
                                                    self._gamma_nodes)
                if use3d:
                    ue = self._zslice_planes(ue, ti)
                    vn = self._zslice_planes(vn, ti)
                if len(self._uv_cache) > 8:
                    self._uv_cache.clear()
                self._uv_cache[ti] = (ue.astype(np.float32),
                                      vn.astype(np.float32))
            u, v = self._uv_cache[ti]
            return u if std == uvs[0] else v
        if use3d and self._var_has_z.get(std):
            return self._zslice_planes(
                self._plane_values(self._name_index[std], ti), ti)
        vals = self._slf.read_variable(self._name_index[std], ti)
        return vals[self._surf]


class SCHISMReader(UnstructuredReader):
    """SCHISM native output (reference: opendrift/readers/
    reader_schism_native.py:18-300).  Node coordinates are projected
    (``SCHISM_hgrid_node_x/y``) — pass the model ``proj4``.  Supports
    depth-averaged ``dahv`` and, with ``use_3d=True``, ``hvel`` columns
    interpolated from the time-varying ``zcor`` levels onto fixed target
    depths at load time."""

    SCALAR_VARS = {
        "elev": "sea_surface_height",
        "depth": "sea_floor_depth_below_sea_level",
        "salt": "sea_water_salinity",
        "temp": "sea_water_temperature",
    }

    def __init__(self, filename, proj4, use_3d=False, target_depths=None,
                 resolution_deg=None, name=None, sampling="regrid"):
        self._ds = ncio.open_dataset(filename)
        self.name = name or filename
        ds = self._ds
        x = np.asarray(ds.variables["SCHISM_hgrid_node_x"][:],
                       dtype=np.float64).ravel()
        y = np.asarray(ds.variables["SCHISM_hgrid_node_y"][:],
                       dtype=np.float64).ravel()
        # coordinate arrays may be tiled (time, node) in some files
        mesh_crs = crslib.from_proj4(proj4)
        self._node_lon, self._node_lat = mesh_crs.inv(np, x, y)
        # element connectivity (1-based, 4th column filled for triangles)
        self._mesh_triangles = None
        if "SCHISM_hgrid_face_nodes" in ds.variables:
            f = np.asarray(ds.variables["SCHISM_hgrid_face_nodes"][:],
                           dtype=np.int64)
            if f.ndim == 2 and f.shape[1] in (3, 4):
                valid = (f >= 1) & (f <= len(self._node_lon))
                self._mesh_triangles = np.where(valid, f - 1, -1)
        tv = ds.variables["time"]
        self.times = list(ncio.parse_cf_time(
            tv.attrs.get("units", "seconds since 1970-01-01"), tv[:]))
        self._use_3d = use_3d and "hvel" in ds.variables
        self.variables = []
        self._var_has_z = {}
        for raw, std in self.SCALAR_VARS.items():
            if raw in ds.variables:
                self.variables.append(std)
                # real SCHISM output carries temp/salt as 3D columns
                # (time, node, lev) like hvel (reference
                # reader_schism_native.py:90-101)
                self._var_has_z[std] = bool(
                    self._use_3d
                    and "lev" in ds.variables[raw].dimensions)
        if self._use_3d or "dahv" in ds.variables:
            for std in ("x_sea_water_velocity", "y_sea_water_velocity"):
                self.variables.append(std)
                self._var_has_z[std] = self._use_3d
        self.variables.append("land_binary_mask")
        self._var_has_z["land_binary_mask"] = False
        if self._use_3d:
            if target_depths is None:
                hmax = float(np.nanmax(np.asarray(
                    ds.variables["depth"][:])))
                from .roms import DEFAULT_DEPTHS
                target_depths = DEFAULT_DEPTHS[
                    DEFAULT_DEPTHS <= max(hmax, 5.0)]
            self.depths = np.asarray(target_depths, dtype=np.float32)
        else:
            self.depths = None
        super().__init__(resolution_deg=resolution_deg, sampling=sampling)

    def _zslice_columns(self, data, ti):
        """(node, lev) column data -> (L, node) at self.depths via the
        frame's time-varying zcor levels (bottom-up)."""
        zcor = ncio.cf_unpack(self._ds.variables["zcor"],
                              self._ds.variables["zcor"][ti])
        out = np.empty((len(self.depths), data.shape[0]), np.float32)
        S = zcor.shape[1]
        for li, d in enumerate(self.depths):
            zt = -float(d)
            k = np.clip(np.sum(zcor < zt, axis=1), 1, S - 1)
            z_lo = np.take_along_axis(zcor, (k - 1)[:, None], 1)[:, 0]
            z_hi = np.take_along_axis(zcor, k[:, None], 1)[:, 0]
            v_lo = np.take_along_axis(data, (k - 1)[:, None], 1)[:, 0]
            v_hi = np.take_along_axis(data, k[:, None], 1)[:, 0]
            denom = np.where(z_hi != z_lo, z_hi - z_lo, 1.0)
            w = np.clip((zt - z_lo) / denom, 0.0, 1.0)
            out[li] = v_lo * (1.0 - w) + w * v_hi
        return out

    def _velocity_nodes(self, comp, ti):
        """(n_nodes,) for 2D dahv, or (L, n_nodes) from hvel columns."""
        ds = self._ds
        if not self._use_3d:
            v = ds.variables["dahv"]
            return ncio.cf_unpack(v, v[ti])[..., comp]
        hvel = ncio.cf_unpack(ds.variables["hvel"],
                              ds.variables["hvel"][ti])  # (node, lev, 2)
        return self._zslice_columns(hvel[..., comp], ti)

    def _node_frame(self, std, ti):
        comp = {"x_sea_water_velocity": 0, "y_sea_water_velocity": 1}
        if std in comp:
            return self._velocity_nodes(comp[std], ti)
        raw = next(k for k, v in self.SCALAR_VARS.items() if v == std)
        var = self._ds.variables[raw]
        if "time" in var.dimensions:
            vals = ncio.cf_unpack(var, var[ti])
        else:
            vals = ncio.cf_unpack(var, var[:])
        if self._var_has_z.get(std) and vals.ndim == 2:
            return self._zslice_columns(vals, ti)    # (node, lev) cols
        return vals.ravel()

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        if std == "land_binary_mask":
            return super()._read_frame(std, ti, zslice, yslice, xslice)
        vals = self._node_frame(std, ti)
        out = self._regrid(vals)
        if out.ndim == 3:
            return out[zslice, yslice, xslice]
        return out[yslice, xslice]


class SHYFEMReader(UnstructuredReader):
    """SHYFEM unstructured output (reference: opendrift/readers/
    unstructured/shyfem.py:20-240): geographic node coordinates
    (``longitude``/``latitude``), fixed ``level`` depths (positive down,
    layer bottoms), variables identified by their ``standard_name``."""

    NAME_MAP = {
        "sea_floor_depth_below_sea_surface":
            "sea_floor_depth_below_sea_level",
        "eastward_sea_water_velocity": "x_sea_water_velocity",
        "northward_sea_water_velocity": "y_sea_water_velocity",
    }

    def __init__(self, filename, resolution_deg=None, name=None,
                 sampling="regrid"):
        self._ds = ncio.open_dataset(filename)
        self.name = name or filename
        ds = self._ds
        self._node_lon = np.asarray(ds.variables["longitude"][:],
                                    dtype=np.float64).ravel()
        self._node_lat = np.asarray(ds.variables["latitude"][:],
                                    dtype=np.float64).ravel()
        tv = ds.variables["time"]
        self.times = list(ncio.parse_cf_time(
            tv.attrs.get("units", "seconds since 1970-01-01"), tv[:]))
        # layer-bottom depths -> layer-centre depths (reference
        # shyfem.py:97-102)
        lv = np.asarray(ds.variables["level"][:], dtype=np.float64).ravel()
        centres = lv - np.diff(np.concatenate([[0.0], lv])) / 2.0
        self._levels = centres.astype(np.float32)
        self._sources = {}
        self.variables = []
        self._var_has_z = {}
        for vn, var in ds.variables.items():
            if vn in ("time", "longitude", "latitude", "level"):
                continue
            std = var.attrs.get("standard_name", vn)
            std = self.NAME_MAP.get(std, std)
            if std in self._sources:
                continue
            has_z = "level" in var.dimensions
            self._sources[std] = (vn, has_z)
            self._var_has_z[std] = has_z
            self.variables.append(std)
        self.variables.append("land_binary_mask")
        self._var_has_z["land_binary_mask"] = False
        self.depths = self._levels if any(
            h for _, h in self._sources.values()) else None
        super().__init__(resolution_deg=resolution_deg, sampling=sampling)

    def _node_frame(self, std, ti):
        vn, has_z = self._sources[std]
        var = self._ds.variables[vn]
        vals = ncio.cf_unpack(
            var, var[ti] if "time" in var.dimensions else var[:])
        if not has_z:
            return vals.ravel()
        # real SHYFEM output is (time, node, level) (reference
        # unstructured/shyfem.py:188-199); normalise to (level, node)
        dims = [d for d in var.dimensions if d != "time"]
        if vals.ndim == 2 and dims and dims[0] == "node":
            vals = vals.T
        return vals

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        if std == "land_binary_mask":
            return super()._read_frame(std, ti, zslice, yslice, xslice)
        vals = self._node_frame(std, ti)
        if vals.ndim > 1:  # (level, node)
            out = self._regrid(vals)
            return out[zslice, yslice, xslice]
        return self._regrid(vals)[yslice, xslice]


class FVCOMReader(UnstructuredReader):
    """FVCOM / CF-UGRID triangular-mesh NetCDF.

    Node variables (zeta, temp, salinity) are regridded from nodes;
    cell-centre variables (u, v, ua, va) from element centroids."""

    NODE_VARS = {
        "zeta": "sea_surface_height",
        "temp": "sea_water_temperature",
        "salinity": "sea_water_salinity",
        "h": "sea_floor_depth_below_sea_level",
    }
    CELL_VARS = {
        "u": "x_sea_water_velocity",
        "v": "y_sea_water_velocity",
        "ua": "x_sea_water_velocity",
        "va": "y_sea_water_velocity",
    }

    def __init__(self, filename, resolution_deg=None, name=None,
                 sampling="regrid", proj4=None, use_3d=False,
                 target_depths=None):
        self._ds = ncio.open_dataset(filename)
        self.name = name or filename
        ds = self._ds

        def get(n):
            return np.asarray(ds.variables[n][:], dtype=np.float64)
        mesh_crs = crslib.from_proj4(proj4) if proj4 else None
        self._mesh_crs = mesh_crs
        if mesh_crs is not None and "x" in ds.variables:
            # Cartesian FVCOM output (the reference requires it,
            # reader_netCDF_CF_unstructured.py:117): project node and
            # cell coordinates to lon/lat
            xx, yy = get("x"), get("y")
            self._node_lon, self._node_lat = mesh_crs.inv(np, xx, yy)
        else:
            self._node_lon = get("lon")
            self._node_lat = get("lat")
            if np.all(self._node_lon == 0):  # some files only carry x/y
                self._node_lon = get("x")
                self._node_lat = get("y")
        self._nv = None
        self._mesh_triangles = None
        if "nv" in ds.variables:
            nv = np.asarray(ds.variables["nv"][:], dtype=int)
            if nv.shape[0] == 3:
                nv = nv.T
            nv = nv - nv.min()
            self._nv = nv
            self._mesh_triangles = nv.astype(np.int32)
        # cell centres (xc/yc projected, latc/lonc, else centroids)
        if mesh_crs is not None and "xc" in ds.variables:
            self._cell_lon, self._cell_lat = mesh_crs.inv(
                np, get("xc"), get("yc"))
        elif "lonc" in ds.variables:
            self._cell_lon = get("lonc")
            self._cell_lat = get("latc")
        else:
            self._cell_lon = self._node_lon[self._nv].mean(axis=1)
            self._cell_lat = self._node_lat[self._nv].mean(axis=1)

        # time axis
        tname = "time" if "time" in ds.variables else "Times"
        tv = ds.variables[tname]
        self.times = list(ncio.parse_cf_time(
            tv.attrs.get("units", "days since 1858-11-17 00:00:00"),
            tv[:]))

        self._sources = {}
        self.variables = []
        for raw, std in {**self.NODE_VARS, **self.CELL_VARS}.items():
            if raw in ds.variables and std not in self._sources:
                on_cells = raw in self.CELL_VARS
                self._sources[std] = (raw, on_cells)
                self.variables.append(std)
        self.variables.append("land_binary_mask")
        # sigma-LAYER columns (u/v/temp/salt on siglay): with
        # use_3d=True, columns are zsliced at load onto fixed target
        # depths from z = sigma*(h) — the reference's z_from_sigma with
        # elevation=0 (reader_netCDF_CF_unstructured.py:420-435)
        self._use_3d = bool(use_3d and "siglay" in ds.variables)
        self._var_has_z = {}
        for v in self.variables:
            raw_oc = self._sources.get(v)
            self._var_has_z[v] = bool(
                self._use_3d and raw_oc is not None
                and "siglay" in ds.variables[raw_oc[0]].dimensions)
        if self._use_3d and any(self._var_has_z.values()):
            if target_depths is None:
                from .roms import PRODUCTION_DEPTHS
                hmax = float(np.nanmax(get("h")))
                cut = int(np.searchsorted(PRODUCTION_DEPTHS,
                                          max(hmax, 5.0),
                                          side="right"))
                target_depths = PRODUCTION_DEPTHS[:max(cut, 2)]
            self.depths = np.asarray(target_depths, np.float32)
        super().__init__(resolution_deg=resolution_deg, sampling=sampling)
        # secondary regridder for cell-centre data
        self._cell_regrid = DelaunayRegridder(
            self._cell_lon, self._cell_lat, resolution_deg=resolution_deg)
        # re-target cell regridder onto the node grid
        if self._cell_regrid.shape != self._regrid.shape:
            self._cell_regrid = DelaunayRegridder(
                self._cell_lon, self._cell_lat,
                resolution_deg=float(self.x[1] - self.x[0]))

    def _node_values(self, std, ti):
        raise NotImplementedError  # frames read directly below

    def _fvcom_zslice(self, cols, on_cells):
        """(lay, m) sigma-layer columns -> (L, m) at self.depths using
        z = sigma*(h) per column (reference z_from_sigma with
        elevation=0, reader_netCDF_CF_unstructured.py:420-435)."""
        ds = self._ds
        sig = np.asarray(ds.variables[
            "siglay_center" if on_cells else "siglay"][:], np.float64)
        h = np.asarray(ds.variables[
            "h_center" if on_cells else "h"][:], np.float64)
        zc = sig * h[None, :]                     # (lay, m), negative
        # top-down layers -> ascending z for the column interp
        order = np.argsort(zc[:, 0])
        zc = zc[order]
        cols = np.asarray(cols, np.float64)[order]
        from .roms import zslice_columns
        return zslice_columns(cols.astype(np.float32), zc, self.depths)

    def _raw_values(self, std, ti):
        """(values, on_cells): raw data for one frame — surface layer,
        or full (L, m) depth-sliced columns when the variable rides
        sigma layers under use_3d.  For projected meshes u/v are
        rotated to true east/north by the grid convergence, like the
        reference's rotate_vectors (reference variables.py:59-109)."""
        uvs = ("x_sea_water_velocity", "y_sea_water_velocity")
        if (std in uvs and self._mesh_crs is not None
                and all(v in self._sources for v in uvs)):
            cache = getattr(self, "_uv_rot_cache", None)
            if cache is None or cache[0] != ti:
                u, oc = self._raw_values_unrotated(uvs[0], ti)
                v, _ = self._raw_values_unrotated(uvs[1], ti)
                lon = self._cell_lon if oc else self._node_lon
                lat = self._cell_lat if oc else self._node_lat
                gamma = self._mesh_crs.convergence(np, lon, lat)
                ue, vn = crslib.rotate_to_eastnorth(np, u, v, gamma)
                self._uv_rot_cache = (ti, ue.astype(np.float32),
                                      vn.astype(np.float32), oc)
            _, ue, vn, oc = self._uv_rot_cache
            return (ue if std == uvs[0] else vn), oc
        return self._raw_values_unrotated(std, ti)

    def _raw_values_unrotated(self, std, ti):
        raw, on_cells = self._sources[std]
        var = self._ds.variables[raw]
        if self._var_has_z.get(std):
            idx = tuple(ti if d == "time" else slice(None)
                        for d in var.dimensions)
            cols = ncio.cf_unpack(var, var[idx])   # (lay, m)
            return self._fvcom_zslice(cols, on_cells), on_cells
        idx = []
        for d in var.dimensions:
            if d in ("time",):
                idx.append(ti)
            elif d in ("siglay", "siglev"):
                idx.append(0)  # surface layer
            else:
                idx.append(slice(None))
        vals = ncio.cf_unpack(var, var[tuple(idx)])
        return vals.ravel(), on_cells

    def _node_frame(self, std, ti):
        """Native-path node values: cell-centre variables (u/v) are
        averaged onto the surrounding nodes through the ``nv``
        connectivity — the standard FVCOM dual-mesh treatment."""
        vals, on_cells = self._raw_values(std, ti)
        if not on_cells:
            return vals
        if self._nv is None:
            raise ValueError(f"{self.name}: native sampling of "
                             "cell-centre variables needs 'nv'")
        n = len(self._node_lon)
        w = np.isfinite(vals)
        v = np.where(w, vals, 0.0)
        sums = np.zeros(n, dtype=np.float64)
        cnt = np.zeros(n, dtype=np.float64)
        for k in range(3):
            np.add.at(sums, self._nv[:, k], v)
            np.add.at(cnt, self._nv[:, k], w.astype(np.float64))
        out = np.where(cnt > 0, sums / np.maximum(cnt, 1.0), np.nan)
        return out.astype(np.float32)

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        if std == "land_binary_mask":
            return super()._read_frame(std, ti, zslice, yslice, xslice)
        vals, on_cells = self._raw_values(std, ti)
        rg = self._cell_regrid if on_cells else self._regrid
        out = rg(np.nan_to_num(vals, nan=0.0))
        # pad/crop cell grid onto the node grid if they differ slightly
        ny, nx = self._regrid.shape
        if out.shape[-2:] != (ny, nx):
            lead = out.shape[:-2]
            fixed = np.full(lead + (ny, nx), np.nan, dtype=np.float32)
            fy = min(ny, out.shape[-2])
            fx = min(nx, out.shape[-1])
            fixed[..., :fy, :fx] = out[..., :fy, :fx]
            out = fixed
        if out.ndim == 3:
            return out[zslice, yslice, xslice]
        return out[yslice, xslice]
