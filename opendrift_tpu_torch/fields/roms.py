"""ROMS native reader: curvilinear C-grid, terrain-following sigma levels.

Port of ``opendrift_tpu/fields/roms.py`` (reference:
opendrift/readers/reader_ROMS_native.py:1-795,
opendrift/readers/roppy/depth.py:1-461).  Two sampling modes:

- ``sampling="native"`` (default): the packed table is the curvilinear
  array itself, and ``CurvilinearIndexCRS`` maps lon/lat to fractional
  (xi, eta) native indices on the device: a global affine part plus a
  smooth residual read from one 16-float row of a raster of the
  reference's fakeproj index interpolators (a clipped gather and a
  bilinear blend).  The raster table is copied to each device once.
- ``sampling="regrid"``: the same native frames are resampled once at
  load onto a regular lon/lat grid at native spacing, at the same
  fractional indices; the device transform is then affine, and the
  compact ``PRODUCTION_DEPTHS`` ladder keeps the packed table small.

Both modes mask with the staggered u/v masks before the ``angle``
rotation to east/north, unstagger to rho points, convert sigma to z
through Vtransform/Vstretching, fill the coast by grey dilation and clamp
the last pixel, all on the host with the JAX package's numpy/scipy code,
unchanged.  ``AKs`` (on ``s_w``) is served as
``ocean_vertical_diffusivity``.
"""

import logging

import numpy as np
import torch

from .grid import StructuredGridReader
from ..utils import ncio

logger = logging.getLogger(__name__)

ROMS_VARIABLE_MAP = {
    "u": "x_sea_water_velocity",
    "v": "y_sea_water_velocity",
    "temp": "sea_water_temperature",
    "salt": "sea_water_salinity",
    "zeta": "sea_surface_height",
    "uice": "sea_ice_x_velocity",
    "vice": "sea_ice_y_velocity",
    "aice": "sea_ice_area_fraction",
    "hice": "sea_ice_thickness",
    "w": "upward_sea_water_velocity",
    "AKs": "ocean_vertical_diffusivity",
    "Hsbl": "ocean_mixed_layer_thickness",
}

# the reference's fixed z-levels for sigma interpolation (positive-down
# here; reference reader_ROMS_native.py:134-138) — using the same levels
# keeps the vertical discretisation identical to the reference
DEFAULT_DEPTHS = np.array(
    [0.0, 0.5, 1.0, 3.0, 5.0, 10.0, 25.0, 50.0, 75.0, 100.0, 150.0,
     200.0, 250.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0, 900.0,
     1000.0, 1500.0, 2000.0, 2500.0, 3000.0, 3500.0, 4000.0, 4500.0,
     5000.0, 5500.0, 6000.0, 6500.0, 7000.0, 7500.0, 8000.0],
    dtype=np.float32)

# compact ladder for the regrid fast path: the packed-table row count
# (Z*Y*X) sets the gather working set, and measured on-chip the
# 15-level reference ladder costs ~40% of the fetch rate vs this
# 12-level one at bench shapes (docs/performance.md ledger) — regrid
# mode trades the reference's exact z discretisation for speed, native
# mode keeps it
PRODUCTION_DEPTHS = np.array(
    [0.0, 2.0, 5.0, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 150.0, 200.0,
     300.0, 500.0, 1000.0, 2000.0, 3000.0], dtype=np.float32)


def _bilin2(xp, arr, fi, fj):
    """Bilinear sample of 2D ``arr`` at fractional (row fi, col fj), on the
    host (``xp`` is numpy).  Indices are clipped to the grid; NaNs in arr
    propagate."""
    a = xp.asarray(arr)
    ny, nx = arr.shape
    fi = xp.clip(fi, 0.0, ny - 1.0)
    fj = xp.clip(fj, 0.0, nx - 1.0)
    i0 = xp.clip(xp.floor(fi).astype(xp.int32), 0, ny - 2)
    j0 = xp.clip(xp.floor(fj).astype(xp.int32), 0, nx - 2)
    wi = fi - i0
    wj = fj - j0
    v00 = a[i0, j0]
    v01 = a[i0, j0 + 1]
    v10 = a[i0 + 1, j0]
    v11 = a[i0 + 1, j0 + 1]
    return ((1 - wi) * (1 - wj) * v00 + (1 - wi) * wj * v01
            + wi * (1 - wj) * v10 + wi * wj * v11)


class CurvilinearIndexCRS:
    """The curvilinear grid's own 'projection': fwd maps lon/lat to
    fractional (xi, eta) NATIVE grid indices by bilinear lookup in a
    precomputed raster of the reference's fakeproj index interpolators
    (reference structured.py:92-107 spl_x/spl_y), so the device sampler
    gathers the native C-grid directly — no intermediate regrid.
    Positions outside the curvilinear hull map to NaN (=> uncovered).
    Vectors are pre-rotated to true east/north at load, so the grid
    convergence seen by the sampler is zero."""

    is_latlon = False

    def __init__(self, ras_xi, ras_eta, lon0, lat0, dlon, dlat,
                 lon_rho, lat_rho):
        ras_xi = np.asarray(ras_xi, np.float64)
        ras_eta = np.asarray(ras_eta, np.float64)
        # inside-hull flag BEFORE filling, dilated one raster cell so
        # hull-boundary nodes (the grid's own rho points) stay covered
        from scipy.ndimage import binary_dilation, distance_transform_edt
        inside = np.isfinite(ras_xi)
        self._inside = binary_dilation(inside, iterations=1)
        # fill outside-hull cells with the nearest finite index values:
        # fwd stays finite everywhere (sampling clamps), and coverage
        # is decided by the inside flag, not NaN propagation
        if (~inside).any() and inside.any():
            ind = distance_transform_edt(~inside, return_indices=True)[1]
            ras_xi = ras_xi[ind[0], ind[1]]
            ras_eta = ras_eta[ind[0], ind[1]]
        # filled raster index maps (kept for the regrid fast path,
        # which samples native frames at exactly these raster points)
        self._fill_xi = ras_xi
        self._fill_eta = ras_eta
        self._lon0 = float(lon0)
        self._lat0 = float(lat0)
        self._dlon = float(dlon)
        self._dlat = float(dlat)
        ny, nx = ras_xi.shape
        self._nras = (ny, nx)
        # TPU scalar gathers are the known trap (one 4-byte fetch per
        # index): evaluating the index map as 8+ raster gathers per
        # fetch costs more than the data gathers themselves.  Split the
        # map into a GLOBAL AFFINE part (pure flops) + a smooth residual
        # sampled with ONE row gather: pack [res_xi, res_eta, inside,
        # pad] as a (ny*nx, 4) table so each element fetches a single
        # 16-byte row, the same access pattern as the data sampler.
        RLON, RLAT = np.meshgrid(lon0 + dlon * np.arange(nx),
                                 lat0 + dlat * np.arange(ny))
        A = np.column_stack([RLON.ravel(), RLAT.ravel(),
                             np.ones(ny * nx)])
        w = inside.ravel()
        coef_xi, *_ = np.linalg.lstsq(A[w], ras_xi.ravel()[w],
                                      rcond=None)
        coef_eta, *_ = np.linalg.lstsq(A[w], ras_eta.ravel()[w],
                                       rcond=None)
        self._cx = coef_xi
        self._ce = coef_eta
        res_xi = ras_xi - (coef_xi[0] * RLON + coef_xi[1] * RLAT
                           + coef_xi[2])
        res_eta = ras_eta - (coef_eta[0] * RLON + coef_eta[1] * RLAT
                             + coef_eta[2])
        # pack the full 2x2 bilinear corner block per cell into one
        # 64-byte row: fwd then needs a SINGLE row gather per element
        # (scalar/multi-gather cost is the TPU bottleneck, not bytes)
        ins_f = self._inside.astype(np.float64)

        def corners(a):
            a00 = a
            a01 = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
            a10 = np.concatenate([a[1:, :], a[-1:, :]], axis=0)
            a11 = np.concatenate([a10[:, 1:], a10[:, -1:]], axis=1)
            return a00, a01, a10, a11
        cols = []
        for field in (res_xi, res_eta, ins_f):
            cols.extend(corners(field))
        cols.extend([np.zeros((ny, nx))] * 4)     # pad to 16 floats
        self._packed = np.stack([c.ravel() for c in cols],
                                axis=1).astype(np.float32)
        # residual nonlinearity within one raster cell bounds the
        # nearest-lookup index error (diagnostic, used by tests)
        self.residual_cell_err = float(max(
            np.abs(np.diff(res_xi, axis=0)).max(initial=0.0),
            np.abs(np.diff(res_xi, axis=1)).max(initial=0.0),
            np.abs(np.diff(res_eta, axis=0)).max(initial=0.0),
            np.abs(np.diff(res_eta, axis=1)).max(initial=0.0)))
        self._lon_rho = np.asarray(lon_rho, np.float32)
        self._lat_rho = np.asarray(lat_rho, np.float32)

    def _device_state(self, device):
        """The residual table and the grid as tensors on ``device``, made
        once per device (the raster never changes); float32 scalars keep
        the index arithmetic the JAX package's, and tensor divisors keep
        it a true division on the card.  The table is stored column-major,
        its 12 used columns only, so that a gather gives each column as a
        contiguous row for the blends."""
        cache = self.__dict__.setdefault("_device_states", {})
        if device not in cache:
            def f32(v):
                return torch.tensor(np.float32(v), device=device)
            cache[device] = {
                "columns": torch.as_tensor(
                    np.ascontiguousarray(self._packed[:, :12].T),
                    device=device),
                "lat0": f32(self._lat0), "dlat": f32(self._dlat),
                "lon0": f32(self._lon0), "dlon": f32(self._dlon),
                "cx": [f32(c) for c in self._cx],
                "ce": [f32(c) for c in self._ce]}
        return cache[device]

    def fwd(self, xp, lon, lat):
        if xp is np:
            return self._fwd_np(np.asarray(lon), np.asarray(lat))
        st = self._device_state(lon.device)
        fi = (lat - st["lat0"]) / st["dlat"]
        fj = (lon - st["lon0"]) / st["dlon"]
        ny, nx = self._nras
        fic = torch.clamp(fi, 0.0, ny - 1.0)
        fjc = torch.clamp(fj, 0.0, nx - 1.0)
        # a NaN position reads cell 0 (its result is NaN: not in the box)
        i0 = torch.clamp(torch.floor(torch.nan_to_num(fic, nan=0.0))
                         .to(torch.int64), 0, ny - 2)
        j0 = torch.clamp(torch.floor(torch.nan_to_num(fjc, nan=0.0))
                         .to(torch.int64), 0, nx - 2)
        wi = torch.clamp(fic - i0, 0.0, 1.0)
        wj = torch.clamp(fjc - j0, 0.0, 1.0)
        col = st["columns"][:, i0 * nx + j0]
        w00 = (1 - wi) * (1 - wj)
        w01 = (1 - wi) * wj
        w10 = wi * (1 - wj)
        w11 = wi * wj

        def blend(k):
            return (w00 * col[4 * k] + w01 * col[4 * k + 1]
                    + w10 * col[4 * k + 2] + w11 * col[4 * k + 3])
        cx, ce = st["cx"], st["ce"]
        x = cx[0] * lon + cx[1] * lat + cx[2] + blend(0)
        y = ce[0] * lon + ce[1] * lat + ce[2] + blend(1)
        in_box = (fi >= -0.5) & (fi <= ny - 0.5) \
            & (fj >= -0.5) & (fj <= nx - 0.5)
        # blended inside flag: > 0.49 keeps the dilated boundary band
        ins = (blend(2) > 0.49) & in_box
        nan = torch.full_like(x, float("nan"))
        return torch.where(ins, x, nan), torch.where(ins, y, nan)

    def _fwd_np(self, lon, lat):
        """:meth:`fwd` on the host, in the inputs' precision."""
        fi = (lat - self._lat0) / self._dlat
        fj = (lon - self._lon0) / self._dlon
        ny, nx = self._nras
        fic = np.clip(fi, 0.0, ny - 1.0)
        fjc = np.clip(fj, 0.0, nx - 1.0)
        i0 = np.clip(np.floor(fic).astype(np.int32), 0, ny - 2)
        j0 = np.clip(np.floor(fjc).astype(np.int32), 0, nx - 2)
        wi = np.clip(fic - i0, 0.0, 1.0)
        wj = np.clip(fjc - j0, 0.0, 1.0)
        row = self._packed[i0 * nx + j0]
        w00 = (1 - wi) * (1 - wj)
        w01 = (1 - wi) * wj
        w10 = wi * (1 - wj)
        w11 = wi * wj

        def blend(k):
            return (w00 * row[..., 4 * k] + w01 * row[..., 4 * k + 1]
                    + w10 * row[..., 4 * k + 2]
                    + w11 * row[..., 4 * k + 3])
        x = (self._cx[0] * lon + self._cx[1] * lat + self._cx[2]
             + blend(0))
        y = (self._ce[0] * lon + self._ce[1] * lat + self._ce[2]
             + blend(1))
        in_box = (fi >= -0.5) & (fi <= ny - 0.5) \
            & (fj >= -0.5) & (fj <= nx - 0.5)
        ins = (blend(2) > 0.49) & in_box
        nan = np.float32(np.nan)
        return np.where(ins, x, nan), np.where(ins, y, nan)

    def inv(self, xp, x, y):
        """Host (numpy) bilinear read of the rho-point coordinates."""
        lon = _bilin2(np, self._lon_rho, np.asarray(y), np.asarray(x))
        lat = _bilin2(np, self._lat_rho, np.asarray(y), np.asarray(x))
        return lon, lat

    def convergence(self, xp, lon, lat):
        if torch.is_tensor(lon):
            return torch.zeros_like(lon)
        return np.zeros_like(np.asarray(lon))


def s_stretch(N, theta_s, theta_b, stagger="rho", vstretching=1):
    """ROMS s-level stretching curves C(s), Vstretching 1-5
    (roppy.s_stretch equivalent, reference roppy/depth.py:383-455;
    formulas from the ROMS vertical-coordinate documentation).  Used
    when a file carries theta_s/theta_b but no Cs_r variable."""
    if stagger == "rho":
        K = np.arange(0.5, N)
    elif stagger == "w":
        K = np.arange(N + 1, dtype=np.float64)
    else:
        raise ValueError("stagger must be 'rho' or 'w'")
    S = -1.0 + K / N
    if vstretching == 1:
        cff1 = 1.0 / np.sinh(theta_s)
        cff2 = 0.5 / np.tanh(0.5 * theta_s)
        return ((1.0 - theta_b) * cff1 * np.sinh(theta_s * S)
                + theta_b * (cff2 * np.tanh(theta_s * (S + 0.5)) - 0.5))
    if vstretching == 2:
        a = b = 1.0
        Csur = (1 - np.cosh(theta_s * S)) / (np.cosh(theta_s) - 1)
        Cbot = np.sinh(theta_b * (S + 1)) / np.sinh(theta_b) - 1
        mu = (S + 1) ** a * (1 + (a / b) * (1 - (S + 1) ** b))
        return mu * Csur + (1 - mu) * Cbot
    if vstretching == 3:
        g = 3.0
        Csur = -np.log(np.cosh(g * (-S) ** theta_s)) / np.log(np.cosh(g))
        Cbot = (np.log(np.cosh(g * (S + 1) ** theta_b))
                / np.log(np.cosh(g)) - 1)
        mu = 0.5 * (1 - np.tanh(g * (S + 0.5)))
        return mu * Csur + (1 - mu) * Cbot
    if vstretching in (4, 5):
        if vstretching == 5:
            S1 = (K * K - 2 * K * N + K + N * N - N) / (N * N - N)
            S2 = (K * K - K * N) / (1.0 - N)
            S = -S1 - 0.01 * S2
        C = (1 - np.cosh(theta_s * S)) / (np.cosh(theta_s) - 1)
        return (np.exp(theta_b * C) - 1) / (1 - np.exp(-theta_b))
    raise ValueError(f"Unknown Vstretching {vstretching}")


def zslice_columns(data_sigma, z, depths):
    """(S, ...) sigma-level columns -> (L, ...) values at fixed target
    depths (positive down), linear in z with end-clamping — the
    vectorised roppy.multi_zslice (reference roppy/depth.py:213-285)."""
    S = z.shape[0]
    out = np.empty((len(depths),) + z.shape[1:], dtype=np.float32)
    for li, d in enumerate(depths):
        zt = -float(d)
        k = np.clip(np.sum(z < zt, axis=0), 1, S - 1)
        z_lo = np.take_along_axis(z, (k - 1)[None], 0)[0]
        z_hi = np.take_along_axis(z, k[None], 0)[0]
        v_lo = np.take_along_axis(data_sigma, (k - 1)[None], 0)[0]
        v_hi = np.take_along_axis(data_sigma, k[None], 0)[0]
        denom = np.where(z_hi != z_lo, z_hi - z_lo, 1.0)
        w = np.clip((zt - z_lo) / denom, 0.0, 1.0)
        out[li] = v_lo * (1.0 - w) + w * v_hi
    return out


def sdepth(h, zeta, hc, C, s, vtransform=2):
    """Depth of sigma levels (roppy.sdepth equivalent,
    reference roppy/depth.py:24-112).  Returns z (S, ...) negative down."""
    h = np.asarray(h)[None, ...]
    zeta_b = np.asarray(zeta)[None, ...]
    C = np.asarray(C).reshape((-1,) + (1,) * (h.ndim - 1))
    s = np.asarray(s).reshape(C.shape)
    if vtransform == 1:
        z0 = hc * s + (h - hc) * C
        return z0 + zeta_b * (1.0 + z0 / h)
    # Vtransform 2 (the modern default)
    z0 = (hc * s + h * C) / (hc + h)
    return zeta_b + (zeta_b + h) * z0


class ROMSReader(StructuredGridReader):
    """Reader for ROMS output (native curvilinear sigma grid)."""

    def __init__(self, filename, gridfile=None, name=None,
                 target_depths=None, refinement=1.0,
                 sampling="native"):
        if sampling not in ("native", "regrid"):
            raise ValueError("sampling must be 'native' or 'regrid'")
        self._sampling = sampling
        if isinstance(filename, (list, tuple)):
            self._files = [ncio.open_dataset(f) for f in filename]
            self.name = name or str(filename[0])
        else:
            self._files = [ncio.open_dataset(filename)]
            self.name = name or str(filename)
        ds = self._files[0]
        grid_ds = ncio.open_dataset(gridfile) if gridfile else ds
        self._grid_ds = grid_ds

        def gvar(n, required=True):
            src = grid_ds if n in grid_ds.variables else ds
            if n not in src.variables:
                if required:
                    raise ValueError(f"{self.name}: missing ROMS grid "
                                     f"variable '{n}'")
                return None
            v = src.variables[n]
            return ncio.cf_unpack(v, v[:])

        lon_rho = gvar("lon_rho").astype(np.float64)
        lat_rho = gvar("lat_rho").astype(np.float64)
        self._eta, self._xi = lon_rho.shape
        h = gvar("h")
        mask_rho = gvar("mask_rho", required=False)
        if mask_rho is None:
            mask_rho = np.ones_like(h)
        # staggered masks: u/v points carry their own land masks
        # (reference reader_ROMS_native.py:365-407); fall back to the
        # rho mask when a subset file does not include them
        mask_u = gvar("mask_u", required=False)
        mask_v = gvar("mask_v", required=False)
        self._mask_u = (np.nan_to_num(mask_u, nan=0.0) > 0.5
                        if mask_u is not None and
                        mask_u.shape == mask_rho.shape else None)
        self._mask_v = (np.nan_to_num(mask_v, nan=0.0) > 0.5
                        if mask_v is not None and
                        mask_v.shape == mask_rho.shape else None)
        angle = gvar("angle", required=False)
        if angle is None:
            angle = np.zeros_like(h)
        self._h = np.nan_to_num(h, nan=0.0)
        self._mask = np.nan_to_num(mask_rho, nan=0.0) > 0.5
        self._angle = np.nan_to_num(angle, nan=0.0)
        self._lon_rho = lon_rho
        self._lat_rho = lat_rho

        # ---- sigma machinery
        self._s_rho = gvar("s_rho", required=False)
        # CROCO names the stretching curve Cs_rho instead of Cs_r
        self._Cs_r = gvar("Cs_r", required=False)
        if self._Cs_r is None:
            self._Cs_r = gvar("Cs_rho", required=False)
        if self._Cs_r is None and self._s_rho is not None:
            # no stored stretching curve: compute from theta_s/theta_b
            # like reference reader_ROMS_native via roppy.s_stretch
            def scalar(n):
                v = gvar(n, required=False)
                if v is not None:
                    return float(np.asarray(v).ravel()[0])
                a = ds.attrs.get(n)
                return float(a) if a is not None else None

            th_s = scalar("theta_s")
            th_b = scalar("theta_b")
            vstr = scalar("Vstretching")
            if th_s is not None:
                self._Cs_r = s_stretch(
                    len(self._s_rho), th_s, th_b or 0.0,
                    vstretching=int(vstr) if vstr else 1)
        hc = gvar("hc", required=False)
        self._hc = float(np.ravel(hc)[0]) if hc is not None else 0.0
        vt = gvar("Vtransform", required=False)
        if vt is not None:
            vt = np.ravel(vt)[0]
        self._vtransform = int(vt) if vt is not None and np.isfinite(vt) \
            else 2
        self._n_sigma = len(self._s_rho) if self._s_rho is not None else 0

        # ---- time axis (ROMS: ocean_time; CROCO: time/scrum_time)
        tname = next(t for t in ("ocean_time", "time", "scrum_time")
                     if t in ds.variables)
        self.times = []
        self._file_of_frame = []
        self._index_in_file = []
        for fi, f in enumerate(self._files):
            tv = f.variables[tname]
            for i, t in enumerate(ncio.parse_cf_time(tv.attrs["units"],
                                                     tv[:])):
                self.times.append(t)
                self._file_of_frame.append(fi)
                self._index_in_file.append(i)
        order = np.argsort([t.timestamp() for t in self.times])
        self.times = [self.times[i] for i in order]
        self._file_of_frame = [self._file_of_frame[i] for i in order]
        self._index_in_file = [self._index_in_file[i] for i in order]

        # ---- variable mapping
        self._sources = {}
        self._var_has_z = {}
        self.variables = []
        for vname, std in ROMS_VARIABLE_MAP.items():
            if vname not in ds.variables:
                continue
            dims = ds.variables[vname].dimensions
            has_z = any(d in ("s_rho", "s_w") for d in dims)
            self._sources[std] = (vname, has_z)
            self._var_has_z[std] = has_z
            self.variables.append(std)
        self.variables += ["land_binary_mask",
                           "sea_floor_depth_below_sea_level"]
        self._var_has_z["land_binary_mask"] = False
        self._var_has_z["sea_floor_depth_below_sea_level"] = False

        # ---- NATIVE-grid sampling in index space.  The device grid IS
        # the curvilinear array: self.x/self.y are the (xi, eta) index
        # axes, and the CRS maps lon/lat -> fractional native index via
        # a fine raster of the reference's own fakeproj interpolators
        # (LinearNDInterpolator over the rho points -> index fields,
        # reference structured.py:92-107).  The device bilinear gather
        # then reproduces the reference's Linear2DInterpolator exactly
        # (interpolators.py:105-139) with no intermediate regrid.
        from scipy.interpolate import LinearNDInterpolator
        from scipy.spatial import Delaunay
        pts = np.column_stack([lon_rho.ravel(), lat_rho.ravel()])
        self._tri = Delaunay(pts)
        block_x, block_y = np.mgrid[0:self._xi, 0:self._eta]
        block_x, block_y = block_x.T, block_y.T
        spl_x = LinearNDInterpolator(
            (lon_rho.ravel(), lat_rho.ravel()), block_x.ravel(),
            fill_value=np.nan)
        import copy as _copy
        spl_y = _copy.deepcopy(spl_x)
        spl_y.values[:, 0] = block_y.ravel()
        self._spl_x, self._spl_y = spl_x, spl_y
        # raster spacing: native cell size in degrees / (3*refinement)
        dlon = max(float(np.median(np.abs(np.diff(lon_rho, axis=1)))),
                   1e-5) / (3.0 * refinement)
        dlat = max(float(np.median(np.abs(np.diff(lat_rho, axis=0)))),
                   1e-5) / (3.0 * refinement)
        nras_x = min(int((lon_rho.max() - lon_rho.min()) / dlon) + 2, 4096)
        nras_y = min(int((lat_rho.max() - lat_rho.min()) / dlat) + 2, 4096)
        rlon = np.linspace(lon_rho.min(), lon_rho.max(), nras_x)
        rlat = np.linspace(lat_rho.min(), lat_rho.max(), nras_y)
        RLON, RLAT = np.meshgrid(rlon, rlat)
        ras_xi = spl_x(RLON.ravel(), RLAT.ravel()).reshape(RLAT.shape)
        ras_eta = spl_y(RLON.ravel(), RLAT.ravel()).reshape(RLAT.shape)
        crs_obj = CurvilinearIndexCRS(
            ras_xi, ras_eta, rlon[0], rlat[0],
            float(rlon[1] - rlon[0]), float(rlat[1] - rlat[0]),
            lon_rho, lat_rho)
        if sampling == "native":
            self.crs = crs_obj
            # the packed grid excludes the last native row/col, like
            # the reference's block fetch ("avoiding the last pixel in
            # each dimension, since several grids are shifted",
            # reader_ROMS_native.py:478-482); samples beyond it clamp —
            # see _covers_idx
            self.x = np.arange(self._xi - 1, dtype=np.float64)
            self.y = np.arange(self._eta - 1, dtype=np.float64)
            self.proj4 = "+curvilinear_index"
            # DD sizes halos in metres; index-space axes need the
            # native cell size (parallel/tiled.py curvilinear path)
            self._curvilinear = True
        else:
            # PRODUCTION FAST PATH: frames are regridded at load onto
            # the regular lon/lat raster grid by sampling the native
            # arrays at the SAME fakeproj fractional indices (index-
            # space bilinear, the reference's own scheme) — the device
            # transform is then a pure affine, with no per-element
            # index-map gather (one whole HBM gather saved per fetch;
            # the scalar-gather rate is the TPU bottleneck).  Values
            # differ from the native path only by the second bilinear
            # resample; the delta is bounded in
            # tests/test_reference_roms_values_parity.py (regrid mode).
            self._crs_obj = crs_obj
            # regrid TARGET grid at ~native spacing/refinement: gather
            # speed scales with the packed-table working set (the r3
            # lesson: a 30k-row table gathers ~3x faster than a
            # 330k-row one), so the target grid is coarser than the
            # index-map raster
            t_dlon = max(float(np.median(np.abs(np.diff(lon_rho,
                                                        axis=1)))),
                         1e-5) / refinement
            t_dlat = max(float(np.median(np.abs(np.diff(lat_rho,
                                                        axis=0)))),
                         1e-5) / refinement
            ntx = min(int((lon_rho.max() - lon_rho.min()) / t_dlon) + 2,
                      2048)
            nty = min(int((lat_rho.max() - lat_rho.min()) / t_dlat) + 2,
                      2048)
            tlon = np.linspace(lon_rho.min(), lon_rho.max(), ntx)
            tlat = np.linspace(lat_rho.min(), lat_rho.max(), nty)
            TL, TA = np.meshgrid(tlon, tlat)
            mx = spl_x(TL.ravel(), TA.ravel()).reshape(TA.shape)
            me = spl_y(TL.ravel(), TA.ravel()).reshape(TA.shape)
            bad = ~np.isfinite(mx)
            if bad.any() and (~bad).any():
                from scipy.ndimage import distance_transform_edt
                ind = distance_transform_edt(bad,
                                             return_indices=True)[1]
                mx = mx[ind[0], ind[1]]
                me = me[ind[0], ind[1]]
            # the reference's last-pixel clamp
            self._map_eta = np.clip(me, 0.0, self._eta - 2.0)
            self._map_xi = np.clip(mx, 0.0, self._xi - 2.0)
            self.x = tlon.astype(np.float64)
            self.y = tlat.astype(np.float64)
            self.proj4 = "+proj=latlong"
            self.crs = None     # base resolves from proj4
            # regrid values are already bounded-approximate (u-rms
            # <=5e-3 vs native); post-cliff tables therefore default to
            # compensated f16-pair storage (error ~2^-21, 3 orders
            # below the mode's own delta) — grid.py device_state
            self.packed_auto_compensate = True
        clat = np.cos(np.radians(lat_rho))
        d_xi = np.hypot(np.diff(lon_rho, axis=1) * clat[:, 1:],
                        np.diff(lat_rho, axis=1)) * 111320.0
        d_eta = np.hypot(np.diff(lon_rho, axis=0) * clat[1:, :],
                         np.diff(lat_rho, axis=0)) * 111320.0
        self._min_cell_m = float(min(np.nanmin(d_xi), np.nanmin(d_eta)))

        # depth levels for the packed blocks
        if target_depths is None:
            hmax = float(np.nanmax(self._h))
            if sampling == "native":
                # one level beyond the deepest seafloor so the last
                # water interval still brackets (below it values clamp,
                # like the reference's vertical buffer)
                ladder = DEFAULT_DEPTHS
                cut = int(np.searchsorted(ladder, max(hmax, 5.0))) + 1
            else:
                # fast path: stop AT the deepest covering level (below
                # it sampling clamps, the documented clamped-z
                # semantics) — gather rate drops ~40% once the packed
                # table crosses the 2^15-row placement cliff measured
                # in docs/performance.md (ops/interp.py
                # GATHER_FAST_MAX_ROWS)
                ladder = PRODUCTION_DEPTHS
                cut = int(np.searchsorted(ladder, max(hmax, 5.0),
                                          side="right"))
            target_depths = ladder[:max(cut, 2)]
        self.depths = np.asarray(target_depths, dtype=np.float32)

        # static regridded fields
        self._static_cache = {}
        super().__init__()

    # ----------------------------------------------------------- regrid --
    @staticmethod
    def _expand_nan(data):
        """The reference's ``expand_numpy_array``: one grey-dilation
        pass replacing NaNs with the 3x3 neighbourhood max (reference
        interpolators.py:9-21)."""
        from scipy.ndimage import grey_dilation
        mask = ~np.isfinite(data)
        if not mask.any() or mask.all():
            return
        minval = np.finfo(data.dtype).min
        data[mask] = minval
        data[mask] = grey_dilation(data, size=3)[mask]
        data[data == minval] = np.nan

    def _fill_coast(self, field2d):
        """<=10 grey-dilation passes filling NaNs (land/below-bottom)
        with the 3x3 neighbourhood max — the reference's lazy
        ``expand_numpy_array`` loop pre-applied at load (dilation pass k
        only touches cells still NaN after pass k-1, so the eager fill
        yields the same values the reference's on-demand expansion
        would).  Cells >10 passes from data stay NaN, exactly like the
        reference's 10-iteration cut-off (interpolators.py:126-130)."""
        out = np.asarray(field2d, dtype=np.float32).copy()
        for _ in range(10):
            if np.isfinite(out).all():
                break
            self._expand_nan(out)
        return out

    def _sigma_to_z(self, data_sigma, zeta):
        """(S, eta, xi) sigma-level data -> (L, eta, xi) at fixed target
        depths (vectorised column interpolation; roppy.zslice equivalent,
        reference roppy/depth.py:115-199)."""
        z = sdepth(self._h, zeta, self._hc, self._Cs_r, self._s_rho,
                   self._vtransform)          # (S, eta, xi), ascending
        return zslice_columns(data_sigma, z, self.depths)

    def _unstagger(self, data, kind):
        """Average u/v-point data to rho points when staggered; subset
        files often store them already on matching shapes."""
        if data.shape[-2:] == (self._eta, self._xi):
            return data
        out = np.full(data.shape[:-2] + (self._eta, self._xi), np.nan,
                      dtype=np.float32)
        if kind == "u":  # (eta, xi-1)
            out[..., :, 1:-1] = 0.5 * (data[..., :, :-1]
                                       + data[..., :, 1:])
            out[..., :, 0] = data[..., :, 0]
            out[..., :, -1] = data[..., :, -1]
        else:            # (eta-1, xi)
            out[..., 1:-1, :] = 0.5 * (data[..., :-1, :]
                                       + data[..., 1:, :])
            out[..., 0, :] = data[..., 0, :]
            out[..., -1, :] = data[..., -1, :]
        return out

    def _read_pair_rotated(self, uname, vname, ti):
        """u/v at rho points rotated to east/north (cached per frame)."""
        key = ("uv_eastnorth", uname, ti)
        if key in self._static_cache:
            return self._static_cache[key]
        fi = self._file_of_frame[ti]
        ii = self._index_in_file[ti]
        ds = self._files[fi]
        uv = []
        for nm, kind in ((uname, "u"), (vname, "v")):
            var = ds.variables[nm]
            raw = var[ii]
            data = ncio.cf_unpack(var, raw)
            data = self._unstagger(data, kind)
            # mask with the staggered land mask BEFORE rotation, like
            # the reference (reader_ROMS_native.py:598-617): rotation
            # then spreads NaN to the mask union, and the regrid's
            # grey-dilation fill reproduces the reference's coastal
            # extrapolation
            m = self._mask_u if kind == "u" else self._mask_v
            if m is None:
                m = self._mask
            data = np.where(m[None] if data.ndim == 3 else m,
                            data, np.nan)
            uv.append(data)
        u, v = uv
        ca, sa = np.cos(self._angle), np.sin(self._angle)
        ue = u * ca - v * sa
        vn = u * sa + v * ca
        self._static_cache = {k: val for k, val in
                              self._static_cache.items()
                              if k[0] != "uv_eastnorth" or k[2] == ti}
        self._static_cache[key] = (ue, vn)
        return ue, vn

    def _zeta(self, ti):
        fi = self._file_of_frame[ti]
        ii = self._index_in_file[ti]
        ds = self._files[fi]
        if "zeta" in ds.variables:
            var = ds.variables["zeta"]
            return np.nan_to_num(ncio.cf_unpack(var, var[ii]), nan=0.0)
        return np.zeros_like(self._h)

    # ------------------------------------------------------------ frames -
    def _native_frame(self, std, ti):
        """Full native (eta, xi) frame: mask + rotate + zslice +
        coastal grey-dilation fill — the reference's fetch semantics."""
        if std == "land_binary_mask":
            if "land" not in self._static_cache:
                self._static_cache["land"] = \
                    (~self._mask).astype(np.float32)
            return self._static_cache["land"]
        if std == "sea_floor_depth_below_sea_level":
            if "h" not in self._static_cache:
                # land h is masked out and coast-filled by grey
                # dilation, like the reference's masked fetch + NaN
                # expansion (reader_ROMS_native.py:610-617)
                self._static_cache["h"] = self._fill_coast(
                    np.where(self._mask, self._h, np.nan))
            return self._static_cache["h"]

        vname, has_z = self._sources[std]
        pair = {"x_sea_water_velocity": ("u", "v", 0),
                "y_sea_water_velocity": ("u", "v", 1),
                "sea_ice_x_velocity": ("uice", "vice", 0),
                "sea_ice_y_velocity": ("uice", "vice", 1)}
        if std in pair:
            un, vn_, comp = pair[std]
            # already masked with the staggered masks pre-rotation
            data = self._read_pair_rotated(un, vn_, ti)[comp]
        else:
            fi = self._file_of_frame[ti]
            ii = self._index_in_file[ti]
            var = self._files[fi].variables[vname]
            data = ncio.cf_unpack(var, var[ii])
            data = np.where(
                self._mask[None] if data.ndim == 3 else self._mask,
                data, np.nan)
        if has_z and data.ndim == 3:
            data = self._sigma_to_z(data, self._zeta(ti))
            return np.stack([self._fill_coast(data[li])
                             for li in range(data.shape[0])])
        return self._fill_coast(data)

    def _to_raster(self, arr, nearest=False):
        """Native frame -> regular lon/lat raster grid by sampling at
        the precomputed fakeproj fractional indices (nearest for
        masks, like the reference's landmask interpolator)."""
        from scipy.ndimage import map_coordinates
        return map_coordinates(
            np.asarray(arr, np.float32),
            [self._map_eta, self._map_xi],
            order=0 if nearest else 1,
            mode="nearest").astype(np.float32)

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        """'native': native (eta, xi) frames gathered at the fwd()
        fractional indices — the reference's index-space bilinear
        end-to-end.  'regrid': the same native frames resampled once at
        load onto the regular raster grid (affine device transform, no
        per-element index-map gather)."""
        out = self._native_frame(std, ti)
        if self._sampling == "regrid":
            near = std == "land_binary_mask"
            key = ("raster", std, ti if std not in
                   ("land_binary_mask",
                    "sea_floor_depth_below_sea_level") else -1)
            cached = self._static_cache.get(key)
            if cached is None:
                if out.ndim == 3:
                    cached = np.stack([self._to_raster(out[k], near)
                                       for k in range(out.shape[0])])
                else:
                    cached = self._to_raster(out, near)
                # bounded per-frame cache
                stale = [k for k in self._static_cache
                         if isinstance(k, tuple) and k[0] == "raster"
                         and k[2] not in (-1, ti, ti - 1, ti + 1)]
                for k in stale:
                    del self._static_cache[k]
                self._static_cache[key] = cached
            out = cached
        if out.ndim == 3:
            return out[:, yslice, xslice]
        return out[yslice, xslice]

    def _covers_idx(self, xi, yi, eps=1e-2):
        """Reference parity: the packed block stops one native cell
        short of the grid edge, but coverage extends to the last rho
        point (fakeproj xmax = shape-1) with CLAMPED sampling there —
        the reference's NaN-refill with mode='nearest'
        (interpolators.py:133-136).  Outside the curvilinear hull the
        CRS returns NaN indices, which fail these comparisons.
        Regrid mode keeps the base bbox test (its grid IS the lon/lat
        bbox; hull masking is host-side only — documented fast-path
        semantics)."""
        if self._sampling == "regrid":
            return super()._covers_idx(xi, yi, eps)
        nx = self._ix.stop - self._ix.start
        ny = self._iy.stop - self._iy.start
        hi_x = nx - 1 + eps + (1.0 if self._ix.stop == len(self.x)
                               else 0.0)
        hi_y = ny - 1 + eps + (1.0 if self._iy.stop == len(self.y)
                               else 0.0)
        return ((xi >= -eps) & (xi <= hi_x)
                & (yi >= -eps) & (yi <= hi_y))

    def covers_positions(self, lon, lat):
        """Host-side: positions inside the curvilinear hull (device
        coverage follows from fwd() returning NaN outside it)."""
        lon1 = np.atleast_1d(np.asarray(lon, np.float64)).ravel()
        lat1 = np.atleast_1d(np.asarray(lat, np.float64)).ravel()
        x, y = self.crs.fwd(np, lon1, lat1)
        # like the device's _covers_idx: the packed grid stops one cell
        # short of the native edge but coverage extends to the last rho
        # point (clamped sampling there)
        ok = np.isfinite(x) & np.isfinite(y)
        pts = np.column_stack([lon1, lat1])
        # small tol: hull BOUNDARY nodes (the grid's own rho points)
        # must count as covered despite fp jitter
        return ok & (self._tri.find_simplex(pts, tol=1e-4) >= 0)
