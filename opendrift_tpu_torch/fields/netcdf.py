"""Generic CF-compliant NetCDF reader.

Port of ``opendrift_tpu/fields/netcdf.py`` (reference:
opendrift/readers/reader_netCDF_CF_generic.py:1-626): autodetects the
coordinate variables, the CF grid mapping (-> ``utils/crs.py``), z levels,
the time axis and an ensemble axis; maps data variables to CF standard
names with the alias table (reference basereader/__init__.py:56-83); reads
scale/offset-packed frames on demand (``utils/ncio.py``).  A single file or
a list of files concatenated along time.

Regular 1D-coordinate grids are sampled through the base class.
Curvilinear (2D lon/lat) grids take the inverse-lookup path (the
reference's 'fakeproj' slot, basereader/structured.py:46-119): two regular
rasters of fractional native indices, built once on the host with scipy,
are copied to each device once and sampled bilinearly there, so field
values stay on the native grid.  ROMS C-grids have their own reader
(``fields/roms.py``).  The host side (decode, fill, lookup rasters) is the
JAX package's numpy/scipy code, unchanged.
"""

import logging

import numpy as np
import torch

from .grid import StructuredGridReader
from ..utils import ncio

logger = logging.getLogger(__name__)

# semantic alias table: producer standard_name -> framework variable name
# (reference basereader/__init__.py:56-83)
VARIABLE_ALIASES = {
    "sea_water_potential_temperature": "sea_water_temperature",
    "x_wind_10m": "x_wind",
    "y_wind_10m": "y_wind",
    "sea_water_x_velocity": "x_sea_water_velocity",
    "sea_water_y_velocity": "y_sea_water_velocity",
    "baroclinic_x_sea_water_velocity": "x_sea_water_velocity",
    "baroclinic_y_sea_water_velocity": "y_sea_water_velocity",
    "x_sea_ice_velocity": "sea_ice_x_velocity",
    "y_sea_ice_velocity": "sea_ice_y_velocity",
    "salinity_vertical_diffusion_coefficient": "ocean_vertical_diffusivity",
    "ocean_vertical_salt_diffusivity": "ocean_vertical_diffusivity",
    "ocean_vertical_tracer_diffusivity": "ocean_vertical_diffusivity",
    "ocean_mixed_layer_thickness_defined_by_sigma_theta":
        "ocean_mixed_layer_thickness",
    "sea_floor_depth_below_sea_surface": "sea_floor_depth_below_sea_level",
    "sea_floor_depth_below_geoid": "sea_floor_depth_below_sea_level",
    "sea_surface_elevation": "sea_surface_height",
    "sea_surface_elevation_anomaly": "sea_surface_height",
    "sea_surface_height_above_mean_sea_level": "sea_surface_height",
    "sea_surface_height_above_sea_level": "sea_surface_height",
    "sea_surface_height_above_geoid": "sea_surface_height",
}

# variables whose components are already true east/north (no grid rotation)
EASTNORTH_ALIASES = {
    "eastward_sea_water_velocity": "x_sea_water_velocity",
    "surface_eastward_sea_water_velocity": "x_sea_water_velocity",
    "northward_sea_water_velocity": "y_sea_water_velocity",
    "surface_northward_sea_water_velocity": "y_sea_water_velocity",
    "eastward_wind": "x_wind",
    "northward_wind": "y_wind",
    "sea_surface_wave_stokes_drift_eastward_velocity":
        "sea_surface_wave_stokes_drift_x_velocity",
    "sea_surface_wave_stokes_drift_northward_velocity":
        "sea_surface_wave_stokes_drift_y_velocity",
    "eastward_sea_ice_velocity": "sea_ice_x_velocity",
    "northward_sea_ice_velocity": "sea_ice_y_velocity",
}

_X_STANDARD_NAMES = {"projection_x_coordinate", "grid_longitude",
                     "longitude"}
_Y_STANDARD_NAMES = {"projection_y_coordinate", "grid_latitude", "latitude"}


def _cf_grid_mapping_to_proj4(attrs):
    """Build a proj4 string from CF grid-mapping attributes
    (reference reader_netCDF_CF_generic.py:102-150 equivalent)."""
    if "proj4_string" in attrs:
        return attrs["proj4_string"]
    if "proj4" in attrs:
        return attrs["proj4"]
    name = attrs.get("grid_mapping_name")
    a = attrs.get("earth_radius",
                  attrs.get("semi_major_axis", 6371000.0))
    b = attrs.get("semi_minor_axis", None)
    ell = f"+a={a} +b={b}" if b is not None else f"+R={a}"
    if name == "polar_stereographic":
        lat0 = attrs.get("latitude_of_projection_origin", 90.0)
        lon0 = attrs.get("straight_vertical_longitude_from_pole",
                         attrs.get("longitude_of_projection_origin", 0.0))
        latts = attrs.get("standard_parallel", lat0)
        return (f"+proj=stere +lat_0={lat0} +lon_0={lon0} "
                f"+lat_ts={latts} +x_0={attrs.get('false_easting', 0.0)} "
                f"+y_0={attrs.get('false_northing', 0.0)} {ell}")
    if name == "stereographic":
        return (f"+proj=stere "
                f"+lat_0={attrs.get('latitude_of_projection_origin', 0.0)} "
                f"+lon_0={attrs.get('longitude_of_projection_origin', 0.0)} "
                f"+k_0={attrs.get('scale_factor_at_projection_origin', 1.0)} "
                f"{ell}")
    if name == "lambert_conformal_conic":
        sp = attrs.get("standard_parallel", 60.0)
        sp = np.atleast_1d(sp)
        lat1 = sp[0]
        lat2 = sp[1] if len(sp) > 1 else sp[0]
        return (f"+proj=lcc "
                f"+lat_0={attrs.get('latitude_of_projection_origin', lat1)} "
                f"+lon_0={attrs.get('longitude_of_central_meridian', 0.0)} "
                f"+lat_1={lat1} +lat_2={lat2} "
                f"+x_0={attrs.get('false_easting', 0.0)} "
                f"+y_0={attrs.get('false_northing', 0.0)} {ell}")
    if name == "mercator":
        return (f"+proj=merc "
                f"+lon_0={attrs.get('longitude_of_projection_origin', 0.0)} "
                f"+lat_ts={attrs.get('standard_parallel', 0.0)} {ell}")
    if name == "transverse_mercator":
        return (f"+proj=tmerc "
                f"+lat_0={attrs.get('latitude_of_projection_origin', 0.0)} "
                f"+lon_0={attrs.get('longitude_of_central_meridian', 0.0)} "
                f"+k_0={attrs.get('scale_factor_at_central_meridian', 1.0)} "
                f"+x_0={attrs.get('false_easting', 0.0)} "
                f"+y_0={attrs.get('false_northing', 0.0)} {ell}")
    if name == "rotated_latitude_longitude":
        return (f"+proj=ob_tran +o_proj=longlat "
                f"+o_lat_p={attrs.get('grid_north_pole_latitude', 90.0)} "
                f"+lon_0={180 + attrs.get('grid_north_pole_longitude', 0.0)} "
                f"{ell}")
    if name in ("latitude_longitude", None):
        return "+proj=latlong"
    raise ValueError(f"Unsupported CF grid mapping: {name}")


class NetCDFReader(StructuredGridReader):
    """CF NetCDF reader over regular 1D-coordinate grids."""

    def __init__(self, filename, name=None, proj4=None,
                 standard_name_mapping=None, shift_x=0.0, shift_y=0.0):
        if isinstance(filename, (list, tuple)):
            self._files = [ncio.open_dataset(f) for f in filename]
            self.name = name or str(filename[0])
        else:
            self._files = [ncio.open_dataset(filename)]
            self.name = name or str(filename)
        ds = self._files[0]
        self._std_map = dict(standard_name_mapping or {})

        # ---- time axis (concatenated over files)
        time_name, time_var = self._find_time(ds)
        self.times = []
        self._file_of_frame = []
        self._index_in_file = []
        for fi, f in enumerate(self._files):
            tv = f.variables[time_name]
            raw_t = np.asarray(tv[:], dtype=np.float64)
            # trim corrupt/fill time entries (reference
            # reader_netCDF_CF_generic.py:210-239 corrupt-time trimming)
            good = np.isfinite(raw_t) & (np.abs(raw_t) < 1e30)
            if not good.all():
                logger.warning("%s: dropping %d corrupt time frames",
                               self.name, int((~good).sum()))
            tvals = ncio.parse_cf_time(tv.attrs["units"], raw_t[good])
            for i, t in zip(np.nonzero(good)[0], tvals):
                self.times.append(t)
                self._file_of_frame.append(fi)
                self._index_in_file.append(int(i))
        if not self.times:
            raise ValueError(f"{self.name}: no valid time frames "
                             "(all time values are fill/corrupt)")
        order = np.argsort([t.timestamp() for t in self.times])
        self.times = [self.times[i] for i in order]
        self._file_of_frame = [self._file_of_frame[i] for i in order]
        self._index_in_file = [self._index_in_file[i] for i in order]
        self._time_dim = time_name

        # ---- spatial coordinates
        self._curvilinear = False
        (self._x_name, self._y_name, x, y,
         is_latlon) = self._find_xy(ds)
        if self._curvilinear:
            xv = ds.variables[self._x_name]
            self._xdim = xv.dimensions[-1]
            self._ydim = xv.dimensions[-2]
        else:
            self._xdim = ds.variables[self._x_name].dimensions[-1]
            self._ydim = ds.variables[self._y_name].dimensions[-1]

        # ---- projection
        if proj4 is None:
            proj4 = self._find_proj4(ds, is_latlon)
        self.proj4 = proj4

        # ---- vertical axis
        self._z_name, depths, self._z_positive_down = self._find_z(ds)
        self.depths = depths

        # ---- ensemble axis (EPS forcing): members are served round-robin
        # to elements (reference reader_netCDF_CF_generic.py:560-569)
        self._ens_dim = None
        self.ensemble_size = 1
        for cand in ("realization", "ensemble_member", "member"):
            if cand in ds.dimensions and (ds.dimensions[cand] or 0) > 1:
                self._ens_dim = cand
                self.ensemble_size = int(ds.dimensions[cand])
                logger.info("%s: ensemble forcing with %d members",
                            self.name, self.ensemble_size)
                break

        # ---- variable mapping
        self._sources = {}        # std -> (var name, has_z, invert_sign)
        self._var_has_z = {}
        self.variables = []
        xdim, ydim = self._xdim, self._ydim
        for vname, var in ds.variables.items():
            if vname in (self._x_name, self._y_name, time_name,
                         self._z_name):
                continue
            dims = var.dimensions
            if xdim not in dims or ydim not in dims:
                continue
            std = var.attrs.get("standard_name", None)
            # 2D coordinate/mask variables are not environment variables
            if std in ("latitude", "longitude", "area_type",
                       "projection_x_coordinate", "projection_y_coordinate"):
                continue
            if vname in self._std_map:
                std = self._std_map[vname]
            elif std in EASTNORTH_ALIASES:
                std = EASTNORTH_ALIASES[std]
            elif std in VARIABLE_ALIASES:
                std = VARIABLE_ALIASES[std]
            elif std is None and vname in VARIABLE_ALIASES:
                std = VARIABLE_ALIASES[vname]
            elif std is None:
                continue
            if std in self._sources:
                continue
            has_z = self._z_name is not None and self._z_name in \
                [d for d in dims]
            self._sources[std] = (vname, has_z)
            self._var_has_z[std] = has_z
            self.variables.append(std)

        # derived landmask: cells where ocean variables are fill values
        # (reference: derived-variable mappings, basereader/
        # variables.py:449-479 'land_binary_mask from sea_floor_depth')
        self._landmask_source = None
        if "land_binary_mask" not in self.variables:
            for cand in ("x_sea_water_velocity", "sea_water_temperature",
                         "sea_floor_depth_below_sea_level"):
                if cand in self._sources:
                    vname, has_z = self._sources[cand]
                    raw = ds.variables[vname]
                    probe = ncio.cf_unpack(
                        raw, raw[tuple(0 if d not in (
                            ds.variables[self._x_name].dimensions[-1],
                            ds.variables[self._y_name].dimensions[-1])
                            else slice(None) for d in raw.dimensions)])
                    if probe.ndim == 2 and np.isnan(probe).any() \
                            and not np.isnan(probe).all():
                        self._landmask_source = cand
                        self._land_raster = (~np.isfinite(probe)).astype(
                            np.float32)
                        self.variables.append("land_binary_mask")
                        self._var_has_z["land_binary_mask"] = False
                        break

        # hidden grid-registration correction, in grid units
        # (reference reader_netCDF_CF_generic.py:609-624 shift_x/shift_y)
        self.x = x + shift_x
        self.y = y + shift_y
        super().__init__()
        if self._curvilinear:
            self._build_inverse_lookup()

    # ------------------------------------------------------ autodetection
    def _find_time(self, ds):
        for name, var in ds.variables.items():
            if var.ndim != 1:
                continue
            if var.attrs.get("standard_name") == "time" or \
                    " since " in str(var.attrs.get("units", "")):
                if name in ("forecast_reference_time",):
                    continue
                return name, var
        raise ValueError(f"{self.name}: no time coordinate found")

    def _find_xy(self, ds):
        xname = yname = None
        for name, var in ds.variables.items():
            if var.ndim != 1:
                continue
            std = var.attrs.get("standard_name", "")
            units = str(var.attrs.get("units", ""))
            axis = var.attrs.get("axis", "")
            if xname is None and (std in _X_STANDARD_NAMES or axis == "X"
                                  or name in ("x", "X", "lon",
                                              "longitude")):
                if std != "latitude":
                    xname = name
            if yname is None and (std in _Y_STANDARD_NAMES or axis == "Y"
                                  or name in ("y", "Y", "lat", "latitude")):
                if std != "longitude":
                    yname = name
        if xname is None or yname is None:
            found = self._find_xy_curvilinear(ds)
            if found is not None:
                return found
            raise ValueError(
                f"{self.name}: no 1D x/y coordinates and no 2D lon/lat "
                f"pair found")
        xv = ds.variables[xname]
        yv = ds.variables[yname]
        x = np.asarray(xv[:], dtype=np.float64)
        y = np.asarray(yv[:], dtype=np.float64)
        is_latlon = (xv.attrs.get("standard_name") == "longitude"
                     or "degree" in str(xv.attrs.get("units", "")))
        if not is_latlon:
            if str(xv.attrs.get("units", "")) == "km":
                x = x * 1000.0
            if str(yv.attrs.get("units", "")) == "km":
                y = y * 1000.0
        return xname, yname, x, y, is_latlon

    def _find_xy_curvilinear(self, ds):
        """Curvilinear grids: 2D lon/lat coordinate pair -> native index
        axes.  The architectural slot of the reference's 'fakeproj'
        fallback (reference basereader/structured.py:46-119: LinearND
        inverse mapping of 2D lon/lat to fractional indices); here the
        inverse map is precomputed once into regular lookup rasters that
        the device samples bilinearly inside the fused kernel — field
        data stays on the NATIVE grid (no regridding of values)."""
        lon_name = lat_name = None
        for name, var in ds.variables.items():
            if var.ndim != 2:
                continue
            std = var.attrs.get("standard_name", "")
            if lon_name is None and (std == "longitude"
                                     or name in ("lon", "longitude")):
                lon_name = name
            if lat_name is None and (std == "latitude"
                                     or name in ("lat", "latitude")):
                lat_name = name
        if lon_name is None or lat_name is None:
            return None
        lon2d = np.asarray(ds.variables[lon_name][:], dtype=np.float64)
        lat2d = np.asarray(ds.variables[lat_name][:], dtype=np.float64)
        self._curvilinear = True
        self._lon2d, self._lat2d = lon2d, lat2d
        nj, ni = lon2d.shape
        logger.info("%s: curvilinear grid (%d x %d), building inverse "
                    "index lookup", self.name, nj, ni)
        return (lon_name, lat_name, np.arange(ni, dtype=np.float64),
                np.arange(nj, dtype=np.float64), True)

    def _find_proj4(self, ds, is_latlon):
        # a grid_mapping variable referenced by any data variable
        for name, var in ds.variables.items():
            gm = var.attrs.get("grid_mapping")
            if gm and gm in ds.variables:
                return _cf_grid_mapping_to_proj4(ds.variables[gm].attrs)
        # global attribute fallback
        for key in ("proj4", "proj4_string"):
            if key in ds.attrs:
                return ds.attrs[key]
        # bare grid-mapping variable (no data var referencing it)
        for name, var in ds.variables.items():
            if "grid_mapping_name" in var.attrs:
                return _cf_grid_mapping_to_proj4(var.attrs)
        if is_latlon:
            return "+proj=latlong"
        raise ValueError(f"{self.name}: no projection information found")

    def _find_z(self, ds):
        for name, var in ds.variables.items():
            if var.ndim != 1:
                continue
            std = var.attrs.get("standard_name", "")
            if std in ("depth", "depth_below_geoid") or name in (
                    "depth", "z", "lev", "level"):
                vals = np.asarray(var[:], dtype=np.float32)
                positive_down = var.attrs.get("positive", "down") != "up"
                if not positive_down:
                    vals = -vals
                # store ascending positive-down
                if len(vals) > 1 and vals[1] < vals[0]:
                    self._z_flip = True
                    vals = vals[::-1]
                else:
                    self._z_flip = False
                return name, vals, positive_down
        self._z_flip = False
        return None, None, True

    # --------------------------------------------------- curvilinear path -
    def _build_inverse_lookup(self, oversample=1.5, max_cells=4_000_000):
        """Precompute regular lon/lat rasters of fractional native
        indices (XI, YI) by evaluating one LinearND inverse map — done
        once on the host; the device then recovers native indices with
        two cheap bilinear raster lookups per position.  NaN outside
        the grid hull -> position counts as not covered."""
        from scipy.interpolate import LinearNDInterpolator

        lon2d, lat2d = self._lon2d, self._lat2d
        nj, ni = lon2d.shape
        dlon = np.nanmedian(np.abs(np.diff(lon2d, axis=1)))
        dlat = np.nanmedian(np.abs(np.diff(lat2d, axis=0)))
        dlon = max(dlon / oversample, 1e-6)
        dlat = max(dlat / oversample, 1e-6)
        lon0, lon1 = float(np.nanmin(lon2d)), float(np.nanmax(lon2d))
        lat0, lat1 = float(np.nanmin(lat2d)), float(np.nanmax(lat2d))
        nlon = int((lon1 - lon0) / dlon) + 2
        nlat = int((lat1 - lat0) / dlat) + 2
        while nlon * nlat > max_cells:
            nlon = max(nlon // 2, 2)
            nlat = max(nlat // 2, 2)
        glon = np.linspace(lon0, lon1, nlon)
        glat = np.linspace(lat0, lat1, nlat)
        JJ, II = np.meshgrid(np.arange(nj, dtype=np.float64),
                             np.arange(ni, dtype=np.float64),
                             indexing="ij")
        pts = np.column_stack([lon2d.ravel(), lat2d.ravel()])
        itp = LinearNDInterpolator(
            pts, np.column_stack([II.ravel(), JJ.ravel()]))
        GLon, GLat = np.meshgrid(glon, glat)
        inv = itp(np.column_stack([GLon.ravel(), GLat.ravel()]))
        self._lk_xi = inv[:, 0].reshape(nlat, nlon).astype(np.float32)
        self._lk_yi = inv[:, 1].reshape(nlat, nlon).astype(np.float32)
        self._lk_lon0, self._lk_dlon = glon[0], float(glon[1] - glon[0])
        self._lk_lat0, self._lk_dlat = glat[0], float(glat[1] - glat[0])
        # native cell size in metres: prepare() scales speeds into
        # index units with this
        dy_m = np.nanmedian(np.abs(np.diff(lat2d, axis=0))) * 111_320.0
        dx_m = (np.nanmedian(np.abs(np.diff(lon2d, axis=1))) * 111_320.0
                * max(np.cos(np.deg2rad(np.nanmean(lat2d))), 0.05))
        self._min_cell_m = float(max(min(dx_m, dy_m), 1.0))
        logger.info("%s: inverse lookup raster %d x %d (cell ~%.0f m)",
                    self.name, nlat, nlon, self._min_cell_m)

    def _lookup_indices(self, xp, lon, lat):
        """Fractional native (xi, yi) from the inverse rasters, in
        GLOBAL (unsubset) index space; NaN outside the grid hull.  Host
        numpy (the device form is :meth:`_lookup_indices_device`)."""
        li = (lon - self._lk_lon0) / self._lk_dlon
        lj = (lat - self._lk_lat0) / self._lk_dlat
        nlat, nlon = self._lk_xi.shape
        i0 = xp.clip(xp.floor(li), 0, nlon - 2).astype("int32")
        j0 = xp.clip(xp.floor(lj), 0, nlat - 2).astype("int32")
        fi = xp.clip(li - i0, 0.0, 1.0)
        fj = xp.clip(lj - j0, 0.0, 1.0)
        out = []
        for R in (self._lk_xi, self._lk_yi):
            R = xp.asarray(R)
            r00 = R[j0, i0]
            r01 = R[j0, i0 + 1]
            r10 = R[j0 + 1, i0]
            r11 = R[j0 + 1, i0 + 1]
            out.append((r00 * (1 - fi) + r01 * fi) * (1 - fj)
                       + (r10 * (1 - fi) + r11 * fi) * fj)
        # positions outside the raster bounds are outside the grid
        inside = (li >= 0) & (li <= nlon - 1) & (lj >= 0) & (lj <= nlat - 1)
        nan = xp.full_like(out[0], xp.nan)
        return (xp.where(inside, out[0], nan),
                xp.where(inside, out[1], nan))

    def _lookup_state(self, device):
        """The inverse rasters and their grid as tensors on ``device``,
        made once per device (the rasters never change); float32 scalars,
        so the index arithmetic is the JAX package's, and a tensor divisor
        keeps it a true division on the card."""
        cache = self.__dict__.setdefault("_lookup_states", {})
        if device not in cache:
            def f32(v):
                return torch.tensor(np.float32(v), device=device)
            cache[device] = {
                "xi": torch.as_tensor(self._lk_xi, device=device),
                "yi": torch.as_tensor(self._lk_yi, device=device),
                "lon0": f32(self._lk_lon0), "dlon": f32(self._lk_dlon),
                "lat0": f32(self._lk_lat0), "dlat": f32(self._lk_dlat)}
        return cache[device]

    def _lookup_indices_device(self, lon, lat):
        """:meth:`_lookup_indices` on tensors, on their device."""
        st = self._lookup_state(lon.device)
        li = (lon - st["lon0"]) / st["dlon"]
        lj = (lat - st["lat0"]) / st["dlat"]
        nlat, nlon = self._lk_xi.shape
        # a NaN position indexes cell 0 (its result is NaN: not inside)
        i0 = torch.clamp(torch.floor(torch.nan_to_num(li, nan=0.0)), 0,
                         nlon - 2).to(torch.int64)
        j0 = torch.clamp(torch.floor(torch.nan_to_num(lj, nan=0.0)), 0,
                         nlat - 2).to(torch.int64)
        fi = torch.clamp(li - i0, 0.0, 1.0)
        fj = torch.clamp(lj - j0, 0.0, 1.0)
        out = []
        for R in (st["xi"], st["yi"]):
            r00 = R[j0, i0]
            r01 = R[j0, i0 + 1]
            r10 = R[j0 + 1, i0]
            r11 = R[j0 + 1, i0 + 1]
            out.append((r00 * (1 - fi) + r01 * fi) * (1 - fj)
                       + (r10 * (1 - fi) + r11 * fi) * fj)
        inside = (li >= 0) & (li <= nlon - 1) & (lj >= 0) & (lj <= nlat - 1)
        nan = torch.full_like(out[0], float("nan"))
        return (torch.where(inside, out[0], nan),
                torch.where(inside, out[1], nan))

    def _grid_indices(self, lon, lat):
        if not self._curvilinear:
            return super()._grid_indices(lon, lat)
        xi, yi = self._lookup_indices_device(lon, lat)
        return xi - self._ix.start, yi - self._iy.start

    def lonlat2xy(self, lon, lat):
        if not self._curvilinear:
            return super().lonlat2xy(lon, lat)
        return self._lookup_indices(np, np.asarray(lon, np.float64),
                                    np.asarray(lat, np.float64))

    def xy2lonlat(self, x, y):
        if not self._curvilinear:
            return super().xy2lonlat(x, y)
        # bilinear sample of the 2D coordinate arrays at fractional
        # native indices
        nj, ni = self._lon2d.shape
        xi = np.clip(np.asarray(x, np.float64), 0, ni - 1)
        yi = np.clip(np.asarray(y, np.float64), 0, nj - 1)
        i0 = np.clip(np.floor(xi).astype(int), 0, ni - 2)
        j0 = np.clip(np.floor(yi).astype(int), 0, nj - 2)
        fi, fj = xi - i0, yi - j0
        out = []
        for C in (self._lon2d, self._lat2d):
            out.append((C[j0, i0] * (1 - fi) + C[j0, i0 + 1] * fi)
                       * (1 - fj)
                       + (C[j0 + 1, i0] * (1 - fi)
                          + C[j0 + 1, i0 + 1] * fi) * fj)
        return out[0], out[1]

    def prepare(self, extent=None, start_time=None, end_time=None,
                max_speed=None, **kw):
        if self._curvilinear and max_speed is not None:
            # axes are native indices: express the halo rule's speed in
            # cells/s so the buffer formula stays dimensionally right
            max_speed = max_speed / self._min_cell_m
        super().prepare(extent=extent, start_time=start_time,
                        end_time=end_time, max_speed=max_speed, **kw)

    # ----------------------------------------------------------- reading -
    def _read_frame(self, std, ti, zslice, yslice, xslice, member=0):
        if std == "land_binary_mask":
            return self._land_raster[yslice, xslice]
        vname, has_z = self._sources[std]
        fi = self._file_of_frame[ti]
        ii = self._index_in_file[ti]
        ds = self._files[fi]
        var = ds.variables[vname]
        dims = var.dimensions
        idx = []
        for d in dims:
            if d == self._time_dim:
                idx.append(ii)
            elif self._z_name is not None and d == self._z_name:
                idx.append(zslice)
            elif d == self._ydim:
                idx.append(yslice)
            elif d == self._xdim:
                idx.append(xslice)
            elif d == self._ens_dim:
                idx.append(member)
            else:
                idx.append(0)  # e.g. singleton height dims
        raw = var[tuple(idx)]
        out = ncio.cf_unpack(var, raw)
        if has_z and self._z_flip:
            out = out[::-1]
        return out

    def __del__(self):
        for f in getattr(self, "_files", []):
            try:
                f.close()
            except Exception:
                pass
