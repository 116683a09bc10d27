"""Synthetic forcing files in the layouts of real forecast products.

NetCDF-3 (64-bit offset) files written with ``scipy.io.netcdf_file``, in
the shapes of three products the readers are built for, with fields made
from a seed:

* :func:`write_norkyst`: a NorKyst800-like z-level ocean on a polar
  stereographic grid (CF ``polar_stereographic`` mapping, 800 m cells,
  the 16 NorKyst depths), grid-relative currents, temperature and
  salinity packed as int16 with ``scale_factor``/``add_offset`` and a
  ``_FillValue`` on the land cells of the bundled coastline raster (and
  below the seafloor), and a float seafloor depth ``h``;
* :func:`write_arome`: an AROME-like wind file on a Lambert conformal
  grid (CF ``lambert_conformal_conic``, 2.5 km cells), grid-relative
  ``x_wind``/``y_wind`` with a singleton height dimension;
* :func:`write_roms`: a Nordic-4km-like ROMS file: a curvilinear C-grid
  (rho points of a polar stereographic plane, so ``angle`` varies over
  the grid), Vtransform 2 / Vstretching 4 sigma levels, staggered u/v
  with their masks, temp, salt, zeta and ``AKs`` on the w levels.

The tests write them small; ``chip_smoke.py`` writes them at the
products' widths.  Each writer returns the file's path.
"""

import numpy as np

from ..fields.landmask import GlobalLandmask
from ..utils import crs as crslib

T0_UNITS = b"seconds since 2024-03-01 00:00:00"
NORKYST_DEPTHS = np.array([0, 3, 10, 15, 25, 50, 75, 100, 150, 200, 250,
                           300, 500, 1000, 2000, 3000], np.float64)
EARTH_RADIUS = 6371000.0


def _netcdf(path):
    from scipy.io import netcdf_file
    return netcdf_file(path, "w", version=2)


def _land(lon, lat):
    """1 where the bundled coastline raster says land, else 0."""
    return GlobalLandmask().contains(lon, lat).astype(np.float32)


def _axis(n, step, centre):
    return centre + (np.arange(n) - (n - 1) / 2.0) * step


def _pack_i16(f, name, dims, data, scale, offset, std, units, fill=-32767):
    """An int16 variable holding ``data`` (NaN -> ``_FillValue``)."""
    packed = np.round((np.asarray(data, np.float64) - offset) / scale)
    packed = np.where(np.isfinite(packed), np.clip(packed, -32766, 32767),
                      fill).astype(np.int16)
    v = f.createVariable(name, "h", dims)
    v[:] = packed
    v.scale_factor = np.float32(scale)
    v.add_offset = np.float32(offset)
    v._FillValue = np.int16(fill)
    if std:
        v.standard_name = std.encode()
    v.units = units.encode()
    return v


def _time(f, nt, step_s):
    f.createDimension("time", nt)
    tv = f.createVariable("time", "d", ("time",))
    tv[:] = np.arange(nt) * float(step_s)
    tv.units = T0_UNITS
    tv.standard_name = b"time"


def write_norkyst(path, nx=260, ny=300, nz=16, nt=11, step_s=3600.0,
                  centre=(14.0, 68.0), dx=800.0, seed=0):
    """A NorKyst800-like ocean file (see the module docstring): ``nx`` x
    ``ny`` cells of ``dx`` metres centred on ``centre`` (lon, lat),
    ``nz`` of the NorKyst depths, ``nt`` frames ``step_s`` apart."""
    r = np.random.default_rng(seed)
    proj = crslib.from_proj4("+proj=stere +lat_0=90 +lon_0=70 +lat_ts=60 "
                             f"+x_0=0 +y_0=0 +R={EARTH_RADIUS}")
    xc, yc = proj.fwd(np, np.array([centre[0]]), np.array([centre[1]]))
    x = _axis(nx, dx, float(xc[0]))
    y = _axis(ny, dx, float(yc[0]))
    X, Y = np.meshgrid(x, y)
    lon, lat = proj.inv(np, X, Y)
    depths = NORKYST_DEPTHS[:nz]
    land = _land(lon, lat) > 0.5
    gx, gy = np.meshgrid(np.linspace(0, 3 * np.pi, nx),
                         np.linspace(0, 3 * np.pi, ny))
    h = 40.0 + 2900.0 * (0.5 + 0.5 * np.sin(gx / 3.0) * np.cos(gy / 4.0))
    h = np.where(land, np.nan, h)
    below = depths[:, None, None] > np.nan_to_num(h, nan=0.0)[None]
    dead = land[None] | below
    phase = np.arange(nt)[:, None, None, None] * 0.3
    decay = np.exp(-depths / 80.0)[None, :, None, None]
    u = (0.25 * np.sin(gy + phase) * decay + 0.1
         + 0.03 * r.standard_normal((nt, nz, ny, nx)))
    v = (0.25 * np.cos(gx - phase) * decay
         + 0.03 * r.standard_normal((nt, nz, ny, nx)))
    temp = 4.0 + 5.0 * np.exp(-depths / 200.0)[None, :, None, None] \
        + 0.2 * np.sin(gx + phase)
    salt = 33.0 + 2.0 * (1.0 - np.exp(-depths / 100.0))[None, :, None,
                                                          None] \
        + 0.1 * np.cos(gy - phase)
    f = _netcdf(path)
    f.Conventions = b"CF-1.6"
    f.title = b"NorKyst800-like synthetic z-level ocean"
    _time(f, nt, step_s)
    f.createDimension("depth", nz)
    f.createDimension("Y", ny)
    f.createDimension("X", nx)
    xv = f.createVariable("X", "d", ("X",))
    xv[:] = x
    xv.standard_name = b"projection_x_coordinate"
    xv.units = b"meter"
    yv = f.createVariable("Y", "d", ("Y",))
    yv[:] = y
    yv.standard_name = b"projection_y_coordinate"
    yv.units = b"meter"
    dv = f.createVariable("depth", "d", ("depth",))
    dv[:] = depths
    dv.standard_name = b"depth"
    dv.positive = b"down"
    dv.units = b"meter"
    gm = f.createVariable("projection_stere", "i", ())
    gm.grid_mapping_name = b"polar_stereographic"
    gm.straight_vertical_longitude_from_pole = 70.0
    gm.latitude_of_projection_origin = 90.0
    gm.standard_parallel = 60.0
    gm.earth_radius = EARTH_RADIUS
    dims4 = ("time", "depth", "Y", "X")
    for name, data, scale, offset, std, units in (
            ("u", u, 0.001, 0.0, "x_sea_water_velocity", "m s-1"),
            ("v", v, 0.001, 0.0, "y_sea_water_velocity", "m s-1"),
            ("temperature", temp, 0.001, 10.0, "sea_water_temperature",
             "degC"),
            ("salinity", salt, 0.001, 30.0, "sea_water_salinity", "1")):
        var = _pack_i16(f, name, dims4, np.where(dead[None], np.nan, data),
                        scale, offset, std, units)
        var.grid_mapping = b"projection_stere"
    hv = f.createVariable("h", "f", ("Y", "X"))
    hv[:] = np.where(land, -32767.0, h).astype(np.float32)
    hv._FillValue = np.float32(-32767.0)
    hv.standard_name = b"sea_floor_depth_below_sea_level"
    hv.units = b"meter"
    hv.grid_mapping = b"projection_stere"
    f.close()
    return path


def write_arome(path, nx=160, ny=140, nt=11, step_s=3600.0,
                centre=(14.0, 68.0), dx=2500.0, seed=1):
    """An AROME-like wind file (see the module docstring): ``nx`` x ``ny``
    cells of ``dx`` metres centred on ``centre``."""
    r = np.random.default_rng(seed)
    proj = crslib.from_proj4("+proj=lcc +lat_0=63.3 +lon_0=15 +lat_1=63.3 "
                             f"+lat_2=63.3 +x_0=0 +y_0=0 +R={EARTH_RADIUS}")
    xc, yc = proj.fwd(np, np.array([centre[0]]), np.array([centre[1]]))
    x = _axis(nx, dx, float(xc[0]))
    y = _axis(ny, dx, float(yc[0]))
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                         np.linspace(0, 2 * np.pi, ny))
    t = np.arange(nt)[:, None, None, None]
    xw = 8.0 + 3.0 * np.sin(gx + 0.2 * t) + 0.5 * r.standard_normal(
        (nt, 1, ny, nx))
    yw = 4.0 * np.cos(gy - 0.1 * t) + 0.5 * r.standard_normal(
        (nt, 1, ny, nx))
    f = _netcdf(path)
    f.Conventions = b"CF-1.6"
    f.title = b"AROME-like synthetic 10 m wind"
    _time(f, nt, step_s)
    f.createDimension("height0", 1)
    f.createDimension("y", ny)
    f.createDimension("x", nx)
    xv = f.createVariable("x", "d", ("x",))
    xv[:] = x
    xv.standard_name = b"projection_x_coordinate"
    xv.units = b"m"
    yv = f.createVariable("y", "d", ("y",))
    yv[:] = y
    yv.standard_name = b"projection_y_coordinate"
    yv.units = b"m"
    hv = f.createVariable("height0", "d", ("height0",))
    hv[:] = [10.0]
    hv.standard_name = b"height"
    gm = f.createVariable("projection_lambert", "i", ())
    gm.grid_mapping_name = b"lambert_conformal_conic"
    gm.standard_parallel = 63.3
    gm.longitude_of_central_meridian = 15.0
    gm.latitude_of_projection_origin = 63.3
    gm.earth_radius = EARTH_RADIUS
    for name, data in (("x_wind_10m", xw), ("y_wind_10m", yw)):
        var = f.createVariable(name, "f", ("time", "height0", "y", "x"))
        var[:] = data.astype(np.float32)
        var.standard_name = name[:6].encode()
        var.units = b"m/s"
        var.grid_mapping = b"projection_lambert"
    f.close()
    return path


def roms_grid(nxi=200, neta=160, centre=(12.0, 67.5), dx=4000.0,
              lon_0=58.0):
    """rho-point lon/lat of a ``neta`` x ``nxi`` curvilinear grid: a
    regular ``dx`` grid of a polar stereographic plane (straight vertical
    longitude ``lon_0``) centred on ``centre``, and the ``angle`` of its
    xi axis from east (radians), from the coordinates."""
    proj = crslib.from_proj4(f"+proj=stere +lat_0=90 +lon_0={lon_0} "
                             f"+lat_ts=60 +R={EARTH_RADIUS}")
    xc, yc = proj.fwd(np, np.array([centre[0]]), np.array([centre[1]]))
    X, Y = np.meshgrid(_axis(nxi, dx, float(xc[0])),
                       _axis(neta, dx, float(yc[0])))
    lon, lat = proj.inv(np, X, Y)
    dlon = np.gradient(lon, axis=1) * np.cos(np.radians(lat))
    dlat = np.gradient(lat, axis=1)
    return lon, lat, np.arctan2(dlat, dlon)


def write_roms(path, nxi=200, neta=160, ns=32, nt=5, step_s=3 * 3600.0,
               centre=(12.0, 67.5), dx=4000.0, hmax=3000.0, staggered=True,
               stretching_curve=True, seed=2):
    """A Nordic-4km-like ROMS file (see the module docstring), the seafloor
    from 20 m to ``hmax``.
    ``staggered``: u on (eta, xi - 1) and v on (eta - 1, xi) with their own
    masks, as ROMS writes them; else both on rho points with rho-shaped
    ``mask_u``/``mask_v`` (as subset files do).  ``stretching_curve``:
    store ``Cs_r``/``Cs_w``; else only ``theta_s``/``theta_b``/
    ``Vstretching``, from which the reader computes them."""
    from ..fields.roms import s_stretch
    r = np.random.default_rng(seed)
    lon, lat, angle = roms_grid(nxi, neta, centre, dx)
    mask = 1.0 - _land(lon, lat)
    gx, gy = np.meshgrid(np.linspace(0, 3 * np.pi, nxi),
                         np.linspace(0, 3 * np.pi, neta))
    h = 20.0 + (hmax - 20.0) * (0.5 + 0.5 * np.sin(gx / 2.0)
                                * np.cos(gy / 3.0))
    theta_s, theta_b, hc = 7.0, 2.0, 20.0
    s_rho = -1.0 + (np.arange(ns) + 0.5) / ns
    s_w = -1.0 + np.arange(ns + 1) / ns
    cs_r = s_stretch(ns, theta_s, theta_b, "rho", 4)
    cs_w = s_stretch(ns, theta_s, theta_b, "w", 4)
    t = np.arange(nt)[:, None, None, None]
    sig = s_rho[None, :, None, None]
    u = (0.2 * np.sin(gy + 0.3 * t) * (1.0 + sig) + 0.1
         + 0.02 * r.standard_normal((nt, ns, neta, nxi)))
    v = (0.2 * np.cos(gx - 0.3 * t) * (1.0 + sig)
         + 0.02 * r.standard_normal((nt, ns, neta, nxi)))
    temp = 5.0 + 4.0 * (1.0 + sig) + 0.2 * np.sin(gx + 0.3 * t)
    salt = 34.0 + 1.0 * sig + 0.1 * np.cos(gy)
    zeta = 0.3 * np.sin(gx / 2.0 + 0.5 * np.arange(nt)[:, None, None])
    swl = s_w[None, :, None, None]
    aks = 1e-5 + 2e-2 * np.exp(8.0 * swl) * (
        1.0 + 0.5 * np.sin(gx + 0.3 * t))
    dims_u, dims_v = ("eta_rho", "xi_rho"), ("eta_rho", "xi_rho")
    mask_u = mask_v = mask
    if staggered:
        u = 0.5 * (u[..., :-1] + u[..., 1:])
        v = 0.5 * (v[..., :-1, :] + v[..., 1:, :])
        mask_u = mask[:, :-1] * mask[:, 1:]
        mask_v = mask[:-1, :] * mask[1:, :]
        dims_u, dims_v = ("eta_u", "xi_u"), ("eta_v", "xi_v")
    f = _netcdf(path)
    f.title = b"Nordic-4km-like synthetic ROMS output"
    for name, n in (("ocean_time", nt), ("s_rho", ns), ("s_w", ns + 1),
                    ("eta_rho", neta), ("xi_rho", nxi), ("eta_u", neta),
                    ("xi_u", nxi - 1), ("eta_v", neta - 1), ("xi_v", nxi)):
        f.createDimension(name, n)
    tv = f.createVariable("ocean_time", "d", ("ocean_time",))
    tv[:] = np.arange(nt) * float(step_s)
    tv.units = T0_UNITS
    rho = ("eta_rho", "xi_rho")
    for name, dims, data in (
            ("lon_rho", rho, lon), ("lat_rho", rho, lat), ("h", rho, h),
            ("mask_rho", rho, mask), ("mask_u", dims_u, mask_u),
            ("mask_v", dims_v, mask_v), ("angle", rho, angle),
            ("s_rho", ("s_rho",), s_rho), ("s_w", ("s_w",), s_w)):
        var = f.createVariable(name, "d", dims)
        var[:] = data
    if stretching_curve:
        for name, dims, data in (("Cs_r", ("s_rho",), cs_r),
                                 ("Cs_w", ("s_w",), cs_w)):
            var = f.createVariable(name, "d", dims)
            var[:] = data
    else:
        for name, value in (("theta_s", theta_s), ("theta_b", theta_b),
                            ("Vstretching", 4.0)):
            var = f.createVariable(name, "d", ())
            var.data[()] = value
    for name, value in (("hc", hc), ("Vtransform", 2.0)):
        var = f.createVariable(name, "d", ())
        var.data[()] = value
    t3 = ("ocean_time", "s_rho")
    for name, dims, data, scale, offset in (
            ("u", t3 + dims_u, u, 0.001, 0.0),
            ("v", t3 + dims_v, v, 0.001, 0.0),
            ("temp", t3 + rho, temp, 0.001, 10.0),
            ("salt", t3 + rho, salt, 0.001, 30.0)):
        _pack_i16(f, name, dims, data, scale, offset, None, "")
    zv = f.createVariable("zeta", "f", ("ocean_time",) + rho)
    zv[:] = zeta.astype(np.float32)
    av = f.createVariable("AKs", "f", ("ocean_time", "s_w") + rho)
    av[:] = aks.astype(np.float32)
    f.close()
    return path
