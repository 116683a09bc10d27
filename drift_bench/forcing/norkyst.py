"""A NorKyst800-like z-level ocean file, made from a seed.

A frozen copy of ``write_norkyst`` of
``opendrift_tpu_torch/tools/synthetic_nc.py`` at commit
6f1980e1cee06c33f9f539f1b9a6d1e50f17f533: a polar stereographic grid (CF
``polar_stereographic``, 800 m cells, the 16 NorKyst depths, hourly
frames), grid-relative currents, temperature and salinity packed as int16
with ``scale_factor``/``add_offset`` and a ``_FillValue`` on the land cells
of the coastline raster and below the seafloor, and a float seafloor depth
``h``.  :func:`write` also returns what it wrote, for the plain reference.
"""

import numpy as np

from . import cf

NORKYST_DEPTHS = np.array([0, 3, 10, 15, 25, 50, 75, 100, 150, 200, 250,
                           300, 500, 1000, 2000, 3000], np.float64)
PROJ = {"proj": "stere", "lat_0": 90.0, "lon_0": 70.0, "lat_ts": 60.0,
        "R": cf.EARTH_RADIUS}
# (name in the file, standard name, scale, offset, units)
PACKED = (("u", "x_sea_water_velocity", 0.001, 0.0, "m s-1"),
          ("v", "y_sea_water_velocity", 0.001, 0.0, "m s-1"),
          ("temperature", "sea_water_temperature", 0.001, 10.0, "degC"),
          ("salinity", "sea_water_salinity", 0.001, 30.0, "1"))


def write(path, rng, nx=260, ny=300, nz=16, nt=11, step_s=3600.0,
          centre=(14.0, 68.0), dx=800.0):
    """Write the file; ``rng`` is a ``numpy.random.Generator``.  Returns
    {"proj", "x", "y", "depths", "times_s", "vars": {standard name:
    {"packed", "scale", "offset", "fill"}}, "h", "grid_relative"}."""
    from ..reference import proj as projlib
    xc, yc = projlib.fwd(PROJ, centre[0], centre[1])
    x = cf.axis(nx, dx, float(xc))
    y = cf.axis(ny, dx, float(yc))
    X, Y = np.meshgrid(x, y)
    lon, lat = projlib.inv(PROJ, X, Y)
    depths = NORKYST_DEPTHS[:nz]
    land = cf.land(lon, lat) > 0.5
    gx, gy = np.meshgrid(np.linspace(0, 3 * np.pi, nx),
                         np.linspace(0, 3 * np.pi, ny))
    h = 40.0 + 2900.0 * (0.5 + 0.5 * np.sin(gx / 3.0) * np.cos(gy / 4.0))
    h = np.where(land, np.nan, h)
    below = depths[:, None, None] > np.nan_to_num(h, nan=0.0)[None]
    dead = land[None] | below
    phase = np.arange(nt)[:, None, None, None] * 0.3
    decay = np.exp(-depths / 80.0)[None, :, None, None]
    fields = {
        "u": (0.25 * np.sin(gy + phase) * decay + 0.1
              + 0.03 * rng.standard_normal((nt, nz, ny, nx))),
        "v": (0.25 * np.cos(gx - phase) * decay
              + 0.03 * rng.standard_normal((nt, nz, ny, nx))),
        "temperature": (4.0 + 5.0 * np.exp(-depths / 200.0)[None, :, None,
                                                              None]
                        + 0.2 * np.sin(gx + phase)),
        "salinity": (33.0 + 2.0 * (1.0 - np.exp(-depths / 100.0))[
            None, :, None, None] + 0.1 * np.cos(gy - phase))}
    f = cf.netcdf(path)
    f.Conventions = b"CF-1.6"
    f.title = b"NorKyst800-like synthetic z-level ocean"
    cf.time_axis(f, nt, step_s)
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
    gm.straight_vertical_longitude_from_pole = PROJ["lon_0"]
    gm.latitude_of_projection_origin = PROJ["lat_0"]
    gm.standard_parallel = PROJ["lat_ts"]
    gm.earth_radius = PROJ["R"]
    dims4 = ("time", "depth", "Y", "X")
    out = {}
    for name, std, scale, offset, units in PACKED:
        packed = cf.pack_i16(np.where(dead[None], np.nan, fields.pop(name)),
                             scale, offset)
        var = cf.write_i16(f, name, dims4, packed, scale, offset, std, units)
        var.grid_mapping = b"projection_stere"
        out[std] = {"packed": packed, "scale": scale, "offset": offset,
                    "fill": -32767}
    hv = f.createVariable("h", "f", ("Y", "X"))
    h32 = np.where(land, -32767.0, h).astype(np.float32)
    hv[:] = h32
    hv._FillValue = np.float32(-32767.0)
    hv.standard_name = b"sea_floor_depth_below_sea_level"
    hv.units = b"meter"
    hv.grid_mapping = b"projection_stere"
    f.close()
    return {"proj": PROJ, "x": x, "y": y, "depths": depths,
            "times_s": np.arange(nt) * float(step_s), "vars": out,
            "h": np.where(land, np.nan, h32.astype(np.float64)),
            "grid_relative": True}
