"""An AROME-like 10 m wind file, made from a seed.

A frozen copy of ``write_arome`` of
``opendrift_tpu_torch/tools/synthetic_nc.py`` at commit
6f1980e1cee06c33f9f539f1b9a6d1e50f17f533: a Lambert conformal grid (CF
``lambert_conformal_conic``, 2.5 km cells, hourly frames), grid-relative
float32 ``x_wind``/``y_wind`` with a singleton height dimension.
:func:`write` also returns what it wrote, for the plain reference.
"""

import numpy as np

from . import cf

PROJ = {"proj": "lcc", "lat_0": 63.3, "lon_0": 15.0, "lat_1": 63.3,
        "R": cf.EARTH_RADIUS}


def write(path, rng, nx=160, ny=140, nt=11, step_s=3600.0,
          centre=(14.0, 68.0), dx=2500.0):
    """Write the file; ``rng`` is a ``numpy.random.Generator``.  Returns
    {"proj", "x", "y", "depths": None, "times_s", "vars": {standard name:
    {"values"}}, "grid_relative"}."""
    from ..reference import proj as projlib
    xc, yc = projlib.fwd(PROJ, centre[0], centre[1])
    x = cf.axis(nx, dx, float(xc))
    y = cf.axis(ny, dx, float(yc))
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                         np.linspace(0, 2 * np.pi, ny))
    t = np.arange(nt)[:, None, None, None]
    xw = 8.0 + 3.0 * np.sin(gx + 0.2 * t) + 0.5 * rng.standard_normal(
        (nt, 1, ny, nx))
    yw = 4.0 * np.cos(gy - 0.1 * t) + 0.5 * rng.standard_normal(
        (nt, 1, ny, nx))
    f = cf.netcdf(path)
    f.Conventions = b"CF-1.6"
    f.title = b"AROME-like synthetic 10 m wind"
    cf.time_axis(f, nt, step_s)
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
    gm.standard_parallel = PROJ["lat_1"]
    gm.longitude_of_central_meridian = PROJ["lon_0"]
    gm.latitude_of_projection_origin = PROJ["lat_0"]
    gm.earth_radius = PROJ["R"]
    out = {}
    for name, std, data in (("x_wind_10m", "x_wind", xw),
                            ("y_wind_10m", "y_wind", yw)):
        values = data.astype(np.float32)
        var = f.createVariable(name, "f", ("time", "height0", "y", "x"))
        var[:] = values
        var.standard_name = std.encode()
        var.units = b"m/s"
        var.grid_mapping = b"projection_lambert"
        out[std] = {"values": values[:, 0]}
    f.close()
    return {"proj": PROJ, "x": x, "y": y, "depths": None,
            "times_s": np.arange(nt) * float(step_s), "vars": out,
            "grid_relative": True}
