"""A MyWave-WAM-like hourly wave file, made from a seed.

A CF file on a Lambert conformal grid (the AROME file's projection, 4 km
cells, hourly frames) with the wave fields an oil forecast reads: the
significant wave height, the peak period, the mean period Tm02 and the
grid-relative Stokes drift at the surface, each float32, a smooth pattern
moving with time plus seeded noise.  MyWave's own files are on a rotated
pole grid; the wave fields here cover the sea and the land alike (the
ocean file's land cells strand the oil before it reaches land).
:func:`write` also returns what it wrote, for the plain reference.
"""

import numpy as np

from . import cf
from .arome import PROJ

# (name in the file, standard name, units)
FIELDS = (
    ("hs", "sea_surface_wave_significant_height", "m"),
    ("tp", "sea_surface_wave_period_at_variance_spectral_density_maximum",
     "s"),
    ("tm2", "sea_surface_wave_mean_period_from_variance_spectral_density_"
     "second_frequency_moment", "s"),
    ("ust", "sea_surface_wave_stokes_drift_x_velocity", "m/s"),
    ("vst", "sea_surface_wave_stokes_drift_y_velocity", "m/s"))


def write(path, rng, nx=100, ny=88, nt=11, step_s=3600.0,
          centre=(14.0, 68.0), dx=4000.0):
    """Write the file; ``rng`` is a ``numpy.random.Generator``.  Returns
    {"proj", "x", "y", "depths": None, "times_s", "vars": {standard name:
    {"values"}}, "grid_relative"}."""
    from ..reference import proj as projlib
    xc, yc = projlib.fwd(PROJ, centre[0], centre[1])
    x = cf.axis(nx, dx, float(xc))
    y = cf.axis(ny, dx, float(yc))
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                         np.linspace(0, 2 * np.pi, ny))
    t = np.arange(nt)[:, None, None]

    def noise(scale):
        return scale * rng.standard_normal((nt, ny, nx))
    hs = np.maximum(2.0 + 0.8 * np.sin(gx + 0.15 * t) + noise(0.1), 0.2)
    tp = 9.0 + 1.5 * np.cos(gy - 0.1 * t) + noise(0.2)
    data = {
        "hs": hs, "tp": tp,
        "tm2": 0.7 * tp + noise(0.1),
        "ust": 0.08 + 0.04 * np.sin(gx + 0.2 * t) + noise(0.01),
        "vst": 0.03 * np.cos(gy - 0.1 * t) + noise(0.01)}
    f = cf.netcdf(path)
    f.Conventions = b"CF-1.6"
    f.title = b"MyWave-WAM-like synthetic waves"
    cf.time_axis(f, nt, step_s)
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
    gm = f.createVariable("projection_lambert", "i", ())
    gm.grid_mapping_name = b"lambert_conformal_conic"
    gm.standard_parallel = PROJ["lat_1"]
    gm.longitude_of_central_meridian = PROJ["lon_0"]
    gm.latitude_of_projection_origin = PROJ["lat_0"]
    gm.earth_radius = PROJ["R"]
    out = {}
    for name, std, units in FIELDS:
        values = data[name].astype(np.float32)
        var = f.createVariable(name, "f", ("time", "y", "x"))
        var[:] = values
        var.standard_name = std.encode()
        var.units = units.encode()
        var.grid_mapping = b"projection_lambert"
        out[std] = {"values": values}
    f.close()
    return {"proj": PROJ, "x": x, "y": y, "depths": None,
            "times_s": np.arange(nt) * float(step_s), "vars": out,
            "grid_relative": True}
