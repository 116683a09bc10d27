"""NetCDF-3 helpers of the forcing writers (frozen copies).

Copied from ``opendrift_tpu_torch/tools/synthetic_nc.py`` at commit
6f1980e1cee06c33f9f539f1b9a6d1e50f17f533 (``_netcdf``, ``_axis``,
``_pack_i16``, ``_time``), with the land test reading the coastline raster
copied beside this file (a byte copy of
``opendrift_tpu_torch/data/coastline_mask.npz`` at that commit) and the
packing split from the writing, so that the benchmark keeps the int16
arrays it wrote for the plain reference.
"""

import os

import numpy as np

T0_UNITS = b"seconds since 2024-03-01 00:00:00"
EARTH_RADIUS = 6371000.0
COASTLINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "coastline_mask.npz")


def netcdf(path):
    from scipy.io import netcdf_file
    return netcdf_file(path, "w", version=2)


def land(lon, lat):
    """1 where the coastline raster says land (its nearest cell, clamped
    to the raster), else 0."""
    d = np.load(COASTLINE)
    ny, nx = (int(v) for v in d["shape"])
    mask = np.unpackbits(d["land"], axis=1)[:, :nx]
    xi = np.clip(np.round((np.asarray(lon, np.float64) - float(d["lon0"]))
                          / float(d["dlon"])).astype(np.int32), 0, nx - 1)
    yi = np.clip(np.round((np.asarray(lat, np.float64) - float(d["lat0"]))
                          / float(d["dlat"])).astype(np.int32), 0, ny - 1)
    return (mask[yi, xi] > 0).astype(np.float32)


def axis(n, step, centre):
    return centre + (np.arange(n) - (n - 1) / 2.0) * step


def pack_i16(data, scale, offset, fill=-32767):
    """``data`` as int16 with ``scale``/``offset`` (NaN -> ``fill``)."""
    packed = np.round((np.asarray(data, np.float64) - offset) / scale)
    return np.where(np.isfinite(packed), np.clip(packed, -32766, 32767),
                    fill).astype(np.int16)


def write_i16(f, name, dims, packed, scale, offset, std, units,
              fill=-32767):
    v = f.createVariable(name, "h", dims)
    v[:] = packed
    v.scale_factor = np.float32(scale)
    v.add_offset = np.float32(offset)
    v._FillValue = np.int16(fill)
    if std:
        v.standard_name = std.encode()
    v.units = units.encode()
    return v


def time_axis(f, nt, step_s):
    f.createDimension("time", nt)
    tv = f.createVariable("time", "d", ("time",))
    tv[:] = np.arange(nt) * float(step_s)
    tv.units = T0_UNITS
    tv.standard_name = b"time"
