"""Synthetic NetCDF files and the reader-pair helpers that the port's file
reader tests (``test_torch_netcdf.py``, ``test_torch_roms.py``,
``test_torch_readers.py``) share.  The regular, curvilinear, global and
ensemble writers are copies of the fixture writers of
``test_curvilinear.py``, ``test_global_grid.py`` and ``test_ensemble.py``;
the product-shaped files come from ``opendrift_tpu_torch.tools.synthetic_nc``
at small sizes.
"""

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import torch

from opendrift_tpu_torch.interop import device_state_from_numpy, \
    table_to_numpy

T0 = datetime(2024, 3, 1)


def write_regular(path, nt=4, fill_time=None, t_offset_h=0.0,
                  z_descending=True):
    """A lat-lon z-level file: int16 eastward/northward currents with a
    fill on a land corner, float temperature, depths stored deepest first
    (``z_descending``: the reader flips them), hourly frames from
    ``t_offset_h``; ``fill_time``: the index of a frame whose time is a
    fill value (a corrupt frame the reader drops)."""
    from scipy.io import netcdf_file
    nx, ny, nz = 30, 24, 5
    r = np.random.default_rng(int(t_offset_h) + 7)
    f = netcdf_file(path, "w", version=2)
    for name, n in (("time", nt), ("depth", nz), ("lat", ny), ("lon", nx)):
        f.createDimension(name, n)
    tv = f.createVariable("time", "d", ("time",))
    times = t_offset_h + np.arange(nt, dtype=float)
    if fill_time is not None:
        times[fill_time] = 9.96921e36
    tv[:] = times
    tv.units = b"hours since 2024-03-01 00:00:00"
    tv.standard_name = b"time"
    lon = f.createVariable("lon", "d", ("lon",))
    lon[:] = np.linspace(3.0, 5.9, nx)
    lon.standard_name = b"longitude"
    lon.units = b"degree_east"
    lat = f.createVariable("lat", "d", ("lat",))
    lat[:] = np.linspace(59.0, 61.3, ny)
    lat.standard_name = b"latitude"
    lat.units = b"degree_north"
    depths = np.array([0.0, 5.0, 20.0, 50.0, 100.0])
    dv = f.createVariable("depth", "d", ("depth",))
    dv[:] = depths[::-1] if z_descending else depths
    dv.standard_name = b"depth"
    dv.positive = b"down"
    land = np.zeros((ny, nx), bool)
    land[-6:, -8:] = True
    for name, std in (("uo", b"eastward_sea_water_velocity"),
                      ("vo", b"northward_sea_water_velocity")):
        data = 0.3 * r.standard_normal((nt, nz, ny, nx))
        packed = np.round(data / 0.001).astype(np.int16)
        packed[:, :, land] = -32767
        vv = f.createVariable(name, "h", ("time", "depth", "lat", "lon"))
        vv[:] = packed
        vv.scale_factor = np.float32(0.001)
        vv.add_offset = np.float32(0.0)
        vv._FillValue = np.int16(-32767)
        vv.standard_name = std
    tt = f.createVariable("thetao", "f", ("time", "depth", "lat", "lon"))
    tt[:] = (8.0 + r.standard_normal((nt, nz, ny, nx))).astype(np.float32)
    tt.standard_name = b"sea_water_potential_temperature"
    f.close()
    return path


def write_curvilinear(path):
    """Rotated curvilinear grid around (4.0E, 60.0N): 2 km cells turned
    20 degrees, (u, v) = (0.4, 0.1) m/s plus a seeded field, east/north
    (the writer of test_curvilinear.py with varying currents)."""
    from scipy.io import netcdf_file
    nj, ni, rot_deg = 40, 50, 20.0
    jj, ii = np.meshgrid(np.arange(nj, dtype=float),
                         np.arange(ni, dtype=float), indexing="ij")
    th = np.deg2rad(rot_deg)
    ex = (ii - ni / 2) * 2.0            # km
    ey = (jj - nj / 2) * 2.0
    rx = ex * np.cos(th) - ey * np.sin(th)
    ry = ex * np.sin(th) + ey * np.cos(th)
    lat2d = 60.0 + ry / 111.32
    lon2d = 4.0 + rx / (111.32 * np.cos(np.deg2rad(60.0)))
    r = np.random.default_rng(11)
    f = netcdf_file(path, "w")
    f.createDimension("time", 2)
    f.createDimension("j", nj)
    f.createDimension("i", ni)
    tv = f.createVariable("time", "d", ("time",))
    tv[:] = [0.0, 86400.0]
    tv.units = b"seconds since 2024-03-01 00:00:00"
    lonv = f.createVariable("longitude", "d", ("j", "i"))
    lonv[:] = lon2d
    lonv.standard_name = b"longitude"
    latv = f.createVariable("latitude", "d", ("j", "i"))
    latv[:] = lat2d
    latv.standard_name = b"latitude"
    for nm, std, val in (("uo", b"eastward_sea_water_velocity", 0.4),
                         ("vo", b"northward_sea_water_velocity", 0.1)):
        vv = f.createVariable(nm, "f", ("time", "j", "i"))
        vv[:] = (val + 0.1 * r.standard_normal((2, nj, ni))).astype(
            np.float32)
        vv.standard_name = std
        vv.coordinates = b"latitude longitude"
    f.close()
    return path


def write_global(path, lon0, lon1):
    """A global lat-lon file (the writer of test_global_grid.py) with a
    seeded eastward current."""
    from scipy.io import netcdf_file
    r = np.random.default_rng(int(lon0) + 500)
    f = netcdf_file(path, "w")
    nx, ny = 144, 30
    f.createDimension("lon", nx)
    f.createDimension("lat", ny)
    f.createDimension("time", 2)
    lon = f.createVariable("lon", "d", ("lon",))
    lon[:] = np.linspace(lon0, lon1, nx)
    lon.standard_name = b"longitude"
    lon.units = b"degree_east"
    lat = f.createVariable("lat", "d", ("lat",))
    lat[:] = np.linspace(-70.0, 70.0, ny)
    lat.standard_name = b"latitude"
    lat.units = b"degree_north"
    t = f.createVariable("time", "d", ("time",))
    t[:] = [0.0, 48.0]
    t.units = b"hours since 2024-03-01 00:00:00"
    u = f.createVariable("u", "d", ("time", "lat", "lon"))
    u[:] = 0.5 + 0.1 * r.standard_normal((2, ny, nx))
    u.standard_name = b"eastward_sea_water_velocity"
    v = f.createVariable("v", "d", ("time", "lat", "lon"))
    v[:] = 0.1 * r.standard_normal((2, ny, nx))
    v.standard_name = b"northward_sea_water_velocity"
    f.close()
    return path


MEMBER_U = [0.1, 0.2, 0.4]


def write_ensemble(path):
    """Lat-lon file with a realization dimension of 3 members whose
    eastward currents differ (the writer of test_ensemble.py)."""
    from scipy.io import netcdf_file
    f = netcdf_file(path, "w")
    nx = ny = 12
    f.createDimension("lon", nx)
    f.createDimension("lat", ny)
    f.createDimension("realization", 3)
    f.createDimension("time", 2)
    lon = f.createVariable("lon", "d", ("lon",))
    lon[:] = np.linspace(3.0, 5.0, nx)
    lon.standard_name = b"longitude"
    lon.units = b"degree_east"
    lat = f.createVariable("lat", "d", ("lat",))
    lat[:] = np.linspace(59.0, 61.0, ny)
    lat.standard_name = b"latitude"
    lat.units = b"degree_north"
    t = f.createVariable("time", "d", ("time",))
    t[:] = [0.0, 24.0]
    t.units = b"hours since 2024-03-01 00:00:00"
    u = f.createVariable("u", "d", ("time", "realization", "lat", "lon"))
    for m, uval in enumerate(MEMBER_U):
        u[:, m] = uval
    u.standard_name = b"eastward_sea_water_velocity"
    v = f.createVariable("v", "d", ("time", "realization", "lat", "lon"))
    v[:] = 0.0
    v.standard_name = b"northward_sea_water_velocity"
    f.close()
    return path


def prepare_pair(jr, tr, **kw):
    """Give both readers the same run context and return (JAX device
    state, the port's host state, the port's CPU device state)."""
    pair_hint = kw.pop("pair_hint", "xy")
    for rd in (jr, tr):
        rd.set_run_epoch(rd.times[0])
        rd.pair_hint = pair_hint
        rd.prepare(**kw)
    end = jr.times[0] + timedelta(seconds=kw.get("interval_seconds", 0.0))
    jstate = jr.device_state(jr.times[0], end)
    host = tr.device_state(tr.times[0], end)
    return jstate, host, device_state_from_numpy(host, "cpu")


def assert_tables_equal(host, jstate):
    """Every array of the port's host state equals the JAX state's, bit
    for bit (compensated tables member by member)."""
    assert set(host) == set(jstate)
    for k in host:
        got, want = table_to_numpy(host[k]), table_to_numpy(jstate[k])
        if isinstance(got, dict):
            for member in ("data", "scale"):
                np.testing.assert_array_equal(got[member].view(np.uint8),
                                              want[member].view(np.uint8))
        else:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def sample_pair(jr, tr, jstate, tstate, names, t, lon, lat, z,
                member=None):
    """Both readers' ``sample`` at the same float32 positions: (JAX values,
    JAX covers, port values, port covers) as numpy."""
    lon, lat, z = (np.asarray(a, np.float32) for a in (lon, lat, z))
    jkw, tkw = {}, {}
    if member is not None:
        jkw["member"] = jnp.asarray(member, jnp.int32)
        tkw["member"] = torch.as_tensor(np.asarray(member, np.int32))
    jv, jc = jr.sample(jstate, names, jnp.float32(t), jnp.asarray(lon),
                       jnp.asarray(lat), jnp.asarray(z), **jkw)
    tv, tc = tr.sample(tstate, names, np.float32(t), torch.as_tensor(lon),
                       torch.as_tensor(lat), torch.as_tensor(z), **tkw)
    return ({v: np.asarray(jv[v]) for v in names}, np.asarray(jc),
            {v: tv[v].numpy() for v in names}, tc.numpy())
