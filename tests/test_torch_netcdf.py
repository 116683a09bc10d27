"""The port's NetCDF reading (``utils/ncio.py``, ``fields/netcdf.py``) against
the JAX package's on the same synthetic files.

Tolerances:

* Host paths are bit-equal: the variables ``NCFile`` reads, ``cf_unpack``
  (int16 through the native ``decode_i16``, and on the numpy fallback of
  both packages), the time axes, and every packed table (the scrub, the
  native NaN fill, the convolution, the curvilinear lookup rasters).
* Samples on lat-lon, curvilinear, global and ensemble grids: the index
  arithmetic is the same float32 expression on both sides, so within
  ``EXACT_ATOL`` (measured equal).
* Samples on projected grids (polar stereographic NorKyst-like, Lambert
  AROME-like): the float32 projection differs by up to 2e-3 of a cell
  (``tests/test_torch_crs.py``), so values within ``PROJECTED_ATOL`` of the
  variable (measured: 7e-5 m/s, 5e-5 degC, 0.13 m of a 3000 m seafloor).
* Runs: ``tests/test_torch_oceandrift.py``'s slice tolerance.
"""

from datetime import timedelta

import numpy as np
import pytest

import torch_nc_fixtures as F
from test_torch_oceandrift import _assert_close

from opendrift_tpu.fields import netcdf as jnetcdf
from opendrift_tpu.utils import native as jnative
from opendrift_tpu.utils import ncio as jncio
from opendrift_tpu_torch.fields import netcdf as tnetcdf
from opendrift_tpu_torch.tools import synthetic_nc
from opendrift_tpu_torch.utils import native as tnative
from opendrift_tpu_torch.utils import ncio as tncio

EXACT_ATOL = 1e-6
PROJECTED_ATOL = {"x_sea_water_velocity": 5e-4, "y_sea_water_velocity": 5e-4,
                  "x_wind": 1e-3, "y_wind": 1e-3,
                  "sea_water_temperature": 5e-4, "sea_water_salinity": 5e-4,
                  "sea_floor_depth_below_sea_level": 0.5,
                  "land_binary_mask": 0.0}
N_RUN = 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nc")
    return {
        "norkyst": synthetic_nc.write_norkyst(str(d / "norkyst.nc"), nx=60,
                                              ny=70, nz=8, nt=5),
        "arome": synthetic_nc.write_arome(str(d / "arome.nc"), nx=50, ny=40,
                                          nt=5),
        "regular": F.write_regular(str(d / "regular.nc")),
        "curvilinear": F.write_curvilinear(str(d / "curvi.nc")),
        "global_0_360": F.write_global(str(d / "g360.nc"), 0.0, 357.5),
        "global_180": F.write_global(str(d / "g180.nc"), -180.0, 177.5),
        "ensemble": F.write_ensemble(str(d / "eps.nc")),
    }


def _positions(reader, n=2000, seed=0):
    r = np.random.default_rng(seed)
    if getattr(reader, "_curvilinear", False):
        lon2, lat2 = reader._lon2d, reader._lat2d
    else:
        X, Y = np.meshgrid(reader.x, reader.y)
        lon2, lat2 = reader.xy2lonlat(X, Y)
    # a margin beyond the grid, so some positions are outside
    lon = r.uniform(np.min(lon2) - 0.1, np.max(lon2) + 0.1, n)
    lat = r.uniform(np.min(lat2) - 0.05, np.max(lat2) + 0.05, n)
    return lon, lat, -r.uniform(0.0, 60.0, n)


# ------------------------------------------------------------ NCFile ------

def _assert_same_file(path):
    j, t = jncio.open_dataset(path), tncio.open_dataset(path)
    try:
        assert t.dimensions == j.dimensions
        assert t.attrs == j.attrs
        assert list(t.variables) == list(j.variables)
        for name, tv in t.variables.items():
            jv = j.variables[name]
            assert (tv.dimensions, tv.shape, tv.dtype) == \
                (jv.dimensions, jv.shape, jv.dtype), name
            assert tv.attrs.keys() == jv.attrs.keys()
            for k in tv.attrs:
                np.testing.assert_array_equal(tv.attrs[k], jv.attrs[k])
            idx = () if tv.ndim == 0 else slice(None)
            np.testing.assert_array_equal(tv[idx], jv[idx])
    finally:
        j.close()
        t.close()


def test_ncfile_netcdf3_matches_jax(files):
    for path in files.values():
        _assert_same_file(path)


def _write_netcdf4(path):
    """A NetCDF-4 (HDF5) file as the netCDF library writes it: dimension
    scales attached to an int16 packed variable."""
    import h5py
    r = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        f.attrs["title"] = np.bytes_("netcdf4 test")
        for name, vals, attrs in (
                ("time", np.arange(3.0) * 3600.0,
                 {"units": b"seconds since 2024-03-01 00:00:00",
                  "standard_name": b"time"}),
                ("lat", np.linspace(59.0, 61.0, 9),
                 {"standard_name": b"latitude", "units": b"degree_north"}),
                ("lon", np.linspace(3.0, 6.0, 11),
                 {"standard_name": b"longitude", "units": b"degree_east"})):
            d = f.create_dataset(name, data=vals)
            for k, v in attrs.items():
                d.attrs[k] = v
            d.make_scale(name)
        for name, std in (("uo", b"eastward_sea_water_velocity"),
                          ("vo", b"northward_sea_water_velocity")):
            data = np.round(300 * r.standard_normal((3, 9, 11)))
            data[:, :2, :3] = -32767
            v = f.create_dataset(name, data=data.astype(np.int16))
            v.attrs["scale_factor"] = np.float32(0.001)
            v.attrs["add_offset"] = np.float32(0.0)
            v.attrs["_FillValue"] = np.int16(-32767)
            v.attrs["standard_name"] = std
            for i, dim in enumerate(("time", "lat", "lon")):
                v.dims[i].attach_scale(f[dim])
    return path


def test_ncfile_netcdf4_through_h5py_matches_jax(tmp_path):
    path = _write_netcdf4(str(tmp_path / "nc4.nc"))
    _assert_same_file(path)
    f = tncio.open_dataset(path)
    assert f.variables["uo"].dimensions == ("time", "lat", "lon")
    f.close()
    j, t = jnetcdf.NetCDFReader(path), tnetcdf.NetCDFReader(path)
    jstate, host, _ = F.prepare_pair(j, t, interval_seconds=3600.0)
    F.assert_tables_equal(host, jstate)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_cf_unpack_bit_equal(route, monkeypatch):
    """int16 with fill, scale and offset (the native decode, or numpy where
    no library builds), valid ranges and a scrub range; int16 with a
    missing_value and float with a fill (numpy in both packages)."""
    if route == "numpy":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tnative.decode_route() == route
    r = np.random.default_rng(2)
    raw = r.integers(-32768, 32767, (7, 33, 41), dtype=np.int16)
    raw[:, :3] = -32767
    raw[:, -2:] = 0
    cases = [
        ({"_FillValue": np.int16(-32767), "scale_factor": np.float32(0.001),
          "add_offset": np.float32(10.0)}, raw, None),
        ({"_FillValue": np.int16(-32767), "scale_factor": 0.01,
          "add_offset": -3.5, "valid_min": -200.0, "valid_max": 250.0},
         raw, (-100.0, 100.0)),
        ({"scale_factor": np.float32(2e-4)}, raw, None),
        ({"missing_value": np.int16(0), "scale_factor": np.float32(0.5)},
         raw, None),
        ({"_FillValue": np.float32(-999.0), "valid_max": np.float32(30.0)},
         np.where(raw > 30000, -999.0, raw / 1000.0).astype(np.float32),
         None),
    ]
    for attrs, data, scrub in cases:
        var = type("V", (), {"attrs": attrs})()
        got = tncio.cf_unpack(var, data, scrub_range=scrub)
        want = jncio.cf_unpack(var, data, scrub_range=scrub)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert np.isnan(got).any() == bool(set(attrs) & {
            "_FillValue", "missing_value", "valid_max"})


@pytest.mark.parametrize("units", [
    "seconds since 2024-03-01 00:00:00", "hours since 1970-01-01",
    "days since 2000-01-01T12:00:00Z", "minutes since 2020-02-29 23:59:30.5",
    "hours since 2024-03-01 00:00:00 +00:00", "second"])
def test_parse_cf_time_matches_jax(units):
    vals = np.array([0.0, 1.5, 36.25, 1e4])
    assert list(tncio.parse_cf_time(units, vals)) == \
        list(jncio.parse_cf_time(units, vals))


def test_multi_file_time_axis_and_corrupt_frames(tmp_path):
    """Two files given out of order, the first with a fill-value time:
    the corrupt frame is dropped and the frames sort across files, as in
    the JAX package; a window across the file boundary packs equal."""
    a = F.write_regular(str(tmp_path / "a.nc"), nt=4, fill_time=2)
    b = F.write_regular(str(tmp_path / "b.nc"), nt=3, t_offset_h=4.0)
    j, t = jnetcdf.NetCDFReader([b, a]), tnetcdf.NetCDFReader([b, a])
    assert t.times == j.times and len(t.times) == 6
    assert t._file_of_frame == j._file_of_frame
    assert t._index_in_file == j._index_in_file
    assert t._z_flip and t.depths[0] == 0.0
    for rd in (j, t):
        rd.set_run_epoch(rd.times[0])
        rd.prepare(interval_seconds=3 * 3600.0)
    start = t.times[2]
    jstate = j.device_state(start, start + timedelta(hours=3))
    host = t.device_state(start, start + timedelta(hours=3))
    F.assert_tables_equal(host, jstate)


@pytest.mark.parametrize("attrs", [
    {"grid_mapping_name": "polar_stereographic",
     "straight_vertical_longitude_from_pole": 70.0,
     "latitude_of_projection_origin": 90.0, "standard_parallel": 60.0,
     "earth_radius": 6371000.0},
    {"grid_mapping_name": "stereographic",
     "latitude_of_projection_origin": 60.0,
     "longitude_of_projection_origin": 5.0,
     "scale_factor_at_projection_origin": 1.0},
    {"grid_mapping_name": "lambert_conformal_conic",
     "standard_parallel": np.array([63.3, 63.3]),
     "longitude_of_central_meridian": 15.0,
     "latitude_of_projection_origin": 63.3, "earth_radius": 6371000.0},
    {"grid_mapping_name": "mercator",
     "longitude_of_projection_origin": 0.0, "standard_parallel": 60.0,
     "semi_major_axis": 6378137.0, "semi_minor_axis": 6356752.3142},
    {"grid_mapping_name": "transverse_mercator",
     "longitude_of_central_meridian": 15.0,
     "scale_factor_at_central_meridian": 0.9996,
     "false_easting": 500000.0},
    {"grid_mapping_name": "rotated_latitude_longitude",
     "grid_north_pole_latitude": 30.0, "grid_north_pole_longitude": 10.0},
    {"grid_mapping_name": "latitude_longitude"},
    {"proj4": "+proj=stere +lat_0=90 +lon_0=58 +R=6371000"}])
def test_grid_mapping_to_proj4_matches_jax(attrs):
    got = tnetcdf._cf_grid_mapping_to_proj4(attrs)
    assert got == jnetcdf._cf_grid_mapping_to_proj4(attrs)
    from opendrift_tpu_torch.utils.crs import from_proj4
    from_proj4(got)


# --------------------------------------------------------- NetCDFReader ---

@pytest.mark.parametrize("kind", ["norkyst", "arome", "regular",
                                  "curvilinear", "global_0_360",
                                  "global_180", "ensemble"])
def test_reader_tables_bit_equal_and_samples_match(files, kind):
    j = jnetcdf.NetCDFReader(files[kind])
    t = tnetcdf.NetCDFReader(files[kind])
    assert t.variables == j.variables
    assert t.proj4 == j.proj4
    assert t.ensemble_size == j.ensemble_size
    jstate, host, tstate = F.prepare_pair(j, t, interval_seconds=7200.0)
    assert t._sampler.pair_mode == j._sampler.pair_mode
    F.assert_tables_equal(host, jstate)
    lon, lat, z = _positions(t, seed=len(kind))
    names = [v for v in t.variables if v not in t._derived]
    member = np.arange(len(lon)) if t.ensemble_size > 1 else None
    for trel in (0.0, 1800.0):
        jv, jc, tv, tc = F.sample_pair(j, t, jstate, tstate, names, trel,
                                       lon, lat, z, member=member)
        np.testing.assert_array_equal(tc, jc)
        assert 0.2 < tc.mean() <= 1.0
        for v in names:
            np.testing.assert_array_equal(np.isnan(tv[v]), np.isnan(jv[v]))
            atol = PROJECTED_ATOL[v] if kind in ("norkyst", "arome") \
                else EXACT_ATOL
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=0,
                                       atol=atol, err_msg=v)
    np.testing.assert_array_equal(t.covers_positions(lon, lat),
                                  j.covers_positions(lon, lat))
    if kind in ("norkyst", "arome"):
        # grid-relative vectors were rotated: the convergence is not zero
        import torch
        g = t.crs.convergence(__import__("opendrift_tpu_torch.utils.xp",
                                         fromlist=["tnp"]).tnp,
                              torch.as_tensor(lon[:10], dtype=torch.float32),
                              torch.as_tensor(lat[:10], dtype=torch.float32))
        assert float(g.abs().max()) > 0.03
    if kind == "curvilinear":
        for got, want in zip(t.lonlat2xy(lon, lat), j.lonlat2xy(lon, lat)):
            np.testing.assert_array_equal(got, want)
        xi, yi = t.lonlat2xy(lon[tc], lat[tc])
        for got, want in zip(t.xy2lonlat(xi, yi), j.xy2lonlat(xi, yi)):
            np.testing.assert_array_equal(got, want)
    if kind == "ensemble":
        u = tv["x_sea_water_velocity"][tc]
        np.testing.assert_allclose(
            u, np.asarray(F.MEMBER_U)[np.arange(len(lon))[tc] % 3],
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel", [3, np.array([[0.0, 1.0, 0.0],
                                                 [1.0, 4.0, 1.0],
                                                 [0.0, 1.0, 0.0]])])
def test_convolution_kernel_tables_match_jax(files, kernel):
    j = jnetcdf.NetCDFReader(files["regular"])
    t = tnetcdf.NetCDFReader(files["regular"])
    _, plain, _ = F.prepare_pair(j, t, interval_seconds=3600.0)
    for rd in (j, t):
        rd.set_convolution_kernel(kernel)
    jstate, host, _ = F.prepare_pair(j, t, interval_seconds=3600.0)
    F.assert_tables_equal(host, jstate)
    assert not np.array_equal(host["packed"], plain["packed"])
    t.set_convolution_kernel(None)
    j.set_convolution_kernel(None)
    jstate, host, _ = F.prepare_pair(j, t, interval_seconds=3600.0)
    np.testing.assert_array_equal(host["packed"], plain["packed"])


def _run(pkg, files, ocean="norkyst", wind="arome", hours=3,
         single_fetch=False):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields.netcdf import NetCDFReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields.netcdf import NetCDFReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(NetCDFReader(files[ocean]))
    if wind:
        o.add_reader(NetCDFReader(files[wind]))
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:advection_single_fetch", single_fetch)
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(3)
    o.seed_elements(lon=r.uniform(13.8, 14.2, N_RUN),
                    lat=r.uniform(67.9, 68.1, N_RUN),
                    z=-r.uniform(0.0, 20.0, N_RUN),
                    time=o.env.readers[list(o.env.readers)[0]].times[0])
    o.run(duration=timedelta(hours=hours), time_step=900,
          time_step_output=3600)
    return o


@pytest.mark.parametrize("single_fetch", [False, True])
def test_default_run_from_files_matches_jax(files, single_fetch):
    """A default OceanDrift run (no landmask setting: the ocean file's own
    fill cells give its land_binary_mask) on the NorKyst-like ocean and the
    AROME-like wind, RK4, Large1994 mixing, horizontal diffusion."""
    oj = _run("jax", files, single_fetch=single_fetch)
    ot = _run("torch", files, single_fetch=single_fetch)
    assert "land_binary_mask" in ot.env.readers[list(ot.env.readers)[0]] \
        .variables
    assert "global_landmask" not in ot.env.readers
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)
    lon = ot.result["lon"].values
    assert np.nanmax(np.abs(lon[:, -1] - lon[:, 0])) > 1e-3
