"""What hangs off the port's readers: the lazy reader, the URL factory and
its schemes, the catalog readers, the reader algebra, the standalone
diagnostics, seeding from a previous result and ``add_readers_from_list``,
each against the JAX package on the same synthetic files.

Tolerances: samples of the same float32 expressions within ``EXACT_ATOL``
(measured equal); the oscillating reader's host float32 ``sin`` against
XLA's within ``OSC_RTOL`` (an ulp or two); the gaussian blend's ``cos`` and
``exp`` differ by an ulp from XLA's, within ``GAUSS_ATOL`` (measured
1.3e-6 on values up to 1.5); the JAX package's diagnostics jit the whole
sample, and XLA contracts the blends into multiply-adds there, so their
values within ``JIT_ATOL`` (measured 1.3e-6 on currents of 0.3 m/s), and
on the projected grid within ``PROJECTED_ATOL`` (the float32 projection,
``tests/test_torch_crs.py``); seeding from a result is equal
element for element; runs are held to ``tests/test_torch_oceandrift.py``'s
slice tolerance.
"""

import os
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nc_fixtures as F
from test_torch_oceandrift import _assert_close

import opendrift_tpu.fields as J
import opendrift_tpu_torch.fields as T
from opendrift_tpu.fields import factory as jfactory
from opendrift_tpu_torch.fields import factory as tfactory
from opendrift_tpu_torch.fields import catalog as tcatalog
from opendrift_tpu_torch.interop import device_state_from_numpy
from opendrift_tpu_torch.tools import synthetic_nc

EXACT_ATOL = 1e-6
OSC_RTOL = 1e-6
GAUSS_ATOL = 1e-5
JIT_ATOL = 1e-5
PROJECTED_ATOL = 5e-4
N_RUN = 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("readers")
    return {"regular": F.write_regular(str(d / "regular.nc")),
            "norkyst": synthetic_nc.write_norkyst(
                str(d / "norkyst.nc"), nx=40, ny=50, nz=6, nt=4,
                centre=(4.5, 60.0)),
            "roms": synthetic_nc.write_roms(
                str(d / "roms.nc"), nxi=30, neta=25, ns=6, nt=3, hmax=200.0,
                centre=(4.5, 60.1), dx=6000.0),
            "dir": str(d)}


def _sample(reader, state, names, t, lon, lat, z, pkg):
    if pkg == "jax":
        v, c = reader.sample(state, names, jnp.float32(t),
                             jnp.asarray(lon, jnp.float32),
                             jnp.asarray(lat, jnp.float32),
                             jnp.asarray(z, jnp.float32))
        return {k: np.asarray(v[k]) for k in names}, np.asarray(c)
    v, c = reader.sample(state, names, np.float32(t),
                         torch.as_tensor(lon, dtype=torch.float32),
                         torch.as_tensor(lat, dtype=torch.float32),
                         torch.as_tensor(z, dtype=torch.float32))
    return {k: v[k].numpy() for k in names}, c.numpy()


def _states(j, t, t0, interval=3600.0):
    for rd in (j, t):
        rd.set_run_epoch(t0)
        rd.prepare(interval_seconds=interval)
    end = t0 + timedelta(seconds=interval)
    return j.device_state(t0, end), device_state_from_numpy(
        t.device_state(t0, end), "cpu")


def _points(n=500, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(3.2, 5.7, n), r.uniform(59.2, 61.1, n),
            -r.uniform(0.0, 60.0, n))


# ---------------------------------------------------------- the algebra ---

def _algebra(mod, path, obs_value):
    base = mod.NetCDFReader(path)
    other = mod.NetCDFReader(path)
    const = mod.ConstantReader({"x_sea_water_velocity": 0.25,
                                "y_sea_water_velocity": -0.1})
    obs = mod.ConstantReader({"x_sea_water_velocity": obs_value,
                              "y_sea_water_velocity": obs_value})
    obs.lon, obs.lat = 4.4, 60.1
    return {"add": base + const, "add_scalar": base + 0.5,
            "radd": 0.5 + base, "sub": base - other, "sub_scalar": base - 1.0,
            "mul": base * 3.0, "rmul": 2.0 * base, "div": base / 4.0,
            "gaussian": base.combine_gaussian(obs, 20000.0)}


@pytest.mark.parametrize("op", ["add", "add_scalar", "radd", "sub",
                                "sub_scalar", "mul", "rmul", "div",
                                "gaussian"])
def test_reader_algebra_matches_jax(files, op):
    j = _algebra(J, files["regular"], 1.5)[op]
    t = _algebra(T, files["regular"], 1.5)[op]
    assert type(t).__name__ == type(j).__name__
    assert t.variables == j.variables and t.name == j.name
    t0 = F.T0
    js, ts = _states(j, t, t0)
    lon, lat, z = _points(seed=len(op))
    names = ["x_sea_water_velocity", "y_sea_water_velocity"]
    jv, jc = _sample(j, js, names, 1800.0, lon, lat, z, "jax")
    tv, tc = _sample(t, ts, names, 1800.0, lon, lat, z, "torch")
    np.testing.assert_array_equal(tc, jc)
    atol = GAUSS_ATOL if op == "gaussian" else EXACT_ATOL
    for v in names:
        np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=0, atol=atol)
    if op == "sub":
        assert np.abs(tv[names[0]][tc]).max() == 0.0


def _run(pkg, readers, n=N_RUN, hours=2, start=None):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        o = OceanDrift(loglevel=40, device="cpu")
    if isinstance(readers[0], str):
        o.add_readers_from_list(readers)
    else:
        o.add_reader(readers)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:horizontal_diffusivity", 5.0)
    r = np.random.default_rng(8)
    o.seed_elements(lon=r.uniform(3.6, 4.6, n), lat=r.uniform(59.6, 60.4, n),
                    z=-r.uniform(0.0, 10.0, n), time=start or F.T0)
    o.run(duration=timedelta(hours=hours), time_step=900,
          time_step_output=3600)
    return o


def _assert_runs_close(ot, oj):
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)


@pytest.mark.parametrize("kind", ["lazy", "combined", "from_list"])
def test_run_from_new_readers_matches_jax(files, kind):
    """OceanDrift runs from a lazy NetCDF reader, from a combined reader
    (file + constant current) and from ``add_readers_from_list`` (a file
    and a ``constant:`` scheme)."""
    runs = {}
    for pkg, mod in (("jax", J), ("torch", T)):
        if kind == "lazy":
            reader = mod.LazyReader(mod.NetCDFReader, files["regular"])
            assert reader.is_lazy and reader.variables is None
            reader.initialise()
            readers = [reader]
        elif kind == "combined":
            readers = [mod.NetCDFReader(files["regular"]) + mod.ConstantReader(
                {"x_sea_water_velocity": 0.2, "y_sea_water_velocity": 0.1})]
        else:
            readers = [files["norkyst"], "constant://x_wind=6&y_wind=2"]
        runs[pkg] = _run(pkg, readers)
    _assert_runs_close(runs["torch"], runs["jax"])


def test_lazy_reader_builds_when_added_and_forwards(files):
    lazy = T.LazyReader(T.NetCDFReader, files["regular"], name="later")
    assert lazy.is_lazy and lazy.name == "LazyReader: later"
    from opendrift_tpu_torch.models import OceanDrift
    o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(lazy)
    assert not lazy.is_lazy and lazy.name == files["regular"]
    assert lazy.device == torch.device("cpu")
    assert "x_sea_water_velocity" in o.env.priority_list
    assert isinstance(lazy._reader, T.NetCDFReader)
    broken = T.LazyReader(T.NetCDFReader, files["regular"] + ".missing")
    with pytest.raises(FileNotFoundError):
        OceanDrift(loglevel=40, device="cpu").add_reader(broken)


# ------------------------------------------------------------- factory ----

def _write_ugrid(path):
    from scipy.io import netcdf_file
    f = netcdf_file(path, "w")
    f.createDimension("node", 4)
    f.createDimension("nele", 2)
    f.createDimension("three", 3)
    for name in ("lon", "lat"):
        v = f.createVariable(name, "d", ("node",))
        v[:] = np.arange(4.0)
    nv = f.createVariable("nv", "i", ("three", "nele"))
    nv[:] = [[1, 2], [2, 3], [3, 4]]
    f.close()
    return path


@pytest.mark.parametrize("url,cls", [
    ("regular", "NetCDFReader"), ("roms", "ROMSReader"),
    ("netcdf://regular", "NetCDFReader"), ("roms://roms", "ROMSReader"),
    ("constant://x_wind=3&y_wind=-1.5", "ConstantReader"),
    ("oscillating://sea_surface_height?amplitude=0.5&period_seconds=7200",
     "OscillatingReader"),
    ("double_gyre://?epsilon=0.2&omega=0.5", "DoubleGyre")])
def test_reader_from_url_matches_jax(files, url, cls):
    scheme, _, rest = url.rpartition("://")
    path = files.get(rest, rest)
    full = f"{scheme}://{path}" if scheme else path
    j, t = jfactory.reader_from_url(full), tfactory.reader_from_url(full)
    assert type(t).__name__ == type(j).__name__ == cls
    assert t.variables == j.variables and t.name == j.name
    lazy = tfactory.reader_from_url(full, lazy=True)
    if "://" not in full or scheme in ("netcdf", "roms"):
        assert isinstance(lazy, T.LazyReader) and lazy.is_lazy
    t0 = getattr(t, "times", [F.T0])[0]
    js, ts = _states(j, t, t0)
    lon, lat, z = _points(seed=3)
    names = [v for v in t.variables if v not in t._derived][:4]
    for trel in (0.0, 1234.0):
        jv, jc = _sample(j, js, names, trel, lon, lat, z, "jax")
        tv, tc = _sample(t, ts, names, trel, lon, lat, z, "torch")
        np.testing.assert_array_equal(tc, jc)
        for v in names:
            rtol = OSC_RTOL if cls == "OscillatingReader" else 0
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=rtol,
                                       atol=EXACT_ATOL)


def test_factory_refusals(files, tmp_path):
    with pytest.raises(ValueError, match="Remote URLs"):
        tfactory.reader_from_url("https://thredds.met.no/x.nc")
    with pytest.raises(ValueError, match="Unknown reader scheme"):
        tfactory.reader_from_url("nonesuch://x")
    with pytest.raises(FileNotFoundError):
        tfactory.reader_from_url(str(tmp_path / "absent.nc"))
    with pytest.raises(NotImplementedError, match="A.10"):
        tfactory.reader_from_url(_write_ugrid(str(tmp_path / "fvcom.nc")))
    slf = tmp_path / "mesh.slf"
    slf.write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError, match="A.10"):
        tfactory.reader_from_url(str(slf))
    made = []
    tfactory.register_scheme("mine", lambda p: made.append(p) or
                             T.ConstantReader({"x_wind": 1.0}))
    assert isinstance(tfactory.reader_from_url("mine://abc"),
                      T.ConstantReader) and made == ["abc"]


def test_catalog_reads_from_the_local_cache_only(files, tmp_path,
                                                 monkeypatch):
    cache = tmp_path / "cache"
    cache.mkdir()
    os.link(files["regular"], cache / "cmems_mod_glo_phy_anfc.nc")
    r = tcatalog.CopernicusMarineReader("cmems_mod_glo_phy",
                                        cache_dir=str(cache))
    assert isinstance(r, T.NetCDFReader) and r.name == "cmems_mod_glo_phy"
    monkeypatch.setenv("OPENDRIFT_DATA_CACHE", str(cache))
    assert isinstance(tcatalog.EarthaccessReader("glo_phy"), T.NetCDFReader)
    with pytest.raises(RuntimeError, match="no network access"):
        tcatalog.EarthaccessReader("MUR-JPL-L4", cache_dir=str(tmp_path))


def test_not_yet_ported_readers_name_their_item():
    from opendrift_tpu_torch.fields import analytic, grib
    for cls in (T.ArtificialOceanEddy, T.FailingReader, T.TimeseriesReader,
                T.CurrentFromTrack, T.CurrentFromDrifter,
                analytic.Constant2DReader):
        with pytest.raises(NotImplementedError, match="A.9b"):
            cls()
    with pytest.raises(NotImplementedError, match="A.9b"):
        grib.GribReader("forcing.grb")


# ---------------------------------------------------------- diagnostics ---

@pytest.mark.parametrize("kind", ["regular", "norkyst"])
def test_timeseries_and_sample_at_match_jax(files, kind):
    j, t = J.NetCDFReader(files[kind]), T.NetCDFReader(files[kind])
    names = ["x_sea_water_velocity", "y_sea_water_velocity"]
    jt = j.get_timeseries_at_position(4.3, 60.0, variables=names, z=-3.0)
    tt = t.get_timeseries_at_position(4.3, 60.0, variables=names, z=-3.0,
                                      device="cpu")
    assert tt["time"] == jt["time"] and len(tt["time"]) == len(t.times)
    atol = PROJECTED_ATOL if kind == "norkyst" else JIT_ATOL
    for v in names:
        np.testing.assert_allclose(tt[v], jt[v], rtol=0, atol=atol)
        assert np.isfinite(tt[v]).all()
    lon, lat, z = _points(seed=11)
    lon = lon * 1.6 - 3.0         # 2.1 to 6.1 E: some beyond both grids
    ja = j.sample_at(lon, lat, t.times[1], variables=names + ["sea_water_speed"],
                     z=z)
    ta = t.sample_at(lon, lat, t.times[1], variables=names + ["sea_water_speed"],
                     z=z, device="cpu")
    for v in ja:
        np.testing.assert_array_equal(np.isnan(ta[v]), np.isnan(ja[v]))
        ok = ~np.isnan(ja[v])
        np.testing.assert_allclose(ta[v][ok], ja[v][ok], rtol=0, atol=atol)
        assert ok.any() and not ok.all()


def test_variables_along_trajectory_match_jax(files):
    times = [F.T0 + timedelta(minutes=20 * i) for i in range(8)]
    lon = np.linspace(3.8, 4.9, 8)
    lat = np.linspace(59.5, 60.6, 8)
    names = ["x_sea_water_velocity", "y_sea_water_velocity"]
    out = {}
    for pkg, mod in (("jax", J), ("torch", T)):
        if pkg == "jax":
            from opendrift_tpu.models import OceanDrift
            o = OceanDrift(loglevel=40)
        else:
            from opendrift_tpu_torch.models import OceanDrift
            o = OceanDrift(loglevel=40, device="cpu")
        o.add_reader(mod.NetCDFReader(files["regular"]))
        o.env.finalize(times[0])
        out[pkg] = o.env.get_variables_along_trajectory(names, lon, lat,
                                                        times, z=-2.0)
    assert out["torch"]["time"] == out["jax"]["time"]
    for v in names:
        np.testing.assert_allclose(out["torch"][v], out["jax"][v], rtol=0,
                                   atol=JIT_ATOL)
        assert np.isfinite(out["torch"][v]).all()


# -------------------------------------------------------------- seeding ---

def test_seed_from_file_and_dataset_match_jax(files, tmp_path):
    """Continue from a previous result: the JAX package writes it, both
    packages seed from the file (and the port from its own result), and
    the seeded elements are equal."""
    out = str(tmp_path / "first.nc")
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu_torch.models import OceanDrift as TOceanDrift
    first = JOceanDrift(loglevel=40)
    first.add_reader(J.NetCDFReader(files["regular"]))
    first.set_config("environment:fallback:land_binary_mask", 0)
    first.set_config("drift:deactivate_east_of", 4.3)
    r = np.random.default_rng(2)
    first.seed_elements(lon=r.uniform(3.6, 4.4, 40),
                        lat=r.uniform(59.6, 60.4, 40),
                        z=-r.uniform(0, 10, 40), time=F.T0)
    first.run(duration=timedelta(hours=2), time_step=900,
              time_step_output=1800, outfile=out)
    seeded = {}
    for pkg, cls in (("jax", JOceanDrift), ("torch", TOceanDrift)):
        o = cls(loglevel=40) if pkg == "jax" else cls(loglevel=40,
                                                      device="cpu")
        o.seed_from_file(out, wind_drift_factor=0.01)
        seeded[pkg] = o._seedings[0]
    assert 0 < len(seeded["torch"]["lon"]) < 40
    for k in ("lon", "lat", "z", "wind_drift_factor"):
        np.testing.assert_array_equal(np.asarray(seeded["torch"][k]),
                                      np.asarray(seeded["jax"][k]))
    np.testing.assert_array_equal(np.asarray(seeded["torch"]["time"]),
                                  np.asarray(seeded["jax"]["time"]))
    # from the port's own result, continuing a port run
    o = _run("torch", [T.NetCDFReader(files["regular"])], n=16, hours=1)
    nxt = TOceanDrift(loglevel=40, device="cpu")
    nxt.seed_from_dataset(o.result)
    np.testing.assert_array_equal(nxt._seedings[0]["lon"],
                                  o.result["lon"].values[:, -1])
