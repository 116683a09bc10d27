"""What hangs off the port's readers: the lazy reader, the URL factory and
its schemes, the catalog readers, the reader algebra, the standalone
diagnostics, seeding from a previous result and ``add_readers_from_list``,
and the analytic readers (the eddy, the failing reader, the track and
drifter currents, the time series, the static 2D grid), each against the
JAX package on the same synthetic files or inputs.

Tolerances: samples of the same float32 expressions within ``EXACT_ATOL``
(measured equal); the oscillating reader's host float32 ``sin`` against
XLA's within ``OSC_RTOL`` (an ulp or two); the gaussian blend's ``cos`` and
``exp`` differ by an ulp from XLA's, within ``GAUSS_ATOL`` (measured
1.3e-6 on values up to 1.5); the JAX package's diagnostics jit the whole
sample, and XLA contracts the blends into multiply-adds there, so their
values within ``JIT_ATOL`` (measured 1.3e-6 on currents of 0.3 m/s), and
on the projected grid within ``PROJECTED_ATOL`` (the float32 projection,
``tests/test_torch_crs.py``), or ``INDEX_ATOL`` of a cell times a field's
largest step between cells; seeding from a result is equal
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
INDEX_ATOL = 1e-3
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
    # a UGRID file goes to FVCOMReader and a .slf file to TelemacReader,
    # as in the JAX package; these two are malformed (no time axis, a
    # truncated header) and fail there as they do in the JAX package
    slf = tmp_path / "mesh.slf"
    slf.write_bytes(b"\0" * 16)
    for bad in (_write_ugrid(str(tmp_path / "fvcom.nc")), str(slf)):
        with pytest.raises(Exception) as want:
            jfactory.reader_from_url(bad)
        with pytest.raises(want.type):
            tfactory.reader_from_url(bad)
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
    """The reader layer is whole and no stub naming a ROADMAP item is left
    in the port: the last one, a reader state of the domain decomposition
    (A.14, ``fields/grid.py``), is now a tile's band, which samples the
    same values as the whole grid at the same positions.  The plots and
    seeders that raised naming A.13 are ported, and every model of the
    zoo resolves."""
    import re
    from opendrift_tpu_torch.ops.interp import PackedSampler
    u = np.arange(2 * 6 * 4, dtype=np.float32).reshape(2, 6, 4)
    grid = T.ArrayReader({"x_sea_water_velocity": u}, np.arange(4.0),
                         np.arange(6.0) + 60.0,
                         [F.T0, F.T0 + timedelta(hours=1)])
    grid.set_run_epoch(F.T0)
    whole = grid.device_state(F.T0, F.T0 + timedelta(hours=1))
    state = {k: (torch.as_tensor(np.asarray(v)) if k != "times" else v)
             for k, v in whole.items()}
    lon = torch.tensor([1.25, 2.5])
    lat = torch.tensor([63.5, 64.25])
    want, _ = grid.sample(state, ["x_sea_water_velocity"], np.float32(900.0),
                          lon, lat, torch.zeros(2))
    # rows 2..5 of the grid as a tile band with y_off = 2
    s = grid._sampler
    band = state["packed"].reshape(s.Y, s.X, -1)[2:]
    tile = dict(state, packed=band.reshape(-1, band.shape[-1]), y_off=2.0)
    grid._sampler = PackedSampler(s.Z, 4, s.X, s.F, s.col_of, s.pair_mode)
    got, covers = grid.sample(tile, ["x_sea_water_velocity"],
                              np.float32(900.0), lon, lat, torch.zeros(2))
    assert covers.all()
    assert torch.equal(got["x_sea_water_velocity"],
                       want["x_sea_water_velocity"])
    import opendrift_tpu_torch
    root = os.path.dirname(opendrift_tpu_torch.__file__)
    stubs = []
    for folder, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                text = open(os.path.join(folder, name)).read()
                for item in re.findall(
                        r"NotImplementedError\([^)]*ROADMAP (A\.\d+\w*)",
                        text):
                    stubs.append((os.path.relpath(os.path.join(
                        folder, name), root), item))
    assert stubs == []
    for name in ("RadionuclideDrift", "ChemicalDrift", "OpenHNS",
                 "OpenBergOld", "ModelTemplate"):
        assert opendrift_tpu_torch.get_model(name).__name__ == name


# ------------------------------------------------------ analytic readers --

def _analytic_pair(name):
    from opendrift_tpu.fields import analytic as janalytic
    from opendrift_tpu_torch.fields import analytic as tanalytic
    return getattr(janalytic, name), getattr(tanalytic, name)


def _analytic_samples(j, t, names, times_s, lon, lat, z, t0):
    """Both readers' samples at ``times_s`` (seconds from ``t0``, the run
    epoch): [(JAX values, JAX covers, port values, port covers)]."""
    js, ts = _states(j, t, t0, interval=max(times_s) or 3600.0)
    return [(*_sample(j, js, names, trel, lon, lat, z, "jax"),
             *_sample(t, ts, names, trel, lon, lat, z, "torch"))
            for trel in times_s]


def _assert_analytic_close(pairs, names, atol, rtol=0.0):
    for jv, jc, tv, tc in pairs:
        np.testing.assert_array_equal(tc, jc)
        assert tc.any()
        for v in names:
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=rtol,
                                       atol=atol, err_msg=v)


def test_artificial_ocean_eddy_matches_jax():
    """The stereographic eddy: its float32 projection, convergence and
    rotation; within PROJECTED_ATOL (m/s on currents of 0.3 m/s)."""
    jc, tc = _analytic_pair("ArtificialOceanEddy")
    j, t = jc(lon=2.0, lat=66.0), tc(lon=2.0, lat=66.0)
    r = np.random.default_rng(4)
    lon, lat = r.uniform(-1.0, 5.0, 800), r.uniform(64.0, 68.0, 800)
    lon[:3], lat[:3] = 2.0, 66.0                      # the centre itself
    names = ["x_sea_water_velocity", "y_sea_water_velocity"]
    pairs = _analytic_samples(j, t, names, [0.0], lon, lat,
                              np.zeros(800), F.T0)
    _assert_analytic_close(pairs, names, PROJECTED_ATOL)
    speed = np.hypot(*(pairs[0][2][v] for v in names))
    assert 0.05 < speed.max() <= 0.3 + 1e-6


def test_failing_reader_fails_in_both_and_is_quarantined():
    """FailingReader raises on every fetch in both packages; a run with it
    before a constant reader discards it after the environment's
    quarantine count and runs on the constant current, as in the JAX
    package."""
    for mod in (J, T):
        r = mod.FailingReader()
        with pytest.raises(RuntimeError, match="always fails"):
            r.device_state()
    runs = {}
    for pkg, mod in (("jax", J), ("torch", T)):
        runs[pkg] = _run(pkg, [mod.FailingReader(), mod.ConstantReader(
            {"x_sea_water_velocity": 0.2, "y_sea_water_velocity": 0.1})],
            hours=3)
    assert runs["torch"].env.discarded_readers.keys() == \
        runs["jax"].env.discarded_readers.keys() == {"failing_reader"}
    _assert_runs_close(runs["torch"], runs["jax"])


def _track(n=7):
    r = np.random.default_rng(5)
    lon = 4.0 + np.cumsum(r.uniform(-0.01, 0.03, n))
    lat = 60.0 + np.cumsum(r.uniform(-0.01, 0.02, n))
    times = [F.T0 + timedelta(minutes=50 * i) for i in range(n)]
    return lon, lat, times


def test_current_from_track_matches_jax():
    """Segment velocities from a track (geodesic inverse, windage) and the
    piecewise-constant series at times before, inside and after it:
    equal."""
    lon, lat, times = _track()
    jc, tc = _analytic_pair("CurrentFromTrack")
    kw = dict(wind_east=3.0, wind_north=-1.0, windage_rate=0.02)
    j, t = jc(lon, lat, times, **kw), tc(lon, lat, times, **kw)
    np.testing.assert_array_equal(t._u, j._u)
    np.testing.assert_array_equal(t._v, j._v)
    names = ["x_sea_water_velocity", "y_sea_water_velocity"]
    p = _points(50, seed=6)
    pairs = _analytic_samples(j, t, names, [-600.0, 0.0, 2999.0, 3000.0,
                                            7000.0, 99999.0], *p, times[0])
    _assert_analytic_close(pairs, names, 0.0)


def test_current_from_drifter_matches_jax():
    """The drifter track with the monochromatic Stokes drift of a wave
    reader subtracted, sampled once a segment at its midpoint and start
    time (an ArrayReader of waves varying in space and time); within
    ``JIT_ATOL`` (the JAX package jits and vectorises the wave samples)."""
    lon, lat, times = _track()
    wave_vars = ["sea_surface_wave_significant_height",
                 "sea_surface_wave_stokes_drift_x_velocity",
                 "sea_surface_wave_stokes_drift_y_velocity",
                 "sea_surface_wave_mean_period_from_variance_spectral_"
                 "density_inverse_frequency_moment"]
    x, y = np.linspace(3.5, 5.0, 16), np.linspace(59.5, 60.8, 14)
    wt = [times[0] + timedelta(hours=2 * i) for i in range(4)]
    r = np.random.default_rng(7)
    data = {v: (r.uniform(0.5, 3.0, (4, 14, 16)) * s).astype(np.float32)
            for v, s in zip(wave_vars, (1.0, 0.1, 0.05, 4.0))}
    made = {}
    for pkg, mod in (("jax", J), ("torch", T)):
        waves = mod.ArrayReader(data, x, y, wt, name="waves")
        kw = {} if pkg == "jax" else {"device": "cpu"}
        made[pkg] = mod.CurrentFromDrifter(lon, lat, times, waves=waves,
                                           z=-1.0, **kw)
    np.testing.assert_allclose(made["torch"]._u, made["jax"]._u, rtol=0,
                               atol=JIT_ATOL)
    np.testing.assert_allclose(made["torch"]._v, made["jax"]._v, rtol=0,
                               atol=JIT_ATOL)
    plain = T.CurrentFromTrack(lon, lat, times, windage_rate=0.0)
    assert np.abs(made["torch"]._u - plain._u).max() > 1e-3


def test_timeseries_reader_matches_jax():
    """Linear interpolation of the series at times before, on, between and
    after its samples: float32 on the host against ``jnp.interp``, within
    ``OSC_RTOL``."""
    times = [F.T0 + timedelta(minutes=37 * i) for i in range(6)]
    series = {"x_wind": [1.0, 3.5, -2.0, 4.0, 4.0, 0.5],
              "y_wind": [0.0, -1.0, 2.5, 2.5, 7.0, 1.0]}
    j = J.TimeseriesReader(series, times, lon=4.0, lat=60.0)
    t = T.TimeseriesReader(series, times, lon=4.0, lat=60.0)
    names = list(series)
    p = _points(20, seed=8)
    pairs = _analytic_samples(j, t, names, [-900.0, 0.0, 1000.0, 2220.0,
                                            4439.9, 9000.0, 11100.0,
                                            20000.0], *p, times[0])
    _assert_analytic_close(pairs, names, EXACT_ATOL, rtol=OSC_RTOL)


@pytest.mark.parametrize("proj", ["latlong", "stere"])
def test_constant_2d_reader_matches_jax(proj):
    """Static 2D fields on a regular lat-lon or projected grid, sampled
    bilinearly with the grid's coverage: equal to the JAX package's within
    EXACT_ATOL; on the projected grid within INDEX_ATOL of a cell (the
    float32 projection, ``tests/test_torch_crs.py``) times the fields'
    largest step between neighbouring cells."""
    r = np.random.default_rng(9)
    if proj == "latlong":
        x, y, proj4 = np.linspace(3.0, 6.0, 13), np.linspace(
            59.0, 61.5, 11), "+proj=latlong"
        lon, lat = r.uniform(2.8, 6.2, 600), r.uniform(58.9, 61.6, 600)
        atol = EXACT_ATOL
    else:
        proj4 = ("+proj=stere +lat_0=90 +lon_0=70 +lat_ts=60 "
                 "+R=6371000 +units=m")
        x = np.linspace(-1.0e6, -0.8e6, 13)
        y = np.linspace(-2.6e6, -2.4e6, 11)
        from opendrift_tpu_torch.utils import crs as crslib
        X, Y = np.meshgrid(x, y)
        glon, glat = crslib.from_proj4(proj4).inv(np, X, Y)
        lon = r.uniform(glon.min(), glon.max(), 600)
        lat = r.uniform(glat.min(), glat.max(), 600)
    arrays = {"sea_floor_depth_below_sea_level":
              r.uniform(20.0, 400.0, (11, 13)),
              "x_sea_water_velocity": r.normal(0.0, 0.3, (11, 13))}
    if proj != "latlong":
        atol = INDEX_ATOL * max(max(np.abs(np.diff(a, axis=k)).max()
                                    for k in (0, 1))
                                for a in arrays.values())
    jc, tc = _analytic_pair("Constant2DReader")
    j, t = jc(x, y, arrays, proj4=proj4), tc(x, y, arrays, proj4=proj4)
    names = list(arrays)
    pairs = _analytic_samples(j, t, names, [0.0], lon, lat,
                              np.zeros(600), F.T0)
    _assert_analytic_close(pairs, names, atol)
    assert not pairs[0][3].all()


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
