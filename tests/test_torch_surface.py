"""The rest of the port's public surface on the CPU, against the JAX
package: the ``Environment`` constructor's JAX signature and ``run``'s
``export_buffer_length``, then the names of ROADMAP A.6b (readers and
seeding from files, LADiM imports, the reader mappings and coverage,
element and config helpers, ``max_speed``, ``memory_usage`` and
``general:profile_dir``).

Tolerances.  Host code (file parsing, numpy seeding, config) is held
bit-equal.  Runs of the two packages are held to the slice tolerance of
``tests/test_torch_oceandrift.py`` (median and outlier bounds per element
and output), and one-point samples to 1e-5 (XLA contracts multiply-adds
where torch rounds twice; 3e-7 measured).  Grid positions taken to lon/lat
through a ROMS grid are held to 1e-9 degrees: both packages interpolate
the same float32 rho coordinates in float64.
"""

import os
import socket
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch.tools import synthetic_nc

MEDIAN_ATOL = {"lon": 1e-6, "lat": 1e-6, "z": 1e-4}
OUTLIER_ATOL = {"lon": 1e-4, "lat": 1e-4, "z": 0.1}
OUTLIER_SHARE = 0.02
SAMPLE_ATOL = 1e-5
GRID_ATOL = 1e-9
T0 = datetime(2020, 1, 1)
ROMS_SMALL = dict(nxi=60, neta=50, ns=12, nt=3, hmax=400.0,
                  centre=(14.0, 67.8))


def _pkg(pkg):
    """(models, analytic, device kwargs) of a package."""
    if pkg == "jax":
        import opendrift_tpu.models as M
        import opendrift_tpu.fields.analytic as A
        return M, A, {}
    import opendrift_tpu_torch.models as M
    import opendrift_tpu_torch.fields.analytic as A
    return M, A, {"device": "cpu"}


def _hold(got, want, variables=("lon", "lat", "z")):
    for var in variables:
        d = np.abs(np.asarray(got[var].values, np.float64)
                   - np.asarray(want[var].values, np.float64))
        d = d[np.isfinite(d)]
        assert np.median(d) <= MEDIAN_ATOL[var], (var, np.median(d))
        assert np.mean(d > OUTLIER_ATOL[var]) <= OUTLIER_SHARE, \
            (var, d.max())
    np.testing.assert_array_equal(got["status"].values,
                                  want["status"].values)


def _basic_run(pkg, hours=3, **run_kw):
    M, A, kw = _pkg(pkg)
    o = M.OceanDrift(loglevel=50, **kw)
    o.add_reader(A.ConstantReader({"x_sea_water_velocity": 0.3,
                                   "y_sea_water_velocity": 0.1,
                                   "x_wind": 6.0, "y_wind": 0.0}))
    o.set_config("general:use_auto_landmask", False)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.seed_elements(lon=4.0, lat=60.0, number=10, time=T0)
    o.run(duration=timedelta(hours=hours), time_step=900, **run_kw)
    return o


@pytest.fixture(scope="module")
def roms_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface_roms")
    return synthetic_nc.write_roms(str(d / "roms.nc"), **ROMS_SMALL)


# ------------------------------------------------------ C.7 and C.8 ------

def test_environment_takes_the_jax_signature(monkeypatch):
    """``Environment(required, 2)`` (the JAX package's positional
    ``max_reader_fails``) gives ``max_reader_fails == 2`` on the default
    device, ``cuda``; ``device`` is a keyword after it."""
    from opendrift_tpu.fields.environment import Environment as JEnv
    from opendrift_tpu_torch.fields.environment import Environment
    required = {"x_sea_water_velocity": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    env = Environment(required, 2)
    assert env.max_reader_fails == JEnv(required, 2).max_reader_fails == 2
    assert env.device.type == "cuda"
    env = Environment(required, 3, device="cpu")
    assert (env.max_reader_fails, env.device.type) == (3, "cpu")
    assert Environment(required, device="cpu").max_reader_fails == \
        JEnv(required).max_reader_fails == 1


def test_environment_without_a_card_raises(monkeypatch):
    from opendrift_tpu_torch.fields.environment import Environment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Environment({"x_sea_water_velocity": {}})
    with pytest.raises(RuntimeError, match="CUDA"):
        Environment({"x_sea_water_velocity": {}}, 2)


def test_variables_along_trajectory_by_the_jax_call():
    """tests/test_api_longtail.py:46-61's inputs through a JAX-style
    ``Environment`` call of each package."""
    out = {}
    times = [T0 + timedelta(minutes=30 * i) for i in range(5)]
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.fields.environment import Environment
            kw = {}
        else:
            from opendrift_tpu_torch.fields.environment import Environment
            kw = {"device": "cpu"}
        _, A, _ = _pkg(pkg)
        r = A.OscillatingReader("x_sea_water_velocity", amplitude=1.0,
                                period_seconds=7200.0, zero_time=T0)
        env = Environment({"x_sea_water_velocity": {},
                           "y_sea_water_velocity": {}}, 1, **kw)
        env.add_reader([r, A.ConstantReader({"y_sea_water_velocity":
                                             0.25})])
        env.finalize(run_epoch=T0)
        out[pkg] = env.get_variables_along_trajectory(
            ["x_sea_water_velocity", "y_sea_water_velocity"],
            lons=np.linspace(3, 3.4, 5), lats=[60.0] * 5, times=times)
    for v in ("x_sea_water_velocity", "y_sea_water_velocity"):
        np.testing.assert_allclose(out["torch"][v], out["jax"][v],
                                   rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(out["torch"]["x_sea_water_velocity"],
                               [0, 1, 0, -1, 0], atol=1e-5)


@pytest.mark.parametrize("buffered", [False, True])
def test_run_accepts_export_buffer_length(tmp_path, buffered):
    """``run(export_buffer_length=...)`` runs in both packages, gives equal
    results and leaves the flush length to ``export:buffer_length``."""
    res = {}
    for pkg in ("jax", "torch"):
        kw = {"export_buffer_length": 3}
        if buffered:
            kw["outfile"] = str(tmp_path / f"{pkg}.nc")
        res[pkg] = _basic_run(pkg, **kw)
    _hold(res["torch"].result, res["jax"].result, ("lon", "lat"))
    if buffered:
        from opendrift_tpu_torch.export.io_netcdf import read_result
        back = read_result(str(tmp_path / "torch.nc"))
        np.testing.assert_array_equal(back["lon"].values,
                                      res["torch"].result["lon"].values)


# ------------------------------------------------ readers from files ------

def test_add_readers_from_file_and_default_readers(tmp_path, roms_file,
                                                   monkeypatch):
    """tests/test_api_parity.py:100-109 on the synthetic ROMS file: the one
    source that opens is added, the missing one is skipped; the default
    sources are the JAX package's list, read as text with no connection
    made and no reader opened."""
    lst = tmp_path / "readers.txt"
    lst.write_text(f"# catalog\n{roms_file}\n/nonexistent.nc\n")
    added = {}
    for pkg in ("jax", "torch"):
        M, _, kw = _pkg(pkg)
        o = M.OceanDrift(loglevel=50, **kw)
        o.add_readers_from_file(str(lst), lazy=False)
        added[pkg] = [type(r).__name__ for r in o.env.readers.values()]
    assert added["torch"] == added["jax"] == ["ROMSReader"]

    def refuse(*args, **kw):
        raise AssertionError("default_readers opened a connection")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    import opendrift_tpu_torch.fields.factory as factory
    monkeypatch.setattr(factory, "reader_from_url", refuse)
    import opendrift_tpu.models as JM
    import opendrift_tpu_torch.models as TM
    got = TM.OceanDrift(loglevel=50, device="cpu").default_readers()
    assert got == JM.OceanDrift(loglevel=50).default_readers()
    assert len(got) == 4 and all(u.startswith("https://") for u in got)


def test_seed_from_ladim_matches_jax(tmp_path, roms_file):
    """tests/test_api_parity.py:112-123 on the synthetic ROMS file."""
    rls = tmp_path / "release.rls"
    rls.write_text("2024-03-01T03 10 20 5\n2024-03-01T03 30 25 2\n"
                   "2024-03-01T06 58.7 49.9 12\n")
    seeded = {}
    for pkg in ("jax", "torch"):
        M, _, kw = _pkg(pkg)
        if pkg == "jax":
            from opendrift_tpu.fields.roms import ROMSReader
        else:
            from opendrift_tpu_torch.fields.roms import ROMSReader
        r = ROMSReader(roms_file)
        o = M.OceanDrift(loglevel=50, **kw)
        o.seed_from_ladim(str(rls), r)
        assert o.num_elements_scheduled_total == 3
        seeded[pkg] = o._seedings[-1]
        assert r.covers_positions(seeded[pkg]["lon"],
                                  seeded[pkg]["lat"]).all()
    for k in ("lon", "lat", "z", "time"):
        np.testing.assert_array_equal(seeded["torch"][k], seeded["jax"][k])
    assert np.all(seeded["torch"]["z"] <= 0)


class _Point:
    geom_type = "Point"

    def __init__(self, x, y):
        self.x, self.y = x, y


class _Ring:
    def __init__(self, coords):
        self.coords = coords


class _Polygon:
    geom_type = "Polygon"

    def __init__(self, coords):
        self.exterior = _Ring(coords)


@pytest.mark.parametrize("kind", ["points", "polygons"])
def test_seed_from_geopandas_ducktyped(kind):
    """tests/test_api_parity.py:126-137, and polygons (the port's
    rejection sampler draws what the JAX package's draws)."""
    class GDF:
        geometry = ([_Point(4.1, 60.2), _Point(4.3, 60.4)]
                    if kind == "points" else
                    [_Polygon([(4.0, 60.0), (4.4, 60.0), (4.2, 60.3)]),
                     _Polygon([(5.0, 61.0), (5.3, 61.0), (5.3, 61.2),
                               (5.0, 61.2)])])
    seeded = {}
    for pkg in ("jax", "torch"):
        M, _, kw = _pkg(pkg)
        o = M.OceanDrift(loglevel=50, **kw)
        o.seed_from_geopandas(GDF(), time=T0,
                              **({} if kind == "points" else {"number": 50}))
        seeded[pkg] = o._seedings
        assert o.num_elements_scheduled_total == (
            2 if kind == "points" else 100)
    assert len(seeded["torch"]) == len(seeded["jax"])
    for a, b in zip(seeded["torch"], seeded["jax"]):
        for k in ("lon", "lat"):
            np.testing.assert_array_equal(a[k], b[k])
    if kind == "points":
        assert np.allclose(sorted(seeded["torch"][-1]["lon"]), [4.1, 4.3])


def _write_ladim(path, x, y):
    """A LADiM output file (tests/test_api_longtail.py:64-83's layout) of
    three particles over two times, particle 1 absent at the second."""
    from scipy.io import netcdf_file
    f = netcdf_file(path, "w")
    f.createDimension("particle_instance", 5)
    f.createDimension("time", 2)
    f.createDimension("particle", 3)
    f.createVariable("pid", "i4", ("particle_instance",))[:] = \
        [0, 1, 2, 0, 2]
    f.createVariable("particle_count", "i4", ("time",))[:] = [3, 2]
    f.createVariable("X", "f4", ("particle_instance",))[:] = x
    f.createVariable("Y", "f4", ("particle_instance",))[:] = y
    v = f.createVariable("time", "f8", ("time",))
    v[:] = [0, 3600]
    v.units = b"seconds since 2020-01-01 00:00:00"
    f.close()


@pytest.mark.parametrize("grid", ["fake", "roms_file"])
def test_import_from_ladim_matches_jax(tmp_path, roms_file, grid):
    """tests/test_api_longtail.py:64-98 with its fake grid, and on the
    Nordic-4km-like ROMS file given by path."""
    import opendrift_tpu
    import opendrift_tpu_torch
    p = str(tmp_path / "ladim.nc")
    _write_ladim(p, [1, 2, 3, 1.5, 3.5], [1, 1, 1, 2, 2])

    class FakeRoms:
        def xy2lonlat(self, x, y):
            return (4.0 + 0.01 * np.asarray(x),
                    60.0 + 0.01 * np.asarray(y))
    roms = FakeRoms() if grid == "fake" else roms_file
    j = opendrift_tpu.import_from_ladim(p, roms)
    t = opendrift_tpu_torch.import_from_ladim(p, roms, device="cpu")
    for var in ("lon", "lat"):
        np.testing.assert_allclose(t.result[var].values,
                                   j.result[var].values, rtol=0,
                                   atol=GRID_ATOL)
    np.testing.assert_array_equal(t.result["status"].values,
                                  j.result["status"].values)
    np.testing.assert_array_equal(t.result.coords["time"],
                                  j.result.coords["time"])
    assert t.status_categories == j.status_categories
    assert t.mode.name == "Result" and type(t).__name__ == "OceanDrift"
    status = t.result["status"].values
    assert status[1, 0] == 1 and status[1, 1] == -128
    if grid == "fake":
        np.testing.assert_allclose(t.result["lon"].values[:, 0],
                                   [4.01, 4.02, 4.03], atol=1e-5)


# ---------------------------------------------------------- readers -------

def _drift(pkg, to_direction):
    M, A, kw = _pkg(pkg)
    o = M.OceanDrift(loglevel=50, **kw)
    r = A.ConstantReader({"wind_speed": 5.0,
                          "wind_to_direction": to_direction,
                          "land_binary_mask": 0.0})
    assert "x_wind" in r.variables and "x_wind" in r.derived_variables
    o.add_reader(r)
    o.set_config("environment:fallback:x_sea_water_velocity", 0.0)
    o.set_config("environment:fallback:y_sea_water_velocity", 0.0)
    o.seed_elements(lon=4, lat=60, number=2, wind_drift_factor=0.02,
                    time=datetime(2021, 1, 1))
    o.run(steps=15, time_step=3600)
    return o.result


@pytest.mark.parametrize("to_direction", [225.0, 45.0])
def test_derived_wind_from_speed_and_direction(to_direction):
    """tests/test_engine_features.py:310-339: windage from a wind given as
    speed and direction, both packages."""
    got = _drift("torch", to_direction)
    _hold(got, _drift("jax", to_direction), ("lon", "lat"))
    lon = got["lon"].values[:, -1].mean()
    lat = got["lat"].values[:, -1].mean()
    sign = -1 if to_direction == 225.0 else 1
    np.testing.assert_almost_equal(lon, 4.0 + sign * 0.068, 2)
    np.testing.assert_almost_equal(lat, 60.0 + sign * 0.034, 2)


def test_derived_variables_and_land_from_depth():
    """tests/test_engine_features.py:341-350: the derived names of each
    package's readers, and the opt-in land-from-depth mapping sampled
    where the seafloor is above and below the sea surface."""
    from opendrift_tpu.fields import analytic as JA
    from opendrift_tpu_torch.fields import analytic as TA
    for spec in ({"x_wind": 3.0, "y_wind": 4.0},
                 {"wind_speed": 5.0, "wind_to_direction": 10.0},
                 {"sea_floor_depth_below_sea_level": 0.0}):
        j, t = JA.ConstantReader(dict(spec)), TA.ConstantReader(dict(spec))
        assert t.derived_variables == j.derived_variables
        assert t.variables == j.variables
    out = TA.ConstantReader({"x_wind": 3.0, "y_wind": 4.0}).sample_at(
        [4.0], [60.0], T0, variables=["wind_speed"], device="cpu")
    np.testing.assert_allclose(out["wind_speed"], [5.0], rtol=1e-6)
    for depth, land in ((0.0, 1.0), (-2.0, 1.0), (30.0, 0.0)):
        j = JA.ConstantReader({"sea_floor_depth_below_sea_level": depth})
        t = TA.ConstantReader({"sea_floor_depth_below_sea_level": depth})
        assert "land_binary_mask" not in t.variables
        for r in (j, t):
            r.activate_environment_mapping(
                "land_binary_mask_from_ocean_depth")
        assert t.derived_variables == j.derived_variables \
            == ["land_binary_mask"]
        assert t.variables == j.variables
        got = t.sample_at([4.0, 5.0], [60.0, 61.0], T0,
                          variables=["land_binary_mask"], device="cpu")
        np.testing.assert_array_equal(got["land_binary_mask"], [land] * 2)
    with pytest.raises(ValueError):
        t.activate_environment_mapping("no_such_mapping")


def test_covers_time_and_verticalbuffer():
    """``covers_time`` of a timed and an always-valid reader, and the
    class attribute ``verticalbuffer``, as in the JAX package."""
    from opendrift_tpu.fields import ArrayReader as JArray, \
        ConstantReader as JConst
    from opendrift_tpu_torch.fields import ArrayReader, ConstantReader
    times = [T0 + timedelta(hours=h) for h in (0, 3, 6)]
    data = {"x_sea_water_velocity": np.zeros((3, 4, 5), np.float32)}
    x, y = np.linspace(3, 4, 5), np.linspace(60, 61, 4)
    pairs = [(ArrayReader(data, x, y, times), JArray(data, x, y, times)),
             (ConstantReader({"x_wind": 1.0}), JConst({"x_wind": 1.0}))]
    for t, j in pairs:
        for when in (T0 - timedelta(hours=1), T0, T0 + timedelta(hours=4),
                     T0 + timedelta(hours=6), T0 + timedelta(hours=7)):
            assert t.covers_time(when) == j.covers_time(when), when
        assert t.verticalbuffer == j.verticalbuffer == 1
    assert not pairs[0][0].covers_time(T0 + timedelta(hours=7))


def test_landmask_contains_matches_jax():
    """tests/test_landmask_bundled.py:27-28, and 10^4 seeded points over
    the bundled raster's domain."""
    from opendrift_tpu.fields.landmask import GlobalLandmask as JMask
    from opendrift_tpu_torch.fields.landmask import GlobalLandmask
    lm, jm = GlobalLandmask(), JMask()
    assert lm.contains([18.0], [68.3])[0]
    assert not lm.contains([8.0], [66.0])[0]
    r = np.random.default_rng(5)
    lon, lat = r.uniform(-5, 35, 10_000), r.uniform(55, 80, 10_000)
    np.testing.assert_array_equal(lm.contains(lon, lat),
                                  jm.contains(lon, lat))
    assert 0 < lm.contains(lon, lat).mean() < 1


# ------------------------------------------------- elements and config ----

def test_seedable_variables_and_max_speed_of_every_model():
    """``seedable_variables`` of every model's element type and the class
    attribute ``max_speed`` equal the JAX package's."""
    import opendrift_tpu
    import opendrift_tpu_torch
    for name in opendrift_tpu_torch.get_model_names():
        t = opendrift_tpu_torch.get_model(name)
        j = opendrift_tpu.get_model(name)
        assert t.ElementType.seedable_variables() == \
            j.ElementType.seedable_variables(), name
        assert t.max_speed == j.max_speed, name
    from opendrift_tpu_torch.models.base import OpenDriftSimulation
    assert OpenDriftSimulation.max_speed == 1.3


def test_num_active_and_config_hash_remove():
    """``ElementState.num_active`` over a run's state, and
    ``_config_hash_remove`` of a key, in both packages."""
    res = {pkg: _basic_run(pkg, hours=1) for pkg in ("jax", "torch")}
    from opendrift_tpu.elements import ElementState as JState
    from opendrift_tpu_torch.elements import ElementState
    state = res["torch"].state
    status = state.data["status"].clone()
    status[:3] = 1
    state = state.replace(status=status)
    jstate = JState.from_numpy({"lon": np.zeros(10),
                                "status": status.numpy()})
    assert state.num_active() == jstate.num_active() == 7
    for o in res.values():
        assert "drift:max_speed" in o._config
        o._config_hash_remove("drift:max_speed")
        o._config_hash_remove("no:such_key")
        assert "drift:max_speed" not in o._config
    # the parallel layer's keys (A.14) included, the same keys
    assert set(res["torch"]._config) == set(res["jax"]._config)
    for key in ("parallel:domain_decomposition", "parallel:particle_sharding",
                "parallel:tile_capacity_factor", "parallel:tile_grid",
                "export:sharded"):
        assert res["torch"].get_config(key) == res["jax"].get_config(key)


# ---------------------------------------------------- run diagnostics -----

@pytest.mark.parametrize("output_steps", [1, 2])
def test_memory_usage_one_entry_per_output_interval(output_steps):
    """tests/test_api_longtail.py:179-190: one host peak-RSS sample in MB
    an output interval, in both packages."""
    out = {}
    for pkg in ("jax", "torch"):
        M, _, kw = _pkg(pkg)
        o = M.OceanDrift(loglevel=40, **kw)
        o.set_config("environment:fallback:x_sea_water_velocity", 0.5)
        o.set_config("environment:fallback:y_sea_water_velocity", 0.0)
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.seed_elements(lon=4, lat=60, time=T0, number=10)
        o.run(steps=4, time_step=600, time_step_output=600 * output_steps)
        out[pkg] = o.memory_usage
    assert len(out["torch"]) == len(out["jax"]) == 4 // output_steps
    assert all(m > 10 for m in out["torch"])
    assert out["torch"] == sorted(out["torch"])    # a running peak


def test_profile_dir_writes_a_trace(tmp_path):
    """tests/test_engine_features.py:282-303: ``general:profile_dir``
    writes a torch.profiler trace of the main loop (a Chrome trace JSON
    naming the run's operations)."""
    import json
    M, A, kw = _pkg("torch")
    o = M.OceanDrift(loglevel=50, **kw)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("general:profile_dir", str(tmp_path / "trace"))
    o.add_reader(A.ConstantReader({"x_sea_water_velocity": 0.1,
                                   "y_sea_water_velocity": 0.0}))
    o.seed_elements(4.0, 60.0, number=8, time=datetime(2021, 1, 1))
    o.run(duration=timedelta(hours=1), time_step=900)
    found = [f for _, _, files in os.walk(tmp_path / "trace")
             for f in files]
    assert len(found) == 1 and found[0].endswith(".pt.trace.json")
    trace = json.load(open(tmp_path / "trace" / found[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_profiler_stops_when_the_run_fails(tmp_path):
    """A run that fails in its main loop leaves no profiler running."""
    M, A, kw = _pkg("torch")
    o = M.OceanDrift(loglevel=50, **kw)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("general:profile_dir", str(tmp_path / "trace"))
    o.add_reader(A.ConstantReader({"x_sea_water_velocity": 0.1,
                                   "y_sea_water_velocity": 0.0}))
    o.seed_elements(4.0, 60.0, number=8, time=datetime(2021, 1, 1))

    def fail(*args, **kw):
        raise RuntimeError("a reader failed")
    o.env.build_device_states = fail
    with pytest.raises(RuntimeError, match="a reader failed"):
        o.run(duration=timedelta(hours=1), time_step=900)
    assert not torch.autograd.profiler._is_profiler_enabled
