"""The runtime's public surface of the port against the JAX package: the
result methods of ``OpenDriftSimulation``, ``StepContext.update_z`` and
``deactivate_elements``, seafloor and per-element environment seeding,
``PassiveTracer``, and at package level ``open``, ``versions``,
``_config_from_attributes`` and the Parquet export.

Tolerances: a method on the same result gives the same numbers (equal);
two runs of the same configuration are held as
``tests/test_torch_oceandrift.py`` holds them (statuses equal, positions
to the slice tolerance of float32 arithmetic that XLA may contract).
"""

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendrift_tpu
import opendrift_tpu_torch
from opendrift_tpu.elements import elements as jelements
from opendrift_tpu_torch.elements import elements as telements

T0 = datetime(2024, 3, 1)
N = 300


def _model(pkg, **kw):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        return OceanDrift(loglevel=40, seed=2, **kw)
    from opendrift_tpu_torch.models import OceanDrift
    return OceanDrift(loglevel=40, seed=2, device="cpu", **kw)


def _run(pkg, outfile=None):
    """Elements west of the Lofoten wall pushed east onto it by constant
    currents (the automatic landmask strands some), two of them released
    an hour late; Euler, no mixing."""
    o = _model(pkg)
    o.set_config("environment:fallback:x_sea_water_velocity", 0.6)
    o.set_config("environment:fallback:y_sea_water_velocity", 0.1)
    o.set_config("drift:vertical_mixing", False)
    o.add_metadata("experiment", "port surface")
    r = np.random.default_rng(7)
    o.seed_elements(lon=r.uniform(12.6, 12.85, N - 2),
                    lat=r.uniform(67.82, 67.95, N - 2), time=T0)
    o.seed_elements(lon=[12.7, 12.8], lat=[67.9, 67.9],
                    time=T0 + timedelta(hours=1))
    o.run(duration=timedelta(hours=6), time_step=900,
          time_step_output=3600, outfile=outfile)
    return o


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    files = {pkg: str(d / f"{pkg}.nc") for pkg in ("jax", "torch")}
    return {pkg: (_run(pkg, files[pkg]), files[pkg])
            for pkg in ("jax", "torch")}


def test_the_runs_agree(runs):
    (oj, _), (ot, _) = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat"):
        np.testing.assert_allclose(ot.result[var].values,
                                   np.asarray(oj.result[var].values),
                                   atol=1e-5, rtol=0)
    stranded = ot.status_categories.index("stranded")
    assert 0 < (ot.result["status"].values[:, -1] == stranded).mean() < 1


def test_counts_match_jax(runs):
    (oj, _), (ot, _) = runs["jax"], runs["torch"]
    for name in ("num_elements_total", "num_elements_scheduled",
                 "num_elements_activated", "num_elements_active",
                 "num_elements_deactivated", "simulation_direction"):
        assert getattr(ot, name)() == getattr(oj, name)(), name
    assert ot.num_elements_deactivated() > 0
    assert ot.num_elements_scheduled() == N


@pytest.mark.parametrize("method", ["get_time_array", "get_property",
                                    "get_trajectory_lengths",
                                    "index_of_first_and_last"])
def test_result_methods_match_jax(runs, method):
    """The port's methods on the JAX package's result equal the JAX
    package's; on its own result they give the same shapes."""
    (oj, _), (ot, _) = runs["jax"], runs["torch"]
    twin = _model("torch")
    twin.result = oj.result
    twin.time_step_output = oj.time_step_output
    if method == "get_property":
        args = ("lon",)
    elif method == "index_of_first_and_last":
        args = (np.asarray(oj.result["lon"].values),)
    else:
        args = ()
    want = getattr(oj, method)(*args)
    got = getattr(twin, method)(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if method == "get_time_array":
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    own = getattr(ot, method)(*((np.asarray(ot.result["lon"].values),)
                                if method == "index_of_first_and_last"
                                else args))
    for g, w in zip(own, want):
        assert np.shape(g) == np.shape(w)
    if method == "index_of_first_and_last":
        first, last = got
        assert (first[-2:] == 1).all() and (first[:-2] == 0).all()


def test_metadata_status_messages_and_hooks(runs):
    (oj, _), (ot, _) = runs["jax"], runs["torch"]
    assert ot.result.attrs["experiment"] == oj.result.attrs["experiment"] \
        == "port surface"
    for o in (oj, ot):
        o.store_message("first")
        o.store_message("second")
    assert ot.get_messages() == oj.get_messages() == "first\nsecond"
    assert ot.register_status("custom") == oj.register_status("custom")
    assert ot.status_code("custom") == ot.status_categories.index("custom")
    jsrs, tsrs = oj.SRS(), ot.SRS()
    assert tsrs.is_latlon and jsrs.is_latlon
    assert tsrs.proj4 == jsrs.proj4
    for o in (oj, ot):
        o.time_step = timedelta(seconds=-900)
    assert ot.simulation_direction() == oj.simulation_direction() == -1
    for o in (oj, ot):
        o.time_step = timedelta(seconds=900)
    calls = []
    o = _model("torch")
    o.post_run = lambda: calls.append(o.mode.name)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.seed_elements(lon=4.0, lat=60.0, number=3, time=T0)
    o.run(steps=2, time_step=600)
    assert calls == ["Result"]


def test_open_round_trip(runs):
    """Each package's file opens through the port as through the JAX
    package: the same model class, result and config."""
    for pkg in ("jax", "torch"):
        _, path = runs[pkg]
        ot = opendrift_tpu_torch.open(path, device="cpu")
        oj = opendrift_tpu.open(path)
        assert type(ot).__name__ == type(oj).__name__ == "OceanDrift"
        assert ot.mode.name == oj.mode.name == "Result"
        assert ot.device.type == "cpu"
        assert set(ot.result.variables) == set(oj.result.variables)
        for name in oj.result.variables:
            np.testing.assert_array_equal(ot.result[name].values,
                                          oj.result[name].values)
        np.testing.assert_array_equal(ot.result.coords["time"],
                                      oj.result.coords["time"])
        for key in ot._config:
            if key in oj._config:
                assert ot.get_config(key) == oj.get_config(key), key
        assert ot.get_config("drift:vertical_mixing") is False
        assert ot.result.attrs["experiment"] == "port surface"
        assert ot.num_elements_active() == oj.num_elements_active()


def test_config_from_attributes_matches_jax():
    oj, ot = _model("jax"), _model("torch")
    attrs = {"config_drift:horizontal_diffusivity": 3.5,
             "config_general:use_auto_landmask": 0,
             "config_export:buffer_length": "7",
             "config_drift:max_age_seconds": "None",
             "config_drift:advection_scheme": "runge-kutta4",
             "config_no:such_key": 1, "title": "x"}
    oj._config_from_attributes(attrs)
    ot._config_from_attributes(attrs)
    for key in ot._config:
        assert ot.get_config(key) == oj.get_config(key), key
    assert ot.get_config("export:buffer_length") == 7
    assert ot.get_config("general:use_auto_landmask") is False


def test_versions_names_torch():
    text = opendrift_tpu_torch.versions()
    assert "torch version" in text and "CUDA devices" in text
    assert "jax" not in text
    assert opendrift_tpu_torch.__version__ in text


def test_parquet_round_trip_matches_jax(runs, tmp_path):
    from opendrift_tpu.export import io_parquet as jparquet
    from opendrift_tpu_torch.export import io_parquet as tparquet
    ot, _ = runs["torch"]
    a, b = str(tmp_path / "t.parquet"), str(tmp_path / "j.parquet")
    tparquet.write_result_parquet(ot.result, a)
    jparquet.write_result_parquet(ot.result, b)
    cols_t, attrs_t = tparquet.read_result_parquet(a)
    cols_j, attrs_j = jparquet.read_result_parquet(b)
    assert attrs_t == attrs_j and set(cols_t) == set(cols_j)
    for k in cols_j:
        np.testing.assert_array_equal(cols_t[k], cols_j[k])
    assert len(cols_t["lon"]) == int(np.isfinite(
        ot.result["lon"].values).sum())


def test_passive_tracer_matches_jax():
    assert list(telements.PassiveTracer.variables) \
        == list(jelements.PassiveTracer.variables)
    assert issubclass(telements.PassiveTracer, telements.LagrangianArray)


def _step_context(pkg):
    """A StepContext over six elements: active and moving, active and
    frozen, not yet released, stranded."""
    status = np.array([0, 0, 0, -1, 1, 0], np.int32)
    data = {"z": np.array([-1.0, -2.0, -3.0, -4.0, -5.0, -6.0], np.float32),
            "moving": np.array([1, 1, 0, 1, 1, 1], np.float32),
            "status": status}
    o = _model(pkg)
    if pkg == "jax":
        from opendrift_tpu.models.base import StepContext
        from opendrift_tpu.elements import ElementState
        state = ElementState({k: jnp.asarray(v) for k, v in data.items()})
    else:
        from opendrift_tpu_torch.models.base import StepContext
        from opendrift_tpu_torch.elements import ElementState
        state = ElementState({k: torch.as_tensor(v) for k, v in data.items()})
    return StepContext(o, state, {}, None, (), 0.0, {"dt": 900.0}, None,
                       None)


def _host(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def test_step_context_update_z_and_deactivate_match_jax():
    cj, ct = _step_context("jax"), _step_context("torch")
    mask = np.array([True, False, True, True, True, True])
    cj.update_z(dz=jnp.full(6, 0.5, jnp.float32))
    ct.update_z(dz=torch.full((6,), 0.5))
    cj.update_z(new_z=jnp.full(6, -7.0, jnp.float32))
    ct.update_z(new_z=torch.full((6,), -7.0))
    cj.deactivate_elements(jnp.asarray(mask), "hatched")
    ct.deactivate_elements(torch.as_tensor(mask), "hatched")
    for name in ("z", "status"):
        np.testing.assert_array_equal(_host(ct.state.data[name]),
                                      _host(cj.state.data[name]))
    z = _host(ct.state.data["z"])
    assert z[0] == -7.0 and z[2] == -3.0 and z[3] == -4.0
    assert _host(ct.state.data["status"])[0] \
        == ct.sim.status_categories.index("hatched")


def _seafloor_run(pkg):
    if pkg == "jax":
        from opendrift_tpu.fields.grid import ArrayReader
    else:
        from opendrift_tpu_torch.fields import ArrayReader
    x = np.linspace(3.0, 5.0, 21)
    y = np.linspace(59.0, 61.0, 21)
    X, Y = np.meshgrid(x, y)
    h = (40.0 + 30.0 * np.sin(X) * np.cos(Y)).astype(np.float32)
    o = _model(pkg)
    o.add_reader(ArrayReader({"sea_floor_depth_below_sea_level": h}, x, y,
                             [T0, T0 + timedelta(hours=6)], name="bathy"))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("seed:seafloor", True)
    r = np.random.default_rng(8)
    o.seed_elements(lon=r.uniform(3.2, 4.8, 50), lat=r.uniform(59.2, 60.8, 50),
                    time=T0)
    _, _, state, _ = o.prepare_run(900.0, 2, total_steps=2)
    return _host(state.data["z"]), _host(state.data["prev_z"])


def test_seafloor_seeding_matches_jax():
    """z = 0.01 m above the seafloor at each seed (the JAX package pads
    its state to a multiple of its devices; the padding is not
    compared)."""
    zj, pj = _seafloor_run("jax")
    zt, pt = _seafloor_run("torch")
    assert zt.shape == (50,)
    np.testing.assert_allclose(zt, zj[:50], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(zt, pt)
    assert (zt < -9.0).all()


def _per_element_run(pkg):
    o = _model(pkg)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_mixing", False)
    n = 40
    o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0), time=T0,
                    environment={"x_sea_water_velocity":
                                 np.linspace(0.0, 0.8, n)})
    o.seed_elements(lon=4.0, lat=60.0, number=10, time=T0,
                    environment={"y_sea_water_velocity": 0.3})
    o.run(steps=4, time_step=900)
    return o


def test_per_element_environment_matches_jax():
    oj, ot = _per_element_run("jax"), _per_element_run("torch")
    assert ot.env.priority_list["x_sea_water_velocity"][0] \
        == "per_element_environment"
    for var in ("lon", "lat"):
        np.testing.assert_allclose(ot.result[var].values,
                                   np.asarray(oj.result[var].values),
                                   atol=1e-5, rtol=0)
    lon = ot.result["lon"].values[:, -1]
    lat = ot.result["lat"].values[:, -1]
    assert np.all(np.diff(lon[:40]) > 0) and np.all(lat[40:] > 60.0)
    assert np.allclose(lat[:40], 60.0, atol=1e-6)


def test_open_defaults_to_the_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        opendrift_tpu_torch.open(runs["torch"][1])
