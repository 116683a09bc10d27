"""The port's main path as a whole: OceanDrift runs of
``opendrift_tpu_torch`` on the CPU against the JAX package on the same
seeded inputs, against the reference goldens, and across the interop
bridge.

Tolerances (the slice tolerance; chip_smoke.py holds the card against the
CPU to the same numbers): per element and output step, the median
difference must stay within ``MEDIAN_ATOL`` and at most ``OUTLIER_SHARE``
of the values may differ by more than ``OUTLIER_ATOL``.  Both packages run
the same float32 operation sequence, but the libraries' transcendentals
differ by an ulp and XLA fuses some multiply-adds; an ulp in z can move
an element across a nearest-level boundary of the mixing (``round(|z|)``),
and from there its random walk feels another diffusivity.  Measured on
these runs: lon/lat differ by at most 4e-6 degrees and z by at most 1e-4 m.
The goldens keep the bounds of tests/test_reference_trajectory_parity.py.
"""

import os
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_compare  # noqa: E402
from opendrift_tpu_torch import interop, rng  # noqa: E402

MEDIAN_ATOL = {"lon": 1e-6, "lat": 1e-6, "z": 1e-4}
OUTLIER_ATOL = {"lon": 1e-4, "lat": 1e-4, "z": 0.1}
OUTLIER_SHARE = 0.02
T0 = datetime(2020, 1, 1)
N = 64            # a multiple of the 8 virtual JAX devices


def _forcing(seed=0, nx=24, ny=20, nz=6, nt=4):
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0, 2, 5, 10, 20, 40][:nz], np.float32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    current = {
        "x_sea_water_velocity":
            (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32),
        "y_sea_water_velocity":
            (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32),
        "sea_floor_depth_below_sea_level":
            r.uniform(30, 80, (ny, nx)).astype(np.float32)}
    wind = {"x_wind": (5 + 3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32),
            "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32)}
    return current, wind, x, y, depths, times


def _simulation(pkg, model, hdiff):
    current, wind, x, y, depths, times = _forcing()
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ArrayReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ArrayReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ArrayReader(current, x, y, times, depths=depths))
    o.add_reader(ArrayReader(wind, x, y, times))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", model)
    o.set_config("drift:horizontal_diffusivity", hdiff)
    o.set_config("environment:fallback:ocean_vertical_diffusivity", 1e-3)
    r = np.random.default_rng(1)
    o.seed_elements(lon=r.uniform(3.5, 4.5, N), lat=r.uniform(59.4, 60.1, N),
                    z=-r.uniform(0, 20, N), time=times[0])
    return o


def _run(pkg, model, hdiff):
    o = _simulation(pkg, model, hdiff)
    o.run(duration=timedelta(hours=5), time_step=900,
          time_step_output=3600)
    return o


def _assert_close(got, want, var):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want)), var
    d = np.abs(got - want)[~np.isnan(want)]
    assert np.median(d) <= MEDIAN_ATOL[var], (var, np.median(d))
    assert np.mean(d > OUTLIER_ATOL[var]) <= OUTLIER_SHARE, (var, d.max())


@pytest.mark.parametrize("model,hdiff", [("windspeed_Large1994", 0.0),
                                         ("constant", 0.0),
                                         ("windspeed_Large1994", 10.0)])
def test_3d_rk4_mixing_run_matches_jax(model, hdiff):
    """3D ArrayReader ('xyz' current tier, 'xy' wind tier), RK4, Visser
    mixing through the windspeed or the profile kernel's plain version;
    with hdiff > 0 the horizontal diffusion's threefry normals too."""
    oj = _run("jax", model, hdiff)
    ot = _run("torch", model, hdiff)
    assert ot.env.readers[list(ot.env.readers)[0]]._sampler.pair_mode \
        == "xyz"
    assert ot.result["lon"].shape == oj.result["lon"].shape == (N, 6)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)
    z = ot.result["z"].values
    assert (z <= 0).all() and not np.array_equal(z[:, 0], z[:, -1])


@pytest.mark.parametrize("name", ["double_gyre_rk4", "double_gyre_rk2",
                                  "double_gyre_euler",
                                  "constant_wind_euler"])
def test_matches_reference_golden(name):
    """The reference OpenDrift's own trajectories, at the bounds of
    tests/test_reference_trajectory_parity.py."""
    from test_reference_trajectory_parity import TOLERANCES
    golden, cfg = parity_compare.load_golden(name)
    from opendrift_tpu_torch.models import OceanDrift
    o = OceanDrift(loglevel=40, device="cpu")
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", cfg["scheme"])
    if name.startswith("double_gyre"):
        from opendrift_tpu_torch.fields import DoubleGyre
        r = DoubleGyre(epsilon=cfg["epsilon"], omega=cfg["omega"], A=cfg["A"])
        o.add_reader(r)
        lon, lat = r.xy2lonlat(np.asarray(cfg["seed_x"]),
                               np.asarray(cfg["seed_y"]))
        o.seed_elements(lon=lon, lat=lat, time=r.initial_time)
    else:
        for var, key in (("x_sea_water_velocity", "u"),
                         ("y_sea_water_velocity", "v"), ("x_wind", "wind_u"),
                         ("y_wind", "wind_v")):
            o.set_config(f"environment:fallback:{var}", cfg[key])
        o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                        lat=np.asarray(cfg["seed_lat"]),
                        time=datetime(2015, 9, 22, 6),
                        wind_drift_factor=np.asarray(
                            cfg["wind_drift_factor"]))
    o.run(duration=timedelta(seconds=cfg["duration_s"]),
          time_step=cfg["time_step"])
    stats = parity_compare.compare(name, o, golden)
    max_tol, final_tol = TOLERANCES[name]
    assert stats["shape_ref"] == stats["shape_our"]
    assert stats["finite_mismatch"] == 0, stats
    assert stats["max_m"] < max_tol, stats
    assert stats["final_mean_m"] < final_tol, stats


def _default_diffusivity_run(pkg):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ConstantReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ConstantReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ConstantReader({"x_wind": 8.0, "y_wind": 3.0,
                                "x_sea_water_velocity": 0.1,
                                "y_sea_water_velocity": 0.0,
                                "sea_floor_depth_below_sea_level": 80.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_mixing", True)
    o.seed_elements(lon=4.0, lat=60.0, number=56, z=-5.0, time=T0)
    o.run(steps=4, time_step=900)
    return o


def test_default_diffusivity_model_runs_and_matches_jax():
    """The default ``vertical_mixing:diffusivitymodel`` is 'environment'.
    With no reader serving the diffusivity its profile is listed as
    required but nothing reads it: the step switches to
    windspeed_Large1994, as the JAX package's does."""
    ot = _default_diffusivity_run("torch")
    assert ot.get_config("vertical_mixing:diffusivitymodel") == "environment"
    assert ot.required_profiles() == ["ocean_vertical_diffusivity"]
    oj = _default_diffusivity_run("jax")
    z = ot.result["z"].values
    assert z.shape == (56, 5) and len(np.unique(z[:, -1])) > 40
    _assert_close(z, oj.result["z"].values, "z")
    for var in ("lon", "lat"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)


def test_reader_served_profiles_still_raise():
    """A reader that serves the diffusivity needs ``sample_profiles``,
    which is not ported: the run says so before its first step."""
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import ConstantReader
    o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ConstantReader({"ocean_vertical_diffusivity": 0.01}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_mixing", True)
    o.seed_elements(lon=4.0, lat=60.0, number=8, z=-5.0, time=T0)
    with pytest.raises(NotImplementedError, match="A.3"):
        o.run(steps=2, time_step=900)


def _stranding_run(pkg, action):
    """An eastward current carries elements onto a reader-served coast."""
    nx, ny, nt = 40, 30, 3
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    times = [T0 + timedelta(hours=6 * i) for i in range(nt)]
    r = np.random.default_rng(7)
    land = np.zeros((ny, nx), np.float32)
    land[:, 26:] = 1.0
    land[10:14, 22:] = 1.0          # a headland
    data = {"x_sea_water_velocity": (0.6 + 0.05 * r.standard_normal(
                (nt, ny, nx))).astype(np.float32),
            "y_sea_water_velocity": (0.1 * r.standard_normal(
                (nt, ny, nx))).astype(np.float32),
            "land_binary_mask": land}
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ArrayReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ArrayReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ArrayReader(data, x, y, times))
    o.set_config("general:coastline_action", action)
    # some start on land and are moved to the nearest ocean cell first
    o.seed_elements(lon=r.uniform(3.8, 4.45, N), lat=r.uniform(59.2, 60.3, N),
                    time=T0)
    o.run(duration=timedelta(hours=8), time_step=1800,
          time_step_output=3600)
    return o


@pytest.mark.parametrize("action", ["stranding", "previous"])
def test_reader_served_landmask_run_matches_jax(action):
    """The coastline code on a landmask that a reader serves: relocation of
    land-seeded elements, stranding at the first land point of the last
    transect (or stepping back), against the JAX package."""
    oj = _stranding_run("jax", action)
    ot = _stranding_run("torch", action)
    for sj, st in zip(oj._seedings, ot._seedings):
        np.testing.assert_array_equal(st["lon"], sj["lon"])
        np.testing.assert_array_equal(st["lat"], sj["lat"])
    status = ot.result["status"].values
    np.testing.assert_array_equal(status,
                                  np.asarray(oj.result["status"].values))
    stranded = status[:, -1] == ot.status_categories.index("stranded")
    if action == "stranding":
        assert 10 < stranded.sum() < N
    else:
        assert not stranded.any()
    for var in ("lon", "lat"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)


def test_interop_round_trips():
    r = np.random.default_rng(2)
    arrays = {"lon": r.random(16).astype(np.float32),
              "ID": np.arange(16, dtype=np.int32),
              "status": np.zeros(16, np.int32)}
    state = interop.element_state_from_numpy(arrays, "cpu")
    assert state.lon.dtype == torch.float32 and state.ID.dtype == torch.int32
    back = interop.element_state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    dev = {"packed": r.random((6, 8)).astype(np.float32),
           "times": [0.0, 3600.0], "depths": np.zeros(1, np.float32)}
    tstate = interop.device_state_from_numpy(dev, "cpu")
    assert torch.is_tensor(tstate["packed"])
    assert isinstance(tstate["times"], np.ndarray)
    back = interop.device_state_to_numpy(tstate)
    for k, v in dev.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))


def test_advance_from_a_jax_mid_run_state():
    """Hand the JAX package's state after one interval, and its forcing
    tables, to the port; one more interval of each must agree."""
    import jax
    model, K, dt = "windspeed_Large1994", 4, 900.0
    oj = _simulation("jax", model, 0.0)
    j_adv, _, j_state, j_key = oj.prepare_run(dt, K, total_steps=2 * K)
    j_dev = oj.env.build_device_states()
    j_state, _ = j_adv(j_state, j_dev, np.float32(0.0),
                       jax.random.fold_in(j_key, 0))
    mid = {k: np.asarray(v) for k, v in j_state.data.items()}

    ot = _simulation("torch", model, 0.0)
    t_adv, _, t_state, t_key = ot.prepare_run(dt, K, total_steps=2 * K)
    t_dev = tuple(interop.device_state_from_numpy(
        {k: np.asarray(v) for k, v in s.items()}, "cpu") for s in j_dev)
    ot.env.build_device_states()   # the port's readers set up their samplers
    assert set(t_state.data) <= set(mid)
    t_state = interop.element_state_from_numpy(
        {k: mid[k] for k in t_state.data}, "cpu")
    t_next, t_snap = t_adv(t_state, t_dev, np.float32(K * dt),
                           rng.fold_in(t_key, 1))
    j_next, j_snap = j_adv(j_state, j_dev, np.float32(K * dt),
                           jax.random.fold_in(j_key, 1))
    for var in ("lon", "lat", "z"):
        np.testing.assert_array_equal(t_snap[var].numpy(),
                                      np.asarray(j_snap[var]))
        _assert_close(t_next.data[var].numpy(), np.asarray(j_next.data[var]),
                      var)



@pytest.mark.parametrize("buffer_length", [0, 2])
def test_outfile_round_trip(tmp_path, buffer_length):
    """``run(outfile=...)``, written at the end (0) or flushed every two
    output steps (2), reads back equal to the in-memory result, with the
    port's reader and with the JAX package's."""
    from opendrift_tpu.export.io_netcdf import read_result as jax_read
    from opendrift_tpu_torch.export import read_result
    o = _simulation("torch", "windspeed_Large1994", 0.0)
    o.set_config("export:buffer_length", buffer_length)
    path = str(tmp_path / "out.nc")
    o.run(duration=timedelta(hours=5), time_step=900, time_step_output=3600,
          outfile=path)
    for back in (read_result(path), jax_read(path)):
        np.testing.assert_array_equal(back.coords["time"],
                                      o.result.coords["time"])
        for var in ("lon", "lat", "z", "status"):
            np.testing.assert_array_equal(np.asarray(back[var]),
                                          o.result[var].values)
