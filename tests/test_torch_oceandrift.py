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

from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch import interop, rng
from opendrift_tpu_torch.tools import parity_compare as parity

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
    """The reference OpenDrift's own trajectories, through the port's
    parity tool (its copies of the bounds of
    tests/test_reference_trajectory_parity.py)."""
    rec = parity.check(name, "cpu")
    assert rec["status"] == "pass", rec


def test_mixing_sundby_stat_golden():
    """The reference OpenDrift's Visser walk with the Sundby1983
    diffusivity (3,000 elements, constant fallbacks, Euler), through the
    port's parity tool, at the statistical bounds of
    tests/test_reference_stat_parity.py."""
    golden, cfg = parity.load_golden("mixing_sundby_stat")
    o = parity.RUNNERS["mixing_sundby_stat"](cfg, "cpu")
    assert o.result["z"].values.shape[0] == 3000
    rows = parity.check_stat("mixing_sundby_stat", cfg, o, golden)
    assert all(r["ok"] for r in rows), rows


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


def _served_diffusivity_run(pkg):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ConstantReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ConstantReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ConstantReader({"ocean_vertical_diffusivity": 0.01,
                                "sea_floor_depth_below_sea_level": 60.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_mixing", True)
    o.seed_elements(lon=4.0, lat=60.0, number=56, z=-5.0, time=T0)
    o.run(steps=3, time_step=900)
    return o


def test_reader_served_profiles_still_raise():
    """A reader that serves the diffusivity once raised here, for want of
    ``sample_profiles``.  It runs now: the profile comes through the base
    reader's level loop into the profile kernel's plain version, and the
    depths spread as the JAX package's do."""
    ot = _served_diffusivity_run("torch")
    oj = _served_diffusivity_run("jax")
    z = ot.result["z"].values
    assert z.shape == (56, 4) and len(np.unique(z[:, -1])) > 40
    _assert_close(z, oj.result["z"].values, "z")


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


# ------------------------------------------ the packed-row sampler path ----

def _coast_forcing(seed=0, nx=30, ny=24, nz=6, nt=4):
    """A 3D ocean with currents setting towards a coast in the east, a 3D
    diffusivity that falls with depth, a seafloor and a landmask in one
    reader, and a wind reader."""
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0, 2, 5, 10, 20, 40][:nz], np.float32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    decay = np.exp(-depths / 15.0)[None, :, None, None]
    land = np.zeros((ny, nx), np.float32)
    land[:, nx - 6:] = 1.0
    land[8:12, nx - 9:] = 1.0
    ocean = {
        "x_sea_water_velocity": (0.5 * decay + 0.1 * r.standard_normal(
            (nt, nz, ny, nx))).astype(np.float32),
        "y_sea_water_velocity": (0.15 * r.standard_normal(
            (nt, nz, ny, nx))).astype(np.float32),
        "ocean_vertical_diffusivity": (0.02 * decay * r.uniform(
            0.5, 1.5, (nt, nz, ny, nx))).astype(np.float32),
        "sea_floor_depth_below_sea_level":
            r.uniform(30, 80, (ny, nx)).astype(np.float32),
        "land_binary_mask": land}
    wind = {"x_wind": (5 + 3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32),
            "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32)}
    return ocean, wind, x, y, depths, times


def _sampler_sim(pkg, config=(), cls=None, diffusivity=True, n=N):
    ocean, wind, x, y, depths, times = _coast_forcing()
    if not diffusivity:
        del ocean["ocean_vertical_diffusivity"]
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ArrayReader
        o = (cls or OceanDrift)(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ArrayReader
        o = (cls or OceanDrift)(loglevel=40, device="cpu")
    o.add_reader(ArrayReader(ocean, x, y, times, depths=depths, name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    for key, value in dict(config).items():
        o.set_config(key, value)
    r = np.random.default_rng(1)
    o.seed_elements(lon=r.uniform(3.9, 4.6, n), lat=r.uniform(59.2, 60.3, n),
                    z=-r.uniform(0, 20, n), time=times[0])
    return o


def _sampler_run(pkg, config=(), **kw):
    o = _sampler_sim(pkg, config, **kw)
    o.run(duration=timedelta(hours=7), time_step=900, time_step_output=3600)
    return o


def _assert_runs_close(ot, oj, min_stranded=1):
    status = ot.result["status"].values
    np.testing.assert_array_equal(status,
                                  np.asarray(oj.result["status"].values))
    stranded = status[:, -1] == ot.status_categories.index("stranded")
    assert min_stranded <= stranded.sum() < status.shape[0]
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)


@pytest.mark.parametrize("bisection", ["block", "refetch"])
def test_single_fetch_run_matches_jax(bisection):
    """RK4 on one corner block a step (drift:advection_single_fetch), the
    step's environment from the same block, and stranding whose bisection
    probes re-read the block or refetch the mask."""
    config = {"drift:advection_single_fetch": True,
              "general:coastline_bisection": bisection}
    ot = _sampler_run("torch", config)
    oj = _sampler_run("jax", config)
    assert ot.env.readers["ocean"]._sampler.pair_mode == "xyz"
    assert ot.env.uv_block_plan_index() == oj.env.uv_block_plan_index() == 0
    _assert_runs_close(ot, oj, min_stranded=5)
    # and it is a different computation from the multi-fetch run, though a
    # close one: stage displacements stay inside a cell
    om = _sampler_run("torch")
    d = np.abs(ot.result["lon"].values - om.result["lon"].values)
    assert 0 < np.nanmax(d) < 1e-2


def test_single_fetch_gathers_one_block_a_step(monkeypatch):
    """Row gathers of one interval, counted: the multi-fetch step takes 5
    (the ocean fetch, three RK4 stage refetches, the wind); the
    single-fetch step 2 (one corner block, the wind), plus the mask
    fetches of a 'refetch' bisection where something strands."""
    from opendrift_tpu_torch.fields import grid as tgrid
    from opendrift_tpu_torch.ops import interp as tinterp
    calls = []
    real = tinterp.take_rows

    def counted(packed, lin):
        calls.append(tuple(packed.shape))
        return real(packed, lin)
    monkeypatch.setattr(tinterp, "take_rows", counted)
    monkeypatch.setattr(tgrid, "take_rows", counted)
    counts = {}
    for name, config in (
            ("multi", {}),
            ("single", {"drift:advection_single_fetch": True,
                        "general:coastline_bisection": "block"})):
        o = _sampler_sim("torch", config, diffusivity=False)
        advance, _, state, key = o.prepare_run(900.0, 4, total_steps=4)
        states = o.env.build_device_states()
        calls.clear()
        advance(state, states, np.float32(0.0), key)
        counts[name] = len(calls) / 4
    assert counts["single"] == 2.0
    # 5 a step, and 3 mask refetches in each step where something strands
    extra = counts["multi"] * 4 - 20
    assert extra >= 0 and extra % 3 == 0, counts


def test_environment_diffusivity_reader_run_matches_jax(monkeypatch):
    """'environment' with a reader that serves a 3D diffusivity: profiles of
    ``profile_levels`` levels a step through ``sample_profiles`` /
    ``get_profiles`` into the profile kernel (its plain version here)."""
    from opendrift_tpu_torch.ops import mixing
    config = {"vertical_mixing:diffusivitymodel": "environment",
              "vertical_mixing:profile_levels": 11,
              "drift:profile_depth": 40.0,
              "drift:advection_single_fetch": True,
              "general:coastline_bisection": "block"}
    used = []
    real = mixing.visser_mixing_profile_plain

    def counted(*args, **kw):
        used.append(tuple(args[3].shape))
        return real(*args, **kw)
    monkeypatch.setattr(mixing, "visser_mixing_profile_plain", counted)
    ot = _sampler_run("torch", config)
    assert used == [(11, N)] * 28           # once a step, (levels, elements)
    oj = _sampler_run("jax", config)
    _assert_runs_close(ot, oj)
    z = ot.result["z"].values
    assert not np.array_equal(z[:, 0], z[:, -1])


@pytest.mark.parametrize("model", ["windspeed_Large1994", "environment",
                                   "constant"])
def test_generic_loop_matches_kernels_and_jax(model):
    """vertical_mixing:use_pallas=False takes the per-substep loop.  With
    the base hooks it repeats the kernels' plain versions operation for
    operation (equal to the bit here, where both are the same torch calls)
    and matches the JAX package's loop to the slice tolerance."""
    config = {"vertical_mixing:diffusivitymodel": model,
              "vertical_mixing:profile_levels": 11,
              "environment:fallback:ocean_vertical_diffusivity": 1e-3}
    loop = dict(config, **{"vertical_mixing:use_pallas": False})
    ot = _sampler_run("torch", loop, diffusivity=model == "environment")
    ok = _sampler_run("torch", config, diffusivity=model == "environment")
    for var in ("lon", "lat", "z", "status"):
        np.testing.assert_array_equal(ot.result[var].values,
                                      ok.result[var].values)
    oj = _sampler_run("jax", loop, diffusivity=model == "environment")
    _assert_runs_close(ot, oj)


def test_tsprofiles_run_matches_jax():
    """vertical_mixing:TSprofiles asks for profiles every step and sends
    the mixing through the per-substep loop; OceanDrift's own terminal
    velocity ignores T and S, so the depths are the loop's."""
    config = {"vertical_mixing:TSprofiles": True,
              "vertical_mixing:diffusivitymodel": "environment",
              "vertical_mixing:profile_levels": 11}
    ot = _sampler_run("torch", config)
    oj = _sampler_run("jax", config)
    _assert_runs_close(ot, oj)


def _sticky(base):
    """A subclass that overrides a substep hook: elements that reach the
    seafloor stay there (``moving`` is carried through the loop)."""
    where = torch.where if base.__module__.startswith(
        "opendrift_tpu_torch") else __import__("jax").numpy.where

    class Sticky(base):
        def bottom_interaction(self, ctx, mix, zmin):
            mix["moving"] = where(mix["z"] <= zmin, 0.0, mix["moving"])
            return mix
    return Sticky


def test_overridden_hook_takes_the_generic_loop_and_matches_jax():
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu_torch.models import OceanDrift as TOceanDrift
    config = {"environment:fallback:sea_floor_depth_below_sea_level": 12.0}
    runs = {}
    for pkg, base in (("torch", TOceanDrift), ("jax", JOceanDrift)):
        ocean, wind, x, y, depths, times = _coast_forcing()
        del ocean["sea_floor_depth_below_sea_level"]
        o = _sticky(base)(loglevel=40, **(
            {"device": "cpu"} if pkg == "torch" else {}))
        reader = __import__(base.__module__.split(".")[0] + ".fields",
                            fromlist=["ArrayReader"]).ArrayReader
        o.add_reader(reader(ocean, x, y, times, depths=depths))
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:vertical_mixing", True)
        o.set_config("vertical_mixing:diffusivitymodel", "environment")
        o.set_config("vertical_mixing:profile_levels", 11)
        for key, value in config.items():
            o.set_config(key, value)
        r = np.random.default_rng(1)
        o.seed_elements(lon=r.uniform(3.6, 4.2, N),
                        lat=r.uniform(59.2, 60.3, N), z=-r.uniform(0, 12, N),
                        terminal_velocity=-0.002, time=times[0])
        o.run(duration=timedelta(hours=4), time_step=900,
              time_step_output=3600)
        runs[pkg] = o
    moving = runs["torch"].result["moving"].values[:, -1]
    assert 0 < (moving == 0).sum() < N        # some stuck, not all
    np.testing.assert_array_equal(
        moving, np.asarray(runs["jax"].result["moving"].values)[:, -1])
    for var in ("lon", "lat", "z"):
        _assert_close(runs["torch"].result[var].values,
                      runs["jax"].result[var].values, var)


def test_prefetch_thread_gives_the_same_run(monkeypatch):
    """Seven windows packed on the worker thread beside the steps, against
    the same run with every window packed by the main thread: equal to the
    bit, and the thread was used for every window but the first and the
    final snapshot's."""
    config = {"drift:advection_single_fetch": True,
              "vertical_mixing:diffusivitymodel": "environment",
              "vertical_mixing:profile_levels": 11}
    with_thread = _sampler_sim("torch", config)
    started = []
    real = with_thread.env.prefetch_device_states

    def counting(a, b):
        started.append((a, b))
        return real(a, b)
    monkeypatch.setattr(with_thread.env, "prefetch_device_states", counting)
    with_thread.run(duration=timedelta(hours=7), time_step=900,
                    time_step_output=3600)
    assert len(started) == 6
    assert with_thread.env._prefetch is None
    assert with_thread.env.pack_seconds > 0.0
    without = _sampler_sim("torch", config)
    monkeypatch.setattr(without.env, "prefetch_device_states",
                        lambda a, b: None)
    without.run(duration=timedelta(hours=7), time_step=900,
                time_step_output=3600)
    for var in ("lon", "lat", "z", "status"):
        np.testing.assert_array_equal(with_thread.result[var].values,
                                      without.result[var].values)


def test_prefetch_failure_surfaces_at_the_join():
    """What the worker thread raises outside a reader's own packing is
    raised again by the thread that takes the window."""
    o = _sampler_sim("torch")
    o.prepare_run(900.0, 4, total_steps=4)

    def broken(a, b):
        raise RuntimeError("packing failed")
    o.env._pack_host_states = broken
    o.env.prefetch_device_states(None, None)
    with pytest.raises(RuntimeError, match="packing failed"):
        o.env.build_device_states(None, None)
    assert o.env._prefetch is None


@pytest.mark.parametrize("single_fetch", [True, False])
def test_trajectories_bit_identical_across_tiers(single_fetch, monkeypatch):
    """OPENDRIFT_XY_PAIR=0 puts every reader on the 'x' tier, =1 on the
    wide one: more gathers, the same arithmetic, the same trajectories to
    the bit (the case of the JAX package's tests/test_pair_hint.py)."""
    results = {}
    for flag, tier in (("0", "x"), ("1", "xyz")):
        monkeypatch.setenv("OPENDRIFT_XY_PAIR", flag)
        o = _sampler_run("torch", {
            "drift:advection_single_fetch": single_fetch,
            "general:coastline_bisection": "block"})
        assert o.env.readers["ocean"]._sampler.pair_mode == tier
        results[flag] = o.result
    for var in ("lon", "lat", "z", "status"):
        np.testing.assert_array_equal(results["0"][var].values,
                                      results["1"][var].values)


def test_surface_truncated_single_fetch_gets_the_xy_tier():
    """drift:truncate_ocean_model_below_m=0 packs the surface level alone:
    Z collapses to 1, the tier is 'xy' (never 'xyz' without a z+1 plane),
    a corner block is one gather, and the run matches the JAX package."""
    config = {"drift:advection_single_fetch": True,
              "drift:truncate_ocean_model_below_m": 0.0,
              "drift:vertical_mixing": False}
    ot = _sampler_run("torch", config, diffusivity=False)
    oj = _sampler_run("jax", config, diffusivity=False)
    for o in (ot, oj):
        s = o.env.readers["ocean"]._sampler
        assert (s.pair_mode, s.Z) == ("xy", 1)
    _assert_runs_close(ot, oj)
