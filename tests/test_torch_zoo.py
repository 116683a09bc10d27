"""The model zoo of ``opendrift_tpu_torch`` on the CPU: the first ten
models (WindBlow, SeaIceDrift, Leeway, PlastDrift, SedimentDrift,
PelagicEggDrift, LarvalFish and LarvalFishExtended, OpenBerg, ShipDrift,
SeaLice), each against the JAX package on the same seeded inputs and
against its reference golden, with the physics and RNG functions they
brought; then the legacy models (OpenHNS, OpenBergOld) and ModelTemplate
against the JAX package, and the registry of the whole zoo.  The
chemistry models have their own file (tests/test_torch_chemistry.py).

Tolerances.  Runs against the JAX package (64 elements, 3D models on an
``ArrayReader`` ocean as tests/test_torch_oceandrift.py runs OceanDrift):
statuses equal; lon, lat and z held to that file's ``MEDIAN_ATOL``,
``OUTLIER_ATOL`` and ``OUTLIER_SHARE`` (transcendentals of the two
libraries differ by an ulp and XLA contracts multiply-adds; an ulp in z
can move an element across a nearest level of the Visser walk); model
variables to ``VAR_RTOL`` (with ``VAR_ATOL`` near zero) under the same
outlier share.  The goldens keep the bounds of the JAX package's tests:
tests/test_reference_trajectory_parity.py ``TOLERANCES`` for the
deterministic runs, the bounds of tests/test_reference_stat_parity.py for
the statistical ones.  The fetch-tabulated Stokes drift and Hs are equal
to the bit on the wind sweep along an axis (elsewhere XLA's CPU ``sqrt``
of the speed is not torch's: 2e-5 relative); ``rng.exponential`` takes
bit-equal uniforms and is within 2 ulp (XLA's ``log1p`` is its own
polynomial).
"""

import os
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_compare  # noqa: E402
from opendrift_tpu_torch import rng  # noqa: E402
from opendrift_tpu_torch.ops import physics as tph  # noqa: E402
from opendrift_tpu_torch.tools import zoo_setups  # noqa: E402
from test_torch_oceandrift import MEDIAN_ATOL, OUTLIER_ATOL, \
    OUTLIER_SHARE  # noqa: E402

T0 = datetime(2021, 4, 1, 6)
N = 64            # a multiple of the 8 virtual JAX devices
VAR_RTOL = 1e-4
VAR_ATOL = 1e-6


# ------------------------------------------------------------ the models --

def _forcing(seed=0, nx=24, ny=20, nz=6, nt=5):
    """A 3D ocean (currents, T, S, seafloor), a 2D wind and sea ice."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0, 2, 5, 10, 20, 40][:nz], f32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    shape3 = (nt, nz, ny, nx)
    ocean = {
        "x_sea_water_velocity": (0.2 * r.standard_normal(shape3)).astype(f32),
        "y_sea_water_velocity": (0.2 * r.standard_normal(shape3)).astype(f32),
        "sea_water_temperature": (8.0 + 4.0 * r.random(shape3)
                                  - 0.1 * depths[None, :, None, None]
                                  ).astype(f32),
        "sea_water_salinity": (33.0 + 2.0 * r.random(shape3)).astype(f32),
        "sea_floor_depth_below_sea_level": r.uniform(
            25, 80, (ny, nx)).astype(f32)}
    wind = {"x_wind": (8 + 3 * r.standard_normal((nt, ny, nx))).astype(f32),
            "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(f32)}
    ice = {"sea_ice_x_velocity": (0.2 + 0.05 * r.standard_normal(
               (nt, ny, nx))).astype(f32),
           "sea_ice_y_velocity": (0.05 * r.standard_normal(
               (nt, ny, nx))).astype(f32),
           "sea_ice_area_fraction": r.uniform(0.5, 1.0, (nt, ny, nx)).astype(
               f32)}
    return ocean, wind, ice, x, y, depths, times


# model -> (class name, readers, extra config, seed kwargs of N elements,
# model variables to compare)
def _case(name):
    r = np.random.default_rng(3)
    z = -r.uniform(0.0, 20.0, N)
    cases = {
        "WindBlow": ("WindBlow", ("wind",), {}, {}, ()),
        "SeaIceDrift": ("SeaIceDrift", ("ice",), {}, {}, ()),
        "Leeway": ("Leeway", ("ocean2d", "wind"), {
            "processes:capsizing": True, "capsizing:wind_threshold": 8.0,
            "capsizing:wind_threshold_sigma": 3.0},
            {"object_type": 26}, ("capsized", "orientation",
                                  "crosswind_slope")),
        "PlastDrift": ("PlastDrift", ("ocean", "wind"), {}, {"z": z},
                       ("terminal_velocity",)),
        # rising slowly enough that the walk keeps most below the surface
        "PlastDrift_randomwalk": ("PlastDrift", ("ocean", "wind"), {
            "vertical_mixing:mixingmodel": "randomwalk"}, {
            "z": z, "terminal_velocity": r.uniform(0.0, 2e-4, N)}, ()),
        "SedimentDrift": ("SedimentDrift", ("ocean", "wind"), {}, {"z": z},
                          ("settled", "moving")),
        "PelagicEggDrift": ("PelagicEggDrift", ("ocean", "wind"), {},
                            {"z": z}, ("terminal_velocity",)),
        "LarvalFish": ("LarvalFish", ("ocean", "wind"), {}, {
            "z": z, "stage_fraction": r.uniform(0.9, 1.0, N)},
            ("hatched", "stage_fraction", "weight", "length",
             "terminal_velocity")),
        "LarvalFishExtended": ("LarvalFishExtended", ("ocean", "wind"),
                               {"egg:hatch_time_days": 0.3}, {
            "z": z, "stage_fraction": r.uniform(0.5, 1.0, N)},
            ("hatched", "stage_fraction")),
        "OpenBerg": ("OpenBerg", ("ocean2d", "wind"), {
            "processes:melting": True}, {
            "sail": r.uniform(5, 30, N), "draft": r.uniform(10, 60, N),
            "length": r.uniform(50, 300, N), "width": r.uniform(40, 200, N)},
            ("length", "width", "sail", "draft", "iceb_x_velocity",
             "iceb_y_velocity")),
        "ShipDrift": ("ShipDrift", ("ocean2d", "wind"), {
            "environment:fallback:sea_surface_wave_significant_height": 2.5},
            {"length": r.uniform(40, 200, N), "beam": r.uniform(8, 30, N),
             "height": r.uniform(10, 40, N), "draft": r.uniform(2, 12, N)},
            ("orientation",)),
        "SeaLice": ("SeaLice", ("ocean",), {
            "environment:fallback:surface_net_downward_radiative_flux":
                150.0}, {"z": z}, ("nauplii", "copepodid", "degree_days",
                                   "light", "temperature_above",
                                   "safe_salinity_above")),
    }
    return cases[name]


def _zoo_run(pkg, name):
    cls_name, readers, config, seed_kw, _ = _case(name)
    if pkg == "jax":
        import opendrift_tpu.models as M
        from opendrift_tpu.fields import ArrayReader
        o = getattr(M, cls_name)(loglevel=40)
    else:
        import opendrift_tpu_torch.models as M
        from opendrift_tpu_torch.fields import ArrayReader
        o = getattr(M, cls_name)(loglevel=40, device="cpu")
    ocean, wind, ice, x, y, depths, times = _forcing()
    for kind in readers:
        if kind == "ocean":
            o.add_reader(ArrayReader(ocean, x, y, times, depths=depths))
        elif kind == "ocean2d":
            o.add_reader(ArrayReader(
                {k: (v[:, 0] if v.ndim == 4 else v)
                 for k, v in ocean.items()}, x, y, times))
        elif kind == "wind":
            o.add_reader(ArrayReader(wind, x, y, times))
        else:
            o.add_reader(ArrayReader(ice, x, y, times))
    if "land_binary_mask" in o.required_variables:
        o.set_config("environment:fallback:land_binary_mask", 0)
    for key, value in config.items():
        o.set_config(key, value)
    r = np.random.default_rng(1)
    o.seed_elements(lon=r.uniform(3.5, 4.5, N), lat=r.uniform(59.4, 60.1, N),
                    time=times[0], **seed_kw)
    o.run(duration=timedelta(hours=3), time_step=900, time_step_output=3600)
    return o


def _assert_close(got, want, var, median_atol, outlier_atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, var
    assert np.array_equal(np.isnan(got), np.isnan(want)), var
    d = np.abs(got - want)[~np.isnan(want)]
    assert np.median(d) <= median_atol, (var, np.median(d))
    assert np.mean(d > outlier_atol) <= OUTLIER_SHARE, (var, d.max())


ZOO = ["WindBlow", "SeaIceDrift", "Leeway", "PlastDrift",
       "PlastDrift_randomwalk", "SedimentDrift", "PelagicEggDrift",
       "LarvalFish", "LarvalFishExtended", "OpenBerg", "ShipDrift",
       "SeaLice"]


@pytest.mark.parametrize("name", ZOO)
def test_model_run_matches_jax(name):
    """Each model of the slice from one seed in both packages: the same
    statuses, positions and model variables."""
    oj = _zoo_run("jax", name)
    ot = _zoo_run("torch", name)
    assert ot.result["lon"].shape == oj.result["lon"].shape == (N, 4)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])
    for var in _case(name)[4]:
        want = np.asarray(oj.result[var].values, np.float64)
        scale = np.abs(want[~np.isnan(want)])
        atol = VAR_ATOL + VAR_RTOL * (np.median(scale) if scale.size else 0)
        _assert_close(ot.result[var].values, want, var, atol, 10 * atol)
    lon = ot.result["lon"].values
    assert not np.array_equal(lon[:, 0], lon[:, -1])


def test_plastdrift_randomwalk_takes_the_windspeed_kernel():
    """PlastDrift with 'randomwalk' passes every substep hook through, so
    its walk is the windspeed mixing kernel K1 (its plain version on the
    CPU) with Sundby1983 and the rising terminal velocity, once a step;
    against the JAX package's emulation z agrees to 2e-5 m but for rare
    nearest-level flips (ROADMAP C.4)."""
    from opendrift_tpu_torch.ops import mixing
    before = mixing.visser_mixing.launches
    ot = _zoo_run("torch", "PlastDrift_randomwalk")
    assert mixing.visser_mixing.launches == before    # no card, no launch
    assert ot._mixing_kernels_applicable("windspeed_Sundby1983")
    oj = _zoo_run("jax", "PlastDrift_randomwalk")
    z_t = np.asarray(ot.result["z"].values, np.float64)
    z_j = np.asarray(oj.result["z"].values, np.float64)
    d = np.abs(z_t - z_j)
    assert np.median(d) <= 2e-5 and np.mean(d > 2e-5) <= OUTLIER_SHARE
    assert (z_t <= 0).all()


def test_leeway_seeding_draws_equal_jax():
    """Leeway draws its coefficient perturbations on the host: the same
    ``_np_random`` calls in the same order as the JAX package, so every
    seeded value is equal."""
    from opendrift_tpu.models import Leeway as JLeeway
    from opendrift_tpu_torch.models import Leeway
    seeds = []
    for o in (JLeeway(loglevel=40), Leeway(loglevel=40, device="cpu")):
        # object 3 has a negative downwind offset: the rejection loop runs
        o.seed_elements(lon=4.0, lat=60.0, number=500, radius=1000,
                        time=T0, object_type=3)
        o.seed_elements(lon=4.1, lat=60.1, number=300, time=T0)
        seeds.append(o._seedings)
    for sj, st in zip(*seeds):
        assert set(sj) == set(st)
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


def test_leeway_ascii_export_and_the_plot_still_to_come(tmp_path):
    from opendrift_tpu.models.leeway import Leeway as JLeeway
    o = _zoo_run("torch", "Leeway")
    mine, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    o.export_ascii(str(mine))
    JLeeway.export_ascii(o, str(theirs))
    assert mine.read_text() == theirs.read_text()
    assert mine.read_text().count("Time step") == 4
    # the plot is ported: the probability curve of the JAX package's
    import matplotlib
    matplotlib.use("Agg")
    line = o.plot_capsize_probability().axes[0].get_lines()[0]
    jl = JLeeway(loglevel=40)
    for key in ("capsizing:wind_threshold", "capsizing:wind_threshold_sigma"):
        jl.set_config(key, o.get_config(key))
    want = jl.plot_capsize_probability().axes[0].get_lines()[0]
    np.testing.assert_array_equal(line.get_xdata(), want.get_xdata())
    np.testing.assert_allclose(line.get_ydata(), want.get_ydata(),
                               rtol=0, atol=1e-6)


# -------------------------------------------------------------- goldens --

GOLDENS = ["windblow_euler", "seaice_euler", "openberg_det", "leeway_stat",
           "plast_stat", "sediment_stat", "pelagicegg_stat",
           "larvalfish_stat", "shipdrift_stat", "sealice_stat"]


def _golden_run(name):
    golden, cfg = parity_compare.load_golden(name)
    o, run_kw = zoo_setups.setup(name, cfg, "cpu")
    o.run(**run_kw)
    return golden, cfg, o


def _final(ds, var):
    return np.asarray(ds[var].values if hasattr(ds[var], "values")
                      else ds[var], np.float64)[:, -1]


def _cloud(lon, lat, lat0, lon0):
    from opendrift_tpu_torch.utils.geodesic import inverse_np
    az, _, dist = inverse_np(np.full(lon.shape[0], lat0),
                             np.full(lon.shape[0], lon0), lat, lon)
    return dist * np.sin(np.deg2rad(az)), dist * np.cos(np.deg2rad(az))


@pytest.mark.parametrize("name", GOLDENS)
def test_matches_reference_golden(name):
    """The reference OpenDrift's runs of the zoo under constant fallbacks
    (tools/parity_compare.py's configurations, written out on the port's
    classes in opendrift_tpu_torch/tools/zoo_setups.py), at the bounds of
    the JAX package's tests."""
    from test_reference_trajectory_parity import TOLERANCES
    golden, cfg, o = _golden_run(name)
    res = o.result
    if name in TOLERANCES:                       # deterministic runs
        stats = parity_compare.compare(name, o, golden)
        max_tol, final_tol = TOLERANCES[name]
        assert stats["shape_ref"] == stats["shape_our"]
        assert stats["finite_mismatch"] == 0, stats
        assert stats["max_m"] < max_tol, stats
        assert stats["final_mean_m"] < final_tol, stats
        return
    z_r, z_o = _final(golden, "z"), _final(res, "z")
    if name in ("leeway_stat", "shipdrift_stat"):
        lat0, lon0 = (59.5, 2.0) if name == "leeway_stat" else (60.0, 4.0)
        dx_r, dy_r = _cloud(_final(golden, "lon"), _final(golden, "lat"),
                            lat0, lon0)
        dx_o, dy_o = _cloud(_final(res, "lon"), _final(res, "lat"),
                            lat0, lon0)
        leeway = name == "leeway_stat"
        assert abs(dx_o.mean() - dx_r.mean()) / dx_r.mean() < 0.03
        assert abs(dy_o.mean() - dy_r.mean()) < (800.0 if leeway else 1000.0)
        spread = 0.10 if leeway else 0.15
        assert abs(dx_o.std() - dx_r.std()) / dx_r.std() < spread
        assert abs(dy_o.std() - dy_r.std()) / dy_r.std() < spread
        share = abs((dy_o < 0).mean() - (dy_r < 0).mean())
        assert share < (0.05 if leeway else 0.08)
    elif name == "plast_stat":
        assert abs(np.nanmean(z_o) - np.nanmean(z_r)) < 0.4
        assert abs(np.nanstd(z_o) - np.nanstd(z_r)) < 0.4
        for q in (10, 50, 90):
            assert abs(np.nanpercentile(z_o, q)
                       - np.nanpercentile(z_r, q)) < 0.6, q
        assert abs(np.nanmean(_final(res, "lon"))
                   - np.nanmean(_final(golden, "lon"))) < 0.01
    elif name == "sediment_stat":
        assert abs(np.nanmean(z_o) - np.nanmean(z_r)) < 1.5
        assert abs(np.nanstd(z_o) - np.nanstd(z_r)) < 1.5
        m_r, m_o = _final(golden, "moving"), _final(res, "moving")
        assert abs((m_o == 0).mean() - (m_r == 0).mean()) < 0.06
        assert abs(np.nanmedian(z_o) - np.nanmedian(z_r)) < 0.5
    elif name == "pelagicegg_stat":
        assert abs(z_o.mean() - z_r.mean()) < 2.5, (z_o.mean(), z_r.mean())
        assert abs(z_o.std() - z_r.std()) < 2.0, (z_o.std(), z_r.std())
        for q in (5, 25, 50, 75, 95):
            assert abs(np.percentile(z_o, q)
                       - np.percentile(z_r, q)) < 3.5, q
    elif name == "larvalfish_stat":
        h_r, h_o = _final(golden, "hatched"), _final(res, "hatched")
        np.testing.assert_array_equal(h_o, h_r)
        for var, tol in (("stage_fraction", 1e-4), ("weight", 1e-3),
                         ("length", 1e-3)):
            a, b = _final(res, var), _final(golden, var)
            sel = np.isfinite(b)
            assert np.abs(a[sel] - b[sel]).max() < tol, var
        for pop in (0, 1):          # eggs, larvae
            sr, so = h_r == pop, h_o == pop
            assert abs(np.nanmean(z_o[so]) - np.nanmean(z_r[sr])) < 1.2
            assert abs(np.nanstd(z_o[so]) - np.nanstd(z_r[sr])) < 1.2
    elif name == "sealice_stat":
        np.testing.assert_allclose(_final(res, "degree_days"),
                                   _final(golden, "degree_days"), atol=0.05)
        assert abs(np.nanmean(z_o) - np.nanmean(z_r)) < 0.5
        assert abs(np.nanstd(z_o) - np.nanstd(z_r)) < 0.5
    else:
        raise AssertionError(f"no bounds for {name}")


def test_zoo_configs_carry_the_goldens_scalars():
    """``zoo_setups.CONFIGS`` (which chip_smoke.py runs without the
    goldens at hand) holds each golden's configuration but its
    per-element lists and its size."""
    for name in GOLDENS:
        _, cfg = parity_compare.load_golden(name)
        want = {k: v for k, v in cfg.items()
                if not isinstance(v, list) and k != "n"}
        assert zoo_setups.CONFIGS[name] == want, name


# ----------------------------------------------------- physics and RNG ---

def test_exponential_matches_jax():
    import jax
    import jax.numpy as jnp
    for seed in (0, 7, 2 ** 31 + 5):
        jk = jax.random.PRNGKey(seed)
        tk = rng.fold_in(rng.PRNGKey(seed), 3)
        jk = jax.random.fold_in(jk, 3)
        shape = (3, 40_001)
        np.testing.assert_array_equal(
            rng.uniform(tk, shape).numpy(),
            np.asarray(jax.random.uniform(jk, shape)))
        want = np.asarray(jax.random.exponential(jk, shape, jnp.float32))
        got = rng.exponential(tk, shape).numpy()
        assert got.dtype == np.float32 and (got >= 0).all()
        assert np.all(np.abs(got - want) <= 2 * np.spacing(want))


@pytest.mark.parametrize("fetch", ["5000", "25000", "50000"])
def test_tabulated_stokes_and_hs_equal_jax_on_the_wind_sweep(fetch):
    """Wind speeds 0-30 m/s in steps of 0.01, blowing east and west: the
    polynomials (degree 6 for the larger fetches) in float32 Horner steps,
    as ``jnp.polyval`` evaluates them, are equal to the bit.  With both
    wind components non-zero XLA's CPU ``sqrt`` of the speed (not the
    correctly rounded one) differs from torch's by an ulp for 0.5% of the
    speeds, which the polynomial's cancellation turns into 1e-5 of the
    factor."""
    import jax.numpy as jnp
    from opendrift_tpu.ops import physics as jph
    speed = np.arange(3001, dtype=np.float64) * 0.01

    def both(wx, wy):
        wx, wy = wx.astype(np.float32), wy.astype(np.float32)
        ju, jv = jph.wave_stokes_drift_parameterised(
            jnp.asarray(wx), jnp.asarray(wy), fetch)
        jh = jph.wave_significant_height_parameterised(
            jnp.asarray(wx), jnp.asarray(wy), fetch)
        tw = torch.from_numpy(wx), torch.from_numpy(wy)
        tu, tv = tph.wave_stokes_drift_parameterised(*tw, fetch)
        th = tph.wave_significant_height_parameterised(*tw, fetch)
        return [(tu.numpy(), np.asarray(ju)), (tv.numpy(), np.asarray(jv)),
                (th.numpy(), np.asarray(jh))]

    for sign in (1.0, -1.0):
        for got, want in both(sign * speed, 0.0 * speed):
            np.testing.assert_array_equal(got, want)
    for ang in (0.7, 2.1, 4.0):
        for got, want in both(speed * np.cos(ang), speed * np.sin(ang)):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-9)


def test_tabulated_stokes_drift_runs_and_fills_hs():
    """``drift:use_tabularised_stokes_drift`` on an OceanDrift run with no
    wave reader: the run no longer raises, and it equals the JAX
    package's."""
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu_torch.models import OceanDrift
    results = []
    for o in (JOceanDrift(loglevel=40), OceanDrift(loglevel=40,
                                                   device="cpu")):
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("environment:fallback:x_wind", 12.0)
        o.set_config("environment:fallback:y_wind", -4.0)
        o.set_config("drift:use_tabularised_stokes_drift", True)
        o.set_config("drift:tabularised_stokes_drift_fetch", "50000")
        o.seed_elements(lon=4.0, lat=60.0, number=N, radius=2000,
                        z=-np.linspace(0, 3, N), time=T0)
        o.run(duration=timedelta(hours=2), time_step=900)
        results.append(o.result)
    for var in ("lon", "lat"):
        _assert_close(results[1][var].values, results[0][var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])


def test_solar_and_wind_stress_functions_match_jax():
    import jax.numpy as jnp
    from opendrift_tpu.ops import physics as jph
    r = np.random.default_rng(4)
    n = 4096
    doy = r.integers(1, 366, n).astype(np.float32)
    minutes = r.uniform(0, 1440, n).astype(np.float32)
    lon = r.uniform(-180, 180, n).astype(np.float32)
    lat = r.uniform(-89, 89, n).astype(np.float32)
    T = torch.from_numpy
    pairs = [
        (tph.solar_declination(T(doy)), jph.solar_declination(doy), 1e-4),
        (tph.equation_of_time(T(doy), T(minutes / 60)),
         jph.equation_of_time(doy, jnp.asarray(minutes / 60)), 1e-4),
        (tph.hour_angle(T(doy), T(minutes), T(lon)),
         jph.hour_angle(doy, jnp.asarray(minutes), jnp.asarray(lon)), 1e-3),
        (tph.solar_elevation(T(doy), T(minutes), T(lon), T(lat)),
         jph.solar_elevation(doy, jnp.asarray(minutes), jnp.asarray(lon),
                             jnp.asarray(lat)), 1e-3)]
    wind = r.uniform(0, 35, n).astype(np.float32)
    tau = r.uniform(0, 3, n).astype(np.float32)
    temp = r.uniform(-2, 30, n).astype(np.float32)
    sal = r.uniform(0, 40, n).astype(np.float32)
    pairs += [
        (tph.wind_drag_coefficient(T(wind)),
         jph.wind_drag_coefficient(jnp.asarray(wind)), 1e-9),
        (tph.windspeed_from_stress(T(tau)),
         jph.windspeed_from_stress(jnp.asarray(tau)), 1e-4),
        (tph.seawater_dynamic_viscosity_ladim(T(temp), T(sal)),
         jph.seawater_dynamic_viscosity_ladim(jnp.asarray(temp),
                                              jnp.asarray(sal)), 1e-9)]
    for got, want, atol in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=atol)
    times = [datetime(2021, 6, 21, 12), datetime(2021, 12, 21, 3, 30, 15)]
    np.testing.assert_allclose(
        tph.solar_elevation_time(times, 5.0, 60.0).numpy(),
        np.asarray(jph.solar_elevation_time(times, 5.0, 60.0)), atol=1e-3)
    stress = tph.windspeed_from_stress(tph.wind_drag_coefficient(
        T(wind)) * 1.225 * T(wind) ** 2)
    np.testing.assert_allclose(stress.numpy(), wind, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("model", ["windspeed_Large1994",
                                   "windspeed_Sundby1983"])
def test_diffusivity_profile_matches_jax(model):
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu_torch.models import OceanDrift
    depths = np.linspace(0, 80, 41)
    wind = np.array([0.0, 3.0, 11.5, 25.0])
    want = JOceanDrift.get_diffusivity_profile(model, depths, wind, 30.0,
                                               1e-5)
    got = OceanDrift.get_diffusivity_profile(model, depths, wind, 30.0, 1e-5)
    assert got.shape == (41, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        OceanDrift.get_diffusivity_profile("constant", depths, wind)


def test_ml_correction_matches_jax():
    """A residual-drift MLP of two layers with weights from numpy, on a
    predictor the model does not require (it becomes a required variable
    with fallback 0 and its environment configs) and on the wind."""
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu_torch.models import OceanDrift
    r = np.random.default_rng(5)
    weights = [(r.normal(0, 0.5, (3, 8)), r.normal(0, 0.1, 8)),
               (r.normal(0, 0.5, (8, 2)), r.normal(0, 0.1, 2))]
    predictors = ["x_wind", "y_wind", "sea_surface_wave_period_at_variance_"
                  "spectral_density_maximum"]
    norm_in = (np.array([5.0, 0.0, 6.0]), np.array([3.0, 3.0, 2.0]))
    norm_out = (np.array([10.0, -5.0]), np.array([300.0, 200.0]))
    results = []
    for o in (JOceanDrift(loglevel=40), OceanDrift(loglevel=40,
                                                   device="cpu")):
        o.set_ml_correction(weights, predictors, norm_in, norm_out)
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("environment:fallback:x_wind", 7.0)
        o.set_config("environment:fallback:y_wind", 2.0)
        o.set_config("environment:fallback:" + predictors[2], 8.0)
        o.seed_elements(lon=4.0, lat=60.0, number=N, radius=3000, time=T0)
        o.run(duration=timedelta(hours=3), time_step=900)
        results.append(o)
    assert predictors[2] not in OceanDrift.required_variables
    assert predictors[2] in results[1].required_variables
    for var in ("lon", "lat"):
        _assert_close(results[1].result[var].values,
                      results[0].result[var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])
    # the correction moved the elements beyond what the wind alone does
    plain = OceanDrift(loglevel=40, device="cpu")
    plain.set_config("environment:fallback:land_binary_mask", 0)
    plain.set_config("environment:fallback:x_wind", 7.0)
    plain.set_config("environment:fallback:y_wind", 2.0)
    plain.seed_elements(lon=4.0, lat=60.0, number=N, radius=3000, time=T0)
    plain.run(duration=timedelta(hours=3), time_step=900)
    moved = np.abs(results[1].result["lon"].values[:, -1]
                   - plain.result["lon"].values[:, -1])
    assert moved.min() > 1e-4


def test_get_model_names_the_zoo():
    """Every model of the JAX package's registry resolves to the port's
    class and ``eulerdrift`` imports; the plots that raised naming A.13
    draw now, and the domain decomposition (A.14) runs: a tiled run
    resolves to its tiles and keeps every element."""
    import opendrift_tpu
    import opendrift_tpu_torch
    from opendrift_tpu_torch.models import eulerdrift
    names = opendrift_tpu_torch.get_model_names()
    assert set(names) == set(opendrift_tpu.get_model_names())
    for name in names:
        cls = opendrift_tpu_torch.get_model(name)
        assert cls.__name__ == name
        assert cls.__module__.startswith("opendrift_tpu_torch.models")
    for name in ("RadionuclideDrift", "ChemicalDrift", "OpenHNS",
                 "OpenBergOld", "ModelTemplate"):
        assert name in names
    assert eulerdrift.ExplSimulation.__module__ == \
        "opendrift_tpu_torch.models.eulerdrift"
    o = opendrift_tpu_torch.get_model("ChemicalDrift")(loglevel=40,
                                                       device="cpu")
    grid = eulerdrift.EulerGrid.new(shape=(8, 8), device="cpu")
    import matplotlib
    matplotlib.use("Agg")
    assert grid.plot().get_images()[0].get_array().shape == (8, 8)
    import matplotlib.pyplot as plt
    plt.close("all")
    from opendrift_tpu_torch.fields import ArrayReader
    reader = ArrayReader({"x_sea_water_velocity":
                          np.zeros((2, 3, 4), np.float32)},
                         np.arange(4.0), np.arange(3.0) + 60.0,
                         [T0, T0 + timedelta(hours=1)])
    o = opendrift_tpu_torch.get_model("OceanDrift")(loglevel=40,
                                                    device="cpu")
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("parallel:domain_decomposition", True)
    o.set_mesh(["cpu"] * 2)
    o.add_reader(ArrayReader({"x_sea_water_velocity":
                              np.full((2, 40, 8), 0.2, np.float32),
                              "y_sea_water_velocity":
                              np.full((2, 40, 8), 0.1, np.float32)},
                             np.linspace(0.0, 4.0, 8),
                             np.linspace(60.0, 62.0, 40),
                             [T0, T0 + timedelta(hours=1)]))
    o.seed_elements(lon=1.5, lat=61.0, number=16, radius=1000, time=T0)
    o.run(steps=2, time_step=600)
    assert o._dd is not None and o._dd.n_tiles == 2
    assert np.isfinite(o.result["lon"].values).all()
    with pytest.raises(ValueError):
        opendrift_tpu_torch.get_model("NoSuchModel")


# ------------------------------------------- legacy models and the template --

def _legacy_run(pkg, name, hns_type="butyl"):
    if pkg == "jax":
        import opendrift_tpu.models as M
        from opendrift_tpu.fields.analytic import ConstantReader
        kw = {}
    else:
        import opendrift_tpu_torch.models as M
        from opendrift_tpu_torch.fields.analytic import ConstantReader
        kw = {"device": "cpu"}
    o = getattr(M, name)(loglevel=50, **kw)
    o.add_reader(ConstantReader({
        "x_sea_water_velocity": 0.2, "y_sea_water_velocity": 0.05,
        "x_wind": 8.0, "y_wind": -2.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    seed = {}
    if name == "OpenHNS":
        seed["hns_type"] = hns_type
    else:
        o.set_config("template:my_setting", 2.0)
        seed["my_property"] = np.linspace(0.0, 1.0, 200)
    o.seed_elements(lon=4.0, lat=60.0, radius=2000.0, time=T0, number=200,
                    **seed)
    o.run(duration=timedelta(hours=6), time_step=600, time_step_output=3600)
    return o


@pytest.mark.parametrize("hns_type", ["butyl", "acetone", "xylene"])
def test_openhns_matches_jax(hns_type):
    """OpenHNS's two Bernoulli uniforms a step are bit-equal to the JAX
    package's: every phase change, mass and position agrees, and mass is
    kept (tests/test_legacy_template.py)."""
    oj = _legacy_run("jax", "OpenHNS", hns_type)
    ot = _legacy_run("torch", "OpenHNS", hns_type)
    for var in ("mass", "mass_evaporated", "mass_dissolved",
                "wind_drift_factor", "z", "status"):
        np.testing.assert_array_equal(ot.result[var].values,
                                      np.asarray(oj.result[var].values),
                                      err_msg=var)
    for var in ("lon", "lat"):
        _assert_close(ot.result[var].values, oj.result[var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])
    me, md, mm = (np.asarray(ot.result[v].values)[:, -1]
                  for v in ("mass_evaporated", "mass_dissolved", "mass"))
    assert np.allclose(me + md + mm, 1.0) and (me > 0).any()
    z = np.asarray(ot.result["z"].values)[:, -1]
    assert np.all(z[me > 0] == 10.0) and np.all(z[md > 0] <= -10.0)


def test_model_template_matches_jax():
    oj = _legacy_run("jax", "ModelTemplate")
    ot = _legacy_run("torch", "ModelTemplate")
    np.testing.assert_allclose(ot.result["my_property"].values,
                               np.asarray(oj.result["my_property"].values),
                               rtol=1e-6)
    np.testing.assert_allclose(
        ot.result["my_property"].values[:, -1],
        np.linspace(0.0, 1.0, 200) + 12.0, rtol=1e-6)   # rate 2 a h, 6 h
    for var in ("lon", "lat"):
        _assert_close(ot.result[var].values, oj.result[var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])
    assert not ot.get_config("drift:vertical_mixing")


def test_openberg_old_is_a_deprecated_openberg():
    from opendrift_tpu_torch.models import OpenBerg, OpenBergOld
    with pytest.warns(DeprecationWarning):
        o = OpenBergOld(loglevel=50, device="cpu")
    assert isinstance(o, OpenBerg) and o.device.type == "cpu"


def test_gls_tke_matches_jax():
    from opendrift_tpu.models.legacy import gls_tke as jgls
    from opendrift_tpu_torch.models.legacy import gls_tke
    r = np.random.default_rng(5)
    args = (r.uniform(0.01, 0.5, 300).astype(np.float32), np.arange(12.0),
            r.uniform(1020, 1028, 300).astype(np.float32),
            r.uniform(1e-6, 1e-3, 300).astype(np.float32),
            r.uniform(1e-8, 1e-5, 300).astype(np.float32))
    params = {"gls_p": 3.0, "gls_m": 1.5, "gls_n": -1.0, "gls_cmu0": 0.5477}
    for p in (None, params):
        got = gls_tke(*[torch.as_tensor(a) for a in args],
                      gls_parameters=p)
        want = np.asarray(jgls(*args, gls_parameters=p))
        assert got.shape == want.shape == (12, 300)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
