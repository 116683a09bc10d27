"""The reference OpenDrift's goldens against the port.

The counterpart of the JAX package's ``tools/parity_compare.py``: each
scenario of ``tests/goldens/ref_traj_<name>.npz`` (the reference's own
``run()``; ``config`` in each file) is run on the port's classes on any
device and held to the bounds of the JAX package's golden tests
(``tests/test_reference_trajectory_parity.py`` for trajectories,
``tests/test_reference_stat_parity.py`` for the stochastic and budget
scenarios), of which this module keeps its own copies::

    python -m opendrift_tpu_torch.tools.parity_compare [--device cuda] \\
        [--data DIR] [scenario ...]

prints one JSON line a scenario (its statistics, each beside its bound,
and whether it is within them) and exits 1 if any scenario is not.  Six
scenarios read a forcing file of the reference's test data (the four
Arctic20 NetCDF runs and the two Nordic ROMS runs): ``--data`` names the
directory that stands for the reference's ``tests/test_data`` (by default
the path the golden records); where the file is absent the scenario is
listed as ``"no data"``, not run, and not counted as passed.  The default
device is ``cuda``, which raises without a card.
"""

import argparse
import functools
import json
import os
import sys
import time
from datetime import datetime, timedelta

import numpy as np

from . import zoo_setups

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDENS = os.path.join(REPO, "tests", "goldens")
# the reference's test-data directory, as a golden's "file" records it
TEST_DATA_MARK = "tests/test_data/"

# scenarios that face an existing golden under another configuration of
# the engine (the golden itself is the same)
GOLDEN_ALIASES = {"nordic_sigma_3d_euler_regrid": "nordic_sigma_3d_euler"}

# ---- copies of tests/test_reference_trajectory_parity.py's bounds -------
# scenario -> (max separation any step [m], mean separation final step [m])
TOLERANCES = {
    "double_gyre_euler": (1e-3, 1e-3),
    "double_gyre_rk4": (1e-3, 1e-3),
    "double_gyre_rk2": (1e-3, 1e-3),
    "constant_wind_euler": (50.0, 25.0),
    "arctic20_euler": (60.0, 20.0),
    "arctic20_rk4": (60.0, 20.0),
    "arctic20_backward": (60.0, 20.0),
    "arctic20_3d_euler": (60.0, 20.0),
    "arctic20_stranding": (150.0, 60.0),
    "nordic_sigma_3d_euler": (4000.0, 1200.0),
    "nordic_sigma_3d_euler_regrid": (6000.0, 2000.0),
    "windblow_euler": (30.0, 15.0),
    "seaice_euler": (60.0, 40.0),
    "openberg_det": (120.0, 60.0),
}
# max |z_ref - z_ours| at any output step [m]
DZ_TOLERANCES = {"arctic20_3d_euler": 0.05,
                 "nordic_sigma_3d_euler": 0.05,
                 "nordic_sigma_3d_euler_regrid": 0.05}
# final-step median separation [m]
MEDIAN_TOLERANCES = {"nordic_sigma_3d_euler": 500.0,
                     "nordic_sigma_3d_euler_regrid": 1500.0}

# ---- copies of tests/test_reference_stat_parity.py's bounds -------------
# scenario -> {statistic: bound}; a pair is an open interval
STAT_BOUNDS = {
    "mixing_sundby_stat": {"z_mean": 1.5, "z_std": 1.0, "z_quantile": 2.5,
                           "below_mld_share": 0.06},
    "openoil_budget_surface": {
        "mass_oil": 0.01, "mass_evaporated": 0.01,
        "mass_biodegraded": 0.005, "water_fraction": 0.02,
        "oil_film_thickness": 1e-4, "viscosity_rel": 0.05,
        "centroid_m": 200.0, "spread_mean_m": 200.0,
        "spread_std_rel": 0.3},
    "leeway_stat": {"downwind_mean_rel": 0.03, "crosswind_mean_m": 800.0,
                    "downwind_std_rel": 0.10, "crosswind_std_rel": 0.10,
                    "left_share": 0.05},
    "openoil_full_stat": {
        "mass_oil": 0.06, "mass_evaporated": 0.04, "mass_dispersed": 0.05,
        "dispersed_share_min": 0.45, "water_fraction": 0.03,
        "diameter_median_ratio": (0.5, 2.0), "surface_share": (0.1, 0.7),
        "z_mean": (-40.0, -5.0), "z_p5_min": -80.0},
    "pelagicegg_stat": {"z_mean": 2.5, "z_std": 2.0, "z_quantile": 3.5},
    "chemical_stat": {"occupation_share": 0.05, "mass_rel": 0.005,
                      "loss_rel": 0.5, "z_mean": 3.0, "z_std": 3.0},
    "shipdrift_stat": {"downwind_mean_rel": 0.03,
                       "crosswind_mean_m": 1000.0, "downwind_std_rel": 0.15,
                       "crosswind_std_rel": 0.15, "left_share": 0.08},
    "eulerdrift_field": {"field_max_abs": 1e-5, "mass_abs": 1e-4},
    "sediment_stat": {"z_mean": 1.5, "z_std": 1.5, "settled_share": 0.06,
                      "z_median": 0.5},
    "plast_stat": {"z_mean": 0.4, "z_std": 0.4, "z_quantile": 0.6,
                   "lon_mean": 0.01},
    "larvalfish_stat": {"stage_fraction": 1e-4, "weight": 1e-3,
                        "length": 1e-3, "z_mean": 1.2, "z_std": 1.2},
    "sealice_stat": {"degree_days": 0.05, "z_mean": 0.5, "z_std": 0.5},
    "radionuclide_stat": {"occupation_share": 0.05, "z_mean": 1.0,
                          "z_std": 1.0},
}


def load_golden(name):
    """(the golden's arrays, its configuration) of scenario ``name``."""
    name = GOLDEN_ALIASES.get(name, name)
    d = np.load(os.path.join(GOLDENS, f"ref_traj_{name}.npz"),
                allow_pickle=False)
    return d, json.loads(str(d["config"]))


def forcing_file(cfg, data=None):
    """The forcing file a golden's configuration names, under ``data``
    (the directory standing for the reference's test data) if given."""
    path = cfg["file"]
    if data is None or TEST_DATA_MARK not in path:
        return path
    return os.path.join(data, path.split(TEST_DATA_MARK, 1)[1])


# ---------------------------------------------------------------- runners --

def _oceandrift(device, scheme=None, land=True):
    from ..models import OceanDrift
    o = OceanDrift(loglevel=40, device=device)
    if land:
        o.set_config("environment:fallback:land_binary_mask", 0)
    if scheme is not None:
        o.set_config("drift:advection_scheme", scheme)
    return o


def _run(o, cfg, output=None):
    kw = {}
    if output is not None:
        kw["time_step_output"] = output
    o.run(duration=timedelta(seconds=cfg["duration_s"]),
          time_step=cfg["time_step"], **kw)
    return o


def run_double_gyre(cfg, device):
    from ..fields import DoubleGyre
    o = _oceandrift(device, cfg["scheme"])
    r = DoubleGyre(epsilon=cfg["epsilon"], omega=cfg["omega"], A=cfg["A"])
    o.add_reader(r)
    lon, lat = r.xy2lonlat(np.asarray(cfg["seed_x"]),
                           np.asarray(cfg["seed_y"]))
    o.seed_elements(lon=lon, lat=lat, time=r.initial_time)
    return _run(o, cfg)


def run_constant_wind(cfg, device):
    o = _oceandrift(device, cfg["scheme"])
    for var, key in (("x_sea_water_velocity", "u"),
                     ("y_sea_water_velocity", "v"), ("x_wind", "wind_u"),
                     ("y_wind", "wind_v")):
        o.set_config(f"environment:fallback:{var}", cfg[key])
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]),
                    time=datetime(2015, 9, 22, 6),
                    wind_drift_factor=np.asarray(cfg["wind_drift_factor"]))
    return _run(o, cfg)


def _file_oceandrift(cfg, device, vertical_advection):
    o = _oceandrift(device, cfg["scheme"])
    o.set_config("general:use_auto_landmask", False)
    o.set_config("drift:vertical_mixing", False)
    o.set_config("drift:vertical_advection", vertical_advection)
    if vertical_advection:
        o.set_config("environment:fallback:upward_sea_water_velocity",
                     cfg["w_fallback"])
    return o


def run_arctic20(cfg, device):
    from ..fields import NetCDFReader
    o = _file_oceandrift(cfg, device, False)
    r = NetCDFReader(cfg["file"])
    o.add_reader(r)
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]), time=r.times[0])
    return _run(o, cfg, cfg["time_step"])


def run_arctic20_backward(cfg, device):
    """The reference flips element IDs on backward runs (reference
    basemodel/__init__.py:2056-2063), so golden row 0 is the last seed
    point: seeded in reverse to align the rows."""
    from ..fields import NetCDFReader
    o = _file_oceandrift(cfg, device, False)
    r = NetCDFReader(cfg["file"])
    o.add_reader(r)
    o.seed_elements(lon=np.asarray(cfg["seed_lon"])[::-1],
                    lat=np.asarray(cfg["seed_lat"])[::-1], time=r.times[-1])
    return _run(o, cfg, abs(cfg["time_step"]))


def run_arctic20_3d(cfg, device):
    from ..fields import NetCDFReader
    o = _file_oceandrift(cfg, device, True)
    r = NetCDFReader(cfg["file"])
    o.add_reader(r)
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]),
                    z=np.asarray(cfg["seed_z"]), time=r.times[0])
    return _run(o, cfg, cfg["time_step"])


def run_nordic_sigma_3d(cfg, device):
    """The reference's reader_ROMS_native end-to-end run, sampling the
    native C-grid in index space (``cfg["sampling"]``, default
    'native')."""
    from ..fields import ROMSReader
    o = _file_oceandrift(cfg, device, True)
    r = ROMSReader(cfg["file"], sampling=cfg.get("sampling", "native"))
    o.add_reader(r)
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]),
                    z=np.asarray(cfg["seed_z"]), time=r.times[0])
    return _run(o, cfg, cfg["time_step"])


def run_nordic_sigma_3d_regrid(cfg, device):
    """The regrid sampling mode against the native rung's golden."""
    return run_nordic_sigma_3d({**cfg, "sampling": "regrid"}, device)


def run_mixing_sundby(cfg, device):
    o = _oceandrift(device)
    for var, val in (("x_wind", cfg["wind_u"]), ("y_wind", 0.0),
                     ("sea_floor_depth_below_sea_level", cfg["seafloor"]),
                     ("ocean_mixed_layer_thickness", cfg["mld"])):
        o.set_config(f"environment:fallback:{var}", val)
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Sundby1983")
    o.set_config("vertical_mixing:timestep", cfg["dt_mix"])
    n = cfg["n"]
    o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                    z=np.full(n, cfg["seed_z"]), time=datetime(2021, 6, 1),
                    wind_drift_factor=np.zeros(n),
                    terminal_velocity=np.zeros(n))
    return _run(o, cfg)


def _openoil(cfg, device, fallbacks, processes):
    from ..models import OpenOil
    o = OpenOil(loglevel=40, device=device)
    o.set_config("environment:fallback:land_binary_mask", 0)
    for var, val in fallbacks.items():
        o.set_config(f"environment:fallback:{var}", val)
    for key, val in processes.items():
        o.set_config(key, val)
    o.set_config("seed:m3_per_hour", cfg["m3_per_hour"])
    return o


def run_openoil_budget(cfg, device):
    o = _openoil(cfg, device, {
        "x_wind": cfg["wind_u"], "y_wind": cfg["wind_v"],
        "x_sea_water_velocity": cfg["u"], "y_sea_water_velocity": cfg["v"],
        "sea_water_temperature": cfg["sst"]}, {
        "drift:vertical_mixing": False, "processes:dispersion": False,
        "processes:evaporation": True, "processes:emulsification": True,
        "processes:biodegradation": True})
    n = cfg["n"]
    o.seed_elements(lon=4.5, lat=60.0, radius=0, number=n,
                    time=datetime(2022, 5, 1), oil_type=cfg["oil_type"],
                    wind_drift_factor=np.full(n, cfg["wind_drift_factor"]))
    return _run(o, cfg, cfg["time_step_output"])


def run_openoil_full(cfg, device):
    o = _openoil(cfg, device, {
        "x_wind": cfg["wind_u"], "y_wind": 0.0,
        "x_sea_water_velocity": cfg["u"], "y_sea_water_velocity": 0.0,
        "sea_water_temperature": cfg["sst"],
        "sea_floor_depth_below_sea_level": cfg["seafloor"]}, {
        "drift:vertical_mixing": True,
        "vertical_mixing:timestep": cfg["dt_mix"],
        "processes:dispersion": True, "processes:evaporation": True,
        "processes:emulsification": True})
    o.seed_elements(lon=4.5, lat=60.0, radius=0, number=cfg["n"],
                    time=datetime(2022, 5, 1), oil_type=cfg["oil_type"])
    return _run(o, cfg, cfg["time_step_output"])


def run_stranding(cfg, device):
    """Stranding on the bundled coastline raster."""
    from ..fields import GlobalLandmask
    o = _oceandrift(device, "euler", land=False)
    o.set_config("environment:fallback:x_sea_water_velocity", cfg["u"])
    o.set_config("environment:fallback:y_sea_water_velocity", cfg["v"])
    o.set_config("drift:vertical_mixing", False)
    o.set_config("drift:vertical_advection", False)
    o.set_config("general:coastline_action", "stranding")
    o.set_config("general:use_auto_landmask", False)
    o.add_reader(GlobalLandmask())
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]),
                    time=datetime(2021, 3, 1))
    return _run(o, cfg)


def run_zoo(name, cfg, device):
    """A zoo golden's constant-fallback run (``tools/zoo_setups.py``)."""
    o, run_kw = zoo_setups.setup(name, cfg, device)
    o.run(**run_kw)
    return o


def run_eulerdrift_field(cfg, device):
    """The Eulerian solver's final concentration field, transposed into the
    reference's [x, y] order (reference eulerdrift grid.py:18).  The source
    patch is placed at the index the reference's grid yields: its axes are
    ``linspace(x0, x0 + N * res, N)``, endpoint included (reference
    grid.py:71-72), in the standard UTM zone (32 by the Norway exception),
    so the placement lives in the reference's index space."""
    from ..models import eulerdrift as ed
    from ..utils import crs as crslib
    ny, nx = cfg["shape"]
    sim = ed.ExplSimulation.new(lon0=cfg["lon0"], lat0=cfg["lat0"],
                                res=cfg["res"], shape=(ny, nx), device=device)
    sim.readers.append(ed.ConstantReader.new_xy(cfg["u"], cfg["v"]))
    sim.D = cfg["D"]
    zone = int((cfg["lon0"] + 180.0) // 6) + 1
    if 56 <= cfg["lat0"] < 64 and 3 <= cfg["lon0"] < 12:
        zone = 32
    refp = crslib.from_proj4(f"+proj=utm +zone={zone} +north "
                             "+ellps=WGS84 +datum=WGS84 +units=m")
    x0, y0 = refp.fwd(np, np.float64(cfg["lon0"]), np.float64(cfg["lat0"]))
    ref_x = np.linspace(float(x0), float(x0) + nx * cfg["res"], nx)
    ref_y = np.linspace(float(y0), float(y0) + ny * cfg["res"], ny)
    xs, ys = refp.fwd(np, np.float64(cfg["src_lon"]),
                      np.float64(cfg["src_lat"]))
    ix0 = int(np.argmin(np.abs(ref_x - xs)))
    iy0 = int(np.argmin(np.abs(ref_y - ys)))
    k = np.arange(cfg["N"]) - (cfg["N"] - 1) / 2.0
    g = np.exp(-0.5 * (k * cfg["res"] / cfg["sigma"]) ** 2)
    sim.grid._update_slice(np.outer(g, g).T, iy0, ix0)
    sim.integrate(dt=cfg["dt"], max_steps=cfg["steps"])
    return sim.grid.field.cpu().numpy().astype(np.float64).T


ZOO = ("pelagicegg_stat", "chemical_stat", "sediment_stat", "plast_stat",
       "larvalfish_stat", "sealice_stat", "radionuclide_stat",
       "windblow_euler", "seaice_euler", "openberg_det", "shipdrift_stat",
       "leeway_stat")

# every scenario of the JAX package's tools/parity_compare.py RUNNERS
RUNNERS = {
    "double_gyre_euler": run_double_gyre,
    "double_gyre_rk4": run_double_gyre,
    "double_gyre_rk2": run_double_gyre,
    "constant_wind_euler": run_constant_wind,
    "arctic20_euler": run_arctic20,
    "arctic20_rk4": run_arctic20,
    "arctic20_backward": run_arctic20_backward,
    "arctic20_3d_euler": run_arctic20_3d,
    "nordic_sigma_3d_euler": run_nordic_sigma_3d,
    "nordic_sigma_3d_euler_regrid": run_nordic_sigma_3d_regrid,
    "mixing_sundby_stat": run_mixing_sundby,
    "openoil_budget_surface": run_openoil_budget,
    "openoil_full_stat": run_openoil_full,
    "arctic20_stranding": run_stranding,
    **{name: functools.partial(run_zoo, name) for name in ZOO},
}
# the scenarios of the command line: RUNNERS and the Eulerian field
SCENARIOS = (*RUNNERS, "eulerdrift_field")


# -------------------------------------------------------------- compare --

def _values(result, var):
    v = result[var]
    return np.asarray(v.values if hasattr(v, "values") else v, np.float64)


def compare(name, o, golden):
    """The divergence statistics of a run against its golden (the JAX
    tool's ``compare``, through the port's geodesic inverse)."""
    from ..utils.geodesic import inverse_np
    lon_r = np.asarray(golden["lon"], np.float64)
    lat_r = np.asarray(golden["lat"], np.float64)
    lon_o = _values(o.result, "lon")
    lat_o = _values(o.result, "lat")
    nt = min(lon_r.shape[1], lon_o.shape[1])
    lon_r, lat_r = lon_r[:, :nt], lat_r[:, :nt]
    lon_o, lat_o = lon_o[:, :nt], lat_o[:, :nt]
    both = np.isfinite(lon_r) & np.isfinite(lon_o)
    _, _, dist = inverse_np(lat_r[both], lon_r[both],
                            np.where(both, lat_o, lat_r)[both],
                            np.where(both, lon_o, lon_r)[both])
    dist = np.asarray(dist)
    last = both[:, -1]
    _, _, dist_last = inverse_np(lat_r[:, -1][last], lon_r[:, -1][last],
                                 lat_o[:, -1][last], lon_o[:, -1][last])
    dist_last = np.asarray(dist_last)

    def stat(fn, a):
        return float(fn(a)) if a.size else float("nan")
    out = {
        "shape_ref": list(lon_r.shape), "shape_our": list(lon_o.shape),
        "finite_mismatch": int((np.isfinite(lon_r)
                                != np.isfinite(lon_o)).sum()),
        "max_m": stat(np.max, dist), "mean_m": stat(np.mean, dist),
        "final_max_m": stat(np.max, dist_last),
        "final_mean_m": stat(np.mean, dist_last),
        "final_median_m": stat(np.median, dist_last)}
    if "z" in golden and "z" in o.result:
        z_r = np.asarray(golden["z"], np.float64)[:, :nt]
        dz = np.abs(z_r - _values(o.result, "z")[:, :nt])[both]
        out["max_dz_m"] = stat(np.max, dz)
        out["mean_dz_m"] = stat(np.mean, dz)
    return out


# --------------------------------------------------------------- checks --
# each check gives rows (statistic, value, bound): a number bound is an
# upper bound, a pair an open interval, ("min", b) a lower bound, and
# ("equal", True) a statement that must hold

def _row(stat, value, bound):
    if isinstance(bound, tuple) and bound[0] == "min":
        ok = value > bound[1]
    elif isinstance(bound, tuple) and bound[0] == "equal":
        ok = bool(value) == bound[1]
    elif isinstance(bound, tuple):
        ok = bound[0] < value < bound[1]
    else:
        ok = value < bound
    return {"stat": stat, "value": value if isinstance(value, bool)
            else float(value), "bound": list(bound)
            if isinstance(bound, tuple) else bound, "ok": bool(ok)}


def check_trajectory(name, o, golden):
    s = compare(name, o, golden)
    max_tol, final_tol = TOLERANCES[name]
    rows = [_row("same_shape", s["shape_ref"] == s["shape_our"],
                 ("equal", True)),
            _row("finite_mismatch", s["finite_mismatch"] == 0,
                 ("equal", True)),
            _row("max_m", s["max_m"], max_tol),
            _row("final_mean_m", s["final_mean_m"], final_tol)]
    if name in DZ_TOLERANCES:
        rows.append(_row("max_dz_m", s["max_dz_m"], DZ_TOLERANCES[name]))
    if name in MEDIAN_TOLERANCES:
        rows.append(_row("final_median_m", s["final_median_m"],
                         MEDIAN_TOLERANCES[name]))
    return rows, s


def _final(ds, var):
    return np.asarray(ds[var].values if hasattr(ds[var], "values")
                      else ds[var], np.float64)[:, -1]


def _z_moments(b, z_o, z_r, quantiles=(), nan=False):
    mean, std, pct = ((np.nanmean, np.nanstd, np.nanpercentile) if nan
                      else (np.mean, np.std, np.percentile))
    rows = [_row("z_mean", abs(mean(z_o) - mean(z_r)), b["z_mean"]),
            _row("z_std", abs(std(z_o) - std(z_r)), b["z_std"])]
    rows += [_row(f"z_p{q}", abs(pct(z_o, q) - pct(z_r, q)),
                  b["z_quantile"]) for q in quantiles]
    return rows


def _cloud(lon, lat, lat0, lon0):
    from ..utils.geodesic import inverse_np
    az, _, dist = inverse_np(np.full(lon.shape[0], lat0),
                             np.full(lon.shape[0], lon0), lat, lon)
    return dist * np.sin(np.deg2rad(az)), dist * np.cos(np.deg2rad(az))


def _counts(sp):
    sp = np.asarray(sp, np.float64)
    keys, counts = np.unique(sp[np.isfinite(sp)], return_counts=True)
    return {int(k): int(c) for k, c in zip(keys, counts)}


def check_stat(name, cfg, o, golden):
    """The statistical and budget checks of
    ``tests/test_reference_stat_parity.py`` for scenario ``name``."""
    b = STAT_BOUNDS[name]
    res = o.result
    z_r, z_o = _final(golden, "z"), _final(res, "z")
    rows = []
    if name == "mixing_sundby_stat":
        rows += [_row("same_shape", z_o.shape == z_r.shape, ("equal", True))]
        rows += _z_moments(b, z_o, z_r, (5, 25, 50, 75, 95))
        rows.append(_row("below_mld_share", abs(
            (z_o < -cfg["mld"]).mean() - (z_r < -cfg["mld"]).mean()),
            b["below_mld_share"]))
    elif name == "pelagicegg_stat":
        rows += _z_moments(b, z_o, z_r, (5, 25, 50, 75, 95))
    elif name in ("leeway_stat", "shipdrift_stat"):
        lat0, lon0 = (59.5, 2.0) if name == "leeway_stat" else (60.0, 4.0)
        dx_r, dy_r = _cloud(_final(golden, "lon"), _final(golden, "lat"),
                            lat0, lon0)
        dx_o, dy_o = _cloud(_final(res, "lon"), _final(res, "lat"), lat0,
                            lon0)
        rows += [
            _row("downwind_mean_rel", abs(dx_o.mean() - dx_r.mean())
                 / dx_r.mean(), b["downwind_mean_rel"]),
            _row("crosswind_mean_m", abs(dy_o.mean() - dy_r.mean()),
                 b["crosswind_mean_m"]),
            _row("downwind_std_rel", abs(dx_o.std() - dx_r.std())
                 / dx_r.std(), b["downwind_std_rel"]),
            _row("crosswind_std_rel", abs(dy_o.std() - dy_r.std())
                 / dy_r.std(), b["crosswind_std_rel"]),
            _row("left_share", abs((dy_o < 0).mean() - (dy_r < 0).mean()),
                 b["left_share"])]
    elif name == "openoil_budget_surface":
        rows += _openoil_budget_rows(b, golden, res)
    elif name == "openoil_full_stat":
        rows += _openoil_full_rows(b, golden, res)
    elif name in ("chemical_stat", "radionuclide_stat"):
        c_r = _counts(np.asarray(golden["specie"])[:, -1])
        c_o = _counts(_final(res, "specie"))
        rows.append(_row("occupation_share", max(
            abs(c_o.get(sp, 0) - c_r.get(sp, 0)) / cfg["n"]
            for sp in set(c_r) | set(c_o)), b["occupation_share"]))
        if name == "chemical_stat":
            m_r = np.nansum(_final(golden, "mass"))
            m_o = np.nansum(_final(res, "mass"))
            rows.append(_row("mass_rel", abs(m_o - m_r) / m_r,
                             b["mass_rel"]))
            for var in ("mass_degraded", "mass_volatilized"):
                g = np.nansum(_final(golden, var))
                m = np.nansum(_final(res, var))
                rows.append(_row(f"{var}_rel", abs(m - g) / g,
                                 b["loss_rel"]))
        rows += _z_moments(b, z_o, z_r, nan=True)
    elif name == "sediment_stat":
        rows += _z_moments(b, z_o, z_r, nan=True)
        m_r, m_o = _final(golden, "moving"), _final(res, "moving")
        rows += [_row("settled_share", abs((m_o == 0).mean()
                                           - (m_r == 0).mean()),
                      b["settled_share"]),
                 _row("z_median", abs(np.nanmedian(z_o) - np.nanmedian(z_r)),
                      b["z_median"])]
    elif name == "plast_stat":
        rows += _z_moments(b, z_o, z_r, (10, 50, 90), nan=True)
        rows.append(_row("lon_mean", abs(np.nanmean(_final(res, "lon"))
                                         - np.nanmean(_final(golden, "lon"))),
                         b["lon_mean"]))
    elif name == "larvalfish_stat":
        h_r, h_o = _final(golden, "hatched"), _final(res, "hatched")
        rows.append(_row("hatched_equal", np.array_equal(h_o, h_r),
                         ("equal", True)))
        for var in ("stage_fraction", "weight", "length"):
            a, g = _final(res, var), _final(golden, var)
            sel = np.isfinite(g)
            rows.append(_row(var, np.abs(a[sel] - g[sel]).max(), b[var]))
        for pop, label in ((0, "eggs"), (1, "larvae")):
            so, sr = h_o == pop, h_r == pop
            rows += [_row(f"{label}_z_mean", abs(
                np.nanmean(z_o[so]) - np.nanmean(z_r[sr])), b["z_mean"]),
                _row(f"{label}_z_std", abs(
                    np.nanstd(z_o[so]) - np.nanstd(z_r[sr])), b["z_std"])]
    elif name == "sealice_stat":
        rows.append(_row("degree_days", np.abs(
            _final(res, "degree_days")
            - _final(golden, "degree_days")).max(), b["degree_days"]))
        rows += _z_moments(b, z_o, z_r, nan=True)
    else:
        raise KeyError(f"no statistical check for {name}")
    return rows


def _openoil_budget_rows(b, golden, res):
    from ..utils.geodesic import inverse_np
    rows = []
    tot0 = np.nansum(np.asarray(golden["mass_oil"], np.float64), axis=0)[0]
    for var in ("mass_oil", "mass_evaporated", "mass_biodegraded"):
        g = np.nansum(np.asarray(golden[var], np.float64), axis=0)
        m = np.nansum(_values(res, var), axis=0)
        n = min(len(g), len(m))
        rows.append(_row(var, (np.abs(m[:n] - g[:n]) / tot0).max(), b[var]))
    for var in ("water_fraction", "oil_film_thickness"):
        g = np.nanmean(np.asarray(golden[var], np.float64), axis=0)[-1]
        m = np.nanmean(_values(res, var), axis=0)[-1]
        rows.append(_row(var, abs(m - g), b[var]))
    g = np.nanmean(np.asarray(golden["viscosity"], np.float64), axis=0)[-1]
    m = np.nanmean(_values(res, "viscosity"), axis=0)[-1]
    rows.append(_row("viscosity_rel", abs(m - g) / g, b["viscosity_rel"]))
    lon_r, lat_r = _final(golden, "lon"), _final(golden, "lat")
    lon_o, lat_o = _final(res, "lon"), _final(res, "lat")
    _, _, d = inverse_np(lat_r.mean(), lon_r.mean(), lat_o.mean(),
                         lon_o.mean())
    rows.append(_row("centroid_m", float(d), b["centroid_m"]))
    _, _, sp_r = inverse_np(np.full_like(lat_r, 60.0),
                            np.full_like(lon_r, 4.5), lat_r, lon_r)
    _, _, sp_o = inverse_np(np.full_like(lat_o, 60.0),
                            np.full_like(lon_o, 4.5), lat_o, lon_o)
    rows += [_row("spread_mean_m", abs(sp_o.mean() - sp_r.mean()),
                  b["spread_mean_m"]),
             _row("spread_std_rel", abs(sp_o.std() - sp_r.std())
                  / sp_r.std(), b["spread_std_rel"])]
    return rows


def _openoil_full_rows(b, golden, res):
    rows = []
    tot_g = np.nansum(np.asarray(golden["mass_oil"], np.float64), axis=0)[0]
    tot_o = np.nansum(_values(res, "mass_oil"), axis=0)[0]
    for var in ("mass_oil", "mass_evaporated", "mass_dispersed"):
        g = np.nansum(np.asarray(golden[var], np.float64), axis=0)[-1]
        m = np.nansum(_values(res, var), axis=0)[-1]
        rows.append(_row(var, abs(m / tot_o - g / tot_g), b[var]))
    rows.append(_row("dispersed_share", np.nansum(
        _values(res, "mass_dispersed"), axis=0)[-1] / tot_o,
        ("min", b["dispersed_share_min"])))
    wf_g = np.nanmean(np.asarray(golden["water_fraction"])[:, -1])
    rows.append(_row("water_fraction", abs(np.nanmean(
        _final(res, "water_fraction")) - wf_g), b["water_fraction"]))
    dg, zg = _final(golden, "diameter"), _final(golden, "z")
    do, zo = _final(res, "diameter"), _final(res, "z")
    med_g = np.median(dg[(zg < 0) & (dg > 0)])
    med_o = np.median(do[(zo < 0) & (do > 0)])
    rows += [_row("diameter_median_ratio", med_o / med_g,
                  b["diameter_median_ratio"]),
             _row("surface_share", (zo == 0).mean(), b["surface_share"]),
             _row("z_mean", np.nanmean(zo), b["z_mean"]),
             _row("z_p5", np.nanpercentile(zo, 5), ("min", b["z_p5_min"]))]
    return rows


def check_field(field, golden):
    ref = np.asarray(golden["field"], np.float64)
    b = STAT_BOUNDS["eulerdrift_field"]
    same = field.shape == ref.shape
    rows = [_row("same_shape", same, ("equal", True))]
    if same:
        rows += [_row("field_max_abs", np.abs(field - ref).max(),
                      b["field_max_abs"]),
                 _row("mass_abs", abs(field.sum() - ref.sum()),
                      b["mass_abs"])]
    return rows


def check(name, device="cuda", data=None):
    """Run scenario ``name`` on ``device`` against its golden: a record
    with ``status`` 'pass', 'fail' or 'no data', the rows of statistics
    beside their bounds, and the seconds of the run."""
    golden, cfg = load_golden(name)
    if "file" in cfg:
        cfg = {**cfg, "file": forcing_file(cfg, data)}
        if not os.path.exists(cfg["file"]):
            return {"scenario": name, "status": "no data",
                    "file": cfg["file"]}
    t = time.perf_counter()
    if name == "eulerdrift_field":
        rows = check_field(run_eulerdrift_field(cfg, device), golden)
        stats = None
    else:
        o = RUNNERS[name](cfg, device)
        if name in TOLERANCES:
            rows, stats = check_trajectory(name, o, golden)
        else:
            rows, stats = check_stat(name, cfg, o, golden), None
    ok = all(r["ok"] for r in rows)
    out = {"scenario": name, "status": "pass" if ok else "fail",
           "device": str(device), "rows": rows,
           "seconds": time.perf_counter() - t}
    if stats is not None:
        out["stats"] = stats
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scenarios", nargs="*", help="default: every scenario")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data", default=None,
                   help="the directory standing for the reference's "
                   "tests/test_data")
    args = p.parse_args(argv)
    names = args.scenarios or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        p.error(f"unknown scenario(s) {unknown}; known: {list(SCENARIOS)}")
    failed = 0
    for name in names:
        rec = check(name, args.device, args.data)
        failed += rec["status"] == "fail"
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
