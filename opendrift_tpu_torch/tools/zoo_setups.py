"""Constant-fallback runs of the model zoo, on the port's classes.

The configurations under which the reference OpenDrift produced the zoo's
goldens (``tests/goldens/ref_traj_<name>.npz``; the JAX package runs them
through ``tools/parity_compare.py``), written out for the port:
``setup(name, cfg, device)`` builds and seeds the simulation and returns it
with the keyword arguments of its ``run``.  ``CONFIGS`` holds each
configuration's scalars; ``config(name, n, seed)`` makes a whole one at any
size, seed positions and sizes drawn with numpy from ``seed``, where a
golden lists them per element.  The tests hold these runs against the
goldens at the JAX tests' bounds (``tests/test_torch_zoo.py``) and
``chip_smoke.py`` runs them on the card against the CPU.
"""

from datetime import datetime, timedelta

import numpy as np

# each golden's scalars (the npz files' ``config``); LarvalFishExtended has
# no golden and runs LarvalFish's configuration with its own behaviour, and
# the metals ChemicalDrift (the Copper preset), OpenHNS and ModelTemplate
# have none and run the constant fallbacks of their JAX tests
CONFIGS = {
    "windblow_euler": dict(model="WindBlow", wind_u=9.0, wind_v=-3.0,
                           time_step=900, duration_s=90000),
    "seaice_euler": dict(model="SeaIceDrift", ice_u=0.25, ice_v=0.1,
                         ice_conc=0.8, u=0.05, wind_u=10.0, time_step=900,
                         duration_s=90000),
    "leeway_stat": dict(model="Leeway", object_type=26, wind_u=12.0,
                        wind_v=0.0, time_step=600, duration_s=43200,
                        time_step_output=3600),
    "plast_stat": dict(model="PlastDrift", wind_u=10.0, u=0.1,
                       time_step=1800, duration_s=21600,
                       time_step_output=3600),
    "sediment_stat": dict(model="SedimentDrift", wind_u=6.0, u=0.15,
                          seafloor=30.0, seed_z=-5.0, dt_mix=60.0,
                          time_step=1800, duration_s=43200,
                          time_step_output=3600),
    "pelagicegg_stat": dict(model="PelagicEggDrift", wind_u=8.0, sst=10.0,
                            sss=34.0, seafloor=150.0, seed_z=-30.0,
                            diameter=0.0014, time_step=1800,
                            duration_s=43200, time_step_output=3600),
    "larvalfish_stat": dict(model="LarvalFish", sst=12.0, sss=34.0,
                            seed_z=-10.0, time_step=1800, duration_s=172800,
                            time_step_output=7200, dt_mix=60.0),
    "larvalfish_extended": dict(model="LarvalFishExtended", sst=12.0,
                                sss=34.0, seed_z=-10.0, time_step=1800,
                                duration_s=172800, time_step_output=7200,
                                dt_mix=60.0),
    "openberg_det": dict(model="OpenBerg", wind_u=12.0, wind_v=3.0, u=0.25,
                         v=-0.05, time_step=900, duration_s=90000),
    "shipdrift_stat": dict(model="ShipDrift", wind_u=12.0, hs=2.5,
                           length=120.0, beam=18.0, height=22.0, draft=6.0,
                           time_step=600, duration_s=43200,
                           time_step_output=3600),
    "sealice_stat": dict(model="SeaLice", u=0.05, sst=10.0, sss=34.0,
                         seafloor=80.0, seed_z=-5.0, time_step=1800,
                         duration_s=86400, time_step_output=3600),
    "chemical_stat": dict(model="ChemicalDrift", compound="Phenanthrene",
                          wind_u=5.0, u=0.05, sst=12.0, sss=34.0,
                          seafloor=60.0, spm=5.0, seed_z=-5.0,
                          time_step=1800, duration_s=43200,
                          time_step_output=3600),
    "radionuclide_stat": dict(model="RadionuclideDrift", u=0.05, sst=10.0,
                              sss=34.0, seafloor=50.0, seed_z=-5.0,
                              time_step=1800, duration_s=86400,
                              time_step_output=3600, dt_mix=60.0),
    "chemical_metals": dict(model="ChemicalDrift", compound="Copper",
                            wind_u=5.0, u=0.3, sst=12.0, sss=30.0,
                            seafloor=20.0, spm=20.0, seed_z=-5.0,
                            time_step=1800, duration_s=43200,
                            time_step_output=3600),
    "hns_butyl": dict(model="OpenHNS", hns_type="butyl", u=0.2,
                      wind_u=8.0, time_step=600, duration_s=21600,
                      time_step_output=3600),
    "model_template": dict(model="ModelTemplate", u=0.1, my_setting=2.0,
                           time_step=600, duration_s=7200,
                           time_step_output=600),
}


def config(name, n, seed=0):
    """A whole configuration of ``n`` elements: the golden's scalars, and
    per-element seeds drawn from ``seed`` where the golden lists them."""
    cfg = dict(CONFIGS[name], n=n)
    r = np.random.default_rng(seed)
    if name in ("windblow_euler", "seaice_euler", "openberg_det"):
        cfg["seed_lon"] = r.uniform(3.0, 5.0, n).tolist()
        cfg["seed_lat"] = r.uniform(59.5, 61.0, n).tolist()
    if name == "openberg_det":
        cfg["sail"] = r.uniform(5.0, 30.0, n).tolist()
        cfg["draft"] = r.uniform(20.0, 150.0, n).tolist()
        cfg["length"] = r.uniform(50.0, 300.0, n).tolist()
    if name.startswith("larvalfish"):
        cfg["stage_fraction"] = r.uniform(0.0, 0.9, n).tolist()
    return cfg


def _set_fallbacks(o, vals):
    for k, v in vals.items():
        try:
            o.set_config(f"environment:fallback:{k}", v)
        except (ValueError, KeyError):
            pass


def _run_kwargs(cfg):
    kw = {"duration": timedelta(seconds=cfg["duration_s"]),
          "time_step": cfg["time_step"]}
    if "time_step_output" in cfg:
        kw["time_step_output"] = cfg["time_step_output"]
    return kw


def _seed_lists(cfg):
    return np.asarray(cfg["seed_lon"]), np.asarray(cfg["seed_lat"])


def setup(name, cfg, device):
    """The simulation of configuration ``name`` (``cfg`` as in a golden)
    on ``device``, seeded, and the keyword arguments of its ``run``."""
    from .. import models as M
    n = cfg.get("n")
    if name == "windblow_euler":
        o = M.WindBlow(loglevel=40, device=device)
        _set_fallbacks(o, {"x_wind": cfg["wind_u"], "y_wind": cfg["wind_v"],
                           "land_binary_mask": 0})
        lon, lat = _seed_lists(cfg)
        o.seed_elements(lon=lon, lat=lat, time=datetime(2021, 1, 1))
    elif name == "seaice_euler":
        o = M.SeaIceDrift(loglevel=40, device=device)
        _set_fallbacks(o, {
            "sea_ice_x_velocity": cfg["ice_u"],
            "sea_ice_y_velocity": cfg["ice_v"],
            "sea_ice_area_fraction": cfg["ice_conc"],
            "x_sea_water_velocity": cfg["u"], "y_sea_water_velocity": 0.0,
            "x_wind": cfg["wind_u"], "y_wind": 0.0, "land_binary_mask": 0})
        lon, lat = _seed_lists(cfg)
        o.seed_elements(lon=lon, lat=lat, time=datetime(2021, 2, 1))
    elif name == "leeway_stat":
        o = M.Leeway(loglevel=40, device=device)
        for var, val in (("land_binary_mask", 0), ("x_wind", cfg["wind_u"]),
                         ("y_wind", cfg["wind_v"]),
                         ("x_sea_water_velocity", 0.0),
                         ("y_sea_water_velocity", 0.0)):
            o.set_config(f"environment:fallback:{var}", val)
        o.seed_elements(lon=2.0, lat=59.5, radius=0, number=n,
                        time=datetime(2021, 3, 1),
                        object_type=cfg["object_type"])
    elif name == "plast_stat":
        o = M.PlastDrift(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        _set_fallbacks(o, {"x_wind": cfg["wind_u"], "y_wind": 0.0,
                           "x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "sea_floor_depth_below_sea_level": 200.0})
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        time=datetime(2021, 4, 1))
    elif name == "sediment_stat":
        o = M.SedimentDrift(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        _set_fallbacks(o, {"x_wind": cfg["wind_u"], "y_wind": 0.0,
                           "x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "sea_floor_depth_below_sea_level":
                               cfg["seafloor"]})
        o.set_config("vertical_mixing:timestep", cfg["dt_mix"])
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 4, 1))
    elif name == "pelagicegg_stat":
        o = M.PelagicEggDrift(loglevel=40, device=device)
        for var, val in (("land_binary_mask", 0), ("x_wind", cfg["wind_u"]),
                         ("y_wind", 0.0), ("x_sea_water_velocity", 0.0),
                         ("y_sea_water_velocity", 0.0),
                         ("sea_water_temperature", cfg["sst"]),
                         ("sea_water_salinity", cfg["sss"]),
                         ("sea_floor_depth_below_sea_level",
                          cfg["seafloor"])):
            o.set_config(f"environment:fallback:{var}", val)
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 4, 1),
                        diameter=cfg["diameter"])
    elif name in ("larvalfish_stat", "larvalfish_extended"):
        cls = M.LarvalFish if name == "larvalfish_stat" \
            else M.LarvalFishExtended
        o = cls(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        _set_fallbacks(o, {"x_wind": 4.0, "y_wind": 0.0,
                           "sea_water_temperature": cfg["sst"],
                           "sea_water_salinity": cfg["sss"],
                           "sea_floor_depth_below_sea_level": 100.0})
        o.set_config("vertical_mixing:timestep", cfg["dt_mix"])
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 4, 1, 0),
                        stage_fraction=np.asarray(cfg["stage_fraction"]))
    elif name == "openberg_det":
        o = M.OpenBerg(loglevel=40, device=device)
        _set_fallbacks(o, {
            "horizontal_diffusivity": 0.0,   # deterministic force balance
            "x_wind": cfg["wind_u"], "y_wind": cfg["wind_v"],
            "x_sea_water_velocity": cfg["u"],
            "y_sea_water_velocity": cfg["v"],
            "sea_water_temperature": 2.0,
            "sea_surface_wave_significant_height": 1.5,
            "land_binary_mask": 0})
        lon, lat = _seed_lists(cfg)
        o.seed_elements(lon=lon, lat=lat, time=datetime(2021, 2, 1),
                        sail=np.asarray(cfg["sail"]),
                        draft=np.asarray(cfg["draft"]),
                        length=np.asarray(cfg["length"]),
                        width=np.asarray(cfg["length"]))
    elif name == "shipdrift_stat":
        o = M.ShipDrift(loglevel=40, device=device)
        _set_fallbacks(o, {
            "x_wind": cfg["wind_u"], "y_wind": 0.0,
            "x_sea_water_velocity": 0.0, "y_sea_water_velocity": 0.0,
            "sea_surface_wave_significant_height": cfg["hs"],
            "land_binary_mask": 0})
        o.seed_elements(lon=4.0, lat=60.0, radius=0, number=n,
                        time=datetime(2021, 3, 1),
                        length=cfg["length"], beam=cfg["beam"],
                        height=cfg["height"], draft=cfg["draft"])
    elif name == "sealice_stat":
        o = M.SeaLice(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        _set_fallbacks(o, {"x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "sea_water_temperature": cfg["sst"],
                           "sea_water_salinity": cfg["sss"],
                           "sea_floor_depth_below_sea_level":
                               cfg["seafloor"]})
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 6, 1, 0))
    elif name in ("chemical_stat", "chemical_metals"):
        o = M.ChemicalDrift(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        for k, v in (("x_wind", cfg["wind_u"]), ("y_wind", 0.0),
                     ("x_sea_water_velocity", cfg["u"]),
                     ("y_sea_water_velocity", 0.0),
                     ("sea_water_temperature", cfg["sst"]),
                     ("sea_water_salinity", cfg["sss"]),
                     ("sea_floor_depth_below_sea_level", cfg["seafloor"]),
                     ("spm", cfg["spm"])):
            o.set_config(f"environment:fallback:{k}", v)
        o.set_config("chemical:transformations:degradation", True)
        o.set_config("chemical:transformations:volatilization", True)
        o.init_chemical_compound(cfg["compound"])
        # the SPM diameters come from numpy's global generator, as in the
        # JAX package: seeded here so that runs on two devices are equal
        np.random.seed(0)
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 4, 1))
    elif name == "radionuclide_stat":
        o = M.RadionuclideDrift(loglevel=40, device=device)
        o.set_config("environment:fallback:land_binary_mask", 0)
        _set_fallbacks(o, {"x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "sea_water_temperature": cfg["sst"],
                           "sea_water_salinity": cfg["sss"],
                           "sea_floor_depth_below_sea_level":
                               cfg["seafloor"]})
        o.set_config("vertical_mixing:timestep", cfg["dt_mix"])
        o.seed_elements(lon=np.full(n, 4.0), lat=np.full(n, 60.0),
                        z=np.full(n, cfg["seed_z"]),
                        time=datetime(2021, 4, 1))
    elif name == "hns_butyl":
        o = M.OpenHNS(loglevel=40, device=device)
        _set_fallbacks(o, {"x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "x_wind": cfg["wind_u"], "y_wind": 0.0,
                           "land_binary_mask": 0})
        o.seed_elements(lon=4.0, lat=60.0, radius=1000.0, number=n,
                        time=datetime(2020, 1, 1),
                        hns_type=cfg["hns_type"])
    elif name == "model_template":
        o = M.ModelTemplate(loglevel=40, device=device)
        _set_fallbacks(o, {"x_sea_water_velocity": cfg["u"],
                           "y_sea_water_velocity": 0.0,
                           "land_binary_mask": 0})
        o.set_config("template:my_setting", cfg["my_setting"])
        o.seed_elements(lon=4.0, lat=60.0, radius=1000.0, number=n,
                        time=datetime(2020, 1, 1), my_property=1.0)
    else:
        raise ValueError(f"no zoo configuration named {name}")
    return o, _run_kwargs(cfg)
