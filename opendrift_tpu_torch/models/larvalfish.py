"""LarvalFish: eggs hatching into growing, vertically migrating larvae
(reference: opendrift/models/larvalfish.py:26-300), and
LarvalFishExtended: configurable depth-keeping and diel vertical
migration for larvae and phytoplankton (reference:
opendrift/models/larvalfish_extended.py:28-342).

Port of ``opendrift_tpu/models/larvalfish.py``.  LarvalFish overrides
``terminal_velocity_inner``, so its Visser walk takes OceanDrift's generic
per-substep loop.  Time of day is float32 arithmetic on the step's
``t_rel``, as in the JAX package.
"""

import numpy as np
import torch

from ..config import (CONFIG_LEVEL_ESSENTIAL, CONFIG_LEVEL_BASIC,
                      CONFIG_LEVEL_ADVANCED)
from ..ops.physics import rdiv, solar_elevation
from .oceandrift import OceanDrift, Lagrangian3DArray
from .pelagicegg import egg_terminal_velocity


class LarvalFishElement(Lagrangian3DArray):
    """(reference larvalfish.py:26-53)."""

    variables = Lagrangian3DArray.add_variables([
        ("diameter", {"dtype": np.float32, "units": "m", "default": 0.0014}),
        ("neutral_buoyancy_salinity", {"dtype": np.float32, "units": "PSU",
                                       "default": 31.25}),
        ("stage_fraction", {"dtype": np.float32, "units": "1",
                            "default": 0.0}),
        ("hatched", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("length", {"dtype": np.float32, "units": "mm", "default": 0.0}),
        ("weight", {"dtype": np.float32, "units": "mg", "default": 0.08}),
        ("survival", {"dtype": np.float32, "units": "1", "default": 1.0}),
    ])


class LarvalFish(OceanDrift):
    """Fish egg and larvae IBM (reference larvalfish.py:55)."""

    ElementType = LarvalFishElement

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
        "sea_floor_depth_below_sea_level": {"fallback": 100},
        "ocean_vertical_diffusivity": {"fallback": 0.01, "profiles": True},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "sea_water_temperature": {"fallback": 10, "profiles": True},
        "sea_water_salinity": {"fallback": 34, "profiles": True},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "IBM:fraction_of_timestep_swimming": {
                "type": "float", "default": 0.15, "min": 0.0, "max": 1.0,
                "units": "fraction", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Fraction of timestep swimming"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_mixing_at_surface", True)
        self._set_config_default("drift:vertical_advection_at_surface", True)

    # eggs and larvae carry the pelagic-egg buoyancy: the reference applies
    # the Sundby/Vikebo formula to all elements (larvalfish.py:105-183);
    # larvae also swim in larvae_vertical_migration
    def update_terminal_velocity(self, ctx, **kwargs):
        d = ctx.state.data
        w = egg_terminal_velocity(
            ctx.environment["sea_water_temperature"],
            ctx.environment["sea_water_salinity"],
            d["diameter"], d["neutral_buoyancy_salinity"])
        ctx.set_var("terminal_velocity", w)

    def terminal_velocity_inner(self, ctx, z, Tprof, Sprof, mix=None):
        d = ctx.state.data
        if Tprof is not None and Sprof is not None:
            T0 = self.profile_interp(ctx, Tprof, z)
            S0 = self.profile_interp(ctx, Sprof, z)
        else:
            T0 = ctx.environment["sea_water_temperature"]
            S0 = ctx.environment["sea_water_salinity"]
        return egg_terminal_velocity(T0, S0, d["diameter"],
                                     d["neutral_buoyancy_salinity"])

    @staticmethod
    def fish_growth(weight, temperature, dt):
        """Folkvord (2005) daily growth rate, as mg a step
        (reference larvalfish.py:189-202)."""
        lw = torch.log(torch.clamp_min(weight, 1e-6))
        lw2 = lw * lw
        GR = (1.08 + 1.79 * temperature - 0.074 * temperature * lw
              - 0.0965 * temperature * lw2
              + 0.0112 * temperature * (lw * lw2))
        g = torch.log(GR / 100.0 + 1.0) * dt / 86400.0
        return weight * (torch.exp(g) - 1.0)

    def update_fish_larvae(self, ctx):
        """Egg development and hatching, larval growth
        (reference larvalfish.py:204-239)."""
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        T = ctx.environment["sea_water_temperature"]
        eggs = d["hatched"] == 0.0
        # Ellertsen et al. (1988) egg development time
        amb_duration = torch.exp(3.65 - 0.145 * T)
        frac = (dt / 86400.0) / amb_duration
        stage = torch.where(eggs, d["stage_fraction"] + frac,
                            d["stage_fraction"])
        hatched = torch.where(eggs & (stage >= 1.0), 1.0, d["hatched"])
        ctx.set_var("stage_fraction", stage)
        ctx.set_var("hatched", hatched)

        larvae = hatched == 1.0
        growth = self.fish_growth(d["weight"], T, dt)
        weight = torch.where(larvae, d["weight"] + growth, d["weight"])
        lw = torch.log(torch.clamp_min(weight, 1e-6))
        l10 = torch.log10(torch.clamp_min(weight, 1e-6))
        length = torch.exp(2.296 + 0.277 * lw - 0.005128 * (l10 * l10))
        ctx.set_var("weight", weight)
        ctx.set_var("length", torch.where(larvae, length, d["length"]))

    def larvae_vertical_migration(self, ctx):
        """Diel vertical migration with Peck (2006) swim speeds
        (reference larvalfish.py:241-260)."""
        d = ctx.state.data
        larvae = d["hatched"] == 1.0
        L = torch.clamp_min(d["length"], 1e-3)
        swim_speed = (0.261 * torch.pow(L, 1.552 * torch.pow(L, -0.08))
                      - rdiv(5.289, L)) / 1000.0
        f = self.get_config("IBM:fraction_of_timestep_swimming")
        dz_max = f * swim_speed * abs(ctx.params["dt"])
        # UTC hour from the run's epoch and the elapsed time (float32)
        start_hour = self.start_time.hour + self.start_time.minute / 60.0
        hour = (start_hour + ctx.t_rel / 3600.0) % 24.0
        direction = -1.0 if hour < 12.0 else 1.0
        new_z = torch.clamp_max(d["z"] + direction * dz_max, 0.0)
        ctx.set_var("z", torch.where(larvae, new_z, d["z"]))

    def update(self, ctx):
        """(reference larvalfish.py:290-300)."""
        self.update_fish_larvae(ctx)
        ctx.advect_ocean_current()
        ctx.stokes_drift()
        self.update_terminal_velocity(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        self.larvae_vertical_migration(ctx)


class LarvalFishExtendedElement(Lagrangian3DArray):
    """(reference larvalfish_extended.py:28-42)."""

    variables = Lagrangian3DArray.add_variables([
        ("stage_fraction", {"dtype": np.float32, "units": "",
                            "default": 0.0}),
        ("hatched", {"dtype": np.float32, "units": "", "default": 0.0}),
    ])


class LarvalFishExtended(OceanDrift):
    """Biological particles with configurable vertical behaviour
    (reference larvalfish_extended.py:44-342): depth-band keeping or
    diel vertical migration driven by solar elevation, for larvae
    (egg/hatching lifecycle) or phytoplankton (always active)."""

    ElementType = LarvalFishExtendedElement

    required_variables = dict(LarvalFish.required_variables)

    def add_config(self):
        super().add_config()
        # (reference larvalfish_extended.py:99-168)
        self._add_config({
            "biology:particle_type": {
                "type": "enum", "enum": ["larva", "phytoplankton"],
                "default": "larva", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Larvae have egg/hatching stages; "
                               "phytoplankton only vertical behaviour"},
            "biology:vertical_behavior_mode": {
                "type": "enum", "enum": ["none", "depth", "dvm"],
                "default": "dvm", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "none / preferred depth band / diel "
                               "vertical migration"},
            "biology:w_active": {
                "type": "float", "default": 0.003, "min": 0.0, "max": 1.0,
                "units": "m/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Maximum active vertical speed"},
            "biology:z_pref": {
                "type": "float", "default": -10.0, "min": -10000.0,
                "max": 0.0, "units": "m", "level": CONFIG_LEVEL_BASIC,
                "description": "Preferred depth for depth mode"},
            "biology:z_day": {
                "type": "float", "default": -25.0, "min": -10000.0,
                "max": 0.0, "units": "m", "level": CONFIG_LEVEL_BASIC,
                "description": "Daytime target depth for DVM"},
            "biology:z_night": {
                "type": "float", "default": -5.0, "min": -10000.0,
                "max": 0.0, "units": "m", "level": CONFIG_LEVEL_BASIC,
                "description": "Nighttime target depth for DVM"},
            "biology:dz_min": {
                "type": "float", "default": 1.0, "min": 0.1, "max": 100.0,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Minimum half-width for depth bands"},
            "biology:dz_rel": {
                "type": "float", "default": 0.1, "min": 0.0, "max": 1.0,
                "units": "fraction", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Relative depth band expansion factor"},
            "biology:dz_max": {
                "type": "float", "default": 15.0, "min": 0.1,
                "max": 1000.0, "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Maximum half-width for depth bands"},
            "egg:hatching_method": {
                "type": "enum", "enum": ["fixed_time"],
                "default": "fixed_time", "level": CONFIG_LEVEL_BASIC,
                "description": "Egg hatching method"},
            "egg:hatch_time_days": {
                "type": "float", "default": 2.0, "min": 0.004, "max": 416.0,
                "units": "days", "level": CONFIG_LEVEL_BASIC,
                "description": "Time to hatching for fixed_time method"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_mixing_at_surface", True)
        self._set_config_default("drift:vertical_advection_at_surface",
                                 True)

    def _band_half_width(self, center):
        """clamp(dz_min, dz_rel*|z|, dz_max) of config scalars
        (reference larvalfish_extended.py:178-187)."""
        dz = self.get_config("biology:dz_rel") * abs(center)
        return min(max(dz, self.get_config("biology:dz_min")),
                   self.get_config("biology:dz_max"))

    @staticmethod
    def _target_into_band(z, center, half_w):
        """(reference larvalfish_extended.py:189-200)."""
        return torch.clamp(z, center - half_w, center + half_w)

    def update_fish_larvae(self, ctx):
        """Fixed-time egg hatching
        (reference larvalfish_extended.py:291-315)."""
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        eggs = d["hatched"] == 0.0
        frac = (dt / 86400.0) / self.get_config("egg:hatch_time_days")
        stage = torch.where(eggs, d["stage_fraction"] + frac,
                            d["stage_fraction"])
        ctx.set_var("stage_fraction", stage)
        ctx.set_var("hatched",
                    torch.where(eggs & (stage >= 1.0), 1.0, d["hatched"]))

    def _apply_vertical_behavior(self, ctx):
        """Active depth keeping or DVM, clipped by swim speed and the
        water column (reference larvalfish_extended.py:206-289)."""
        mode = self.get_config("biology:vertical_behavior_mode")
        if mode == "none":
            return
        w_active = self.get_config("biology:w_active")
        dt = abs(ctx.params["dt"])
        if w_active <= 0.0 or dt <= 0.0:
            return
        d = ctx.state.data
        z = d["z"]
        if self.get_config("biology:particle_type") == "larva":
            active = d["hatched"] == 1.0
        else:
            active = torch.ones_like(z, dtype=torch.bool)

        if mode == "depth":
            z_pref = self.get_config("biology:z_pref")
            target = self._target_into_band(
                z, z_pref, self._band_half_width(z_pref))
        else:  # dvm: day or night from the solar elevation at the element
            start = self.start_time
            sec0 = start.hour * 3600 + start.minute * 60 + start.second
            sec = sec0 + ctx.t_rel
            doy = (start.timetuple().tm_yday - 1
                   + np.floor(sec / np.float32(86400.0))) \
                % np.float32(365.0) + np.float32(1.0)
            minutes = (sec % np.float32(86400.0)) / np.float32(60.0)
            elev = solar_elevation(doy, minutes, d["lon"], d["lat"])
            z_day = self.get_config("biology:z_day")
            z_night = self.get_config("biology:z_night")
            target = torch.where(
                elev > 0.0,
                self._target_into_band(z, z_day,
                                       self._band_half_width(z_day)),
                self._target_into_band(z, z_night,
                                       self._band_half_width(z_night)))

        step = torch.clamp(target - z, -w_active * dt, w_active * dt)
        new_z = torch.clamp_max(z + step, 0.0)
        bottom = -ctx.environment["sea_floor_depth_below_sea_level"]
        new_z = torch.maximum(new_z, bottom)
        ctx.set_var("z", torch.where(active, new_z, z))

    def update(self, ctx):
        """(reference larvalfish_extended.py:321-342)."""
        if self.get_config("biology:particle_type") == "larva":
            self.update_fish_larvae(ctx)
        ctx.advect_ocean_current()
        ctx.stokes_drift()
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        self._apply_vertical_behavior(ctx)
