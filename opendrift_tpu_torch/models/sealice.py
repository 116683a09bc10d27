"""SeaLice: salmon-louse larvae (Lepeophtheirus salmonis) behaviour.

Port of ``opendrift_tpu/models/sealice.py`` (reference:
opendrift/models/sealice.py:24-393): super-individual population dynamics
(nauplii hatching, maturation into copepodids after a degree-day
threshold, mortality), light-, salinity- and temperature-triggered
vertical migration and sinking, as elementwise updates of the element
state.  Sensing samples the environment above and below each element (two
extra ``get_environment`` calls a step).
"""

import numpy as np
import torch

from ..config import CONFIG_LEVEL_BASIC, CONFIG_LEVEL_ADVANCED
from .oceandrift import OceanDrift, Lagrangian3DArray


class SeaLiceElement(Lagrangian3DArray):
    """(reference sealice.py:24-70)."""

    variables = Lagrangian3DArray.add_variables([
        ("LicePerFish", {"dtype": np.float32, "units": "1", "default": 0.5}),
        ("AvFishW8", {"dtype": np.float32, "units": "kg", "default": 4.5}),
        ("particle_biomass", {"dtype": np.float32, "units": "kg",
                              "default": 1000.0}),
        ("hatched", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("nauplii", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("copepodid", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("dead", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("degree_days", {"dtype": np.float32, "units": "degC days",
                         "default": 0.0}),
        ("light", {"dtype": np.float32,
                   "units": "umol photon s-1 m-2", "default": 0.0}),
        ("eliminated", {"dtype": np.int32, "units": "1", "seed": False,
                        "default": 0}),
        ("safe_salinity_above", {"dtype": np.int32, "units": "1",
                                 "seed": False, "default": 0}),
        ("temperature_above", {"dtype": np.float32, "units": "degC",
                               "seed": False, "default": 0.0}),
        ("temperature_below", {"dtype": np.float32, "units": "degC",
                               "seed": False, "default": 0.0}),
    ])


class SeaLice(OceanDrift):
    """Sea-lice larvae model (reference sealice.py:73)."""

    ElementType = SeaLiceElement

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
        "sea_floor_depth_below_sea_level": {"fallback": 50},
        "surface_net_downward_radiative_flux": {"fallback": 0},
        "ocean_vertical_diffusivity": {"fallback": 0.01},
        "sea_water_temperature": {"fallback": 10},
        "sea_water_salinity": {"fallback": 34},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "lice:death_rate": {
                "type": "float", "default": 0.01 / 3600, "min": 0,
                "max": 1.0, "units": "s-1", "level": CONFIG_LEVEL_BASIC,
                "description": "Larvae mortality rate"},
            "lice:maturation_rate": {
                "type": "float", "default": 0.1 / 3600, "min": 0,
                "max": 1.0, "units": "s-1", "level": CONFIG_LEVEL_BASIC,
                "description": "Nauplii -> copepodid maturation rate"},
            "lice:maturity_date": {
                "type": "float", "default": 3.63, "min": 0, "max": 100,
                "units": "days", "level": CONFIG_LEVEL_BASIC,
                "description": "Days before maturation starts"},
            "lice:sinking_velocity": {
                "type": "float", "default": 0.00025, "min": 0, "max": 0.01,
                "units": "m/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Passive larvae sinking velocity"},
            "lice:vertical_migration_speed": {
                "type": "float", "default": 0.00075, "min": 0, "max": 0.01,
                "units": "m/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Active larvae swim speed"},
            "lice:freezing_salinity": {
                "type": "float", "default": 27.0, "min": 0, "max": 35,
                "units": "PSU", "level": CONFIG_LEVEL_BASIC,
                "description": "Salinity immobilising larvae"},
            "lice:avoided_salinity": {
                "type": "float", "default": 32.0, "min": 0, "max": 50,
                "units": "PSU", "level": CONFIG_LEVEL_BASIC,
                "description": "Salinity actively avoided"},
            "lice:k_water": {
                "type": "float", "default": 0.2, "min": 0, "max": 10,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Exponential light-decay coefficient"},
            "lice:Nauplii_light_trigger": {
                "type": "float", "default": 2.0e-5, "min": 0, "max": 1,
                "units": "umol photon s-1 m-2",
                "level": CONFIG_LEVEL_BASIC,
                "description": "Nauplii light detection threshold"},
            "lice:Copepodid_light_trigger": {
                "type": "float", "default": 0.392, "min": 0, "max": 1,
                "units": "umol photon s-1 m-2",
                "level": CONFIG_LEVEL_BASIC,
                "description": "Copepodid light detection threshold"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_status("died")
        self._set_config_default("drift:vertical_mixing", False)

    # ----------------------------------------------------------- biology --
    def population(self, ctx):
        """Super-individual population dynamics: hatching numbers from
        biomass (Rittenhouse 2016: NP = eta*eps*nu*A), exponential
        mortality, degree-day-gated maturation
        (reference sealice.py:200-275)."""
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        T = ctx.environment["sea_water_temperature"]

        # the cohort at hatching: eggs per clutch * egg-string rate *
        # hatching success * adult females on the biomass
        eta, eps, nu_h = 592.0, 0.0476 / 86400.0, 0.6
        adults = d["particle_biomass"] / torch.clamp_min(d["AvFishW8"],
                                                         1e-6) \
            * d["LicePerFish"]
        fresh = d["hatched"] == 0.0
        n0 = eta * eps * nu_h * adults * dt
        ctx.set_var("nauplii", torch.where(fresh, n0, d["nauplii"]))
        ctx.set_var("hatched", torch.ones_like(d["hatched"]))
        d = ctx.state.data

        # degree-day accumulation (reference sealice.py:293-302)
        ctx.set_var("degree_days", d["degree_days"] + T * dt / 86400.0)

        death = self.get_config("lice:death_rate") * dt
        mature_rate = self.get_config("lice:maturation_rate") * dt
        mature_age = self.get_config("lice:maturity_date")
        can_mature = d["age_seconds"] >= mature_age * 86400.0
        matured = torch.where(can_mature, d["nauplii"] * mature_rate, 0.0)
        naup = d["nauplii"] * (1.0 - death) - matured
        cope = d["copepodid"] * (1.0 - death) + matured
        died = d["dead"] + (d["nauplii"] + d["copepodid"]) * death
        ctx.set_var("nauplii", torch.clamp_min(naup, 0.0))
        ctx.set_var("copepodid", torch.clamp_min(cope, 0.0))
        ctx.set_var("dead", died)
        # an exhausted super-individual is deactivated (reference
        # sealice.py:272-273 marks 'eliminated', then deactivates)
        exhausted = (naup + cope) < 1e-3 * torch.clamp_min(died, 1.0)
        ctx.set_var("eliminated", torch.where(
            exhausted, 1, ctx.state.data["eliminated"]))
        ctx.deactivate_elements(exhausted, "died")

    def irradiance(self, ctx):
        """Light at the element's depth from the surface radiative flux,
        decaying exponentially (reference sealice.py:320-340)."""
        d = ctx.state.data
        flux = ctx.environment["surface_net_downward_radiative_flux"]
        # W/m2 -> umol photon/s/m2 (about 4.6 umol/J of PAR)
        surface_light = torch.clamp_min(flux, 0.0) * 4.6 * 0.45
        k = self.get_config("lice:k_water")
        light = surface_light * torch.exp(k * d["z"])  # z negative down
        ctx.set_var("light", light)
        return light

    def sensing(self, ctx):
        """Sense T and S a small distance above and below the element
        (reference sealice.py:277-291 displaces z but reads the already
        fetched environment; here the displaced samples are real
        environment fetches)."""
        d = ctx.state.data
        # sensing distance: twice the migration distance of a step
        # (reference sealice.py:169-172)
        sense = 2.0 * self.get_config("lice:vertical_migration_speed") \
            * abs(ctx.params["dt"])
        varnames = ["sea_water_temperature", "sea_water_salinity"]
        up, _ = self.env.get_environment(
            ctx.dev_states, varnames, ctx.t_rel, d["lon"], d["lat"],
            torch.clamp_max(d["z"] + sense, 0.0))
        dn, _ = self.env.get_environment(
            ctx.dev_states, varnames, ctx.t_rel, d["lon"], d["lat"],
            d["z"] - sense)
        s_avoid = self.get_config("lice:avoided_salinity")
        ctx.set_var("safe_salinity_above",
                    (up["sea_water_salinity"] > s_avoid).to(torch.int32))
        ctx.set_var("temperature_above", up["sea_water_temperature"])
        ctx.set_var("temperature_below", dn["sea_water_temperature"])

    def lice_vertical_migration(self, ctx, light):
        """Salinity-, light- and temperature-triggered swimming against
        passive sinking (reference sealice.py:342-384): all lice sink;
        those in acceptable salinity swim up towards light, or follow the
        warmer of the sensed layers; lice in the fresh-water avoidance
        band dive."""
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        S = ctx.environment["sea_water_salinity"]
        T = ctx.environment["sea_water_temperature"]
        s_freeze = self.get_config("lice:freezing_salinity")
        s_avoid = self.get_config("lice:avoided_salinity")
        swim = self.get_config("lice:vertical_migration_speed") * dt
        sink = self.get_config("lice:sinking_velocity") * dt

        avoiding = (S >= s_freeze) & (S < s_avoid)
        normal = S >= s_avoid
        safe_up = normal & (d["safe_salinity_above"] > 0)
        is_cope = d["copepodid"] > d["nauplii"]
        trigger = torch.where(
            is_cope, self.get_config("lice:Copepodid_light_trigger"),
            self.get_config("lice:Nauplii_light_trigger"))
        light_mig = safe_up & (light > trigger)
        up_temp = safe_up & ~light_mig & (d["temperature_above"] > T)
        down_temp = normal & ~up_temp & ~light_mig \
            & (d["temperature_below"] > T)

        going_up = light_mig | up_temp
        going_down = avoiding | down_temp
        # base sinking for everyone, then active migration on top
        # (reference :346-384)
        dz = -sink + torch.where(going_up, swim, 0.0) \
            - torch.where(going_down, swim, 0.0)
        # the natural larval range is 0-50 m (reference depth_test,
        # sealice.py:334-339), further bounded by the seafloor
        depth = ctx.environment["sea_floor_depth_below_sea_level"]
        new_z = torch.clamp_max(torch.maximum(
            d["z"] + dz, -torch.clamp_max(depth, 50.0)), 0.0)
        ctx.set_var("z", new_z)

    def update(self, ctx):
        """(reference sealice.py:386-393)."""
        self.population(ctx)
        self.sensing(ctx)
        light = self.irradiance(ctx)
        ctx.advect_ocean_current()
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        self.lice_vertical_migration(ctx, light)
