"""PlastDrift: microplastics with wind-mixing depth equilibrium.

Port of ``opendrift_tpu/models/plastdrift.py`` (reference:
opendrift/models/plastdrift.py:23-107).  With the default 'analytical'
mixing model each step draws the equilibrium depth z ~ -Exp(K/w) with
``rng.exponential``; with 'randomwalk' the step runs OceanDrift's Visser
walk, which on PlastDrift's defaults (windspeed_Sundby1983, every hook at
its base implementation) is the windspeed mixing kernel K1
(``ops/mixing.visser_mixing``).
"""

import numpy as np
import torch

from .. import rng
from ..config import CONFIG_LEVEL_ADVANCED
from .oceandrift import OceanDrift, Lagrangian3DArray


class PlastElement(Lagrangian3DArray):
    variables = Lagrangian3DArray.add_variables([
        ("terminal_velocity", {
            "dtype": np.float32, "units": "m/s", "default": 0.01,
            "description": "Positive value means rising particles "
            "(positive buoyancy)"}),
    ])


class PlastDrift(OceanDrift):
    """Microplastic drift with currents, Stokes drift and windage
    (reference plastdrift.py:32)."""

    ElementType = PlastElement

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "ocean_vertical_diffusivity": {"fallback": 0.02, "profiles": True},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "vertical_mixing:mixingmodel": {
                "type": "enum", "enum": ["randomwalk", "analytical"],
                "default": "analytical", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Vertical turbulent mixing scheme"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_advection", True)
        self._set_config_default("drift:use_tabularised_stokes_drift", True)
        self._set_config_default("general:coastline_action", "previous")
        self._set_config_default("vertical_mixing:diffusivitymodel",
                                 "windspeed_Sundby1983")

    def update(self, ctx):
        """(reference plastdrift.py:80-93)."""
        ctx.advect_ocean_current()
        self.update_particle_depth(ctx)
        ctx.stokes_drift()
        ctx.advect_wind()

    def update_particle_depth(self, ctx):
        """(reference plastdrift.py:95-107): the random walk, or the
        analytical exponential equilibrium depth z ~ -Exp(K/w)."""
        if not self.get_config("drift:vertical_mixing"):
            return
        if self.get_config("vertical_mixing:mixingmodel") == "randomwalk":
            self.vertical_mixing(ctx)
            return
        d = ctx.state.data
        K = ctx.environment["ocean_vertical_diffusivity"]
        w = torch.clamp_min(d["terminal_velocity"], 1e-8)
        draw = rng.exponential(ctx.next_key(), tuple(d["z"].shape),
                               d["z"].device)
        ctx.set_var("z", -draw * (K / w))
