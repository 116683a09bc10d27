"""SedimentDrift: sinking particles with seafloor settling and
resuspension.

Port of ``opendrift_tpu/models/sedimentdrift.py`` (reference:
opendrift/models/sedimentdrift.py:28-126).  Its ``bottom_interaction``
overrides a substep hook, so the Visser walk takes OceanDrift's generic
per-substep loop.
"""

import numpy as np
import torch

from ..config import CONFIG_LEVEL_ESSENTIAL
from .oceandrift import OceanDrift, Lagrangian3DArray


class SedimentElement(Lagrangian3DArray):
    variables = Lagrangian3DArray.add_variables([
        ("settled", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("terminal_velocity", {"dtype": np.float32, "units": "m/s",
                               "default": -0.001}),
    ])


class SedimentDrift(OceanDrift):
    """Sediment drift model (reference sedimentdrift.py:39)."""

    ElementType = SedimentElement

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "upward_sea_water_velocity": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_surface_wave_period_at_variance_spectral_density_maximum":
            {"fallback": 0},
        "sea_surface_wave_mean_period_from_variance_spectral_density_"
        "second_frequency_moment": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
        "ocean_vertical_diffusivity": {"fallback": 0.02, "profiles": True},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "vertical_mixing:resuspension_threshold": {
                "type": "float", "default": 0.2, "min": 0, "max": 3,
                "units": "m/s", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Sedimented particles are resuspended if "
                "bottom current speed exceeds this value"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("general:coastline_action", "previous")
        self._set_config_default("drift:vertical_mixing", True)

    def update(self, ctx):
        """(reference sedimentdrift.py:89-106)."""
        ctx.advect_ocean_current()
        self.vertical_advection(ctx)
        ctx.advect_wind()
        ctx.stokes_drift()
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        self.resuspension(ctx)

    def bottom_interaction(self, ctx, mix, zmin):
        """Settle (freeze) elements reaching the seafloor
        (reference sedimentdrift.py:108-116)."""
        settling = (mix["z"] <= zmin) & (mix["moving"] == 1.0)
        mix["moving"] = torch.where(settling, 0.0, mix["moving"])
        return mix

    def resuspension(self, ctx):
        """Resuspend settled elements when bottom currents exceed the
        threshold (reference sedimentdrift.py:118-126)."""
        threshold = self.get_config("vertical_mixing:resuspension_threshold")
        d = ctx.state.data
        resus = (ctx.current_speed() > threshold) & (d["moving"] == 0.0)
        ctx.set_var("moving", torch.where(resus, 1.0, d["moving"]))
        ctx.set_var("z", torch.where(resus, d["z"] + 0.01, d["z"]))
        ctx.set_var("settled", torch.where(d["moving"] == 0.0, 1.0, 0.0))
