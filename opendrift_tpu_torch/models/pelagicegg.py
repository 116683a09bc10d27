"""PelagicEggDrift: buoyant fish eggs with Sundby/Vikebo terminal velocity.

Port of ``opendrift_tpu/models/pelagicegg.py`` (reference:
opendrift/models/pelagicegg.py:26-193).  The terminal velocity depends on
T and S at the element's depth (``vertical_mixing:TSprofiles`` is on), so
the Visser walk takes OceanDrift's generic per-substep loop.
"""

import numpy as np
import torch

from ..ops import physics as ph
from .oceandrift import OceanDrift, Lagrangian3DArray

G = 9.81


class PelagicEgg(Lagrangian3DArray):
    """Egg element (reference pelagicegg.py:26-43)."""

    variables = Lagrangian3DArray.add_variables([
        ("diameter", {"dtype": np.float32, "units": "m",
                      "default": 0.0014}),          # NEA cod
        ("neutral_buoyancy_salinity", {"dtype": np.float32, "units": "1",
                                       "default": 31.25}),  # NEA cod
        ("density", {"dtype": np.float32, "units": "kg/m^3",
                     "default": 1028.0}),
        ("hatched", {"dtype": np.float32, "units": "1", "default": 0.0}),
    ])


def egg_terminal_velocity(T0, S0, diameter, egg_salinity):
    """Sundby (1983) / Vikebo et al. (2007) terminal velocity with the
    high-Reynolds empirical branch (reference pelagicegg.py:100-179)."""
    DENSw = ph.sea_water_density(T0, S0)
    DENSegg = ph.sea_water_density(T0, egg_salinity)
    dr = DENSw - DENSegg

    mu_w = ph.sea_water_dynamic_viscosity(T0, S0)
    W = (1.0 / mu_w) * (1.0 / 18.0) * G * (diameter * diameter) * dr

    high_re = W * 1000.0 * diameter / mu_w > 0.5
    # empirical branch (cgs units, as in the reference)
    mu_cm = 0.01854 * torch.exp(-0.02783 * T0)  # cm2/s
    safe_dr = torch.where(dr == 0.0, 1e-12, dr)
    d0 = (diameter * 100.0) - 0.4 * torch.pow(
        9.0 * (mu_cm * mu_cm) / (100.0 * G) * DENSw / safe_dr, 1.0 / 3.0)
    W2 = 19.0 * d0 * torch.pow(0.001 * torch.abs(safe_dr), 2.0 / 3.0) \
        * torch.sign(safe_dr) * torch.pow(mu_cm * 0.001 * DENSw, -1.0 / 3.0)
    W2 = W2 / 100.0
    return torch.where(high_re, W2, W)


class PelagicEggDrift(OceanDrift):
    """Buoyant egg trajectory model (reference pelagicegg.py:45)."""

    ElementType = PelagicEgg

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_ice_area_fraction": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
        "sea_floor_depth_below_sea_level": {"fallback": 100},
        "ocean_vertical_diffusivity": {"fallback": 0.02, "profiles": True},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "sea_water_temperature": {"fallback": 10, "profiles": True},
        "sea_water_salinity": {"fallback": 34, "profiles": True},
        "upward_sea_water_velocity": {"fallback": 0},
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("general:coastline_action", "previous")
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_mixing_at_surface", True)
        self._set_config_default("drift:vertical_advection_at_surface",
                                 True)
        self._set_config_default("vertical_mixing:TSprofiles", True)

    def update_terminal_velocity(self, ctx, Tprofiles=None, Sprofiles=None,
                                 zi=None):
        d = ctx.state.data
        w = egg_terminal_velocity(ctx.environment["sea_water_temperature"],
                                  ctx.environment["sea_water_salinity"],
                                  d["diameter"],
                                  d["neutral_buoyancy_salinity"])
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

    def update(self, ctx):
        """(reference pelagicegg.py:181-193)."""
        self.update_terminal_velocity(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        ctx.advect_ocean_current()
        if self.get_config("drift:vertical_advection"):
            self.vertical_advection(ctx)
