"""Legacy model zoo: OpenHNS and OpenBergOld.

Port of ``opendrift_tpu/models/legacy.py``, the counterparts of the
reference's legacy models (reference:
opendrift/models/legacy/openhns.py:31-258, legacy/openberg_old.py).
``OpenHNS`` (hazardous & noxious substances) is re-implemented with
vectorised Bernoulli state transitions; ``OpenBergOld`` is a deprecated
alias for the port's :class:`~opendrift_tpu_torch.models.openberg.OpenBerg`
(the reference's old iceberg model is superseded by the force-balance
one and kept only for backwards-compatible imports).
"""

import logging
import warnings

import numpy as np
import torch

from .. import rng
from ..config import CONFIG_LEVEL_ESSENTIAL
from .oceandrift import OceanDrift, Lagrangian3DArray
from .openberg import OpenBerg

logger = logging.getLogger(__name__)


class HNSElement(Lagrangian3DArray):
    """(reference legacy/openhns.py:31-92)."""
    variables = Lagrangian3DArray.add_variables([
        ("mass", {"dtype": np.float32, "units": "kg", "default": 1.0}),
        ("mass_evaporated", {"dtype": np.float32, "units": "kg",
                             "default": 0.0}),
        ("mass_dissolved", {"dtype": np.float32, "units": "kg",
                            "default": 0.0}),
        ("viscosity", {"dtype": np.float32, "units": "Pa s",
                       "default": 0.005}),
        ("density", {"dtype": np.float32, "units": "kg/m^3",
                     "default": 880.0}),
        ("wind_drift_factor", {"dtype": np.float32, "units": "1",
                               "default": 0.03, "seed": True}),
        ("terminal_velocity", {"dtype": np.float32, "units": "m/s",
                               "default": 0.0}),
    ])


class OpenHNS(OceanDrift):
    """HNS drift: surface elements evaporate (then ride the wind fully)
    or dissolve (then submerge) by per-step Bernoulli transitions
    (reference legacy/openhns.py:94-258)."""

    ElementType = HNSElement

    hns_types = {
        "butyl": {"evaporation_rate": 0.03, "dissolution_rate": 0.05},
        "acetone": {"evaporation_rate": 0.16, "dissolution_rate": 0.01},
        "xylene": {"evaporation_rate": 0.25, "dissolution_rate": 0.1},
    }

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "upward_sea_water_velocity": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_water_temperature": {"fallback": 10, "profiles": True},
        "sea_water_salinity": {"fallback": 34, "profiles": True},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "ocean_vertical_diffusivity": {"fallback": 0.02,
                                       "profiles": True},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "sea_ice_area_fraction": {"fallback": 0},
        "sea_ice_x_velocity": {"fallback": 0},
        "sea_ice_y_velocity": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "seed:hns_type": {
                "type": "enum", "enum": list(self.hns_types),
                "default": "butyl", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "HNS type for the simulation"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_advection", False)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:current_uncertainty", 0.05)
        self._set_config_default("drift:wind_uncertainty", 0.5)

    def seed_elements(self, *args, hns_type=None, **kwargs):
        if hns_type is not None:
            self.set_config("seed:hns_type", hns_type)
        super().seed_elements(*args, **kwargs)

    def _phase_changes(self, ctx):
        """Surface Bernoulli transitions (reference openhns.py:231-249):
        evaporated mass lofts to +10 m with full windage; dissolved mass
        submerges to -10 m with zero windage."""
        hns = self.hns_types[self.get_config("seed:hns_type")]
        d = ctx.state.data
        at_surface = (d["z"] >= 0.0) & ctx.active & (d["mass"] > 0)
        shape, device = tuple(d["z"].shape), d["z"].device
        u = rng.uniform(ctx.next_key(), shape, device=device)
        evap = at_surface & (u > 1.0 - hns["evaporation_rate"])
        u2 = rng.uniform(ctx.next_key(), shape, device=device)
        diss = at_surface & ~evap & (u2 > 1.0 - hns["dissolution_rate"])
        ctx.set_var("wind_drift_factor",
                    torch.where(evap, 1.0,
                              torch.where(diss, 0.0,
                                        d["wind_drift_factor"])))
        ctx.set_var("mass_evaporated",
                    d["mass_evaporated"] + torch.where(evap, d["mass"], 0.0))
        ctx.set_var("mass_dissolved",
                    d["mass_dissolved"] + torch.where(diss, d["mass"], 0.0))
        ctx.set_var("mass",
                    torch.where(evap | diss, 0.0, d["mass"]))
        ctx.set_var("z", torch.where(evap, 10.0,
                                   torch.where(diss, -10.0, d["z"])))

    def update(self, ctx):
        self._phase_changes(ctx)
        ctx.advect_ocean_current()
        ctx.stokes_drift()
        ctx.advect_wind()


class OpenBergOld(OpenBerg):
    """Deprecated: kept for import compatibility; use OpenBerg
    (reference legacy/openberg_old.py is superseded by openberg.py)."""

    def __init__(self, *args, **kwargs):
        warnings.warn("OpenBergOld is deprecated; using the modern "
                      "OpenBerg force-balance model", DeprecationWarning,
                      stacklevel=2)
        super().__init__(*args, **kwargs)


def gls_tke(windstress, depths, sea_water_density, tke,
            generic_length_scale, gls_parameters=None):
    """Generic-length-scale TKE vertical diffusivity profile (reference:
    opendrift/legacy.py:5-46, from LADiM, for ROMS k-omega closure
    output).  Returns K of shape (len(depths), N), float32 tensors in, on
    their device: interior diffusivity from the GLS dissipation relation
    plus a wave-enhanced surface layer scaled by the waterside friction
    velocity cubed."""
    g = 9.81
    f0 = 0.1   # mean wave frequency
    c_w = 4.0  # wave mixing parameter
    c_i = 0.2  # interior coefficient
    if gls_parameters is None:
        p, m, n = 0.0, 1.0, 1.0
        cmu0 = 0.5477  # KANTHA_CLAYSON stability function
    else:
        p = gls_parameters["gls_p"]
        m = gls_parameters["gls_m"]
        n = gls_parameters["gls_n"]
        cmu0 = gls_parameters["gls_cmu0"]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)
    windstress, tke = f32(windstress), f32(tke)
    gls, rho = f32(generic_length_scale), f32(sea_water_density)

    phi = 100.0 * (windstress / rho) ** 1.5
    eps = cmu0 ** (3.0 + p / n) * tke ** (1.5 + m / n) * gls ** (-1.0 / n)
    l_i = c_i * tke ** 1.5 / torch.clamp_min(eps, 1e-12)
    ki = c_i * torch.sqrt(2.0 * tke) * l_i
    l_w = torch.sqrt(phi / (g * f0))
    kwave = c_w * torch.sqrt(2.0 * tke) * l_w
    kmix = ki + kwave
    return kmix.expand((len(depths),) + tuple(kmix.shape))
