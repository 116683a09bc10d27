"""Oil-property database interface.

Port of ``opendrift_tpu/models/openoil/oil_db.py`` (reference:
opendrift/models/openoil/adios/oil.py:48-190 ``OpendriftOil``): the
package's own copy of ``oils_db.json.xz`` holds per-oil pseudo-component
properties; this module exposes them with the temperature-dependent
property evaluations used by the weathering, on torch tensors.  A
temperature given as a Python float gives a Python float back (seeding);
a float32 tensor gives a float32 tensor on its device.
"""

import json
import lzma
import math
import os
from functools import lru_cache

import numpy as np
import torch

ATMOS_PRESSURE = 101325.0
GAS_CONSTANT = 8.314


@lru_cache(maxsize=1)
def _load_db():
    path = os.path.join(os.path.dirname(__file__), "oils_db.json.xz")
    with lzma.open(path, "rt") as f:
        return json.load(f)


def get_oil_names(location=None):
    return [o["name"] for o in _load_db()["oils"]]


def find_oil(name):
    for o in _load_db()["oils"]:
        if o["name"] == name or o["id"] == name:
            return o
    raise ValueError(f"Oil '{name}' not found in database "
                     f"({len(_load_db()['oils'])} oils available)")


class OilType:
    """One oil with derived thermophysical property evaluations."""

    def __init__(self, name):
        rec = find_oil(name)
        self.name = rec["name"]
        self.id = rec["id"]
        self.api = rec["api"]
        self.density_ref = rec["density_ref"]
        self.density_ref_temp = rec["density_ref_temp"]
        self.kvis_ref = rec["kvis_ref"]
        self.kvis_ref_temp = rec["kvis_ref_temp"]
        self.kvis_k = rec["kvis_k"]
        self.mass_fraction = np.asarray(rec["mass_fraction"], np.float32)
        self.boiling_point = np.asarray(rec["boiling_point"], np.float32)
        self.molecular_weight = np.asarray(rec["molecular_weight"],
                                           np.float32)
        self.bullwinkle_fraction = rec["bullwinkle_fraction"]
        self.bullwinkle_time = -999.0
        self.emulsion_water_fraction_max = rec["emulsion_water_fraction_max"]
        self.max_water_fraction_sintef = rec.get("max_water_fraction_sintef")

    # -- temperature-dependent bulk properties -----------------------------
    def density_at_temp(self, T):
        """Thermal expansion ~8e-4/K around the reference density
        (standard GNOME approximation)."""
        k_rho = 8.0e-4
        return self.density_ref / (1.0 + k_rho * (T - self.density_ref_temp))

    def kvis_at_temp(self, T):
        """nu(T) = nu_ref * exp(k (1/T - 1/T_ref))."""
        arg = self.kvis_k * (1.0 / T - 1.0 / self.kvis_ref_temp)
        return self.kvis_ref * (torch.exp(arg) if torch.is_tensor(arg)
                                else math.exp(arg))

    def vapor_pressure(self, T):
        """Per-component vapor pressure [Pa] at temperatures T [K]
        (Antoine-type estimate from boiling points, as the reference's
        old-oil-library method, adios/oil.py:143-169).
        Returns shape (C,) + T.shape."""
        T = torch.as_tensor(T, dtype=torch.float32)
        bp = torch.as_tensor(self.boiling_point, device=T.device)[
            (slice(None),) + (None,) * T.ndim]
        D_Zb = 0.97
        R_cal = 1.987
        D_S = 8.75 + 1.987 * torch.log(bp)
        C_2i = 0.19 * bp - 18.0
        var = 1.0 / (bp - C_2i) - 1.0 / (T - C_2i)
        d = bp - C_2i
        ln_p = D_S * (d * d) / (D_Zb * R_cal * bp) * var
        return torch.exp(ln_p) * ATMOS_PRESSURE

    def oil_water_surface_tension(self):
        """Interfacial tension from API [N/m] (ADIOS estimation)."""
        api = self.api if self.api > 0 else 30.0
        return max(1e-3, 0.001 * (39.0 - 0.2571 * api))

    def __repr__(self):
        return f"OilType({self.name!r}, API={self.api})"
