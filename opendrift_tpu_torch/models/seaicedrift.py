"""SeaIceDrift: propagation with ocean sea ice.

Port of ``opendrift_tpu/models/seaicedrift.py`` (reference:
opendrift/models/seaicedrift.py:22).
"""

from ..elements import PassiveTracer
from .base import OpenDriftSimulation


class SeaIceDrift(OpenDriftSimulation):
    """Advect passive tracers with sea-ice velocity."""

    ElementType = PassiveTracer
    required_variables = {
        "sea_ice_x_velocity": {"fallback": None},
        "sea_ice_y_velocity": {"fallback": None},
        "sea_ice_area_fraction": {"fallback": None},
        "land_binary_mask": {"fallback": None},
    }

    def update(self, ctx):
        ctx.advect_with_sea_ice()
