"""WindBlow: minimal atmospheric drift model.

Port of ``opendrift_tpu/models/windblow.py`` (reference:
opendrift/models/windblow.py:22).
"""

from ..elements import PassiveTracer
from .base import OpenDriftSimulation


class WindBlow(OpenDriftSimulation):
    """Advect passive tracers with the ambient wind."""

    ElementType = PassiveTracer
    required_variables = {
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:max_speed", 25)

    def update(self, ctx):
        ctx.update_positions(ctx.environment["x_wind"],
                             ctx.environment["y_wind"])
