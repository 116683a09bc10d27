"""Template for implementing a new drift model on opendrift_tpu_torch.

Port of ``opendrift_tpu/models/model_template.py``.  Copy this file,
rename the classes, and fill in the physics.  The structure mirrors the
reference's template (reference: opendrift/models/model_template.py:
36-241).  ``update()`` runs eagerly on the simulation's device each step,
on whole tensors; the rules:

* every element property and environment variable is a tensor over all
  the elements (seeded, active or not);
* no Python ``if`` on data values (it would wait for the card) — use
  ``torch.where(cond, a, b)``;
* no loops over elements — operations are vectorised;
* randomness comes from ``ctx.next_key()`` and ``rng`` (counter-based
  threefry, so reruns with the same seed are bit-identical, and equal to
  the JAX package's draws);
* config values read via ``self.get_config`` are Python scalars —
  branching on them is free.
"""

import numpy as np

from ..config import CONFIG_LEVEL_ESSENTIAL
from .oceandrift import OceanDrift, Lagrangian3DArray


class TemplateElement(Lagrangian3DArray):
    """Element state: add per-particle properties here.

    Each becomes a float32/int32 tensor of shape (N,) on the device.
    ``seed:True`` properties can be set per-element at seeding time:
    ``o.seed_elements(..., my_property=1.5)``."""

    variables = Lagrangian3DArray.add_variables([
        ("my_property", {
            "dtype": np.float32, "units": "1", "default": 0.0,
            "seed": True,
            "description": "Example per-element scalar"}),
    ])


class ModelTemplate(OceanDrift):
    """Skeleton drift model.

    Inherits OceanDrift's advection, vertical mixing, stranding and
    seeding machinery; override/extend only what your physics needs."""

    ElementType = TemplateElement

    # Environment variables the model needs.  ``fallback`` is used where
    # no reader covers an element; ``profiles: True`` requests a vertical
    # profile for the mixing loop.
    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "ocean_vertical_diffusivity": {"fallback": 0.01, "profiles": True},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "template:my_setting": {
                "type": "float", "default": 1.0, "min": 0.0, "max": 10.0,
                "units": "1", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Example model parameter"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # change inherited defaults here
        self._set_config_default("drift:vertical_mixing", False)

    # ------------------------------------------------------------------
    # The physics step.  ``ctx`` (StepContext) carries:
    #   ctx.state.data       dict of element tensors (read);
    #   ctx.set_var(k, v)    write an element array;
    #   ctx.environment[k]   environment arrays at element positions;
    #   ctx.dt               signed step seconds (negative = backwards);
    #   ctx.next_key()       fresh PRNG key;
    #   helpers: advect_ocean_current/advect_wind/stokes_drift/
    #            vertical_advection/vertical_mixing/update_positions...
    # ------------------------------------------------------------------
    def update(self, ctx):
        ctx.advect_ocean_current()          # currents (Euler/RK2/RK4)
        ctx.advect_wind()                   # windage
        # example custom physics: linear growth of my_property
        rate = self.get_config("template:my_setting")
        d = ctx.state.data
        ctx.set_var("my_property",
                    d["my_property"] + rate * ctx.dt / 3600.0)
