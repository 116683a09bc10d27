"""Element (particle) schema and device state.

The port of ``opendrift_tpu/elements/elements.py``.  ``LagrangianArray``
is the pure schema of per-element variables (reference:
opendrift/elements/elements.py:22, ``add_variables`` as at :168).
``ElementState`` is the runtime state: a fixed-capacity structure of
arrays, one torch tensor per variable, all on one device.  Deactivation
is a status flip, never a compaction.
"""

from collections import OrderedDict

import numpy as np
import torch

# Status codes: 0 = active, negatives = not yet released, positives =
# deactivated (terminal), registered per simulation
NOT_RELEASED = -1
ACTIVE = 0
STANDARD_STATUS_CATEGORIES = [
    "active",          # 0
    "stranded",        # 1
    "retired",         # 2
    "outside",         # 3  (left simulation extent / invalid position)
    "missing_data",    # 4
    "seafloor",        # 5
    "died",            # 6  (biological models)
    "evaporated",      # 7  (oil)
    "dispersed",       # 8  (oil)
    "melted",          # 9  (icebergs)
    "grounded",        # 10 (icebergs)
    "hatched",         # 11 (eggs -> larvae transition marker)
    "sedimented",      # 12 (chemical/radionuclide/sediment burial)
]


class LagrangianArray:
    """Schema base class for element types: ``variables`` maps name ->
    spec dict (``dtype``, ``units``, ``default``, ``seed``, ...)."""

    variables = OrderedDict([
        ("ID", {"dtype": np.int32, "units": "1", "seed": False, "default": 0}),
        ("status", {"dtype": np.int32, "units": "1", "seed": False,
                    "default": NOT_RELEASED}),
        ("moving", {"dtype": np.float32, "units": "1", "seed": False,
                    "default": 1.0}),
        ("age_seconds", {"dtype": np.float32, "units": "s", "default": 0.0}),
        ("origin_marker", {"dtype": np.int32, "units": "1", "default": 0,
                           "description": "An integer kept constant over the "
                           "life of an element, to identify different seedings"}),
        ("lon", {"dtype": np.float32, "units": "degrees_east",
                 "standard_name": "longitude", "default": 0.0}),
        ("lat", {"dtype": np.float32, "units": "degrees_north",
                 "standard_name": "latitude", "default": 0.0}),
        ("z", {"dtype": np.float32, "units": "m", "standard_name": "depth",
               "default": 0.0, "description":
               "Depth below sea level (negative downward)"}),
    ])

    @classmethod
    def add_variables(cls, new_variables):
        """Parent's ``variables`` plus extras (reference elements.py:168)."""
        variables = OrderedDict(cls.variables)
        items = new_variables.items() if isinstance(new_variables, dict) \
            else new_variables
        for name, spec in items:
            variables[name] = dict(spec)
        return variables

    @classmethod
    def seedable_variables(cls):
        return [n for n, s in cls.variables.items() if s.get("seed", True)]

    @classmethod
    def default(cls, name):
        return cls.variables[name].get("default", 0.0)


class PassiveTracer(LagrangianArray):
    """Trivial element (reference: opendrift/elements/passivetracer.py)."""
    variables = LagrangianArray.variables


class ElementState:
    """Fixed-capacity structure of arrays: ``data`` maps variable name ->
    tensor whose last axis is the element axis, all on one device:
    (capacity,) for the schema's variables, (C, capacity) for a model's
    per-component arrays (OpenOil's ``mass_components``).  A per-element
    mask of shape (capacity,) broadcasts against either.  Updates are
    functional (``replace`` returns a new state sharing the untouched
    tensors), as in the JAX package."""

    def __init__(self, data):
        self.data = data

    def __getattr__(self, name):
        data = object.__getattribute__(self, "data")
        if name in data:
            return data[name]
        raise AttributeError(name)

    def __getitem__(self, name):
        return self.data[name]

    def replace(self, **updates):
        new = dict(self.data)
        new.update(updates)
        return ElementState(new)

    @property
    def device(self):
        return self.data["lon"].device

    @property
    def capacity(self):
        return self.data["lon"].shape[0]

    @property
    def active(self):
        return self.data["status"] == ACTIVE

    @property
    def released(self):
        return self.data["status"] >= ACTIVE

    def num_active(self):
        return int(self.active.sum())
