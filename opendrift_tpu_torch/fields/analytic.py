"""Analytic field readers.

Port of the part of ``opendrift_tpu/fields/analytic.py`` this slice
needs: ``ConstantReader`` (the ``environment:constant:*`` configs) and
``DoubleGyre`` (the trajectory golden).  Each sampler evaluates its field
at the given positions on their device; the step time ``t`` is a host
float32 scalar, so time-only terms are computed on the host in float32
exactly as the JAX package computes them on the device.  The other
analytic readers come with ROADMAP A.3's remainder.
"""

import math
from datetime import datetime

import numpy as np
import torch

from .base import ContinuousReader
from ..utils.xp import tnp


class DoubleGyre(ContinuousReader):
    """Time-dependent double gyre (Shadden's LCS benchmark flow), on a
    spherical stereographic plane as in the reference
    (reader_double_gyre.py:30-79)."""

    variables = ["x_sea_water_velocity", "y_sea_water_velocity",
                 "land_binary_mask"]
    proj4 = ("+proj=stere +lat_0=0 +lon_0=0 +lat_ts=0 "
             "+units=m +a=6.371e+06 +e=0 +no_defs")
    xmin, xmax, ymin, ymax = 0.0, 2.0, 0.0, 1.0

    def __init__(self, initial_time=datetime(2000, 1, 1, 0, 0),
                 epsilon=0.1, omega=0.628, A=0.25, proj4=None):
        if proj4 is not None:
            self.proj4 = proj4
        self.initial_time = initial_time
        self.epsilon = float(epsilon)
        self.omega = float(omega)
        self.A = float(A)
        super().__init__()
        self.name = "double_gyre"

    def sample(self, dev_state, varnames, t, lon, lat, z):
        x, y = self.crs.fwd(tnp, lon, lat)
        t_abs = np.float32(t) + self._t_offset(self.initial_time)
        a = np.float32(self.epsilon) * np.sin(np.float32(self.omega) * t_abs)
        b = np.float32(1.0) - np.float32(2.0) * a
        a, b = float(a), float(b)
        f = a * x * x + b * x
        dfdx = 2.0 * a * x + b
        pi = math.pi
        u = -pi * self.A * torch.sin(pi * f) * torch.cos(pi * y)
        v = pi * self.A * torch.cos(pi * f) * torch.sin(pi * y) * dfdx
        values = {}
        for name in varnames:
            if name == "x_sea_water_velocity":
                values[name] = u
            elif name == "y_sea_water_velocity":
                values[name] = v
            elif name == "land_binary_mask":
                values[name] = torch.zeros_like(x)
        covers = ((x >= self.xmin) & (x <= self.xmax)
                  & (y >= self.ymin) & (y <= self.ymax))
        return values, covers


class ConstantReader(ContinuousReader):
    """Fixed values for a set of variables (reference reader_constant.py)."""

    def __init__(self, parameter_value_map, name=None):
        self._values = {k: float(v) for k, v in parameter_value_map.items()}
        self.variables = list(self._values)
        super().__init__()
        self.name = name if name is not None else "constant_reader"

    def sample(self, dev_state, varnames, t, lon, lat, z):
        values = {v: torch.full_like(lon, self._values[v]) for v in varnames}
        return values, torch.ones_like(lon, dtype=torch.bool)
