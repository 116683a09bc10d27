"""Analytic field readers.

Port of the part of ``opendrift_tpu/fields/analytic.py`` the port runs:
``ConstantReader`` (the ``environment:constant:*`` configs),
``DoubleGyre`` (the trajectory golden), ``OscillatingReader`` (the
``oscillating:`` scheme of ``fields/factory.py``) and ``PerElementReader``
(``seed_elements(..., environment={...})``).  Each sampler evaluates its field
at the given positions on their device; the step time ``t`` is a host
float32 scalar, so time-only terms are computed on the host in float32
exactly as the JAX package computes them on the device.  The other
analytic readers raise ``NotImplementedError`` (ROADMAP A.9b).
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


class OscillatingReader(ContinuousReader):
    """Sinusoidally time-varying scalar (reference reader_oscillating.py):
    value = amplitude * sin(2 pi (t - zero_time) / period + phase)."""

    def __init__(self, variable, amplitude, period_seconds=3600.0 * 24,
                 zero_time=None, phase_degrees=0.0):
        self.variables = [variable]
        self._variable = variable
        self.amplitude = float(amplitude)
        self.period = float(period_seconds)
        self.zero_time = zero_time if zero_time is not None else \
            datetime(2000, 1, 1)
        self.phase = math.radians(phase_degrees)
        super().__init__()
        self.name = f"oscillating_{variable}"

    def sample(self, dev_state, varnames, t, lon, lat, z):
        f32 = np.float32
        t_abs = f32(t) + f32(self._t_offset(self.zero_time))
        val = f32(self.amplitude) * np.sin(
            f32(2.0 * math.pi) * t_abs / f32(self.period) + f32(self.phase))
        return ({self._variable: torch.full_like(lon, float(val))},
                torch.ones_like(lon, dtype=torch.bool))


def _later(name):
    """A reader of the JAX package's analytic set that is not ported yet."""
    def init(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP A.9b, GRIB and the "
            "remaining analytic readers)")
    return type(name, (ContinuousReader,), {
        "__init__": init, "__doc__": "Not ported yet (ROADMAP A.9b)."})


ArtificialOceanEddy = _later("ArtificialOceanEddy")
FailingReader = _later("FailingReader")
CurrentFromTrack = _later("CurrentFromTrack")
CurrentFromDrifter = _later("CurrentFromDrifter")
TimeseriesReader = _later("TimeseriesReader")
Constant2DReader = _later("Constant2DReader")


class PerElementReader(ContinuousReader):
    """Constant environment values per element ID (reference:
    reader_constant's ``_parameter_value_map`` with ``element_ID``, used by
    ``seed_elements(..., environment={...})``, basemodel/__init__.py:
    1228-1237).  Values live in a table indexed by element ID; the engine
    passes the IDs as ``member``.  IDs without a value sample NaN, so the
    priority chain falls through to the next reader or the fallback."""

    needs_ids = True

    def __init__(self):
        self.variables = []
        self._chunks = {}          # var -> [(ids, values)]
        super().__init__()
        self.name = "per_element_environment"

    def add(self, variable, ids, values):
        ids = np.asarray(ids, dtype=np.int64)
        values = np.broadcast_to(np.asarray(values, dtype=np.float32),
                                 ids.shape)
        if variable not in self._chunks:
            self._chunks[variable] = []
            self.variables.append(variable)
        self._chunks[variable].append((ids, values.copy()))

    def device_state(self, window_start=None, window_end=None):
        size = 1 + max(int(ids.max()) for lst in self._chunks.values()
                       for ids, _ in lst)
        tables = {}
        for var, lst in self._chunks.items():
            tab = np.full(size + 1, np.nan, dtype=np.float32)
            for ids, vals in lst:
                tab[ids] = vals
            tables[var] = tab
        return tables

    def sample(self, dev_state, varnames, t, lon, lat, z, member=None):
        covers = torch.ones_like(lon, dtype=torch.bool)
        if member is None:
            return {v: torch.full_like(lon, float("nan"))
                    for v in varnames}, covers
        out = {}
        for v in varnames:
            tab = dev_state[v]
            out[v] = tab[torch.clamp(member.to(torch.int64), 0,
                                     tab.shape[0] - 1)]
        return out, covers
