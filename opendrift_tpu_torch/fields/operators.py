"""Reader algebra: combine readers with arithmetic and blending.

Port of ``opendrift_tpu/fields/operators.py`` (reference:
opendrift/readers/operators/readerops.py:15-144, ops.py:9-92): a combined
reader samples both operands on the device and merges the values —
``a + b``, ``a - b``, scalar scaling and shifting, and gaussian blending
of an observation into a background field.  Its device state is the tuple
of its operands' states.
"""

import torch

from .base import BaseReader


class CombinedReader(BaseReader):
    """Element-wise combination of two readers (same variables)."""

    def __init__(self, a, b, op):
        self.a = a
        self.b = b
        self.op = op
        self.variables = [v for v in (a.variables or [])
                          if v in (b.variables or [])]
        self.always_valid = a.always_valid and b.always_valid
        self.start_time = a.start_time or b.start_time
        self.end_time = a.end_time or b.end_time
        super().__init__()
        self.name = f"combined({a.name} {op.__name__} {b.name})"

    def set_run_epoch(self, epoch):
        super().set_run_epoch(epoch)
        self.a.set_run_epoch(epoch)
        self.b.set_run_epoch(epoch)

    def prepare(self, **kwargs):
        self.a.prepare(**kwargs)
        self.b.prepare(**kwargs)

    def device_state(self, window_start=None, window_end=None):
        return (self.a.device_state(window_start, window_end),
                self.b.device_state(window_start, window_end))

    def sample(self, dev_state, varnames, t, lon, lat, z):
        va, ca = self.a.sample(dev_state[0], varnames, t, lon, lat, z)
        vb, cb = self.b.sample(dev_state[1], varnames, t, lon, lat, z)
        out = {v: self.op(va[v], vb[v]) for v in varnames}
        return out, ca & cb


class ScaledReader(BaseReader):
    """A reader multiplied by and shifted with scalars."""

    def __init__(self, a, scale=1.0, offset=0.0):
        self.a = a
        self.scale = float(scale)
        self.offset = float(offset)
        self.variables = list(a.variables or [])
        self.always_valid = a.always_valid
        self.start_time = a.start_time
        self.end_time = a.end_time
        super().__init__()
        self.name = f"scaled({a.name} * {scale} + {offset})"

    def set_run_epoch(self, epoch):
        super().set_run_epoch(epoch)
        self.a.set_run_epoch(epoch)

    def prepare(self, **kwargs):
        self.a.prepare(**kwargs)

    def device_state(self, window_start=None, window_end=None):
        return self.a.device_state(window_start, window_end)

    def sample(self, dev_state, varnames, t, lon, lat, z):
        vals, cov = self.a.sample(dev_state, varnames, t, lon, lat, z)
        return {v: vals[v] * self.scale + self.offset for v in varnames}, \
            cov


class GaussianBlendReader(BaseReader):
    """Blend a local observation reader into a background field with a
    gaussian weight around a centre point (reference operators/ops.py
    gaussian measurement mixing)."""

    def __init__(self, background, observation, lon0, lat0, radius_m):
        self.bg = background
        self.obs = observation
        self.lon0 = float(lon0)
        self.lat0 = float(lat0)
        self.radius = float(radius_m)
        self.variables = [v for v in (background.variables or [])
                          if v in (observation.variables or [])]
        self.always_valid = background.always_valid
        self.start_time = background.start_time
        self.end_time = background.end_time
        super().__init__()
        self.name = f"blend({background.name}, {observation.name})"

    def set_run_epoch(self, epoch):
        super().set_run_epoch(epoch)
        self.bg.set_run_epoch(epoch)
        self.obs.set_run_epoch(epoch)

    def prepare(self, **kwargs):
        self.bg.prepare(**kwargs)
        self.obs.prepare(**kwargs)

    def device_state(self, window_start=None, window_end=None):
        return (self.bg.device_state(window_start, window_end),
                self.obs.device_state(window_start, window_end))

    def sample(self, dev_state, varnames, t, lon, lat, z):
        vb, cb = self.bg.sample(dev_state[0], varnames, t, lon, lat, z)
        vo, co = self.obs.sample(dev_state[1], varnames, t, lon, lat, z)
        # gaussian weight on a local flat-earth distance
        dx = (lon - self.lon0) * 111320.0 * torch.cos(torch.deg2rad(lat))
        dy = (lat - self.lat0) * 111320.0
        w = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * self.radius ** 2))
        w = torch.where(co, w, 0.0)
        out = {v: vb[v] * (1.0 - w) + vo[v] * w for v in varnames}
        return out, cb


def combine_add(a, b):
    return CombinedReader(a, b, torch.add)


def combine_sub(a, b):
    return CombinedReader(a, b, torch.subtract)
