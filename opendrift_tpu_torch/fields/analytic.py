"""Analytic field readers.

Port of ``opendrift_tpu/fields/analytic.py``: ``ConstantReader`` (the
``environment:constant:*`` configs), ``DoubleGyre`` (the trajectory
golden), ``OscillatingReader`` (the ``oscillating:`` scheme of
``fields/factory.py``), ``PerElementReader`` (``seed_elements(...,
environment={...})``), ``ArtificialOceanEddy``, ``FailingReader``,
``CurrentFromTrack``, ``CurrentFromDrifter``, ``TimeseriesReader`` and
``Constant2DReader``.  Each sampler evaluates its field at the given
positions on their device; the step time ``t`` is a host float32 scalar,
so time-only terms are computed on the host in float32 exactly as the JAX
package computes them on the device (the track, drifter and time-series
readers pick their segment and interpolate their series there too).
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


class ArtificialOceanEddy(ContinuousReader):
    """Stationary cyclonic eddy on a stereographic plane (reference:
    opendrift/readers/reader_ArtificialOceanEddy.py): azimuthal speed
    peaking at radius ``eta0`` from the eddy centre."""

    variables = ["x_sea_water_velocity", "y_sea_water_velocity"]

    def __init__(self, lon=2.0, lat=66.0, eta0=2000.0, proj4=None):
        self.lon0, self.lat0 = float(lon), float(lat)
        self.proj4 = proj4 or (
            f"+proj=stere +lat_0={lat} +lon_0={lon} +lat_ts={lat} "
            "+units=m +ellps=WGS84")
        self.eta0 = float(eta0)
        super().__init__()
        self.name = "ArtificialOceanEddy"
        self.xmin, self.xmax = -1e6, 1e6
        self.ymin, self.ymax = -1e6, 1e6

    def sample(self, dev_state, varnames, t, lon, lat, z):
        x, y = self.crs.fwd(tnp, lon, lat)
        r = torch.sqrt(x * x + y * y)
        # azimuthal velocity profile: linear rise to peak at eta0*25 km scale
        umax = 0.3
        scale = 25000.0
        speed = umax * (r / scale) * torch.exp(1.0 - r / scale)
        safe_r = torch.where(r == 0.0, 1.0, r)
        u = -speed * y / safe_r
        v = speed * x / safe_r
        values = {}
        gamma = self.crs.convergence(tnp, lon, lat)
        vals = {"x_sea_water_velocity": u, "y_sea_water_velocity": v}
        vals = self.rotate_vectors_sampled(vals, self.variables, gamma)
        for name in varnames:
            values[name] = vals.get(name, torch.zeros_like(x))
        covers = (torch.abs(x) <= self.xmax) & (torch.abs(y) <= self.ymax)
        return values, covers


class FailingReader(ContinuousReader):
    """Raises on every fetch: exercises the environment's reader-quarantine
    logic (reference: opendrift/readers/reader_failing.py)."""

    variables = ["x_sea_water_velocity", "y_sea_water_velocity"]

    def __init__(self):
        super().__init__()
        self.name = "failing_reader"

    def device_state(self, window_start=None, window_end=None):
        raise RuntimeError("FailingReader always fails (by design)")

    def sample(self, dev_state, varnames, t, lon, lat, z):
        raise RuntimeError("FailingReader always fails (by design)")


def _seconds_since(times):
    """float32 seconds of ``times`` from the first."""
    t0 = times[0]
    return np.asarray([(t - t0).total_seconds() for t in times],
                      dtype=np.float32)


class CurrentFromTrack(ContinuousReader):
    """Current field inverted from an observed drifter track (reference:
    opendrift/readers/reader_current_from_track.py): segment velocities
    between consecutive observed positions, optionally with a windage
    fraction subtracted, served as a spatially uniform time series.  The
    segment is picked on the host from the host step time."""

    variables = ["x_sea_water_velocity", "y_sea_water_velocity"]

    def __init__(self, obslon, obslat, obstime, wind_east=0.0,
                 wind_north=0.0, windspeed=None, wind_direction=None,
                 z=0.0, windage_rate=0.02):
        from ..utils.geodesic import inverse_np
        obslon = np.asarray(obslon, dtype=float)
        obslat = np.asarray(obslat, dtype=float)
        az12, _, dist = inverse_np(obslat[:-1], obslon[:-1],
                                   obslat[1:], obslon[1:])
        dts = np.array([(b - a).total_seconds()
                        for a, b in zip(obstime[:-1], obstime[1:])])
        speed = dist / np.maximum(dts, 1e-9)
        u = speed * np.sin(np.radians(az12)) - windage_rate * wind_east
        v = speed * np.cos(np.radians(az12)) - windage_rate * wind_north
        self._times = list(obstime[:-1])
        self._u = u.astype(np.float32)
        self._v = v.astype(np.float32)
        self.start_time = obstime[0]
        self.end_time = obstime[-1]
        super().__init__()
        self.name = "current_from_track"

    def device_state(self, window_start=None, window_end=None):
        return {"times": _seconds_since(self._times)}

    def sample(self, dev_state, varnames, t, lon, lat, z):
        tsec = dev_state["times"]
        t_abs = np.float32(t) + np.float32(self._t_offset(self._times[0]))
        # piecewise-constant segment velocity
        i = int(np.clip(np.searchsorted(tsec, t_abs, side="right") - 1, 0,
                        len(self._times) - 1))
        values = {}
        if "x_sea_water_velocity" in varnames:
            values["x_sea_water_velocity"] = torch.full_like(
                lon, float(self._u[i]))
        if "y_sea_water_velocity" in varnames:
            values["y_sea_water_velocity"] = torch.full_like(
                lon, float(self._v[i]))
        return values, torch.ones_like(lon, dtype=torch.bool)


class CurrentFromDrifter(CurrentFromTrack):
    """Current field inverted from a drifter track with the Stokes-drift
    contribution subtracted (reference:
    opendrift/readers/reader_current_from_drifter.py): segment
    velocities from consecutive positions, minus the monochromatic
    Stokes profile at depth ``z`` sampled from a wave reader at each
    segment's midpoint and time.  The wave reader is sampled once a
    segment on ``device`` (default: the wave reader's, else ``cuda``)."""

    def __init__(self, lons, lats, times, waves=None, z=0.0,
                 name="current_from_drifter", device=None):
        lons = np.asarray(lons, dtype=float)
        lats = np.asarray(lats, dtype=float)
        times = list(times)
        valid = np.isfinite(lons + lats)
        if not valid.all():
            lons = lons[valid]
            lats = lats[valid]
            times = [t for t, v in zip(times, valid) if v]
        super().__init__(lons, lats, times, windage_rate=0.0)
        self.name = name
        if waves is None:
            return
        from ..interop import device_state_from_numpy, resolve_device
        from ..ops import physics as ph
        device = resolve_device(device or waves.device)
        # midpoints of each segment, sampled at each segment's start
        mid_lon = (0.5 * (lons[:-1] + lons[1:])).astype(np.float32)
        mid_lat = (0.5 * (lats[:-1] + lats[1:])).astype(np.float32)
        wave_vars = [
            "sea_surface_wave_significant_height",
            "sea_surface_wave_stokes_drift_x_velocity",
            "sea_surface_wave_stokes_drift_y_velocity",
            "sea_surface_wave_mean_period_from_variance_spectral_"
            "density_inverse_frequency_moment"]
        waves.set_run_epoch(self._times[0])
        waves.prepare()
        dev = device_state_from_numpy(
            waves.device_state(self._times[0], self._times[-1]), device)
        ts = {v: [] for v in wave_vars}
        for trel, lo, la in zip(_seconds_since(self._times), mid_lon,
                                mid_lat):
            pos = [torch.tensor([v], dtype=torch.float32, device=device)
                   for v in (lo, la, 0.0)]
            vals, _ = waves.sample(dev, wave_vars, trel, *pos)
            for v in wave_vars:
                ts[v].append(vals[v][0])
        ts = {v: torch.stack(ts[v]) for v in wave_vars}
        su, sv, _ = ph.stokes_drift_profile_monochromatic(
            ts["sea_surface_wave_stokes_drift_x_velocity"],
            ts["sea_surface_wave_stokes_drift_y_velocity"],
            ts["sea_surface_wave_significant_height"],
            ts[wave_vars[3]], z)
        self._u = (self._u - su.cpu().numpy()).astype(np.float32)
        self._v = (self._v - sv.cpu().numpy()).astype(np.float32)


def _interp_f32(x, xp, fp):
    """``jnp.interp`` of the scalar ``x`` in float32 on the host, in its
    order of operations (clamped at both ends)."""
    f32 = np.float32
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = f32(x) - xp[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    if abs(dx) <= eps:
        f = fp[i - 1]
    else:
        f = fp[i - 1] + (delta / dx) * df
    if x < xp[0]:
        f = fp[0]
    if x > xp[-1]:
        f = fp[-1]
    return f32(f)


class TimeseriesReader(ContinuousReader):
    """Spatially uniform, time-varying values from a (time, value) series
    (reference: opendrift/readers/reader_timeseries.py), linear in time.
    The series is interpolated on the host at the host step time."""

    def __init__(self, parameter_series_map, times, lon=None, lat=None):
        """``times``: list of datetimes; ``parameter_series_map``:
        var -> array of values per time.  ``lon``/``lat``: optional
        measurement position (used by ``combine_gaussian`` blending)."""
        self.lon = lon
        self.lat = lat
        self.variables = list(parameter_series_map)
        self._series = {k: np.asarray(v, dtype=np.float32)
                        for k, v in parameter_series_map.items()}
        self._times = list(times)
        self.start_time = times[0]
        self.end_time = times[-1]
        self.always_valid = False
        super().__init__()
        self.name = "timeseries_reader"

    def device_state(self, window_start=None, window_end=None):
        return {"times": _seconds_since(self._times)}

    def sample(self, dev_state, varnames, t, lon, lat, z):
        tsec = dev_state["times"]
        t_abs = np.float32(t) + np.float32(self._t_offset(self._times[0]))
        values = {v: torch.full_like(
                      lon, float(_interp_f32(t_abs, tsec, self._series[v])))
                  for v in varnames}
        return values, torch.ones_like(lon, dtype=torch.bool)


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


class Constant2DReader(ContinuousReader):
    """Static 2D fields on a regular grid, bilinearly sampled (reference:
    opendrift/readers/reader_constant_2d.py: a static array_dict served
    through the structured-reader machinery; here one fused gather)."""

    always_valid = True

    def __init__(self, x, y, array_dict, proj4="+proj=latlong"):
        self.proj4 = proj4
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.xmin, self.xmax = float(x.min()), float(x.max())
        self.ymin, self.ymax = float(y.min()), float(y.max())
        self._x0 = float(x[0])
        self._y0 = float(y[0])
        self._dx = float(x[1] - x[0]) if len(x) > 1 else 1.0
        self._dy = float(y[1] - y[0]) if len(y) > 1 else 1.0
        self._nx = len(x)
        self._ny = len(y)
        self.variables = list(array_dict)
        self._arrays = {v: np.asarray(a, dtype=np.float32)
                        for v, a in array_dict.items()}
        for v, a in self._arrays.items():
            if a.shape != (self._ny, self._nx):
                raise ValueError(
                    f"{v}: array shape {a.shape} != (ny, nx) "
                    f"({self._ny}, {self._nx})")
        super().__init__()
        self.name = "constant_2d_reader"

    def device_state(self, window_start=None, window_end=None):
        out = dict(self._arrays)
        # float32 tensor divisors keep the cell index a true float32
        # division on the card (fields/grid.py ``_grid_consts``)
        out["_grid"] = np.asarray([self._x0, self._y0, self._dx, self._dy],
                                  dtype=np.float32)
        return out

    def sample(self, dev_state, varnames, t, lon, lat, z):
        x, y = self.crs.fwd(tnp, lon, lat)
        g = dev_state["_grid"]
        fi = (x - g[0]) / g[2]
        fj = (y - g[1]) / g[3]
        covers = ((fi >= 0) & (fi <= self._nx - 1)
                  & (fj >= 0) & (fj <= self._ny - 1))
        fi = torch.clamp(fi, 0.0, self._nx - 1.0)
        fj = torch.clamp(fj, 0.0, self._ny - 1.0)
        i0 = torch.clamp(fi.to(torch.int32), 0, self._nx - 2).long()
        j0 = torch.clamp(fj.to(torch.int32), 0, self._ny - 2).long()
        wx = fi - i0
        wy = fj - j0
        out = {}
        for v in varnames:
            a = dev_state[v]
            v00 = a[j0, i0]
            v01 = a[j0, i0 + 1]
            v10 = a[j0 + 1, i0]
            v11 = a[j0 + 1, i0 + 1]
            out[v] = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
                      + wy * ((1 - wx) * v10 + wx * v11))
        return out, covers
