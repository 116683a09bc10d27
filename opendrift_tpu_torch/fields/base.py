"""Field providers: host-side readers whose samplers run on the device.

Port of ``opendrift_tpu/fields/base.py``.  A reader is a host object whose
runtime job is to provide

* a dict of host arrays (``device_state``) for a time window, which the
  environment copies to the device between output intervals
  (``fields/environment.py`` via ``interop.device_state_from_numpy``);
* ``sample(dev_state, varnames, t, lon, lat, z)`` mapping element
  positions (tensors) and the host float32 step time ``t`` to
  ``({var: float32 tensor}, covers: bool tensor)``.

Priority chains, fallbacks and vector rotation are applied by the
environment.  The reader algebra (``+``, ``-``, ``*``, ``/``,
``combine_gaussian``; ``fields/operators.py``) and the standalone
diagnostics (``covers_positions``, ``get_timeseries_at_position``,
``sample_at``) and ``plot`` are the JAX package's; they sample on the
reader's device (``device=``, else the one the environment gave it, else
``cuda``).  ``plot`` imports matplotlib when called.
"""

from datetime import datetime
from numbers import Number

import numpy as np
import torch

from ..interop import device_state_from_numpy, resolve_device
from ..utils import crs as crslib
from ..utils.plotting import pyplot
from ..utils.xp import tnp

# grid-x/grid-y vector pairs rotated to east/north on projected grids
# (reference: opendrift/readers/basereader/__init__.py:85-105)
VECTOR_PAIRS = [
    ("x_sea_water_velocity", "y_sea_water_velocity"),
    ("x_wind", "y_wind"),
    ("sea_ice_x_velocity", "sea_ice_y_velocity"),
    ("sea_surface_wave_stokes_drift_x_velocity",
     "sea_surface_wave_stokes_drift_y_velocity"),
]

# (x, y, speed, to_direction) rows for the derived environment mappings
# (reference basereader/consts.py:27 vector_pairs_xy)
SPEED_DIRECTION_PAIRS = [
    ("x_wind", "y_wind", "wind_speed", "wind_to_direction"),
    ("sea_ice_x_velocity", "sea_ice_y_velocity", "sea_ice_speed",
     "direction_of_sea_ice_velocity"),
    ("x_sea_water_velocity", "y_sea_water_velocity", "sea_water_speed",
     "sea_water_to_direction"),
    ("sea_surface_wave_stokes_drift_x_velocity",
     "sea_surface_wave_stokes_drift_y_velocity",
     "sea_surface_wave_stokes_drift_speed",
     "sea_surface_wave_stokes_drift_to_direction"),
]

# physically plausible bounds per CF standard name, used to scrub corrupt
# input (reference: basereader/consts.py:2-22, variables.py:630-668)
STANDARD_NAMES = {
    "x_sea_water_velocity": {"valid_min": -15.0, "valid_max": 15.0,
                             "units": "m s-1"},
    "y_sea_water_velocity": {"valid_min": -15.0, "valid_max": 15.0,
                             "units": "m s-1"},
    "x_wind": {"valid_min": -50.0, "valid_max": 50.0, "units": "m s-1"},
    "y_wind": {"valid_min": -50.0, "valid_max": 50.0, "units": "m s-1"},
    "sea_water_temperature": {"valid_min": -4.0, "valid_max": 40.0,
                              "units": "degC"},
    "sea_water_salinity": {"valid_min": 0.0, "valid_max": 45.0, "units": "1"},
    "sea_floor_depth_below_sea_level": {"valid_min": -20.0,
                                        "valid_max": 12000.0, "units": "m"},
    "sea_surface_height": {"valid_min": -15.0, "valid_max": 15.0, "units": "m"},
    "significant_height_of_combined_wind_waves_and_swell":
        {"valid_min": 0.0, "valid_max": 30.0, "units": "m"},
}


class BaseReader:
    """Host-side reader base.  Subclasses set ``variables`` (CF standard
    names), ``proj4`` and coverage metadata, and implement ``sample``."""

    name = None
    variables = None
    proj4 = "+proj=latlong"
    start_time = None          # datetime or None = always covered
    end_time = None
    time_step = None
    xmin = None
    xmax = None
    ymin = None
    ymax = None
    always_valid = False
    device = None
    verticalbuffer = 1

    def __init__(self):
        if self.name is None:
            self.name = type(self).__name__
        if getattr(self, "crs", None) is None:
            self.crs = crslib.from_proj4(self.proj4)
        self._setup_environment_mappings()

    # ----------------------------------------- derived environment mappings
    def _setup_environment_mappings(self):
        """Component/magnitude variables derived from what the reader
        serves (reference basereader/variables.py:449-553)."""
        self._derived = {}
        have = set(self.variables or [])
        y_is_north = getattr(self.crs, "is_latlon", False)
        for x, y, speed, direction in SPEED_DIRECTION_PAIRS:
            if speed in have and direction in have and x not in have \
                    and y_is_north:
                # the reference assigns cos(direction) to x and sin to y
                # (variables.py:469-473), reproduced for parity
                self._derived[x] = ((speed, direction),
                                    lambda v, s=speed, d=direction:
                                    v[s] * torch.cos(torch.deg2rad(v[d])))
                self._derived[y] = ((speed, direction),
                                    lambda v, s=speed, d=direction:
                                    v[s] * torch.sin(torch.deg2rad(v[d])))
                self.variables = list(self.variables) + [x, y]
            if x in have and y in have and speed not in have:
                self._derived[speed] = ((x, y),
                                        lambda v, a=x, b=y:
                                        torch.hypot(v[a], v[b]))
                self.variables = list(self.variables) + [speed]

    @property
    def derived_variables(self):
        """Names served by mappings rather than data (reference
        ``Variables.derived_variables``)."""
        return list(self._derived)

    def activate_environment_mapping(self, name):
        """Opt-in mappings (reference ``activate_environment_mapping``):
        'land_binary_mask_from_ocean_depth' (variables.py:449-450, off by
        default there too)."""
        if name != "land_binary_mask_from_ocean_depth":
            raise ValueError(f"unknown environment mapping: {name}")
        src = "sea_floor_depth_below_sea_level"
        if src in (self.variables or []) \
                and "land_binary_mask" not in self.variables:
            self._derived["land_binary_mask"] = (
                (src,), lambda v, s=src: (v[s] <= 0).to(torch.float32))
            self.variables = list(self.variables) + ["land_binary_mask"]

    def expand_derived(self, want):
        """Split a request into (fetch list incl. sources, derived names)."""
        if not self._derived:
            return list(want), []
        native = [v for v in want if v not in self._derived]
        derived = [v for v in want if v in self._derived]
        needed = dict.fromkeys(native)
        for v in derived:
            for s in self._derived[v][0]:
                needed.setdefault(s)
        return list(needed), derived

    def apply_derived(self, vals, derived):
        for v in derived:
            vals[v] = self._derived[v][1](vals)
        return vals

    # ------------------------------------------------------------------ API
    def xy2lonlat(self, x, y):
        return self.crs.inv(np, np.asarray(x, float), np.asarray(y, float))

    def lonlat2xy(self, lon, lat):
        return self.crs.fwd(np, np.asarray(lon, float), np.asarray(lat, float))

    def covers_time(self, time):
        """Whether the reader has data at ``time`` (a datetime)."""
        if self.always_valid or self.start_time is None:
            return True
        return self.start_time <= time <= self.end_time

    def covers_positions(self, lon, lat):
        """Host-side coverage check (seeding diagnostics)."""
        x, y = self.lonlat2xy(lon, lat)
        return np.asarray(self._covers_xy_host(x, y))

    def _covers_xy_host(self, x, y):
        ok = np.ones(np.shape(x), dtype=bool)
        if self.xmin is not None:
            # geographic grids: the file's longitude convention (0..360 or
            # -180..180) before the range test
            if getattr(self.crs, "is_latlon", False):
                x = np.where(x > self.xmax, x - 360.0, x)
                x = np.where(x < self.xmin, x + 360.0, x)
            ok &= (x >= self.xmin) & (x <= self.xmax)
        if self.ymin is not None:
            ok &= (y >= self.ymin) & (y <= self.ymax)
        return ok

    def prepare(self, **kwargs):
        """Hook called at run start (reference structured.py:149)."""

    def device_state(self, window_start=None, window_end=None):
        """Host arrays the sampler needs for this window."""
        return {}

    def sample(self, dev_state, varnames, t, lon, lat, z):
        raise NotImplementedError

    def sample_profiles(self, dev_state, varnames, t, lon, lat, zlevels):
        """Sample variables at the fixed ``zlevels`` for each element, by
        default one ``sample`` per level.  Returns ({var: (L, N)},
        covers (N,))."""
        outs = {v: [] for v in varnames}
        covers = None
        for level in zlevels:
            zvec = torch.full_like(lon, float(level))
            vals, cov = self.sample(dev_state, varnames, t, lon, lat, zvec)
            covers = cov if covers is None else covers
            for v in varnames:
                outs[v].append(vals[v])
        return {v: torch.stack(outs[v]) for v in varnames}, covers

    def get_timeseries_at_position(self, lon, lat, variables=None,
                                   start_time=None, end_time=None,
                                   times=None, z=0.0, device=None):
        """A time series of ``variables`` at one position, the standalone
        reader diagnostic (reference readers/basereader/__init__.py:
        387-431).  Returns ``{'time': [datetimes], var: np.ndarray[T]}``;
        one window holds every time, sampled once a time on ``device``."""
        if variables is None:
            variables = list(self.variables)
        variables = list(variables)
        if times is None:
            own = getattr(self, "times", None)
            if own:
                times = [t for t in own
                         if (start_time is None or t >= start_time)
                         and (end_time is None or t <= end_time)]
            else:
                t0 = start_time or self.start_time
                t1 = end_time or self.end_time
                if t0 is None or t1 is None:
                    raise ValueError(
                        "give explicit times for a reader without a "
                        "time axis")
                times = [t0 + i * (t1 - t0) / 19 for i in range(20)]
        if not times:
            raise ValueError("no times within the requested range")
        device = resolve_device(device or self.device)
        self.set_run_epoch(times[0])
        span = (times[-1] - times[0]).total_seconds()
        self.prepare(interval_seconds=span if span > 0 else None)
        dev = device_state_from_numpy(
            self.device_state(times[0], times[-1]), device)
        pos = [torch.tensor([v], dtype=torch.float32, device=device)
               for v in (lon, lat, z)]
        fetch, derived = self.expand_derived(variables)
        series = {v: [] for v in variables}
        for t in times:
            trel = np.float32((t - times[0]).total_seconds())
            vals, _ = self.sample(dev, fetch, trel, *pos)
            if derived:
                vals = self.apply_derived(vals, derived)
            for v in variables:
                series[v].append(vals[v][0])
        result = {"time": list(times)}
        for v in variables:
            result[v] = torch.stack(series[v]).cpu().numpy()
        return result

    def sample_at(self, lon, lat, time, variables=None, z=0.0, device=None):
        """Sample ``variables`` at arbitrary positions and one time: numpy
        in, numpy dict out, NaN outside coverage (the standalone analogue
        of the reference's ``get_variables_interpolated``,
        basereader/variables.py:860-918)."""
        if variables is None:
            variables = list(self.variables)
        variables = list(variables)
        lon = np.atleast_1d(np.asarray(lon, dtype=np.float32)).ravel()
        lat = np.atleast_1d(np.asarray(lat, dtype=np.float32)).ravel()
        zv = np.broadcast_to(np.asarray(z, dtype=np.float32),
                             lon.shape).ravel()
        device = resolve_device(device or self.device)
        self.set_run_epoch(time)
        self.prepare()
        dev = device_state_from_numpy(self.device_state(time, time), device)
        fetch, derived = self.expand_derived(variables)
        pos = [torch.as_tensor(np.ascontiguousarray(a), device=device)
               for a in (lon, lat, zv)]
        vals, covers = self.sample(dev, fetch, np.float32(0.0), *pos)
        if derived:
            vals = self.apply_derived(vals, derived)
        return {v: torch.where(covers, vals[v], float("nan")).cpu().numpy()
                for v in variables}

    def set_run_epoch(self, epoch):
        """Record the run's t = 0 (a datetime)."""
        self._run_epoch = epoch

    def _t_offset(self, reference_time):
        """Seconds from ``reference_time`` to the run epoch."""
        if reference_time is None:
            return 0.0
        return (self._run_epoch - reference_time).total_seconds()

    def rotate_vectors_sampled(self, values, varnames, gamma):
        """Rotate known grid-x/y vector pairs to east/north by the
        convergence angle ``gamma`` (radians)."""
        for xv, yv in VECTOR_PAIRS:
            if xv in varnames and yv in varnames:
                values[xv], values[yv] = crslib.rotate_to_eastnorth(
                    tnp, values[xv], values[yv], gamma)
        return values

    # --------------------------------------------------- reader algebra
    # (reference operators/ops.py:9-92: the Combine mixin on BaseReader)
    def __add__(self, other):
        from . import operators
        if isinstance(other, Number):
            return operators.ScaledReader(self, scale=1.0,
                                          offset=float(other))
        if isinstance(other, BaseReader):
            return operators.combine_add(self, other)
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        from . import operators
        if isinstance(other, Number):
            return operators.ScaledReader(self, scale=float(other))
        return NotImplemented

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        if isinstance(other, Number):
            return self.__mul__(1.0 / float(other))
        return NotImplemented

    def __sub__(self, other):
        from . import operators
        if isinstance(other, Number):
            return operators.ScaledReader(self, scale=1.0,
                                          offset=-float(other))
        if isinstance(other, BaseReader):
            return operators.combine_sub(self, other)
        return NotImplemented

    def combine_gaussian(self, measurement_reader, std):
        """Blend a point observation into this background field with a
        gaussian weight of width ``std`` metres centred on the measurement
        reader's (lon, lat) (reference operators/ops.py
        combine_gaussian)."""
        from . import operators
        return operators.GaussianBlendReader(
            self, measurement_reader, lon0=measurement_reader.lon,
            lat0=measurement_reader.lat, radius_m=std)

    def plot(self, variable=None, time=None, vmin=None, vmax=None,
             filename=None, buffer=1.0, device=None):
        """Plot the reader's coverage outline, optionally with one
        variable's field sampled on an 80 x 80 grid over its extent at
        ``time`` (reference basereader/__init__.py:240-330; plain
        matplotlib).  The field is sampled on ``device`` (else the
        reader's, else ``cuda``) and brought to the host."""
        plt = pyplot()
        fig, ax = plt.subplots()
        if self.xmin is not None and self.ymin is not None:
            xs = np.array([self.xmin, self.xmax, self.xmax, self.xmin,
                           self.xmin])
            ys = np.array([self.ymin, self.ymin, self.ymax, self.ymax,
                           self.ymin])
            blon, blat = self.xy2lonlat(xs, ys)
            ax.plot(blon, blat, "r-", lw=1.5, label="coverage")
        if variable is not None:
            nx = ny = 80
            if self.xmin is None:
                raise ValueError("reader has no spatial extent to plot")
            gx = np.linspace(self.xmin, self.xmax, nx)
            gy = np.linspace(self.ymin, self.ymax, ny)
            GX, GY = np.meshgrid(gx, gy)
            glon, glat = self.xy2lonlat(GX.ravel(), GY.ravel())
            t = time or getattr(self, "start_time", None)
            if getattr(self, "_run_epoch", None) is None:
                self.set_run_epoch(t or datetime(2000, 1, 1))
            self.prepare()
            device = resolve_device(device or self.device)
            dev = device_state_from_numpy(self.device_state(), device)
            trel = 0.0 if t is None else (
                t - self._run_epoch).total_seconds()
            pos = [torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)
                   for a in (glon, glat, np.zeros(len(glon)))]
            vals, covers = self.sample(dev, [variable], np.float32(trel),
                                       *pos)
            field = vals[variable].cpu().numpy().reshape(ny, nx)
            field = np.where(covers.cpu().numpy().reshape(ny, nx),
                             field, np.nan)
            m = ax.pcolormesh(np.asarray(glon).reshape(ny, nx),
                              np.asarray(glat).reshape(ny, nx), field,
                              vmin=vmin, vmax=vmax, shading="auto")
            fig.colorbar(m, ax=ax, label=variable)
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        ax.set_title(self.name)
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig

    def __repr__(self):
        s = f"Reader: {self.name}\n  variables: {self.variables}\n"
        s += f"  proj4: {self.proj4}\n"
        if self.xmin is not None:
            s += f"  x: {self.xmin} .. {self.xmax}\n"
        if self.ymin is not None:
            s += f"  y: {self.ymin} .. {self.ymax}\n"
        if self.start_time is not None:
            s += f"  time: {self.start_time} .. {self.end_time}\n"
        return s


class ContinuousReader(BaseReader):
    """Analytic readers: defined everywhere in their domain, at any time
    (reference: basereader/continuous.py:8-46)."""

    always_valid = True
