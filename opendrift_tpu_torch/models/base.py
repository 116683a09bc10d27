"""Core simulation engine: ``OpenDriftSimulation``.

Port of the run path of ``opendrift_tpu/models/base.py`` (reference:
opendrift/models/basemodel/__init__.py:193-2340).  The public API (ctor,
``set_config``, ``add_reader``, ``seed_elements``, ``run``, ``result``)
matches upstream; the internals follow the JAX package:

* Elements live in a fixed-capacity ``ElementState`` of torch tensors on
  one device, the element axis last ((N,), or (C, N) for a model's
  per-component arrays); deactivation is a status flip, never compaction.
* Each step — release, environment fetch, missing-data/outside/seafloor
  handling, aging, the model's ``update`` physics and horizontal
  diffusion — runs as eager torch on the device, K steps per output
  interval (there is no jit; CUDA graphs are a later item).  The step
  order reproduces the reference main loop (basemodel/__init__.py:
  2193-2304).
* Random numbers come from one base key folded per (interval, step, use),
  with threefry, or with ``general:rng='rbg'`` Philox, bit-equal to the
  JAX package's (``rng.py``).
* Over a mesh of several tiles (``set_mesh``, by default the visible CUDA
  cards) the run shards its elements (``parallel:particle_sharding``,
  ``parallel/mesh.py``) or decomposes the primary forcing grid with halo
  exchange and migration (``parallel:domain_decomposition``,
  ``parallel/tiled.py``); the tiles step in turn, a step at a time.
  Several processes join through ``parallel/multihost.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card a CUDA request raises.  The post-processing mixin (density
maps, residence time, FTLE) and the plotting mixin (matplotlib, imported
inside each plot) are mixed in as in the JAX package.
"""

import json
import logging
import os
import re
from datetime import datetime, timedelta
from enum import Enum
from functools import wraps

import numpy as np
import torch

from .. import rng
from ..config import Configurable, CONFIG_LEVEL_ESSENTIAL, \
    CONFIG_LEVEL_BASIC, CONFIG_LEVEL_ADVANCED
from ..timer import Timeable
from ..errors import WrongMode
from ..elements import LagrangianArray, ElementState
from ..elements.elements import NOT_RELEASED, ACTIVE, \
    STANDARD_STATUS_CATEGORIES
from ..fields.analytic import PerElementReader
from ..fields.environment import Environment
from ..fields.landmask import GlobalLandmask
from ..interop import element_state_from_numpy, resolve_device
from ..utils.crs import LatLonCRS
from ..utils.geodesic import direct_np, inverse_np, geodesic_inverse, \
    geodesic_step, geodesic_step_second_order
from ..utils.shapefile import points_in_ring, shapefile_polygons
from ..utils.dataset import TrajectoryDataset, DataVar
from ..utils.xp import tnp
from .physics import PhysicsContext
from .plot import PlottingMixin
from .postprocess import PostProcessingMixin

logger = logging.getLogger(__name__)


class Mode(Enum):
    """Simulation lifecycle (reference basemodel/__init__.py:78)."""
    Config = 1
    Ready = 2
    Run = 3
    Result = 4


def require_mode(mode, error=None):
    """Decorator enforcing modes (reference :136-190)."""
    modes = mode if isinstance(mode, (list, tuple, set)) else [mode]

    def decorator(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            if self.mode not in modes:
                raise WrongMode(modes, self.mode, error)
            return fn(self, *args, **kwargs)
        return wrapper
    return decorator


def _seconds(value):
    """Accept a timedelta or a number of seconds."""
    if isinstance(value, timedelta):
        return value.total_seconds()
    return float(value)


_MICROSECOND = timedelta(microseconds=1)


def _spread_times(t0, t1, number):
    """``number`` datetimes spread evenly over [t0, t1]: the i-th is
    ``t0 + frac[i] * (t1 - t0)`` with ``frac = linspace(0, 1, number)``,
    rounded to the microsecond as ``timedelta`` rounds it (half to even).
    Made in bulk for plain datetimes without a time zone."""
    frac = np.linspace(0, 1, number)
    span = t1 - t0
    if type(t0) is not datetime or type(t1) is not datetime \
            or t0.tzinfo is not None or t1.tzinfo is not None:
        return np.array([t0 + f * span for f in frac])
    us = frac * (span // _MICROSECOND)
    rounded = np.rint(us)
    # where the float product lies within its rounding of a half, the
    # exact product may round the other way: those are made as timedelta
    # makes them
    for i in np.flatnonzero(np.abs(us - np.floor(us) - 0.5) < 1e-4):
        rounded[i] = (frac[i] * span) // _MICROSECOND
    return (np.datetime64(t0, "us")
            + rounded.astype(np.int64).astype("timedelta64[us]")
            ).astype(object)


def _frame_budget(device):
    """Bytes of output frames a run may keep on ``device`` until its
    result is assembled: half the card's free memory, no limit on the
    CPU."""
    if device.type != "cuda":
        return float("inf")
    return torch.cuda.mem_get_info(device)[0] // 2


def _invalid_frames(status):
    """Where ``io_netcdf.valid_mask`` of an (N, T) status tensor is false,
    computed where the tensor lies: the frames before an element's release
    and those after its first dead one (the reference keeps the active
    frames and the first dead one, basemodel/__init__.py:2390-2396)."""
    dead = status > ACTIVE
    invalid = status < ACTIVE
    invalid[:, 1:] |= dead[:, 1:] & dead[:, :-1]
    return invalid


class OpenDriftSimulation(PostProcessingMixin, PlottingMixin, Timeable,
                          Configurable):
    """Abstract base simulation.  Subclasses define ``ElementType``,
    ``required_variables`` and ``update(ctx)``."""

    ElementType = LagrangianArray
    required_variables = {}
    required_profiles_z_range = None
    max_speed = 1.3                    # m/s, for coverage/halo estimates

    def __init__(self, loglevel=logging.DEBUG, seed=0, logfile=None,
                 device=None):
        self.device = resolve_device(device)
        self.mode = Mode.Config
        self.status_categories = list(STANDARD_STATUS_CATEGORIES)
        self._seedings = []
        self.num_elements_scheduled_total = 0
        self.result = None
        self.rng_seed = seed
        self._np_random = np.random.RandomState(seed)
        self.simulation_extent = None
        self.messages = []
        self._dd = self._sharding = None
        if loglevel is not None:
            logging.basicConfig(level=loglevel)
        self.env = Environment(self.required_variables, device=self.device)
        self.env.recorder = self.recorder   # its spans and counters
        self._add_base_config()
        self._add_seed_configs()
        self._add_environment_configs()
        self.add_config()  # model hook
        self.timer_start("total time")

    # ----------------------------------------------------------- config ---
    def _add_base_config(self):
        self._add_config({
            "general:coastline_action": {
                "type": "enum", "enum": ["none", "stranding", "previous"],
                "default": "stranding", "level": CONFIG_LEVEL_BASIC,
                "description": "What happens at the coastline"},
            "general:seafloor_action": {
                "type": "enum",
                "enum": ["none", "lift_to_seafloor", "deactivate", "previous"],
                "default": "lift_to_seafloor", "level": CONFIG_LEVEL_BASIC,
                "description": "What happens at the seafloor"},
            "general:use_auto_landmask": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_ADVANCED,
                "description": "Add a coastline landmask automatically"},
            "general:coastline_bisection": {
                "type": "enum", "enum": ["refetch", "block"],
                "default": "refetch", "level": CONFIG_LEVEL_ADVANCED,
                "description": "How stranding bisection probes sample the "
                "landmask. 'refetch': a fresh mask fetch per probe (exact, "
                "reference semantics). 'block': probes re-read the held "
                "corner block with edge clamping, with no gather; exact "
                "when the step stays within one grid cell, else the "
                "crossing point degrades toward the cell edge. Requires "
                "drift:advection_single_fetch and the landmask served by "
                "the same reader as the currents"},
            "general:rng": {
                "type": "enum", "enum": ["threefry", "rbg"],
                "default": "threefry", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Counter-based PRNG of the stochastic "
                "processes. 'threefry' is bit-reproducible across backends "
                "(like the reference's seeded numpy, basemodel "
                "__init__.py:270-326); 'rbg' is the Philox4x32-10 stream "
                "XLA's CPU and GPU backends give RngBitGenerator (not a "
                "TPU's hardware stream), drawn by a CUDA kernel on the "
                "card: same statistics, another stream"},
            "general:profile_dir": {
                "type": "str", "default": "",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Capture a torch.profiler trace of the main "
                "loop (host and, on a card, CUDA kernels) into this "
                "directory as a Chrome/TensorBoard trace file; empty = "
                "off.  The device-level counterpart of the hierarchical "
                "wall-clock timers (reference timer.py)"},
            "general:time_step_minutes": {
                "type": "float", "default": 60.0, "min": 1e-6, "max": 1e5,
                "units": "minutes", "level": CONFIG_LEVEL_BASIC,
                "description": "Calculation time step"},
            "general:time_step_output_minutes": {
                "type": "float", "default": None, "min": 1e-6, "max": 1e6,
                "units": "minutes", "level": CONFIG_LEVEL_BASIC,
                "description": "Output time step"},
            "drift:advection_scheme": {
                "type": "enum", "enum": ["euler", "runge-kutta", "runge-kutta4"],
                "default": "euler", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Numerical advection scheme"},
            "drift:current_uncertainty": {
                "type": "float", "default": 0.0, "min": 0, "max": 5,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Std of gaussian noise added to current"},
            "drift:current_uncertainty_uniform": {
                "type": "float", "default": 0.0, "min": 0, "max": 5,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Half-width of uniform noise added to current"},
            "drift:wind_uncertainty": {
                "type": "float", "default": 0.0, "min": 0, "max": 5,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Std of gaussian noise added to wind"},
            "drift:horizontal_diffusivity": {
                "type": "float", "default": 0.0, "min": 0, "max": 100000,
                "units": "m2/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Horizontal diffusivity"},
            "drift:max_age_seconds": {
                "type": "float", "default": None, "min": 0, "max": 1e10,
                "units": "s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Retire elements older than this"},
            "drift:max_speed": {
                "type": "float", "default": 2.0, "min": 0, "max": 100,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Speed bound used for coverage/halo sizing"},
            "drift:position_update": {
                "type": "enum", "enum": ["fused", "sequential"],
                "default": "fused", "level": CONFIG_LEVEL_ADVANCED,
                "description": "'fused' sums process velocities and "
                "commits one geodesic solve per step; 'sequential' "
                "solves per process like the reference"},
            "drift:geodesy": {
                "type": "enum", "enum": ["second_order", "vincenty"],
                "default": "second_order",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Committed position update: 'second_order' "
                "ellipsoidal expansion or the full 'vincenty' direct solve"},
            "drift:deactivate_north_of": {
                "type": "float", "default": None, "min": -90, "max": 90,
                "units": "degrees", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Deactivate elements north of this latitude"},
            "drift:deactivate_south_of": {
                "type": "float", "default": None, "min": -90, "max": 90,
                "units": "degrees", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Deactivate elements south of this latitude"},
            "drift:deactivate_east_of": {
                "type": "float", "default": None, "min": -360, "max": 360,
                "units": "degrees", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Deactivate elements east of this longitude"},
            "drift:deactivate_west_of": {
                "type": "float", "default": None, "min": -360, "max": 360,
                "units": "degrees", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Deactivate elements west of this longitude"},
            "readers:max_number_of_fails": {
                "type": "int", "default": 1, "min": 1, "max": 100,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Discard readers failing more often than this"},
            "seed:ocean_only": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_ADVANCED,
                "description": "Relocate land-seeded elements to the ocean"},
            "seed:number": {
                "type": "int", "default": 1, "min": 1, "max": 10 ** 9,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Default number of elements per seeding"},
            "drift:advection_single_fetch": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "RK stages re-evaluate one gathered corner "
                "block instead of refetching fields (fewer gathers; exact "
                "while stage displacements stay inside one grid cell, "
                "clamped beyond)"},
            "export:buffer_length": {
                "type": "int", "default": 100, "min": 0, "max": 10 ** 6,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Flush the outfile every this many output "
                "steps during the run; 0 writes only at the end"},
            "parallel:particle_sharding": {
                "type": "bool", "default": True,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Shard elements over the tiles of the mesh "
                "(set_mesh, default the visible CUDA cards); forcing "
                "fields are replicated"},
            "parallel:domain_decomposition": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Split the primary forcing grid into Y "
                "bands over the tiles of the mesh (for grids too large to "
                "replicate): per-tile particle buffers, halo exchange "
                "between neighbour tiles and neighbour-only particle "
                "migration after every step"},
            "parallel:tile_capacity_factor": {
                "type": "float", "default": 2.0, "min": 1.0, "max": 64.0,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Per-tile particle buffer slots as a "
                "multiple of the even share (headroom for spatially "
                "clumped distributions under domain decomposition)"},
            "parallel:tile_grid": {
                "type": "str", "default": "auto",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Tile topology for domain decomposition: "
                "'auto' = 1D Y bands (one per tile), or 'RxC' for a "
                "2D Y-by-X tiling (R*C must equal the tile count; "
                "right for domains wider than tall)"},
            "export:sharded": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Multi-process runs: every process writes "
                "its own slots to <outfile>.pNNN.nc instead of gathering "
                "every snapshot to every process; merge offline with "
                "opendrift_tpu_torch/tools/concat_shards.py. "
                "Single-process runs ignore this"},
        })

    def _add_seed_configs(self):
        """``seed:<var>`` configs from the element schema
        (reference basemodel/__init__.py:529-545)."""
        specs = {}
        for name, spec in self.ElementType.variables.items():
            if not spec.get("seed", True) or name in ("lon", "lat"):
                continue
            default = spec.get("default", 0.0)
            specs[f"seed:{name}"] = {
                "type": "float" if not isinstance(default, str) else "str",
                "default": default, "units": spec.get("units"),
                "min": spec.get("min", -1e30), "max": spec.get("max", 1e30),
                "level": CONFIG_LEVEL_BASIC,
                "description": spec.get("description", f"Seed value of {name}")}
        self._add_config(specs)

    def _add_environment_configs(self):
        """``environment:constant/fallback:<var>`` configs
        (reference environment.py:41-76)."""
        specs = {}
        for var, spec in self.required_variables.items():
            specs[f"environment:constant:{var}"] = {
                "type": "float", "default": None, "min": -1e30, "max": 1e30,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": f"Use constant value for {var}"}
            specs[f"environment:fallback:{var}"] = {
                "type": "float", "default": spec.get("fallback", None),
                "min": -1e30, "max": 1e30, "level": CONFIG_LEVEL_ADVANCED,
                "description": f"Fallback value for {var} when missing"}
        self._add_config(specs)

    def add_config(self):
        """Model hook to register extra config keys."""

    # ----------------------------------------------------------- readers --
    @require_mode([Mode.Config, Mode.Ready])
    def add_reader(self, readers, variables=None, first=False):
        self.env.add_reader(readers, variables=variables, first=first)
        return self

    def add_readers_from_list(self, urls, timeout=None, lazy=True,
                              variables=None):
        """Open readers for a list of local paths or reader schemes
        (``fields/factory.py``; reference environment.py:248-265)."""
        from ..fields.factory import reader_from_url
        readers = [reader_from_url(u) for u in urls]
        readers = [r for r in readers if r is not None]
        self.add_reader(readers, variables=variables)
        return self

    def add_readers_from_file(self, filename, timeout=None, lazy=True):
        """Add readers from a text file of paths/URLs, one per line
        (reference basemodel/__init__.py:622-624); a source that does not
        open is logged and skipped."""
        from ..fields.factory import reader_from_url
        with open(filename) as fd:
            urls = [ln.strip() for ln in fd
                    if ln.strip() and not ln.startswith("#")]
        for u in urls:
            try:
                self.add_reader(reader_from_url(u, lazy=lazy))
            except Exception as e:
                logger.warning("could not open reader %s: %s", u, e)

    def default_readers(self):
        """The sources listed in the package's ``scripts/data_sources.txt``
        (reference basemodel/__init__.py:626-631), read as text: nothing is
        opened."""
        import importlib.resources as res
        try:
            txt = (res.files("opendrift_tpu_torch.scripts")
                   / "data_sources.txt").read_text()
        except Exception:
            return []
        return [ln.strip() for ln in txt.splitlines()
                if ln.strip() and not ln.startswith("#")]

    # ----------------------------------------------------------- seeding --
    def _seed_count(self, lon, z, number):
        """How many elements a seeding makes: ``number`` where given, else
        one a position (or a depth) given, at least ``seed:number``."""
        if number is not None:
            return number
        return max(np.size(lon), len(z) if np.ndim(z) else 0,
                   int(self.get_config("seed:number")))

    @require_mode([Mode.Config, Mode.Ready])
    def seed_elements(self, lon, lat, time=None, radius=0, number=None,
                      radius_type="gaussian", origin_marker=None, **kwargs):
        """Seed elements at point(s), optionally scattered within ``radius``
        metres, at one or more times (reference basemodel/__init__.py:1033).
        ``time``: a datetime, a [start, end] pair, or per-element times."""
        lon = np.atleast_1d(np.asarray(lon, dtype=np.float64)).ravel()
        lat = np.atleast_1d(np.asarray(lat, dtype=np.float64)).ravel()
        if len(lon) != len(lat):
            raise ValueError("lon and lat must have equal length")
        num_points = len(lon)
        number = int(self._seed_count(lon, kwargs.get("z", 0), number))
        if number < 1:
            raise ValueError(
                f"Number of elements to seed must be >= 1, got {number}")
        if num_points not in (1, number) and number % num_points != 0:
            raise ValueError(
                f"Number of elements ({number}) must equal or be a "
                f"multiple of number of points ({num_points})")
        if num_points == 1:
            lon = np.repeat(lon, number)
            lat = np.repeat(lat, number)
        elif num_points != number:
            reps = number // num_points
            lon = np.repeat(lon, reps)
            lat = np.repeat(lat, reps)
            number = len(lon)

        if time is None:
            raise ValueError("Time of seeding must be specified")
        if isinstance(time, (list, tuple)) and len(time) == 2 \
                and isinstance(time[0], datetime):
            times = _spread_times(*time, number)
        elif isinstance(time, datetime):
            times = np.full(number, time, dtype=object)
        else:
            times = np.asarray(time)
            if len(times) == 1:
                times = np.repeat(times, number)
            elif len(times) != number:
                raise ValueError("Length of time array must match number")

        radius = np.atleast_1d(np.asarray(radius, dtype=np.float64)).ravel()
        if len(radius) == 1:
            radius = np.repeat(radius, number)
        if radius.max() > 0:
            az = self._np_random.uniform(0, 360, number)
            if radius_type == "gaussian":
                dist = abs(self._np_random.normal(0, 1, number)) * radius
            elif radius_type == "uniform":
                dist = np.sqrt(self._np_random.uniform(0, 1, number)) * radius
            else:
                raise ValueError(f"Unknown radius_type: {radius_type}")
            lat, lon = direct_np(lat, lon, az, dist)

        if origin_marker is None:
            origin_marker = len(self._seedings)
        props = {}
        for name in self.ElementType.variables:
            if name in ("lon", "lat", "origin_marker", "ID", "status"):
                continue
            if name in kwargs:
                v = kwargs.pop(name)
            else:
                v = self.get_config(f"seed:{name}", default=None)
                if v is None:
                    v = self.ElementType.default(name)
            v = np.atleast_1d(np.asarray(v))
            if len(v) == 1:
                v = np.repeat(v, number)
            elif len(v) != number:
                raise ValueError(
                    f"Seed property {name} has length {len(v)} != {number}")
            props[name] = v
        # per-element constant environment (reference :1228-1237: a
        # constant reader keyed on the element IDs, at top priority)
        per_elem_env = kwargs.pop("environment", None)
        unknown = [k for k in kwargs if k not in ("z",)]
        if unknown:
            raise ValueError(f"Unknown seed properties for "
                             f"{type(self).__name__}: {unknown}")
        if per_elem_env is not None:
            ids = np.arange(self.num_elements_scheduled_total + 1,
                            self.num_elements_scheduled_total + number + 1)
            rdr = getattr(self, "_per_element_reader", None)
            if rdr is None:
                rdr = self._per_element_reader = PerElementReader()
            for var, vals in per_elem_env.items():
                rdr.add(var, ids, vals)
            # (re-)register the served variables at top priority
            self.env.add_reader(rdr, first=True)
        seeding = {
            "lon": lon.astype(np.float32),
            "lat": lat.astype(np.float32),
            "time": times,
            "origin_marker": np.full(number, origin_marker, dtype=np.int32),
        }
        for name, v in props.items():
            dtype = self.ElementType.variables[name].get("dtype", np.float32)
            seeding[name] = v.astype(dtype)
        self._seedings.append(seeding)
        self.num_elements_scheduled_total += number
        self.mode = Mode.Ready
        return self

    @require_mode([Mode.Config, Mode.Ready])
    def seed_cone(self, lon, lat, time, radius=0, number=None, **kwargs):
        """Seed along a cone (line from (lon0,lat0) to (lon1,lat1) with
        radius varying linearly), elements spread uniformly in time if a
        time interval is given (reference basemodel/__init__.py:1240)."""
        lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
        lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
        if number is None:
            number = int(self.get_config("seed:number"))
        if len(lon) == 1:
            lons = np.repeat(lon, number)
            lats = np.repeat(lat, number)
        elif len(lon) == 2:
            frac = np.linspace(0, 1, number)
            # interpolate along the geodesic between the two endpoints
            az12, _, dist = inverse_np(lat[0], lon[0], lat[1], lon[1])
            lats, lons = direct_np(np.repeat(lat[0], number),
                                   np.repeat(lon[0], number),
                                   np.repeat(az12, number), frac * dist)
        else:
            raise ValueError("seed_cone needs 1 or 2 points")
        radius = np.atleast_1d(np.asarray(radius, dtype=np.float64))
        if len(radius) == 2:
            radius = np.linspace(radius[0], radius[1], number)
        return self.seed_elements(lons, lats, time=time, radius=radius,
                                  number=number, **kwargs)

    @require_mode([Mode.Config, Mode.Ready])
    def seed_within_polygon(self, lons, lats, number=None, **kwargs):
        """Seed uniformly inside a polygon given by vertex arrays
        (reference basemodel/__init__.py:1459), by rejection sampling with
        cos(lat) area weighting: the same ``self._np_random`` draws as the
        JAX package, so the same positions for the same seed."""
        lons = np.asarray(lons, dtype=np.float64)
        lats = np.asarray(lats, dtype=np.float64)
        if number is None:
            number = int(self.get_config("seed:number"))
        ring = np.column_stack([lons, lats])
        lo0, lo1 = lons.min(), lons.max()
        la0, la1 = lats.min(), lats.max()
        if not (-360 <= lo0 <= 360 and -90 <= la0 <= 90):
            raise ValueError(
                "Polygon coordinates look projected (not lon/lat): "
                f"lon {lo0}..{lo1}, lat {la0}..{la1}")
        out_lon = np.empty(0)
        out_lat = np.empty(0)
        for _attempt in range(1000):
            if len(out_lon) >= number:
                break
            n_try = max(4 * number, 128)
            cand_lon = self._np_random.uniform(lo0, lo1, n_try)
            sin0, sin1 = np.sin(np.radians([la0, la1]))
            cand_lat = np.degrees(np.arcsin(
                self._np_random.uniform(sin0, sin1, n_try)))
            inside = points_in_ring(cand_lon, cand_lat, ring)
            out_lon = np.concatenate([out_lon, cand_lon[inside]])
            out_lat = np.concatenate([out_lat, cand_lat[inside]])
        if len(out_lon) < number:
            raise ValueError(
                "Could not place elements inside the polygon (degenerate "
                "or zero-area geometry?)")
        return self.seed_elements(out_lon[:number], out_lat[:number],
                                  number=number, **kwargs)

    @require_mode([Mode.Config, Mode.Ready])
    def seed_letters(self, text, lon, lat, time, number, scale=1.2,
                     **kwargs):
        """Seed elements within the glyph outlines of ``text`` anchored at
        (lon, lat), one :meth:`seed_within_polygon` per glyph polygon
        (reference basemodel/__init__.py:1635-1652).  ``scale`` is the
        glyph height in degrees; ``number`` is per polygon.  The glyphs
        come from matplotlib's fonts, so this needs matplotlib."""
        try:
            from matplotlib.textpath import TextPath
            from matplotlib.font_manager import FontProperties
        except ImportError as e:
            raise ImportError("seed_letters draws its glyphs with "
                              "matplotlib, which is not installed") from e
        fp = FontProperties(family="DejaVu Sans", weight="bold")
        path = TextPath((lon, lat), text, size=1 * scale, prop=fp)
        for p in path.to_polygons():
            if len(p) < 3:
                continue
            self.seed_within_polygon(lons=p[:, 0], lats=p[:, 1],
                                     number=number, time=time, **kwargs)
        return self

    @require_mode([Mode.Config, Mode.Ready])
    def seed_repeated_segment(self, lons, lats, start_time, end_time=None,
                              time_interval=None, number_per_segment=None,
                              **kwargs):
        """Seed the same line segment repeatedly in time
        (reference basemodel/__init__.py:1402-1457)."""
        if number_per_segment is None:
            number_per_segment = int(self.get_config("seed:number"))
        az12, _, dist = inverse_np(lats[0], lons[0], lats[-1], lons[-1])
        frac = np.linspace(0, 1, number_per_segment)
        seg_lats, seg_lons = direct_np(
            np.repeat(lats[0], number_per_segment),
            np.repeat(lons[0], number_per_segment),
            np.repeat(az12, number_per_segment), frac * dist)
        if time_interval is not None and end_time is not None:
            t = start_time
            while t <= end_time:
                self.seed_elements(seg_lons, seg_lats, time=t,
                                   number=number_per_segment, **kwargs)
                t = t + time_interval
        else:
            self.seed_elements(seg_lons, seg_lats, time=start_time,
                               number=number_per_segment, **kwargs)
        return self

    @require_mode([Mode.Config, Mode.Ready])
    def seed_from_geojson(self, gjson, **kwargs):
        """Seed from a GeoJSON string or dict: Point, LineString or Polygon
        features with an optional 'time' and seed properties
        (reference basemodel/__init__.py:1356-1400)."""
        if isinstance(gjson, str):
            gjson = json.loads(gjson)
        if gjson.get("type") == "FeatureCollection":
            for feature in gjson["features"]:
                self.seed_from_geojson(feature, **kwargs)
            return self
        if gjson.get("type") != "Feature":
            raise ValueError("GeoJSON must be a Feature/FeatureCollection")
        props = dict(gjson.get("properties") or {})
        t = props.pop("time", None)
        if t is not None:
            if isinstance(t, (list, tuple)):
                t = [datetime.fromisoformat(str(x).rstrip("Z")) for x in t]
            else:
                t = datetime.fromisoformat(str(t).rstrip("Z"))
        props.update(kwargs)
        props.setdefault("time", t)
        geom = gjson["geometry"]
        coords = np.asarray(geom["coordinates"], dtype=float)
        if geom["type"] == "Point":
            return self.seed_elements(coords[0], coords[1], **props)
        if geom["type"] == "LineString":
            return self.seed_cone(coords[[0, -1], 0], coords[[0, -1], 1],
                                  **props)
        if geom["type"] == "Polygon":
            ring = np.asarray(geom["coordinates"][0], dtype=float)
            return self.seed_within_polygon(ring[:, 0], ring[:, 1], **props)
        raise ValueError(f"Unsupported geometry: {geom['type']}")

    @require_mode([Mode.Config, Mode.Ready])
    def seed_from_wkt(self, wkt, time, **kwargs):
        """Seed inside POLYGON/MULTIPOLYGON or at POINT WKT strings
        (reference basemodel/__init__.py:1561-1571), parsed with a
        from-scratch reader (no GDAL); a POLYGON's holes are ignored, as
        in the JAX package."""
        wkt = wkt.strip()
        if wkt.upper().startswith("POINT"):
            vals = [float(v) for v in re.findall(r"[-+0-9.eE]+", wkt)]
            return self.seed_elements(vals[0], vals[1], time=time, **kwargs)
        rings = re.findall(r"\(([^()]+)\)", wkt)
        if not rings:
            raise ValueError(f"Cannot parse WKT: {wkt[:60]}")
        for ring in rings[:1] if wkt.upper().startswith("POLYGON") \
                else rings:
            pts = np.array([[float(x) for x in pair.split()]
                            for pair in ring.split(",")])
            self.seed_within_polygon(pts[:, 0], pts[:, 1], time=time,
                                     **kwargs)
        return self

    @require_mode([Mode.Config, Mode.Ready])
    def seed_from_shapefile(self, shapefile, number=None, **kwargs):
        """Seed uniformly inside the polygons of an ESRI shapefile
        (reference basemodel/__init__.py:1573-1583), the elements shared
        out by each ring's (rough) area."""
        polys = shapefile_polygons(shapefile)
        if not polys:
            raise ValueError(f"No polygons found in {shapefile}")
        if number is None:
            number = int(self.get_config("seed:number"))
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        areas = np.array([abs(trapezoid(p[:, 1], p[:, 0])) for p in polys])
        areas = areas / max(areas.sum(), 1e-30)
        counts = np.maximum((areas * number).astype(int), 0)
        counts[0] += number - counts.sum()
        for poly, cnt in zip(polys, counts):
            if cnt > 0:
                self.seed_within_polygon(poly[:, 0], poly[:, 1],
                                         number=int(cnt), **kwargs)
        return self

    def seed_from_ladim(self, ladimfile, roms):
        """Seed from a LADiM *.rls release file [time, x, y, z]
        (reference basemodel/__init__.py:1655-1680); grid x/y are taken to
        the cell of the given ROMS reader's rho coordinates."""
        data = np.loadtxt(ladimfile,
                          dtype={"names": ("time", "x", "y", "z"),
                                 "formats": ("U20", "f4", "f4", "f4")},
                          usecols=(0, 1, 2, 3))
        time = np.array([datetime.strptime(t, "%Y-%m-%dT%H")
                         for t in np.atleast_1d(data["time"])])
        x = np.atleast_1d(data["x"])
        y = np.atleast_1d(data["y"])
        z = -np.abs(np.atleast_1d(data["z"]))
        xi = np.clip(x.astype(int), 0, roms._lon_rho.shape[1] - 1)
        yi = np.clip(y.astype(int), 0, roms._lon_rho.shape[0] - 1)
        lon = roms._lon_rho[yi, xi]
        lat = roms._lat_rho[yi, xi]
        self.seed_elements(lon=lon, lat=lat, z=z, time=list(time))

    def seed_from_geopandas(self, geodataframe, time, **kwargs):
        """Seed within the polygons (or at the points) of a GeoPandas
        GeoDataFrame or any object with a ``geometry`` sequence of
        shapely-like geometries (reference basemodel/__init__.py:
        1584-1652); geopandas itself is not needed."""
        geoms = list(geodataframe.geometry)
        if all(getattr(geom, "geom_type", "") == "Point" for geom in geoms):
            self.seed_elements(lon=[p.x for p in geoms],
                               lat=[p.y for p in geoms], time=time, **kwargs)
            return
        for geom in geoms:
            if hasattr(geom, "exterior"):
                lons, lats = zip(*list(geom.exterior.coords))
                self.seed_within_polygon(np.array(lons), np.array(lats),
                                         time=time, **kwargs)

    @require_mode([Mode.Config, Mode.Ready])
    def seed_from_dataset(self, ds, **kwargs):
        """Continue from the last valid state of a previous result: each
        element still active at its last finite position is seeded there,
        at that time, with its other element properties (reference
        basemodel/__init__.py:1681-1732)."""
        lon = ds["lon"].values
        lat = ds["lat"].values
        status = ds["status"].values
        times = ds.coords["time"]
        n, T = lon.shape
        last = np.array([np.where(np.isfinite(row))[0][-1]
                         if np.isfinite(row).any() else -1 for row in lon])
        keep = (last >= 0) & (status[np.arange(n), np.maximum(last, 0)]
                              == ACTIVE)
        idx = np.where(keep)[0]
        if len(idx) == 0:
            raise ValueError("No active elements to continue from")
        seed_time = np.asarray(times)[last[idx]]
        seed_time = [t.astype("datetime64[us]").item() for t in seed_time]
        props = {}
        for name in self.ElementType.variables:
            if name in ("lon", "lat", "ID", "status"):
                continue
            if name in ds:
                props[name] = ds[name].values[idx, last[idx]]
        props.update(kwargs)
        return self.seed_elements(lon[idx, last[idx]], lat[idx, last[idx]],
                                  time=np.array(seed_time),
                                  number=len(idx), **props)

    @require_mode([Mode.Config, Mode.Ready])
    def seed_from_file(self, filename, **kwargs):
        """Continue from a previous output file (reference
        basemodel/__init__.py:1733-1744)."""
        from ..export.io_netcdf import read_result
        return self.seed_from_dataset(read_result(filename), **kwargs)

    # --------------------------------------------------------- status -----
    def register_status(self, reason):
        """Ensure a deactivation reason has a status code; return it."""
        if reason not in self.status_categories:
            self.status_categories.append(reason)
        return self.status_categories.index(reason)

    def status_code(self, reason):
        """The status code of a deactivation reason (registering it)."""
        return self.register_status(reason)

    # ------------------------------------------------------------- run ----
    @require_mode(Mode.Ready, "Elements must be seeded before running")
    def run(self, time_step=None, steps=None, duration=None, end_time=None,
            time_step_output=None, outfile=None, export_variables=None,
            export_buffer_length=100):
        """Run the simulation; the result lands in ``self.result`` (and in
        ``outfile``, a CF trajectory NetCDF file, when given).
        ``export_buffer_length`` is accepted and unused, as in the JAX
        package: the flush length is ``export:buffer_length``.  The host's
        peak RSS in MB is sampled into ``self.memory_usage`` once an output
        interval; ``general:profile_dir`` traces the whole run with
        ``torch.profiler``.  Each stage of the run is a span (``timer.py``;
        ``self.spans``, under ``self.run_id``), its seconds in
        ``self.timers``:

        * ``preparing main loop``: ``:initial state``, ``:readers``,
          ``:to device``, ``:advance`` (the step's set-up);
        * ``main loop``: ``:readers`` each window (``:join wait``,
          ``:pack`` on this thread, ``:copy``), ``:advance`` (an interval's
          launches, and the final snapshot's), ``:to host`` (the frame's
          hand-off: a copy on the device, or to the host, which waits for
          the card), ``:export``;
        * ``postprocessing``: ``:assemble`` (with frames on the device,
          the copies to the host), ``:export``;

        and ``prefetch:pack`` on the prefetch thread, outside the timers.
        The counters (``self.counters``): ``readers.h2d_bytes``,
        ``run.d2h_bytes``, ``readers.windows_prefetched``,
        ``readers.windows_packed_on_loop``, ``run.frames_kept_on_device``,
        ``run.results_assembled_on_device``.

        On one device, without a flushing outfile, the output frames stay
        on the device when all of them fit in half its free memory, and
        the result is assembled there; otherwise each frame is copied to
        the host at its interval."""
        self.next_run()
        profile_dir = self.get_config("general:profile_dir")
        profiler = self._start_profiler(profile_dir) if profile_dir else None
        try:
            return self._run(time_step, steps, duration, end_time,
                             time_step_output, outfile, export_variables)
        finally:
            if profiler is not None:
                profiler.stop()
                logger.info("torch.profiler trace written to %s",
                            profile_dir)

    def _run(self, time_step, steps, duration, end_time, time_step_output,
             outfile, export_variables):
        """The body of :meth:`run`, inside its profiler."""
        self.timer_start("preparing main loop")
        self.mode = Mode.Run
        if time_step is None:
            time_step = timedelta(
                minutes=self.get_config("general:time_step_minutes"))
        dt = _seconds(time_step)
        if dt == 0:
            raise ValueError("time_step must be non-zero")
        all_times = np.concatenate([s["time"] for s in self._seedings])
        self.start_time = all_times.min() if dt > 0 else all_times.max()
        if steps is None:
            if duration is not None:
                duration = abs(_seconds(duration))
            elif end_time is not None:
                duration = abs(_seconds(end_time - self.start_time))
            else:
                raise ValueError("Provide one of steps, duration or end_time")
            steps = int(round(duration / abs(dt)))
        steps = int(steps)
        if steps < 1:
            raise ValueError("Simulation needs at least one step")
        if time_step_output is None:
            out_cfg = self.get_config("general:time_step_output_minutes")
            dt_out = out_cfg * 60.0 if out_cfg else abs(dt)
        else:
            dt_out = abs(_seconds(time_step_output))
        K = max(1, int(round(dt_out / abs(dt))))
        if abs(K * abs(dt) - dt_out) > 1e-9 * abs(dt):
            raise ValueError(
                "Output time step must be an integer multiple of time step")
        n_intervals = steps // K
        if n_intervals * K != steps:
            steps = n_intervals * K
            logger.warning("Rounding steps down to %d (whole output steps)",
                           steps)
        self.time_step = timedelta(seconds=dt)
        self.time_step_output = timedelta(seconds=K * dt)
        self.steps_calculation = steps
        # sharded output needs per-slot IDs in every snapshot (slots
        # migrate under domain decomposition)
        self._want_id_in_snapshot = bool(
            outfile is not None and self.get_config("export:sharded"))

        advance, final_snap, state, base_key = self.prepare_run(
            dt, K, export_variables=export_variables, total_steps=steps)

        def window(k):
            a = self.start_time + timedelta(seconds=k * K * dt)
            b = self.start_time + timedelta(seconds=(k + 1) * K * dt)
            return (min(a, b), max(a, b))

        self.timer_end("preparing main loop")
        self.timer_start("main loop")
        self.memory_usage = []
        frames, frame_times = [], []
        writer = None
        flushed = 0
        from ..parallel import multihost
        # sharded output (export:sharded): every process writes its own
        # slots' raw frames to <outfile>.pNNN.nc, merged offline by
        # tools/concat_shards.py; otherwise only the first process writes
        sharded_out = False
        if outfile is not None:
            sharded_out = bool(self.get_config("export:sharded")) \
                and multihost.is_multihost()
            if multihost.is_multihost() and not multihost.is_primary() \
                    and not sharded_out:
                outfile = None
        buffer_length = self.get_config("export:buffer_length") or 0
        n_real = self._n_real_elements
        if outfile is not None and sharded_out:
            self._shard_outfile = \
                f"{outfile}.p{multihost.process_index():03d}.nc"
            buffer_length = max(buffer_length, 1)
        elif outfile is not None and buffer_length > 0:
            from ..export.io_netcdf import IncrementalWriter
            writer = IncrementalWriter(outfile, n_real)
        exporting = sharded_out or writer is not None

        def flush(force=False):
            nonlocal flushed, writer
            if sharded_out and writer is None and frames:
                from ..export.io_netcdf import ShardWriter
                writer = ShardWriter(
                    self._shard_outfile, int(frames[0]["lon"].shape[-1]),
                    n_real, multihost.process_index(),
                    multihost.process_count())
            pending = frames[flushed:]
            if writer is not None and pending and (
                    force or len(pending) >= buffer_length):
                cut = None if sharded_out else n_real
                writer.append([{n: np.asarray(v)[..., :cut]
                                for n, v in f.items()} for f in pending],
                              frame_times[flushed:])
                flushed = len(frames)

        placement = self._dd or self._sharding
        # the plain path keeps its frames on the device until the result
        # is assembled where all of them fit in half the free memory: the
        # first frame tells their size
        keepable = not exporting and placement is None
        budget = _frame_budget(self.device) if keepable else 0
        keep = False

        def host(snap):
            with self.timed("main loop:to host"):
                if keep:
                    # a copy on the device: later in-place writes to the
                    # state's tensors do not reach it
                    self.count("run.frames_kept_on_device")
                    return {n: v.clone() for n, v in snap.items()}
                if placement is not None:
                    frame = placement.host_frame(snap, local=sharded_out)
                else:
                    frame = {n: v.cpu() for n, v in snap.items()}
            self.count("run.d2h_bytes", sum(int(v.nbytes)
                                            for v in frame.values()))
            return frame

        def assemble():
            result = self._assemble_result(frames, frame_times,
                                           trim=not sharded_out)
            if keep:
                self.count("run.d2h_bytes", sum(
                    result[n].values.nbytes for n in result.variables))
                self.count("run.results_assembled_on_device")
            return result

        def device_states(k):
            # host packing and the copy to the device, timed apart from
            # the steps (the copy returns once the tables are on the card);
            # a decomposed grid is split into its tiles' bands here, before
            # the next window's prefetch starts
            with self.timed("main loop:readers"):
                states = self.env.build_device_states(
                    *window(k), category="main loop:readers")
                if self._dd is not None:
                    with self.timed("main loop:readers:copy"):
                        states = self._dd.retile(states)
            return states
        try:
            for k in range(n_intervals):
                t_rel = np.float32(k * K * dt)
                dev_states = device_states(k)
                if k + 1 < n_intervals:
                    # Overlap the next window's host packing with this
                    # interval's steps.  The JAX package starts the thread
                    # after its asynchronous advance has returned; here
                    # advance returns only when the host has launched every
                    # kernel of the interval, so the thread starts before
                    # it.  It packs on the host only: the copy to the card
                    # is made by device_states(k + 1), on this thread.
                    self.env.prefetch_device_states(*window(k + 1))
                with self.timed("main loop:advance"):
                    state, snap = advance(state, dev_states, t_rel,
                                          rng.fold_in(base_key, k))
                if k == 0 and keepable:
                    frame_bytes = sum(v.nbytes for v in snap.values())
                    keep = frame_bytes * (n_intervals + 1) <= budget
                frames.append(host(snap))
                frame_times.append(self.start_time
                                   + timedelta(seconds=float(t_rel)))
                self._sample_memory()
                if exporting:
                    with self.timed("main loop:export"):
                        flush()
            t_rel = np.float32(n_intervals * K * dt)
            dev_states = device_states(n_intervals - 1)
            with self.timed("main loop:advance"):
                snap = final_snap(state, dev_states, t_rel)
            frames.append(host(snap))
            frame_times.append(self.start_time
                               + timedelta(seconds=float(t_rel)))
            self.state = state if placement is None else \
                element_state_from_numpy(placement.host_state(state),
                                         self.device)
        except Exception:
            self.env.cancel_prefetch()
            if writer is not None:
                flush(force=True)
                writer.abort_close()
            if frames:
                self.result = assemble()
                self.mode = Mode.Result
            self.timer_end("main loop")
            raise
        self.timer_end("main loop")

        self.timer_start("postprocessing")
        # sharded output: self.result holds this process's own slots (with
        # an ID variable); the global file comes from concat_shards
        with self.timed("postprocessing:assemble"):
            self.result = assemble()
        if outfile is not None:
            with self.timed("postprocessing:export"):
                if writer is not None:
                    flush(force=True)
                    writer.finalize(self.result)
                elif not sharded_out:
                    from ..export.io_netcdf import write_result
                    write_result(self.result, outfile)
        self.timer_end("postprocessing")
        self.timer_end("total time")
        self.mode = Mode.Result
        self.post_run()
        return self

    def _start_profiler(self, profile_dir):
        """A started ``torch.profiler`` that writes its trace into
        ``profile_dir`` when stopped (CUDA kernels too on a card, and every
        thread where the installed torch can)."""
        from torch.profiler import ProfilerActivity, profile, \
            tensorboard_trace_handler
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        try:
            # every thread's spans, the prefetch thread's too
            from torch._C._profiler import _ExperimentalConfig
            extra = dict(experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
        except (ImportError, TypeError):
            extra = {}
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(
                               profile_dir), **extra)
        profiler.start()
        return profiler

    def _sample_memory(self):
        """Append the host's peak RSS in MB (reference samples psutil
        into ``memory_usage`` each step, basemodel/__init__.py:2194)."""
        try:
            import resource
            self.memory_usage.append(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
        except Exception:  # noqa: BLE001 (diagnostics only)
            pass

    def post_run(self):
        """Model hook called after the run completes
        (reference basemodel/__init__.py post_run)."""

    def set_mesh(self, devices):
        """The tiles of particle sharding or domain decomposition: a list
        of torch devices, one tile each, repeats allowed (``["cpu"] * 8``,
        ``["cuda:0"] * 4``); across processes, this process's own tiles.
        ``None`` restores the default, the visible CUDA cards (one card
        or the CPU: no sharding)."""
        self._mesh_devices = list(devices) if devices is not None else None

    def _tile_mesh(self):
        """The run's mesh of tiles (``parallel.mesh.Mesh``)."""
        from ..parallel.mesh import particle_mesh
        return particle_mesh(getattr(self, "_mesh_devices", None),
                             self.device)

    def simulation_direction(self):
        """+1 forward, -1 backward (reference basemodel
        ``simulation_direction``)."""
        ts = getattr(self, "time_step", None)
        if ts is None:
            return 1
        secs = ts.total_seconds() if hasattr(ts, "total_seconds") \
            else float(ts)
        return -1 if secs < 0 else 1

    def SRS(self):
        """The simulation's coordinate reference system: geographic WGS84
        (positions are lon/lat; reference basemodel ``SRS``)."""
        return LatLonCRS("+proj=latlong +datum=WGS84")

    def add_metadata(self, key, value):
        """Attach a global attribute to the result and its output file
        (reference basemodel ``add_metadata``)."""
        if not hasattr(self, "_extra_metadata"):
            self._extra_metadata = {}
        self._extra_metadata[key] = value

    @staticmethod
    def index_of_first_and_last(array):
        """Index of the first and the last finite value of each row; -1
        for a row with none."""
        ok = np.isfinite(array)
        any_ok = ok.any(axis=1)
        first = np.where(any_ok, ok.argmax(axis=1), -1)
        last = np.where(any_ok,
                        array.shape[1] - 1 - ok[:, ::-1].argmax(axis=1), -1)
        return first, last

    @staticmethod
    def points_within_polygon(lons, lats, polygon_lons, polygon_lats):
        """Boolean mask of the points inside the polygon (even-odd rule;
        the reference delegates to shapely)."""
        ring = np.column_stack([np.asarray(polygon_lons),
                                np.asarray(polygon_lats)])
        return points_in_ring(lons, lats, ring)

    def prepare_run(self, dt, K, export_variables=None, total_steps=None):
        """Finalise the environment, build the initial device state and the
        (advance, final_snapshot) callables.  Split out of ``run`` so
        benchmarks drive the loop directly.  Its stages are the spans
        ``preparing main loop:initial state``, ``:readers``, ``:to device``
        and ``:advance``."""
        if getattr(self, "start_time", None) is None:
            all_times = np.concatenate([s["time"] for s in self._seedings])
            self.start_time = all_times.min() if dt > 0 else all_times.max()
            self.time_step = timedelta(seconds=dt)
            self.time_step_output = timedelta(seconds=K * dt)
        self.timer_start("preparing main loop:initial state")
        if self.get_config("seed:ocean_only"):
            for s in self._seedings:
                s["lon"], s["lat"] = self.closest_ocean_points(
                    s["lon"], s["lat"])
        state_np = self._build_initial_state(dt)
        self.timer_end("preparing main loop:initial state")

        self.timer_start("preparing main loop:readers")
        constant_overrides = {}
        fallback_overrides = {}
        for var in self.required_variables:
            c = self.get_config(f"environment:constant:{var}", default=None)
            if c is not None:
                constant_overrides[var] = c
            f = self.get_config(f"environment:fallback:{var}", default=None)
            if f is not None:
                fallback_overrides[var] = f
        hd = self.get_config("drift:horizontal_diffusivity")
        if hd and "horizontal_diffusivity" in self.required_variables:
            fallback_overrides["horizontal_diffusivity"] = hd
        self.env.max_reader_fails = self.get_config(
            "readers:max_number_of_fails")
        self.env.finalize(self.start_time,
                          required_profiles=self.required_profiles(),
                          constant_overrides=constant_overrides,
                          fallback_overrides=fallback_overrides)
        self._auto_landmask_fallback()

        unc = []
        cu = self.get_config("drift:current_uncertainty")
        cuu = self.get_config("drift:current_uncertainty_uniform")
        wu = self.get_config("drift:wind_uncertainty")
        if cu:
            unc.append((("x_sea_water_velocity", "y_sea_water_velocity"),
                        float(cu), False))
        if cuu:
            unc.append((("x_sea_water_velocity", "y_sea_water_velocity"),
                        float(cuu), True))
        if wu:
            unc.append((("x_wind", "y_wind"), float(wu), False))
        self.env.uncertainty = unc

        # simulation extent: seed bbox grown by max_speed * duration
        # (reference basemodel/__init__.py:2018-2044)
        max_speed = float(self.get_config("drift:max_speed"))
        duration = abs(dt) * (total_steps if total_steps is not None else K)
        lons = np.concatenate([s["lon"] for s in self._seedings])
        lats = np.concatenate([s["lat"] for s in self._seedings])
        margin_lat = max_speed * duration / 111000.0
        coslat = max(np.cos(np.radians(np.abs(lats).max())), 0.05)
        margin_lon = margin_lat / coslat
        self.simulation_extent = (
            float(lons.min() - margin_lon),
            float(np.clip(lats.min() - margin_lat, -90, 90)),
            float(lons.max() + margin_lon),
            float(np.clip(lats.max() + margin_lat, -90, 90)))
        end_time = self.start_time + timedelta(seconds=dt * (
            total_steps if total_steps is not None else K))
        self.env.prepare_readers(
            extent=self.simulation_extent,
            start_time=min(self.start_time, end_time),
            end_time=max(self.start_time, end_time), max_speed=max_speed,
            interval_seconds=abs(dt) * K,
            truncate_depth=self.get_config(
                "drift:truncate_ocean_model_below_m", default=None),
            pair_hint="xy")
        # seafloor seeding: z = -depth at the seed positions (reference
        # basemodel/__init__.py:1168-1210)
        if self.get_config("seed:seafloor", default=False):
            dev0 = self.env.build_device_states(
                self.start_time, self.start_time + timedelta(seconds=dt),
                category="preparing main loop:readers")
            envs0, _ = self.env.get_environment(
                dev0, ["sea_floor_depth_below_sea_level"], np.float32(0.0),
                *(torch.as_tensor(state_np[k], device=self.device)
                  for k in ("lon", "lat", "z")))
            depth0 = envs0["sea_floor_depth_below_sea_level"].cpu().numpy()
            state_np["z"] = (-depth0 + 0.01).astype(np.float32)
            state_np["prev_z"] = state_np["z"].copy()
        self.timer_end("preparing main loop:readers")

        self.timer_start("preparing main loop:to device")
        # ---- domain decomposition: tile the primary forcing grid over the
        # mesh and re-layout elements into per-tile buffers (the slot of
        # reference basereader/structured.py:121-123 block buffers at
        # multi-device scale; see parallel/tiled.py)
        for reader, _ in self.env._plan:
            reader._dd_keep_host = reader._dd_defer_pack = False
        mesh = self._tile_mesh()
        self._dd = self._sharding = None
        if mesh.n_tiles > 1 and \
                self.get_config("parallel:domain_decomposition"):
            from ..parallel.tiled import DDContext
            self._dd = DDContext(
                self, max_speed=max_speed, dt=dt, mesh=mesh,
                capacity_factor=self.get_config(
                    "parallel:tile_capacity_factor"),
                tile_grid=self.get_config("parallel:tile_grid"))
            state_np = self._dd.bin_initial_state(state_np,
                                                  self._n_real_elements)
            self._n_padded_elements = len(state_np["lon"])
        elif mesh.n_tiles > 1 and \
                self.get_config("parallel:particle_sharding"):
            from ..parallel.mesh import ShardedRun
            self._sharding = ShardedRun(mesh, self._n_padded_elements,
                                        self._n_real_elements)
        if self._dd is not None or self._sharding is not None:
            # the binned per-tile buffers, or the padded element axis,
            # split evenly: each process keeps its own tiles
            from ..parallel.mesh import shard_state
            state = shard_state(state_np, mesh)
            logger.info("%s %d slots over %d tiles",
                        "Decomposing" if self._dd else "Sharding",
                        self._n_padded_elements, mesh.n_tiles)
        else:
            state = element_state_from_numpy(state_np, self.device)
        self.timer_end("preparing main loop:to device")
        self.export_variables = export_variables
        self.timer_start("preparing main loop:advance")
        advance, final_snap = self._make_advance(K, dt)
        self.timer_end("preparing main loop:advance")
        if self.get_config("general:rng") == "rbg":
            base_key = rng.rbg_key(self.rng_seed)
        else:
            base_key = rng.PRNGKey(self.rng_seed)
        return advance, final_snap, state, base_key

    def _build_initial_state(self, dt):
        """Host arrays of the initial state (every element NOT_RELEASED,
        with its release time relative to the start)."""
        n = self.num_elements_scheduled_total
        self._n_real_elements = n
        # pad the capacity to a multiple of the tile count so the element
        # axis shards evenly; the padding stays NOT_RELEASED
        n_tiles = self._tile_mesh().n_tiles
        if n_tiles > 1 and self.get_config("parallel:particle_sharding") \
                and not self.get_config("parallel:domain_decomposition"):
            n = ((n + n_tiles - 1) // n_tiles) * n_tiles
        self._n_padded_elements = n
        sign = 1.0 if dt > 0 else -1.0
        arrays = {}
        for name, spec in self.ElementType.variables.items():
            arrays[name] = np.full(n, spec.get("default", 0),
                                   dtype=spec.get("dtype", np.float32))
        offset = 0
        for s in self._seedings:
            m = len(s["lon"])
            for kname, v in s.items():
                if kname != "time" and kname in arrays:
                    arrays[kname][offset:offset + m] = v
            offset += m
        arrays["ID"] = np.arange(1, n + 1, dtype=np.int32)
        arrays["status"] = np.full(n, NOT_RELEASED, dtype=np.int32)
        all_times = np.concatenate([s["time"] for s in self._seedings])
        rel = np.array([(t - self.start_time).total_seconds()
                        for t in all_times], dtype=np.float32)
        # padding elements (if any) are never released
        arrays["release_tau"] = np.full(n, np.inf, dtype=np.float32)
        arrays["release_tau"][:len(rel)] = (rel * sign).astype(np.float32)
        arrays["prev_lon"] = arrays["lon"].copy()
        arrays["prev_lat"] = arrays["lat"].copy()
        arrays["prev_z"] = arrays["z"].copy()
        for var in self.store_previous_env_vars():
            arrays[f"prev_env_{var}"] = np.full(n, np.nan, dtype=np.float32)
        return arrays

    def store_previous_env_vars(self):
        """Environment variables whose previous-step values the model
        needs (model hook; reference ``store_previous_if``)."""
        return []

    def _auto_landmask_fallback(self):
        """Resolve land_binary_mask when no reader serves it and no
        fallback is set.  The reference adds the GSHHG global landmask,
        which always covers (reference reader_global_landmask.py:
        201-260); the bundled raster is regional, so it is added only when
        it covers every seed, and otherwise the run raises while a
        coastline action is on: an all-ocean default would quietly turn
        'stranding' into a no-op."""
        if "land_binary_mask" not in self.required_variables:
            return
        if self.env.priority_list.get("land_binary_mask") or \
                self.env.fallback_values.get("land_binary_mask") is not None:
            return
        if self.get_config("general:use_auto_landmask"):
            reason = "auto landmask failed"
            try:
                lm = GlobalLandmask()
                lon = np.concatenate([s["lon"] for s in self._seedings])
                lat = np.concatenate([s["lat"] for s in self._seedings])
                if bool(np.all(lm.covers_positions(lon, lat))):
                    self.env.add_reader(lm)
                    self.env._plan.append((lm, ["land_binary_mask"]))
                    return
                reason = ("the bundled coastline raster does not cover "
                          "the seeding area")
            except (OSError, ValueError, NotImplementedError) as e:
                reason = f"no landmask data available ({e})"
        else:
            reason = "general:use_auto_landmask is False"
        if self.get_config("general:coastline_action") == "none":
            self.env.fallback_values["land_binary_mask"] = 0.0
            return
        raise ValueError(
            f"general:coastline_action="
            f"'{self.get_config('general:coastline_action')}' needs a "
            f"landmask, but {reason}. Either add a gridded ocean reader "
            "whose grid provides a land mask, supply a coastline "
            "shapefile (OPENDRIFT_LANDMASK_SHP), set "
            "environment:fallback:land_binary_mask=0 to explicitly "
            "treat the domain as all ocean, or set "
            "general:coastline_action='none'")

    def closest_ocean_points(self, lon, lat):
        """Move points on land to the nearest ocean cell of a gridded
        landmask reader (reference basemodel/__init__.py:1005-1070)."""
        lon = np.atleast_1d(np.asarray(lon, dtype=np.float64)).copy()
        lat = np.atleast_1d(np.asarray(lat, dtype=np.float64)).copy()
        reader = next((r for r in self.env.readers.values()
                       if "land_binary_mask" in getattr(r, "variables", [])
                       and hasattr(r, "_load_frame")), None)
        if reader is None:
            logger.warning("no gridded landmask available; cannot "
                           "relocate land points to ocean")
            return lon, lat
        land = np.asarray(reader._load_frame("land_binary_mask", 0))
        if land.ndim == 3:
            land = land[0]
        X, Y = np.meshgrid(reader.x[reader._ix], reader.y[reader._iy])
        lons_g, lats_g = (X, Y) if reader.crs.is_latlon \
            else reader.crs.inv(np, X, Y)
        ocean = land < 0.5
        if not ocean.any():
            return lon, lat
        from scipy.spatial import cKDTree
        pts = np.column_stack([lon, lat])
        # each point's query is its own: all cores give the same answer
        _, idx = cKDTree(np.column_stack([lons_g.ravel(),
                                          lats_g.ravel()])).query(
            pts, workers=-1)
        on_land = land.ravel()[idx] > 0.5
        if on_land.any():
            _, oidx = cKDTree(np.column_stack(
                [lons_g[ocean], lats_g[ocean]])).query(pts[on_land],
                                                       workers=-1)
            lon[on_land] = lons_g[ocean][oidx]
            lat[on_land] = lats_g[ocean][oidx]
        return lon, lat

    def _cond_holds(self, cond):
        """Evaluate ``[key, 'is'|'is_not', value]`` (reference
        basemodel/__init__.py:4966)."""
        key, op, value = cond
        current = self.get_config(key, default=None)
        if op == "is":
            return current is value or current == value
        if op == "is_not":
            return not (current is value or current == value)
        raise ValueError(f"Unknown conditional operator: {op}")

    def _skip_if_holds(self, spec):
        cond = spec.get("skip_if")
        return cond is not None and self._cond_holds(cond)

    def active_required_variables(self):
        """Required variables minus those skipped by config conditions."""
        return [v for v, spec in self.required_variables.items()
                if not self._skip_if_holds(spec)]

    def required_profiles(self):
        """Variables needing vertical profiles (``profiles_if`` gated)."""
        out = []
        for v, spec in self.required_variables.items():
            if not spec.get("profiles", False) or self._skip_if_holds(spec):
                continue
            cond = spec.get("profiles_if")
            if cond is not None and not self._cond_holds(cond):
                continue
            out.append(v)
        return out

    # --------------------------------------------------------- the step ---
    def _dynamic_params(self):
        maxage = self.get_config("drift:max_age_seconds")
        return {
            "dt": None,
            "hdiff": float(self.get_config("drift:horizontal_diffusivity")),
            "max_age": float(maxage) if maxage is not None else np.inf,
        }

    def _make_advance(self, K, dt):
        """Build the (advance_interval, final_snapshot) callables."""
        params = self._dynamic_params()
        params["dt"] = float(dt)
        env = self.env
        sign = 1.0 if dt > 0 else -1.0
        coastline_action = self.get_config("general:coastline_action")
        seafloor_action = self.get_config("general:seafloor_action")
        env_vars = self.active_required_variables()
        coastline_bisection = self.get_config("general:coastline_bisection",
                                              default="refetch")
        # profile variables that only have a fallback need no profile:
        # nothing reads one (vertical_mixing switches 'environment' to
        # windspeed_Large1994 when no reader serves the diffusivity)
        profile_vars = env.required_profiles if (
            any(env.has_reader_for(v) for v in env.required_profiles)
            or self.get_config("vertical_mixing:TSprofiles", default=False)
        ) else []
        zlevels = self._profile_zlevels()
        has_seafloor = "sea_floor_depth_below_sea_level" in env_vars
        no_fallback_vars = [v for v in env_vars
                            if env.fallback_values.get(v, None) is None]
        status_stranded = self.status_code("stranded")
        status_retired = self.status_code("retired")
        status_outside = self.status_code("outside")
        status_missing = self.status_code("missing_data")
        status_seafloor = self.status_code("seafloor")
        # readers keyed on element IDs (per-element environment seeding)
        # and ensemble forcing (elements ride members round-robin by ID)
        # are given the IDs through the ``member`` channel
        has_ids = any(getattr(r, "needs_ids", False)
                      or getattr(r, "ensemble_size", 1) > 1
                      for r in env.readers.values())
        bounds = [(self.get_config(f"drift:deactivate_{side}_of"), name, op)
                  for side, name, op in (("west", "lon", torch.lt),
                                         ("east", "lon", torch.gt),
                                         ("south", "lat", torch.lt),
                                         ("north", "lat", torch.gt))]
        # when no reader serves the landmask (fallback only) there is no
        # coast to cross: a fallback of 0 never strands anything
        landmask_spatial = env.has_reader_for("land_binary_mask")
        coast_active = ("land_binary_mask" in env_vars
                        and coastline_action != "none"
                        and (landmask_spatial or float(
                            env.fallback_values.get("land_binary_mask", 0.0)
                            or 0.0) > 0.5))

        # block-backed env fetch: with single-fetch RK one corner-block
        # gather serves the start-position environment AND every RK stage.
        # Resolved at the first step: the plan needs the readers' samplers,
        # which exist only after device_state().
        want_block = bool(
            self.get_config("drift:advection_single_fetch", default=False)
            and self.get_config("drift:advection_scheme") != "euler")
        block_plan_cache = []

        def block_plan():
            if not block_plan_cache:
                plan = None
                idx = env.uv_block_plan_index() if want_block else None
                if idx is not None:
                    b_reader, b_served = env._plan[idx]
                    keep = [v for v in b_served if v in env_vars
                            and b_reader.name in env.priority_list.get(v, [])]
                    for v in ("x_sea_water_velocity", "y_sea_water_velocity"):
                        if v not in keep:
                            keep.append(v)
                    plan = (idx, keep)
                block_plan_cache.append(plan)
            return block_plan_cache[0]

        def fetch_block(d, dev_states):
            """(plan index, corner block, covers0) of the block reader at
            the elements' positions, or None."""
            plan = block_plan()
            if plan is None:
                return None
            block_idx, block_keep = plan
            b_reader = env._plan[block_idx][0]
            member = d["ID"] if getattr(b_reader, "ensemble_size", 1) > 1 \
                else None
            block, covers0 = b_reader.corner_block(
                dev_states[block_idx], d["lon"], d["lat"], d["z"],
                member=member, keep_vars=block_keep)
            return (block_idx, block, covers0)

        def coastline(d, active, envs, dev_states, t_rel, block_ctx):
            """Coastline interaction (reference :670-746): strand at the
            first land point of the last transect (3 bisection rounds,
            each one mask fetch or, with 'block' bisection, one
            re-evaluation of the held corner block; only when something
            strands), or move back to the previous position."""
            on_land = envs["land_binary_mask"] > 0.5
            if coastline_action == "previous":
                back = active & on_land
                d["lon"] = torch.where(back, d["prev_lon"], d["lon"])
                d["lat"] = torch.where(back, d["prev_lat"], d["lat"])
                return active
            strand = active & on_land
            if landmask_spatial and bool(strand.any()):
                plon, plat = d["prev_lon"], d["prev_lat"]
                lon_a, lat_a = d["lon"], d["lat"]
                use_block_mask = (coastline_bisection == "block"
                                  and block_ctx is not None
                                  and "land_binary_mask" in block_ctx[1][4])

                def mask_at(slon, slat):
                    if use_block_mask:
                        vals, _ = env._plan[block_ctx[0]][0].sample_from_block(
                            dev_states[block_ctx[0]], block_ctx[1], t_rel,
                            slon, slat, ["land_binary_mask"])
                        return vals["land_binary_mask"]
                    menv, _ = env.get_environment(
                        dev_states, ["land_binary_mask"], t_rel, slon, slat,
                        d["z"])
                    return menv["land_binary_mask"]

                lo = torch.zeros_like(lon_a)
                hi = torch.ones_like(lon_a)
                for _ in range(3):
                    mid = 0.5 * (lo + hi)
                    land = mask_at(plon + mid * (lon_a - plon),
                                   plat + mid * (lat_a - plat)) > 0.5
                    hi = torch.where(land, mid, hi)
                    lo = torch.where(land, lo, mid)
                d["lon"] = torch.where(strand, plon + hi * (lon_a - plon),
                                       lon_a)
                d["lat"] = torch.where(strand, plat + hi * (lat_a - plat),
                                       lat_a)
            d["status"] = torch.where(strand, status_stranded, d["status"])
            return d["status"] == ACTIVE

        def pre_update(state, dev_states, t_rel, tau, key):
            """Release, env fetch, deactivations, seafloor — the phase
            before motion (reference loop :2193-2265)."""
            d = dict(state.data)
            release = (d["status"] == NOT_RELEASED) & \
                (d["release_tau"] < float(tau + np.float32(abs(params["dt"]))))
            d["status"] = torch.where(release, ACTIVE, d["status"])
            active = d["status"] == ACTIVE
            block_ctx = fetch_block(d, dev_states)
            envs, missing = env.get_environment(
                dev_states, env_vars, t_rel, d["lon"], d["lat"], d["z"],
                key=key if env.uncertainty else None,
                member=d["ID"] if has_ids else None, block_ctx=block_ctx)
            if no_fallback_vars:
                miss_any = torch.zeros_like(active)
                for v in no_fallback_vars:
                    miss_any = miss_any | missing[v]
                d["status"] = torch.where(active & miss_any, status_missing,
                                          d["status"])
                active = d["status"] == ACTIVE
            bad = (~torch.isfinite(d["lon"])) | (~torch.isfinite(d["lat"])) \
                | (torch.abs(d["lat"]) > 90.0)
            for value, name, op in bounds:
                if value is not None:
                    bad = bad | op(d[name], value)
            d["status"] = torch.where(active & bad, status_outside,
                                      d["status"])
            active = d["status"] == ACTIVE
            if coast_active:
                active = coastline(d, active, envs, dev_states, t_rel,
                                   block_ctx)
            if has_seafloor and seafloor_action != "none":
                depth = envs["sea_floor_depth_below_sea_level"]
                below = d["z"] < -depth
                if seafloor_action == "lift_to_seafloor":
                    d["z"] = torch.where(active & below, -depth, d["z"])
                elif seafloor_action == "deactivate":
                    d["status"] = torch.where(active & below,
                                              status_seafloor, d["status"])
                elif seafloor_action == "previous":
                    d["z"] = torch.where(active & below, d["prev_z"], d["z"])
            return ElementState(d), envs, block_ctx

        dd = self._dd

        def snapshot(state, envs):
            export = self.export_variables
            # domain decomposition: slots move with migration, so the host
            # re-indexes every frame by element ID
            always = ("lon", "lat", "z", "status") + (
                ("ID",) if dd is not None
                or getattr(self, "_want_id_in_snapshot", False) else ())
            snap = {name: state.data[name]
                    for name in self.ElementType.variables
                    if export is None or name in export or name in always}
            snap.update({name: v for name, v in envs.items()
                         if export is None or name in export})
            return snap

        def post_update(state, envs, dev_states, t_rel, key, block_ctx):
            """Aging/retirement, model physics, horizontal diffusion —
            the phase after the output snapshot (reference :2266-2304)."""
            d = dict(state.data)
            active = d["status"] == ACTIVE
            d["age_seconds"] = torch.where(
                active, d["age_seconds"] + abs(params["dt"]),
                d["age_seconds"])
            d["status"] = torch.where(
                active & (d["age_seconds"] > params["max_age"]),
                status_retired, d["status"])
            d["prev_lon"] = d["lon"]
            d["prev_lat"] = d["lat"]
            d["prev_z"] = d["z"]
            profiles = None
            if profile_vars:
                profiles = env.get_profiles(dev_states, profile_vars, t_rel,
                                            d["lon"], d["lat"], zlevels)
            ctx = StepContext(self, ElementState(d), envs, profiles,
                              dev_states, t_rel, params, key, zlevels)
            if block_ctx is not None:
                ctx.uv_block_ctx = (env._plan[block_ctx[0]][0],
                                    dev_states[block_ctx[0]], block_ctx[1],
                                    block_ctx[2])
            self.update(ctx)
            ctx.horizontal_diffusion()
            ctx.flush_positions()
            prev = {f"prev_env_{v}": envs[v]
                    for v in self.store_previous_env_vars() if v in envs}
            if prev:
                ctx.state = ctx.state.replace(**prev)
            return ctx.state

        def step(state, dev_states, t_rel, tau, key, want_snap):
            state, envs, block_ctx = pre_update(state, dev_states, t_rel, tau,
                                                rng.fold_in(key, 987654))
            snap = snapshot(state, envs) if want_snap else None
            state = post_update(state, envs, dev_states, t_rel, key,
                                block_ctx)
            return state, snap

        def advance(state, dev_states, t0_rel, key):
            """K steps from host float32 time ``t0_rel``; returns the new
            state and the snapshot taken at the first step."""
            t0_rel = np.float32(t0_rel)
            state, snap = step(state, dev_states, t0_rel,
                               t0_rel * np.float32(sign), rng.fold_in(key, 0),
                               True)
            for i in range(1, K):
                t_rel = t0_rel + np.float32(i) * np.float32(params["dt"])
                state, _ = step(state, dev_states, t_rel,
                                t_rel * np.float32(sign),
                                rng.fold_in(key, i), False)
            return state, snap

        def final_snapshot(state, dev_states, t_rel):
            t_rel = np.float32(t_rel)
            state, envs, _ = pre_update(state, dev_states, t_rel,
                                        t_rel * np.float32(sign),
                                        rng.PRNGKey(0))
            return snapshot(state, envs)

        if dd is not None:
            # the tiles step in turn, a step at a time, each with the
            # unchanged step program on its own slots and extended forcing
            # band; migration after every step
            return (dd.wrap_advance(step, K, params["dt"], sign),
                    dd.wrap_final(final_snapshot))
        if self._sharding is not None:
            return (self._sharding.wrap_advance(advance),
                    self._sharding.wrap_final(final_snapshot))
        return advance, final_snapshot

    def _profile_zlevels(self):
        zr = self.required_profiles_z_range or [-20.0, 0.0]
        return np.linspace(zr[1], zr[0], 9, dtype=np.float32)

    def update(self, ctx):
        """Model physics for one time step — must be overridden."""
        raise NotImplementedError(
            "Subclasses must define an update(ctx) method")

    # --------------------------------------------------- result assembly --
    def _assemble_result(self, frames, frame_times, trim=True):
        """The frames (dicts of (..., N) tensors, on the device or the
        host, or numpy arrays) as the run's result: each variable stacked
        into (..., N, T) where its frames lie, floats NaN where the frame
        is not valid; frames on the card are brought to the host in one
        copy a column, one column at a time: the peak is the frames and
        one column."""
        # particle sharding pads the element axis: keep the real elements
        cut = getattr(self, "_n_real_elements", None) if trim else None

        def stacked(name):
            return torch.stack([torch.as_tensor(f[name])[..., :cut]
                                for f in frames], dim=-1)
        status = stacked("status")
        on_card = status.device.type == "cuda"

        def to_host(column):
            if not on_card:
                return column.numpy()
            # pinned memory from torch's caching host allocator, which a
            # later run's columns reuse once this result is gone; the copy
            # is queued, and waited for below
            out = torch.empty(column.shape, dtype=column.dtype,
                              pin_memory=True)
            return out.copy_(column, non_blocking=True).numpy()
        invalid = _invalid_frames(status)
        values = {"status": to_host(status)}
        del status
        for n in frames[0]:
            if n != "status":
                column = stacked(n)
                if column.is_floating_point():
                    column.masked_fill_(invalid, float("nan"))
                values[n] = to_host(column)
        if on_card:
            torch.cuda.current_stream(invalid.device).synchronize()
        variables = {}
        for n in frames[0]:
            attrs = {}
            if n in self.ElementType.variables:
                spec = self.ElementType.variables[n]
                attrs = {k: v for k, v in spec.items()
                         if k in ("units", "standard_name", "description")}
            variables[n] = DataVar(("trajectory", "time"), values[n], attrs)
        coords = {
            "trajectory": np.arange(1, values["status"].shape[0] + 1),
            "time": np.array(frame_times, dtype="datetime64[ns]"),
        }
        attrs = {
            "opendrift_class": type(self).__name__,
            "opendrift_module": type(self).__module__,
            "time_coverage_start": str(frame_times[0]),
            "time_coverage_end": str(frame_times[-1]),
            "time_step_calculation": str(self.time_step),
            "time_step_output": str(self.time_step_output),
            "status_categories": " ".join(self.status_categories),
        }
        attrs.update(self._config_to_attributes())
        attrs.update(getattr(self, "_extra_metadata", {}))
        return TrajectoryDataset(variables, coords, attrs)

    def num_elements_total(self):
        return self.num_elements_scheduled_total

    def num_elements_scheduled(self):
        return self.num_elements_scheduled_total

    def num_elements_activated(self):
        """Elements released by the end of the run, as the JAX package
        counts them: valid at the last output plus deactivated there."""
        if self.result is not None:
            status = self.result["status"].values
            return int((~np.isnan(
                np.asarray(self.result["lon"].values[:, -1]))).sum()
                + (status[:, -1] > 0).sum())
        return 0

    def num_elements_active(self):
        if self.result is not None:
            return int((self.result["status"].values[:, -1]
                        == ACTIVE).sum())
        return 0

    def num_elements_deactivated(self):
        if self.result is not None:
            return int((self.result["status"].values[:, -1]
                        > ACTIVE).sum())
        return 0

    def get_time_array(self):
        """Output times of the last run and their offsets from the first
        (deprecated upstream; use ``result.time``; reference
        basemodel/__init__.py:4506)."""
        times = np.asarray(self.result.coords["time"]) \
            .astype("datetime64[s]").tolist()
        return times, [t - times[0] for t in times]

    def get_property(self, propname):
        """(values.T, status.T) of a result variable, as the reference's
        deprecated accessor returns them (basemodel:4603)."""
        logger.warning("get_property is deprecated; use o.result[...]")
        return (np.asarray(self.result[propname].values).T,
                np.asarray(self.result["status"].values).T)

    def get_trajectory_lengths(self):
        """(total length, step lengths, step speeds) along each trajectory
        in metres and m/s; steps faster than 100 m/s count 0 (reference
        basemodel/__init__.py:4614-4634)."""
        lon = np.asarray(self.result["lon"].values)   # (N, T)
        lat = np.asarray(self.result["lat"].values)
        _, _, dist = geodesic_inverse(np, lat[:, :-1], lon[:, :-1],
                                      lat[:, 1:], lon[:, 1:])
        dist = np.nan_to_num(dist, nan=0.0)
        speeds = dist / self.time_step_output.total_seconds()
        bad = speeds > 100
        dist[bad] = 0
        speeds[bad] = 0
        return np.cumsum(dist, axis=1)[:, -1], dist, speeds

    def store_message(self, msg):
        self.messages.append(msg)
        logger.warning(msg)

    def get_messages(self):
        return "\n".join(self.messages)

    def __repr__(self):
        return (f"Model: {type(self).__name__} (mode: {self.mode.name}, "
                f"device: {self.device})\n"
                f"  {self.num_elements_scheduled_total} elements scheduled\n"
                f"  readers: {list(self.env.readers)}\n")


class StepContext(PhysicsContext):
    """Per-step context handed to model ``update`` implementations: the
    element state, fetched environment, RNG and the physics methods of the
    reference ``PhysicsMethods`` mixin (physics_methods.py:570)."""

    def __init__(self, sim, state, env, profiles, dev_states, t_rel, params,
                 key, zlevels):
        self.sim = sim
        self.state = state
        self.environment = env
        self.profiles = profiles
        self.dev_states = dev_states
        self.t_rel = np.float32(t_rel)
        self.params = params
        self.zlevels = zlevels
        self._key = key
        self._key_counter = 0
        self._fused_positions = (
            sim.get_config("drift:position_update") == "fused")
        self._u_acc = None
        self._v_acc = None
        # (reader, device state, corner block, covers0) of the step's
        # block-backed env fetch, for the single-fetch RK stages
        self.uv_block_ctx = None

    # -- RNG ---------------------------------------------------------------
    def next_key(self):
        self._key_counter += 1
        return rng.fold_in(self._key, self._key_counter)

    @property
    def dt(self):
        """Signed step length in seconds (negative for backward runs)."""
        return self.params["dt"]

    @property
    def active(self):
        return self.state.data["status"] == ACTIVE

    def get_environment(self, varnames, t_rel, lon, lat, z):
        key = self.next_key() if self.sim.env.uncertainty else None
        member = None
        if any(getattr(r, "needs_ids", False)
               or getattr(r, "ensemble_size", 1) > 1
               for r in self.sim.env.readers.values()):
            member = self.state.data["ID"]
        envs, _ = self.sim.env.get_environment(
            self.dev_states, varnames, t_rel, lon, lat, z, key=key,
            member=member)
        return envs

    def update_positions(self, x_vel, y_vel):
        """Geodesic position update (reference basemodel/__init__.py:4631),
        masked to active, moving elements.  In 'fused' mode the process
        velocities are summed and one solve commits them in
        :meth:`flush_positions`."""
        mv = self.state.data["moving"]
        u, v = x_vel * mv, y_vel * mv
        if not self._fused_positions:
            self._commit_positions(u, v)
        elif self._u_acc is None:
            self._u_acc, self._v_acc = u, v
        else:
            self._u_acc = self._u_acc + u
            self._v_acc = self._v_acc + v

    def flush_positions(self):
        """Commit accumulated fused-mode velocities (one geodesic solve)."""
        if self._u_acc is not None:
            u, v = self._u_acc, self._v_acc
            self._u_acc = self._v_acc = None
            self._commit_positions(u, v)

    def _commit_positions(self, u, v):
        d = self.state.data
        vincenty = self.sim.get_config("drift:geodesy") == "vincenty"
        step_fn = geodesic_step if vincenty else geodesic_step_second_order
        lat2, lon2 = step_fn(tnp, d["lat"], d["lon"], u, v,
                             self.params["dt"])
        mask = self.active
        self.state = self.state.replace(
            lon=torch.where(mask, lon2, d["lon"]),
            lat=torch.where(mask, lat2, d["lat"]))

    def update_z(self, dz=None, new_z=None):
        """Move active, moving elements vertically by ``dz`` or to
        ``new_z``."""
        d = self.state.data
        mask = self.active & (d["moving"] > 0)
        if new_z is None:
            new_z = d["z"] + dz
        self.state = self.state.replace(z=torch.where(mask, new_z, d["z"]))

    def deactivate_elements(self, mask, reason):
        """Give the active elements of ``mask`` the status of ``reason``."""
        code = self.sim.status_code(reason)
        d = self.state.data
        self.state = self.state.replace(
            status=torch.where(self.active & mask, code, d["status"]))

    def set_var(self, name, values, mask=None):
        d = self.state.data
        if mask is None:
            mask = self.active
        self.state = self.state.replace(
            **{name: torch.where(mask, values, d[name])})

    def horizontal_diffusion(self):
        """Random-walk horizontal diffusion (reference
        basemodel/__init__.py:1746-1772): v = sqrt(2 D / dt) * N(0,1)."""
        if "horizontal_diffusivity" in self.environment:
            D = self.environment["horizontal_diffusivity"]
        else:
            D = self.params["hdiff"]
            if D == 0.0:
                return
            D = torch.tensor(D, dtype=torch.float32, device=self.sim.device)
        d = self.state.data
        std = torch.sqrt(2.0 * D / abs(self.params["dt"]))
        noise = rng.normal(self.next_key(), (2,) + tuple(d["lon"].shape),
                           d["lon"].device)
        self.update_positions(std * noise[0], std * noise[1])
