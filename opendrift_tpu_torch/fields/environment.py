"""Environment orchestration: reader registry, priority lists, fallbacks.

Port of ``opendrift_tpu/fields/environment.py`` (reference:
opendrift/models/basemodel/environment.py:20-923).  The priority-ordered
reader chain is a sequence of sampler calls merged with ``torch.where``
on per-variable missing masks, ended by scalar fallbacks.  Host-side:
registry and priority bookkeeping, failure quarantine
(environment.py:656-674), and the per-window device states, which
readers build on the host and this class takes to the device: host arrays
are copied, a structured reader's window (``ops/pack.py``) uploads the
frames the device does not hold yet and is assembled there.  The next
window's host work (reading and decoding frames, packing) can run on a
worker thread beside the steps (``prefetch_device_states``); the copy to
the device and the assembly are always made by the thread that takes the
states (``build_device_states``), on its stream.
Each of these is a span of ``recorder`` (the simulation's
:class:`~opendrift_tpu_torch.timer.Recorder`): the join, the packing and
the copy under the caller's category, the worker's packing as
``prefetch:pack`` on its own thread; the bytes copied, the windows packed
on either thread, the frames uploaded and the windows assembled on the
device are its counters.
"""

import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..errors import VariableNotCoveredError
from ..interop import device_state_from_numpy, host_nbytes, \
    pack_windows, resolve_device
from .. import rng
from ..timer import Recorder
from .analytic import ConstantReader

logger = logging.getLogger(__name__)


class Environment:
    def __init__(self, required_variables, max_reader_fails=1, *,
                 device=None):
        self.required_variables = required_variables
        self.device = resolve_device(device)
        self.readers = OrderedDict()
        self.priority_list = OrderedDict()
        self.max_reader_fails = max_reader_fails
        self.reader_fail_count = {}
        self.discarded_readers = {}
        self.fallback_values = {}
        self.uncertainty = []
        self._plan = None
        self._prefetch = None
        # where the spans and counters go (the simulation sets its own)
        self.recorder = Recorder()
        # seconds of host packing (on either thread), the part of them
        # spent on the prefetch thread, and seconds the caller of
        # build_device_states waited for a prefetched window, from the
        # spans of each
        self.pack_seconds = 0.0
        self.prefetched_pack_seconds = 0.0
        self.join_wait_seconds = 0.0

    # ------------------------------------------------------------- registry
    def add_reader(self, readers, variables=None, first=False):
        if not isinstance(readers, (list, tuple)):
            readers = [readers]
        for reader in readers:
            if getattr(reader, "is_lazy", False):
                # a lazy reader is built when it joins an environment: its
                # variables decide the priority chains
                reader.initialise()
            name = reader.name
            base = name
            suffix = 0
            while name in self.readers \
                    and self.readers[name] is not reader:
                suffix += 1
                name = f"{base}_{suffix}"
            reader.name = name
            # a reader that keeps a device-resident state builds it here
            reader.device = self.device
            self.readers[name] = reader
            for var in reader.variables:
                if variables is not None and var not in variables:
                    continue
                chain = self.priority_list.setdefault(var, [])
                if name not in chain:
                    if first:
                        chain.insert(0, name)
                    else:
                        chain.append(name)

    def set_fallback(self, variable, value):
        self.fallback_values[variable] = value

    # ------------------------------------------------------------- finalize
    def finalize(self, run_epoch, required_profiles=(), constant_overrides=(),
                 fallback_overrides=None):
        """Resolve the sampling plan before a run: ``constant_overrides``
        become a top-priority constant reader (reference
        environment.py:172-196), ``fallback_overrides`` the fallbacks."""
        if constant_overrides:
            self.add_reader(ConstantReader(dict(constant_overrides),
                                           name="constant_overrides"),
                            first=True)
        for var, val in (fallback_overrides or {}).items():
            if val is not None:
                self.fallback_values[var] = val
        for var, spec in self.required_variables.items():
            if var not in self.fallback_values and "fallback" in spec:
                self.fallback_values[var] = spec["fallback"]
        plan = []
        for reader in self.readers.values():
            served = [v for v in reader.variables
                      if v in self.required_variables]
            if served:
                plan.append((reader, served))
            reader.set_run_epoch(run_epoch)
        self._plan = plan
        missing = [v for v in self.required_variables
                   if not self.priority_list.get(v)
                   and self.fallback_values.get(v, None) is None
                   and "fallback" not in self.required_variables[v]]
        if missing:
            raise VariableNotCoveredError(
                f"Missing required environment variables with no fallback: "
                f"{missing}")
        self.required_profiles = list(required_profiles)

    def prepare_readers(self, extent=None, start_time=None, end_time=None,
                        max_speed=None, interval_seconds=None,
                        truncate_depth=None, pair_hint=None):
        """Give every reader its run context: extent (halo subsetting),
        time range, window length, depth truncation and the row-tier hint
        (overwritten on every reader, as the JAX package does)."""
        for reader in self.readers.values():
            reader.truncate_depth = (float(truncate_depth)
                                     if truncate_depth is not None else None)
            reader.pair_hint = pair_hint
            reader.prepare(extent=extent, start_time=start_time,
                           end_time=end_time, max_speed=max_speed,
                           interval_seconds=interval_seconds,
                           variables=list(self.required_variables))

    # ----------------------------------------------------- window device IO
    def _pack_host_states(self, window_start, window_end):
        """Per plan entry the reader's host state, the exception its
        packing raised, or None for a discarded reader.  Host work only
        (numpy), so it may run on the worker thread: it changes nothing of
        this object."""
        packed = []
        for reader, served in self._plan:
            if reader.name in self.discarded_readers:
                packed.append(None)
                continue
            try:
                packed.append(reader.device_state(window_start, window_end))
            except Exception as e:  # noqa: BLE001 — any reader error counts
                packed.append(e)
        return packed

    def prefetch_device_states(self, window_start, window_end):
        """Start packing a window's host states on a worker thread, so that
        the packing overlaps the steps of the window before it.  The next
        ``build_device_states`` call for the same window joins the thread
        and copies the states to the device itself."""
        result = {}

        def work():
            try:
                with self.recorder.timed("prefetch:pack", total=False) as s:
                    packed = self._pack_host_states(window_start, window_end)
                result["packed"] = (packed, s.seconds)
            except Exception as e:  # noqa: BLE001 — re-raised at the join
                result["error"] = e
        thread = threading.Thread(target=work, daemon=True,
                                  name="opendrift-prefetch")
        thread.start()
        self._prefetch = (window_start, window_end, thread, result)

    def cancel_prefetch(self):
        """Wait for a pending prefetch and drop its result."""
        pending, self._prefetch = self._prefetch, None
        if pending is not None:
            pending[2].join()

    def build_device_states(self, window_start=None, window_end=None,
                            category="readers"):
        """Per-reader device states for a time window (host packing, taken
        from the prefetch thread where it packed this window, then the copy
        to the device: the new frames of a structured reader's window and
        their assembly there, other host arrays whole), with the
        failure-quarantine policy.  The join, the packing and the copy are
        spans ``<category>:join wait``, ``:pack`` and ``:copy``."""
        timed, count = self.recorder.timed, self.recorder.count
        pending, self._prefetch = self._prefetch, None
        packed = None
        if pending is not None:
            with timed(f"{category}:join wait") as span:
                pending[2].join()
            self.join_wait_seconds += span.seconds
            if "error" in pending[3]:
                raise pending[3]["error"]
            if pending[:2] == (window_start, window_end):
                packed, seconds = pending[3]["packed"]
                self.prefetched_pack_seconds += seconds
                count("readers.windows_prefetched")
        if packed is None:
            with timed(f"{category}:pack") as span:
                packed = self._pack_host_states(window_start, window_end)
            seconds = span.seconds
            count("readers.windows_packed_on_loop")
        self.pack_seconds += seconds
        with timed(f"{category}:copy"):
            states = []
            for (reader, served), host in zip(self._plan, packed):
                if isinstance(host, Exception):
                    n = self.reader_fail_count.get(reader.name, 0) + 1
                    self.reader_fail_count[reader.name] = n
                    if n >= self.max_reader_fails:
                        logger.warning(
                            "Reader %s failed %d time(s) — discarding: %s",
                            reader.name, n, host)
                        self.discarded_readers[reader.name] = str(host)
                    host = None
                if host is None:
                    states.append(None)
                    continue
                # a domain-decomposed reader's table stays on the host:
                # the run splits it into per-tile bands (parallel/tiled.py)
                keep = ("packed",) if getattr(reader, "_dd_keep_host",
                                              False) else ()
                states.append(device_state_from_numpy(host, self.device,
                                                      keep))
                # a structured reader's window went up as its new frames
                # and was assembled on the device
                nbytes = host_nbytes(host, self.device, keep)
                for window in pack_windows(host):
                    frames, sent = window.sent
                    count("readers.frames_uploaded", frames)
                    count("readers.windows_assembled_on_device")
                    nbytes += sent
                count("readers.h2d_bytes", nbytes)
        return tuple(states)

    # ------------------------------------------------------ device sampling
    def has_reader_for(self, variable):
        """True when an active reader (not just a fallback) serves it."""
        for reader, served in (self._plan or []):
            if reader.name in self.discarded_readers:
                continue
            if variable in served and \
                    reader.name in self.priority_list.get(variable, []):
                return True
        return False

    def get_environment(self, dev_states, varnames, t, lon, lat, z,
                        key=None, member=None, block_ctx=None):
        """Sample ``varnames`` at the element positions and host time
        ``t`` through the priority chains (reference
        environment.py:499-923).  ``key``: optional rng key enabling the
        configured current/wind uncertainty noise (reference
        environment.py:865-891).  ``member``: the element IDs, for readers
        keyed on them (``needs_ids``) and ensemble readers.  ``block_ctx``: optional (plan index,
        corner block, covers0): that reader's variables are evaluated from
        the gathered block, with no further gather (single-fetch RK shares
        one block between the fetch and every stage).  Returns
        (env var -> float32 tensor, missing var -> bool tensor)."""
        varnames = list(varnames)
        nanval = torch.full_like(lon, float("nan"))
        env = {v: nanval for v in varnames}
        missing = {v: torch.ones_like(lon, dtype=torch.bool)
                   for v in varnames}
        for i, ((reader, served), dev_state) in enumerate(
                zip(self._plan, dev_states)):
            if reader.name in self.discarded_readers:
                continue
            want = [v for v in served if v in varnames
                    and reader.name in self.priority_list.get(v, [])]
            if not want:
                continue
            fetch, derived = reader.expand_derived(want)
            if block_ctx is not None and i == block_ctx[0]:
                vals, covers = reader.sample_from_block(
                    dev_state, block_ctx[1], t, lon, lat, fetch)
                covers = covers & block_ctx[2]
            elif member is not None and (
                    getattr(reader, "ensemble_size", 1) > 1
                    or getattr(reader, "needs_ids", False)):
                vals, covers = reader.sample(dev_state, fetch, t, lon, lat,
                                             z, member=member)
            else:
                vals, covers = reader.sample(dev_state, fetch, t, lon, lat,
                                             z)
            if derived:
                vals = reader.apply_derived(vals, derived)
            for v in want:
                good = missing[v] & covers & torch.isfinite(vals[v])
                env[v] = torch.where(good, vals[v], env[v])
                missing[v] = missing[v] & ~good
        for v in varnames:
            fb = self.fallback_values.get(v, None)
            if fb is not None:
                env[v] = torch.where(missing[v], float(fb), env[v])
                missing[v] = torch.zeros_like(missing[v])
        # Kelvin -> Celsius sanity (reference environment.py:829)
        if "sea_water_temperature" in env:
            T = env["sea_water_temperature"]
            env["sea_water_temperature"] = torch.where(T > 100.0,
                                                       T - 273.15, T)
        if key is not None and self.uncertainty:
            for i, (pair, std, uniform) in enumerate(self.uncertainty):
                sub = rng.fold_in(key, i)
                for j, var in enumerate(pair):
                    if var not in env:
                        continue
                    k2 = rng.fold_in(sub, j)
                    if uniform:
                        noise = rng.uniform(k2, lon.shape, -std, std,
                                            lon.device)
                    else:
                        noise = std * rng.normal(k2, lon.shape, lon.device)
                    env[var] = env[var] + noise
        return env, missing

    def get_variables_along_trajectory(self, variables, lons, lats, times,
                                       z=0.0):
        """Sample environment variables at a sequence of (time, position)
        observations, the input of wind-drift-factor calibration
        (reference environment.py:925-941).  Needs :meth:`finalize` first.
        One window covers every time; each observation is sampled at its
        own time on this environment's device, those that share a time in
        one call (a density map samples every pixel at one time).  Returns
        ``{'time': [...], var: np.ndarray[N]}``."""
        if not getattr(self, "_plan", None):
            raise RuntimeError(
                "Environment not finalized — call finalize() first")
        variables = list(variables)
        epoch = times[0]
        for reader, _ in self._plan:
            reader.set_run_epoch(epoch)
        span = (times[-1] - times[0]).total_seconds()
        self.prepare_readers(interval_seconds=span if span > 0 else None)
        dev_states = self.build_device_states(times[0], times[-1])
        lonv = torch.as_tensor(np.asarray(lons, np.float32),
                               device=self.device)
        latv = torch.as_tensor(np.asarray(lats, np.float32),
                               device=self.device)
        zv = torch.full_like(lonv, float(z))
        trel = np.array([(t - epoch).total_seconds() for t in times],
                        np.float32)
        result = {"time": list(times)}
        for v in variables:
            result[v] = np.empty(len(times), np.float32)
        for t in np.unique(trel):
            at = np.nonzero(trel == t)[0]
            sel = torch.as_tensor(at, device=self.device)
            env, _ = self.get_environment(dev_states, variables, t,
                                          lonv[sel], latv[sel], zv[sel])
            for v in variables:
                result[v][at] = env[v].cpu().numpy()
        return result

    def uv_block_plan_index(self):
        """Plan index of the single top-priority reader serving BOTH
        current components through x-paired packed rows, the precondition
        of single-fetch RK (drift:advection_single_fetch); None when the
        configuration does not qualify."""
        names = ("x_sea_water_velocity", "y_sea_water_velocity")
        tops = [self.priority_list.get(v, [None])[0] for v in names]
        if tops[0] is None or tops[0] != tops[1]:
            return None
        for i, (reader, served) in enumerate(self._plan or []):
            if reader.name == tops[0]:
                if getattr(reader, "supports_uv_block", lambda: False)():
                    return i
                return None
        return None

    def get_profiles(self, dev_states, varnames, t, lon, lat, zlevels):
        """Profile variables at the fixed ``zlevels``: {var: (L, N)}."""
        varnames = list(varnames)
        L = len(zlevels)
        nanval = torch.full((L,) + tuple(lon.shape), float("nan"),
                            dtype=lon.dtype, device=lon.device)
        env = {v: nanval for v in varnames}
        missing = {v: torch.ones_like(lon, dtype=torch.bool)
                   for v in varnames}
        for (reader, served), dev_state in zip(self._plan, dev_states):
            if reader.name in self.discarded_readers:
                continue
            want = [v for v in served if v in varnames]
            if not want:
                continue
            vals, covers = reader.sample_profiles(dev_state, want, t, lon,
                                                  lat, zlevels)
            for v in want:
                good = missing[v] & covers
                env[v] = torch.where(good[None, :], vals[v], env[v])
                missing[v] = missing[v] & ~good
        for v in varnames:
            fb = self.fallback_values.get(v, None)
            if fb is not None:
                env[v] = torch.where(missing[v][None, :], float(fb), env[v])
        return env
