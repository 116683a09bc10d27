"""CF-compliant trajectory NetCDF export/import, from scratch.

The port's copy of ``opendrift_tpu/export/io_netcdf.py``, with the
per-process ``ShardWriter`` of multi-process runs (``export:sharded``).

The reference writes CF-1.11 trajectory files via the netCDF4 C library
(reference: opendrift/export/io_netcdf.py:30-187).  netCDF4 is not
available here, so files are written in NetCDF-3 (64-bit-offset) classic
format through ``scipy.io.netcdf_file`` — readable by every NetCDF tool.
Layout matches the reference: dims (trajectory, time), CF featureType
"trajectory", config round-tripped through ``config_*`` global attributes.
"""

import os

import numpy as np
from scipy.io import netcdf_file

from ..utils.dataset import TrajectoryDataset, DataVar

EPOCH = np.datetime64("1970-01-01T00:00:00", "s")


def write_result(result, filename):
    """Write a TrajectoryDataset to a CF trajectory NetCDF file."""
    n_traj, n_time = (result.dims["trajectory"], result.dims["time"])
    f = netcdf_file(filename, "w", version=2)
    try:
        f.createDimension("trajectory", n_traj)
        f.createDimension("time", n_time)

        v = f.createVariable("trajectory", "i", ("trajectory",))
        v[:] = np.asarray(result.coords["trajectory"], dtype=np.int32)
        v.cf_role = "trajectory_id"
        v.units = "1"

        times = result.coords["time"].astype("datetime64[s]")
        secs = (times - EPOCH).astype("float64")
        v = f.createVariable("time", "d", ("time",))
        v[:] = secs
        v.units = "seconds since 1970-01-01 00:00:00"
        v.standard_name = "time"

        for name, var in result.variables.items():
            vals = var.values
            if np.issubdtype(vals.dtype, np.floating):
                nc = f.createVariable(name, "f", ("trajectory", "time"))
                nc[:] = vals.astype(np.float32)
            else:
                nc = f.createVariable(name, "i", ("trajectory", "time"))
                nc[:] = vals.astype(np.int32)
            for k, val in var.attrs.items():
                if val is not None:
                    setattr(nc, k, str(val))

        f.featureType = "trajectory"
        f.Conventions = "CF-1.11"
        for k, val in result.attrs.items():
            if val is None:
                val = "None"
            if isinstance(val, (int, float, np.integer, np.floating)):
                setattr(f, k, val)
            else:
                setattr(f, k, str(val))
        f.flush()
    finally:
        f.close()


class IncrementalWriter:
    """Crash-safe buffered trajectory export (reference:
    export/io_netcdf.py:30-104 buffered append on the unlimited time
    dimension, with a final rewrite to the fixed-dim layout).

    Frames are appended to ``filename`` with time as the NetCDF record
    dimension, i.e. variables are (time, trajectory); a run killed
    mid-way leaves a readable file with every flushed output step.  On
    ``finalize(result)`` the file is atomically replaced by the standard
    (trajectory, time) layout of :func:`write_result`."""

    def __init__(self, filename, n_trajectories):
        self.filename = filename
        self.n = n_trajectories
        self._f = netcdf_file(filename, "w", version=2)
        self._f.createDimension("time", None)  # record dim (must be 1st)
        self._f.createDimension("trajectory", n_trajectories)
        v = self._f.createVariable("trajectory", "i", ("trajectory",))
        v[:] = np.arange(1, n_trajectories + 1, dtype=np.int32)
        v.cf_role = "trajectory_id"
        self._tvar = self._f.createVariable("time", "d", ("time",))
        self._tvar.units = "seconds since 1970-01-01 00:00:00"
        self._vars = {}
        self._written = 0

    def append(self, frames, frame_times):
        """frames: list of {name: (N,) array}; times: list of datetimes."""
        if not frames:
            return
        for name in frames[0]:
            if name not in self._vars:
                flt = np.issubdtype(frames[0][name].dtype, np.floating)
                self._vars[name] = self._f.createVariable(
                    name, "f" if flt else "i", ("time", "trajectory"))
        t0 = self._written
        for i, (fr, when) in enumerate(zip(frames, frame_times)):
            self._tvar[t0 + i] = (np.datetime64(when, "s")
                                  - EPOCH).astype("float64")
            for name, vals in fr.items():
                v = self._vars[name]
                v[t0 + i] = vals.astype(
                    np.float32 if v.typecode() == "f" else np.int32)
        self._written += len(frames)
        self._f.flush()

    def finalize(self, result):
        """Replace the record-layout file with the standard layout."""
        self._f.close()
        tmp = self.filename + ".tmp"
        write_result(result, tmp)
        os.replace(tmp, self.filename)

    def abort_close(self):
        try:
            self._f.close()
        except Exception:
            pass


def read_result(filename):
    """Read a trajectory NetCDF file back into a TrajectoryDataset."""
    f = netcdf_file(filename, "r", mmap=False)
    try:
        attrs = {}
        for k, v in f._attributes.items():
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            attrs[k] = v
        secs = np.asarray(f.variables["time"][:], dtype="float64")
        times = EPOCH + secs.astype("timedelta64[s]")
        coords = {
            "trajectory": np.asarray(f.variables["trajectory"][:]).copy(),
            "time": times.astype("datetime64[ns]"),
        }
        variables = {}
        for name, var in f.variables.items():
            if name in ("trajectory", "time"):
                continue
            vattrs = {}
            for k, v in var._attributes.items():
                if isinstance(v, bytes):
                    v = v.decode("utf-8", "replace")
                vattrs[k] = v
            variables[name] = DataVar(("trajectory", "time"),
                                      np.asarray(var[:]).copy(), vattrs)
        return TrajectoryDataset(variables, coords, attrs)
    finally:
        f.close()


def valid_mask(status, active=None):
    """The reference's output validity rule: an element's frame is
    recorded while ACTIVE plus ONCE at the output step covering its
    deactivation (reference basemodel/__init__.py:2390-2396).
    ``status``: (N, T) int array; returns (N, T) bool."""
    if active is None:
        from ..elements.elements import ACTIVE as active
    dead = status > active
    first_dead = np.zeros_like(dead)
    first_dead[:, 0] = dead[:, 0]
    first_dead[:, 1:] = dead[:, 1:] & ~dead[:, :-1]
    return (status == active) | first_dead


class ShardWriter:
    """Per-process trajectory shard of a multi-process run
    (``export:sharded``): each process appends only its own slots' raw
    frames — O(local) instead of the O(global)-per-process gather — and
    ``opendrift_tpu_torch/tools/concat_shards.py`` merges the shards into
    the standard single-file layout offline.

    File layout (record format, crash-safe like IncrementalWriter):
    dims (time [record], slot); an int ``ID`` variable maps each slot
    to its global element at each output step (slots migrate between
    tiles under domain decomposition); data variables are RAW
    (un-valid-masked) so the concat tool can apply the exact
    ``valid_mask`` rule of the single-process writer.

    The reference's analogue is the per-worker output files of its
    multiprocessing recipe (reference
    examples/example_long_multiprocessing.py:16-50)."""

    def __init__(self, filename, n_slots, n_total, process_id,
                 num_processes):
        self.filename = filename
        self.n = n_slots
        self._f = netcdf_file(filename, "w", version=2)
        self._f.createDimension("time", None)  # record dim (must be 1st)
        self._f.createDimension("slot", n_slots)
        self._f.n_total_elements = n_total
        self._f.shard_process = process_id
        self._f.shard_count = num_processes
        self._tvar = self._f.createVariable("time", "d", ("time",))
        self._tvar.units = "seconds since 1970-01-01 00:00:00"
        self._vars = {}
        self._written = 0

    def append(self, frames, frame_times):
        if not frames:
            return
        for name in frames[0]:
            if name not in self._vars:
                flt = np.issubdtype(frames[0][name].dtype, np.floating)
                self._vars[name] = self._f.createVariable(
                    name, "f" if flt else "i", ("time", "slot"))
        t0 = self._written
        for i, (fr, when) in enumerate(zip(frames, frame_times)):
            self._tvar[t0 + i] = (np.datetime64(when, "s")
                                  - EPOCH).astype("float64")
            for name, vals in fr.items():
                v = self._vars[name]
                v[t0 + i] = vals.astype(
                    np.float32 if v.typecode() == "f" else np.int32)
        self._written += len(frames)
        self._f.flush()

    def finalize(self, result):
        """Stamp the run's global attributes (identical on every shard;
        the concat tool copies them onto the merged file) and close.
        Unlike IncrementalWriter there is no layout rewrite — the
        record layout IS the shard format."""
        for k, val in result.attrs.items():
            if val is None:
                val = "None"
            if isinstance(val, (int, float, np.integer, np.floating)):
                setattr(self._f, k, val)
            else:
                setattr(self._f, k, str(val))
        # per-variable attrs for the merged file
        for name, var in result.variables.items():
            if name in self._vars:
                for k, val in var.attrs.items():
                    if val is not None:
                        setattr(self._vars[name], k, str(val))
        self._f.flush()
        self._f.close()

    def abort_close(self):
        try:
            self._f.close()
        except Exception:
            pass
