"""Minimal labelled-array dataset (xarray-lite).

The port's copy of ``opendrift_tpu/utils/dataset.py`` (pure numpy).

The reference returns simulation results as an ``xarray.Dataset`` with dims
(trajectory, time) (reference: opendrift/models/basemodel/__init__.py:2083-2135).
xarray is unavailable in this environment, so this module provides the small
subset the framework and its tests need: named variables over shared dims,
per-variable and global attributes, coordinate arrays, selection helpers and
NetCDF round-tripping (via export/io_netcdf).
"""

import numpy as np


class DataVar:
    __slots__ = ("dims", "values", "attrs")

    def __init__(self, dims, values, attrs=None):
        self.dims = tuple(dims)
        self.values = np.asarray(values)
        self.attrs = dict(attrs or {})

    @property
    def shape(self):
        return self.values.shape

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, idx):
        return self.values[idx]

    def __repr__(self):
        return f"DataVar{self.dims} {self.values.shape} {self.values.dtype}"


class TrajectoryDataset:
    """Dict of :class:`DataVar` over named dims, with coords and attrs."""

    def __init__(self, variables=None, coords=None, attrs=None):
        self.variables = dict(variables or {})
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    # -- mapping-ish interface --------------------------------------------
    def __getitem__(self, name):
        if name in self.variables:
            return self.variables[name]
        if name in self.coords:
            return self.coords[name]
        raise KeyError(name)

    def __contains__(self, name):
        return name in self.variables or name in self.coords

    def keys(self):
        return self.variables.keys()

    @property
    def dims(self):
        out = {}
        for var in self.variables.values():
            for d, n in zip(var.dims, var.shape):
                out[d] = n
        for name, arr in self.coords.items():
            out.setdefault(name, len(arr))
        return out

    @property
    def sizes(self):
        return self.dims

    def isel(self, **indexers):
        """Integer-position selection along named dims."""
        newvars = {}
        for name, var in self.variables.items():
            idx = tuple(indexers.get(d, slice(None)) for d in var.dims)
            vals = var.values[idx]
            dims = [d for d, i in zip(var.dims, idx)
                    if not np.isscalar(i) and not isinstance(i, int)]
            newvars[name] = DataVar(dims, vals, var.attrs)
        newcoords = {}
        for name, arr in self.coords.items():
            if name in indexers:
                newcoords[name] = np.asarray(arr)[indexers[name]]
            else:
                newcoords[name] = arr
        return TrajectoryDataset(newvars, newcoords, self.attrs)

    def __repr__(self):
        lines = [f"<TrajectoryDataset dims={self.dims}>"]
        for name, var in self.variables.items():
            lines.append(f"  {name:40s} {var.dims} {var.values.dtype}")
        return "\n".join(lines)
