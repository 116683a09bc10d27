"""NetCDF reading without netCDF4 or xarray.

The port's copy of ``opendrift_tpu/utils/ncio.py``: one facade over the
two on-disk formats,

* NetCDF-3 classic / 64-bit offset (``CDF1``/``CDF2`` magic) through
  ``scipy.io.netcdf_file(..., mmap=False, maskandscale=False)``;
* NetCDF-4 (HDF5 magic) through ``h5py``, imported when a NetCDF-4 file is
  first opened, with HDF5 dimension scales mapped back to named
  dimensions.  Where h5py is not installed that open raises an
  ``ImportError`` that names it; NetCDF-3 files need only scipy.

and the CF decoding helpers: scale/offset unpacking (int16 through the
native ``decode_i16`` of ``csrc/fieldpipe.cpp`` where g++ builds it, numpy
where it does not, as in the JAX package), fill-value masking and
``<units> since <epoch>`` time parsing.  All of it is host numpy.
"""

import re
from datetime import datetime, timedelta

import numpy as np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.bytes_):
        return bytes(v).decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.size == 1:
        return _decode(v.reshape(())[()])
    if isinstance(v, np.generic):
        return v.item() if not isinstance(v, np.bytes_) else _decode(bytes(v))
    return v


class NCVariable:
    """A read handle on one variable: dims, shape, dtype, attrs, slicing."""

    def __init__(self, name, dimensions, shape, dtype, attrs, getter):
        self.name = name
        self.dimensions = tuple(dimensions)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.attrs = attrs
        self._get = getter

    def __getitem__(self, idx):
        return self._get(idx)

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"NCVariable({self.name}, dims={self.dimensions}, "
                f"shape={self.shape}, dtype={self.dtype})")


class NCFile:
    """Uniform dataset facade over NetCDF-3 (scipy) and NetCDF-4 (h5py)."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic[:3] == b"CDF":
            self._open_netcdf3(path)
        elif magic == b"\x89HDF":
            self._open_hdf5(path)
        else:
            raise ValueError(
                f"{path}: not a NetCDF file (magic {magic!r})")

    # ------------------------------------------------------------- NetCDF3
    def _open_netcdf3(self, path):
        from scipy.io import netcdf_file
        # mmap=False: copies on read, avoids noisy mmap teardown at exit
        self._nc = netcdf_file(path, "r", mmap=False, maskandscale=False)
        self._h5 = None
        self.dimensions = dict(self._nc.dimensions)
        self.attrs = {k: _decode(v) for k, v in self._nc._attributes.items()}
        self.variables = {}
        for name, var in self._nc.variables.items():
            attrs = {k: _decode(v) for k, v in var._attributes.items()}

            def getter(idx, _v=var):
                if _v.shape == ():  # scalar variable
                    return np.array(_v.getValue())
                out = _v[idx]
                # copy out of the mmap so the array owns its data
                return np.array(out)
            self.variables[name] = NCVariable(
                name, var.dimensions, var.shape,
                np.dtype(var.typecode().replace(">", "")), attrs, getter)

    # --------------------------------------------------------------- HDF5
    def _open_hdf5(self, path):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path} is a NetCDF-4 (HDF5) file, which is read with "
                "h5py, and h5py is not installed; install h5py or convert "
                "the file to NetCDF-3 (64-bit offset)") from e
        self._nc = None
        self._h5 = h5py.File(path, "r")
        self.attrs = {k: _decode(v) for k, v in self._h5.attrs.items()
                      if not k.startswith("_nc")}
        self.dimensions = {}
        self.variables = {}
        items = []
        self._h5.visititems(lambda n, o: items.append((n, o)))
        for name, obj in items:
            if not isinstance(obj, h5py.Dataset):
                continue
            attrs = {k: _decode(v) for k, v in obj.attrs.items()
                     if k not in ("CLASS", "NAME", "DIMENSION_LIST",
                                  "REFERENCE_LIST", "_Netcdf4Dimid",
                                  "_Netcdf4Coordinates")}
            # dimension names from attached dimension scales
            dims = []
            for i in range(obj.ndim):
                label = None
                try:
                    scales = list(obj.dims[i].keys()) or [None]
                    if obj.dims[i].label:
                        label = obj.dims[i].label
                    elif len(obj.dims[i]) > 0:
                        label = obj.dims[i][0].name.lstrip("/")
                except Exception:
                    label = None
                if not label:
                    # a dimension scale dataset is its own dimension
                    if obj.attrs.get("CLASS") == b"DIMENSION_SCALE" \
                            and obj.ndim == 1:
                        label = name
                    else:
                        label = f"phony_dim_{i}"
                label = label.lstrip("/")
                dims.append(label)
                self.dimensions.setdefault(label, obj.shape[i])

            def getter(idx, _d=obj):
                if _d.ndim == 0:  # scalar dataset
                    return np.asarray(_d[()])
                return np.asarray(_d[idx])
            self.variables[name] = NCVariable(
                name, dims, obj.shape, obj.dtype, attrs, getter)

    def close(self):
        if self._nc is not None:
            try:
                self._nc.close()
            except Exception:
                pass
        if self._h5 is not None:
            self._h5.close()

    def __repr__(self):
        return (f"NCFile({self.path}, dims={self.dimensions}, "
                f"vars={list(self.variables)})")


def open_dataset(path):
    return NCFile(path)


# -------------------------------------------------------------- CF decode

def cf_unpack(var, raw, scrub_range=None):
    """Apply _FillValue/missing_value masking and scale_factor/add_offset,
    returning float32 with NaN where invalid (reference: the masked-array
    scrubbing in opendrift/readers/basereader/variables.py:630-690)."""
    a = var.attrs
    raw_arr = np.asarray(raw)
    # native fast path for the common int16-packed case
    if raw_arr.dtype == np.int16 and "missing_value" not in a:
        from . import native
        fillv = a.get("_FillValue")
        fillv = np.asarray(fillv).ravel()[0] if fillv is not None else None
        decoded = native.decode_i16(
            raw_arr, float(a.get("scale_factor", 1.0)),
            float(a.get("add_offset", 0.0)),
            int(fillv) if fillv is not None and
            -32768 <= int(fillv) <= 32767 else None)
        if decoded is not None:
            if "valid_min" in a:
                decoded[decoded < float(np.asarray(a["valid_min"]).ravel()
                                        [0]) - 1e-6] = np.nan
            if "valid_max" in a:
                decoded[decoded > float(np.asarray(a["valid_max"]).ravel()
                                        [0]) + 1e-6] = np.nan
            if scrub_range is not None:
                lo, hi = scrub_range
                decoded[(decoded < lo) | (decoded > hi)] = np.nan
            return decoded
    out = raw_arr.astype(np.float64)
    fill_mask = np.zeros(out.shape, dtype=bool)
    for key in ("_FillValue", "missing_value"):
        if key in a:
            fill_mask |= out == float(np.asarray(a[key]).ravel()[0])
    scale = a.get("scale_factor", None)
    offset = a.get("add_offset", None)
    if scale is not None:
        out = np.asarray(out * float(scale))
    if offset is not None:
        out = np.asarray(out + float(offset))
    # valid_min/max are compared against the unpacked values (when their
    # dtype differs from the packed dtype, per the CF/NUG convention;
    # producers are inconsistent, and unpacked comparison with a small
    # tolerance covers both in practice)
    if "valid_min" in a:
        fill_mask |= out < float(np.asarray(a["valid_min"]).ravel()[0]) \
            - 1e-6
    if "valid_max" in a:
        fill_mask |= out > float(np.asarray(a["valid_max"]).ravel()[0]) \
            + 1e-6
    if scrub_range is not None:
        lo, hi = scrub_range
        fill_mask |= (out < lo) | (out > hi)
    out[fill_mask] = np.nan
    out[~np.isfinite(out)] = np.nan
    return out.astype(np.float32)


_TIME_UNITS_RE = re.compile(
    r"(?P<unit>\w+)\s+since\s+(?P<date>[\d\-T: .+Z]+)")
_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "secs": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0, "mins": 60.0,
    "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "h": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
}


def parse_cf_time(units, values):
    """Decode a CF time coordinate to an array of python datetimes."""
    m = _TIME_UNITS_RE.match(units.strip())
    if m is None:
        # bare unit with no epoch (e.g. CROCO 'second'): anchor at the
        # unix epoch; the caller can shift with a start_time argument
        if units.strip().lower() in _UNIT_SECONDS:
            secs = (np.asarray(values, dtype=np.float64)
                    * _UNIT_SECONDS[units.strip().lower()])
            epoch = datetime(1970, 1, 1)
            return np.array([epoch + timedelta(seconds=float(s))
                             for s in secs])
        raise ValueError(f"Cannot parse time units: {units!r}")
    unit = m.group("unit").lower()
    if unit not in _UNIT_SECONDS:
        raise ValueError(f"Unsupported time unit: {unit!r}")
    datestr = m.group("date").strip().rstrip("Z").replace("T", " ")
    # strip a trailing UTC offset like '+00:00' / '+0000' / ' +00:00'
    datestr = re.sub(r"\s*[+-]\d{2}:?\d{2}$", "", datestr).strip()
    # tolerate fractional seconds and missing time parts
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
                "%Y-%m-%d %H:%M", "%Y-%m-%d"):
        try:
            epoch = datetime.strptime(datestr, fmt)
            break
        except ValueError:
            epoch = None
    if epoch is None:
        raise ValueError(f"Cannot parse reference date: {datestr!r}")
    secs = np.asarray(values, dtype=np.float64) * _UNIT_SECONDS[unit]
    return np.array([epoch + timedelta(seconds=float(s)) for s in secs])
