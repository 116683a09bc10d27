"""Reader factory: open a data source by path or URL, probing formats.

Port of ``opendrift_tpu/fields/factory.py`` (reference:
opendrift/readers/__init__.py:176-279 ``reader_from_urlpath`` and
``applicable_readers``): ``<reader>://path`` scheme prefixes, the analytic
schemes ``constant:``, ``oscillating:`` and ``double_gyre:``, and probing
of local files (CF NetCDF, ROMS when its grid variables are present,
FVCOM when it has UGRID connectivity, Telemac Selafin by its suffix,
shapefiles for landmasks).  Remote URLs fail as in the JAX package, with
no network access attempted.
"""

import logging
import os

logger = logging.getLogger(__name__)


def _parse_query(path):
    """Split 'body?a=1&b=2' -> (body, {a: 1.0, b: 2.0})."""
    body, _, query = path.partition("?")
    kwargs = {}
    if query:
        for part in query.split("&"):
            k, _, v = part.partition("=")
            try:
                kwargs[k] = float(v)
            except ValueError:
                kwargs[k] = v
    return body, kwargs


def _constant_reader(path):
    from .analytic import ConstantReader
    body, kwargs = _parse_query(path)
    mapping = {}
    for part in body.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        mapping[k] = float(v) if v else 0.0
    mapping.update(kwargs)
    return ConstantReader(mapping)


def _oscillating_reader(path):
    from .analytic import OscillatingReader
    body, kwargs = _parse_query(path)
    amplitude = kwargs.pop("amplitude", 1.0)
    return OscillatingReader(body, amplitude, **kwargs)


def _double_gyre_reader(path):
    from .analytic import DoubleGyre
    _, kwargs = _parse_query(path)
    return DoubleGyre(**kwargs)


# `<reader>://spec` URI schemes for the analytic/test readers (the
# reference's reader_from_urlpath scheme table,
# opendrift/readers/__init__.py:225-279)
_ANALYTIC_SCHEMES = {
    "constant": _constant_reader,
    "oscillating": _oscillating_reader,
    "double_gyre": _double_gyre_reader,
}

_SCHEMES = {}


def register_scheme(name, ctor):
    _SCHEMES[name] = ctor


def reader_from_url(url, lazy=False):
    """Open a reader for a path/URL; returns None if nothing applies."""
    from .netcdf import NetCDFReader
    from .roms import ROMSReader
    from .shape import ShapeReader
    from .lazy import LazyReader

    if "://" in url and not url.startswith(("http", "https")):
        scheme, path = url.split("://", 1)
        if scheme in _ANALYTIC_SCHEMES:
            return _ANALYTIC_SCHEMES[scheme](path)
        ctor = _SCHEMES.get(scheme)
        if ctor is None:
            builtin = {"netcdf": NetCDFReader, "roms": ROMSReader,
                       "shape": ShapeReader}
            ctor = builtin.get(scheme)
        if ctor is None:
            raise ValueError(f"Unknown reader scheme: {scheme}")
        return LazyReader(ctor, path) if lazy else ctor(path)

    if url.startswith(("http://", "https://")):
        raise ValueError(
            "Remote URLs are not supported in this offline build; "
            "download the file and pass a local path")

    if not os.path.exists(url):
        raise FileNotFoundError(url)

    if url.endswith(".shp"):
        return ShapeReader(url)

    if url.endswith((".slf", ".sel", ".res")):
        from .unstructured import TelemacReader
        # Selafin carries no CRS; only openable directly when the mesh
        # coordinates are already geographic
        return TelemacReader(url, proj4="+proj=latlong")

    # NetCDF probing: ROMS if the grid variables are present
    if lazy:
        return LazyReader(_probe_netcdf, url, name=url)
    return _probe_netcdf(url)


def _probe_netcdf(path):
    from ..utils import ncio
    from .netcdf import NetCDFReader
    from .roms import ROMSReader
    ds = ncio.open_dataset(path)
    is_roms = "lon_rho" in ds.variables and "s_rho" in ds.variables
    is_ugrid = "nv" in ds.variables and "lon" in ds.variables \
        and ds.variables.get("lon") is not None \
        and len(ds.variables["lon"].shape) == 1 \
        and "lon_rho" not in ds.variables
    ds.close()
    if is_roms:
        return ROMSReader(path)
    if is_ugrid:
        from .unstructured import FVCOMReader
        return FVCOMReader(path)
    return NetCDFReader(path)
