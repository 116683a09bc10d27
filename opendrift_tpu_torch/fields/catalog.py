"""Cloud catalog readers: Copernicus Marine (CMEMS) and NASA Earthdata.

The port's copy of ``opendrift_tpu/fields/catalog.py``.  The reference
wraps the ``copernicusmarine`` and ``earthaccess`` client libraries to
stream remote datasets (reference: opendrift/readers/
reader_copernicusmarine.py:1-74, reader_earthaccess.py:1-55).  These
constructors resolve against a local cache instead: pass ``cache_dir`` (or
set ``$OPENDRIFT_DATA_CACHE``) holding files downloaded with the vendor
tools, and the dataset id is matched to a filename.  With no cache hit
they raise an error that says so; they never open a socket.
"""

import glob
import logging
import os

from .netcdf import NetCDFReader

logger = logging.getLogger(__name__)


def _from_cache(dataset_id, cache_dir, kind, **kwargs):
    cache = cache_dir or os.environ.get("OPENDRIFT_DATA_CACHE")
    if cache:
        pattern = os.path.join(cache, f"*{dataset_id}*")
        hits = sorted(glob.glob(pattern + ".nc")) or sorted(
            glob.glob(pattern))
        hits = [h for h in hits if os.path.isfile(h)]
        if hits:
            logger.info("%s dataset %s resolved to local cache: %s",
                        kind, dataset_id, hits)
            return NetCDFReader(hits if len(hits) > 1 else hits[0],
                                name=dataset_id, **kwargs)
    raise RuntimeError(
        f"{kind} dataset '{dataset_id}' is remote and this build has no "
        f"network access. Download it with the vendor CLI to a directory "
        f"and pass cache_dir=<dir> (or set $OPENDRIFT_DATA_CACHE).")


def CopernicusMarineReader(dataset_id, cache_dir=None, **kwargs):
    """CMEMS dataset by id, resolved from a local download cache
    (reference: reader_copernicusmarine.py:20-74)."""
    return _from_cache(dataset_id, cache_dir, "CopernicusMarine", **kwargs)


def EarthaccessReader(short_name, cache_dir=None, **kwargs):
    """NASA Earthdata dataset by short name, from a local cache
    (reference: reader_earthaccess.py:12-55)."""
    return _from_cache(short_name, cache_dir, "Earthaccess", **kwargs)
