"""GRIB forcing reader: not ported yet.

The JAX package's ``fields/grib.py`` reads GRIB editions 1 and 2 through
its own parsers (``utils/grib1.py``, ``utils/grib2.py``).  They come to the
port with ROADMAP A.9b; until then constructing the reader raises.
"""

from .grid import StructuredGridReader


class GribReader(StructuredGridReader):
    def __init__(self, filename, name=None, variable_map=None):
        raise NotImplementedError(
            "GribReader is not ported yet (ROADMAP A.9b, GRIB and the "
            "remaining analytic readers)")
