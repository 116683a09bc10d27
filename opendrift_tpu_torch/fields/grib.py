"""GRIB forcing reader on the from-scratch parsers (utils/grib2.py,
utils/grib1.py).

Port of ``opendrift_tpu/fields/grib.py`` (reference:
opendrift/readers/reader_grib.py:1-220, wider: polar-stereographic and
Lambert grids with simple or JPEG2000 packing, editions 2 and 1): the
messages of one grid feed the structured reader's host packing and its
packed-row sampler on the device like every other gridded reader.
Editions are detected per message from the indicator section, so
mixed-edition files work.  Each frame decodes its whole message again
(``_read_frame``), as in the JAX package.
"""

import logging

from .grid import StructuredGridReader
from ..utils.grib1 import Grib1File
from ..utils.grib2 import Grib2File

logger = logging.getLogger(__name__)


def _open_messages(path):
    """Messages of either edition (a file may contain both)."""
    msgs = []
    err = []
    for cls in (Grib2File, Grib1File):
        try:
            msgs.extend(cls(path).messages)
        except ValueError as e:
            err.append(str(e))
    if not msgs:
        raise ValueError("; ".join(err))
    return msgs


class GribReader(StructuredGridReader):
    def __init__(self, filename, name=None, variable_map=None):
        files = filename if isinstance(filename, (list, tuple)) \
            else [filename]
        self.name = name or str(files[0])
        msgs = []
        for f in files:
            msgs.extend(_open_messages(f))
        if variable_map:
            for m in msgs:
                if m.parameter_key in variable_map:
                    m.standard_name = variable_map[m.parameter_key]
        msgs = [m for m in msgs if m.standard_name is not None]
        if not msgs:
            raise ValueError(f"{self.name}: no mapped GRIB2 variables "
                             "(pass variable_map={(disc, cat, num): name})")
        # all messages must share one grid
        g0 = msgs[0]
        for m in msgs:
            if m.shape != g0.shape or m.proj4 != g0.proj4:
                raise ValueError(f"{self.name}: mixed grids in GRIB file "
                                 "are not supported")
        self.proj4 = g0.proj4
        self.x = g0.x
        self.y = g0.y
        self.depths = None
        # frame index: (std, time) -> message closest to the surface
        self._frames = {}
        for m in msgs:
            key = (m.standard_name, m.valid_time)
            prev = self._frames.get(key)
            if prev is None or abs(m.level) < abs(prev.level):
                self._frames[key] = m
        self.times = sorted({t for (_, t) in self._frames})
        self.variables = sorted({v for (v, _) in self._frames})
        self._var_has_z = {v: False for v in self.variables}
        super().__init__()

    def _read_frame(self, std, ti, zslice, yslice, xslice):
        when = self.times[ti]
        m = self._frames.get((std, when))
        if m is None:  # variable missing at this time: nearest frame
            cands = [(abs((t - when).total_seconds()), mm)
                     for (v, t), mm in self._frames.items() if v == std]
            m = min(cands)[1]
        return m.values()[yslice, xslice]
