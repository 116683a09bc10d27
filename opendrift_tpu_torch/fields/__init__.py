from .base import BaseReader, ContinuousReader  # noqa: F401
from .environment import Environment  # noqa: F401
from .analytic import (DoubleGyre, ConstantReader,  # noqa: F401
                       OscillatingReader, ArtificialOceanEddy, FailingReader,
                       TimeseriesReader, CurrentFromTrack,
                       CurrentFromDrifter)
from .grid import StructuredGridReader, ArrayReader  # noqa: F401
from .netcdf import NetCDFReader  # noqa: F401
from .roms import ROMSReader  # noqa: F401
from .lazy import LazyReader  # noqa: F401
from .shape import ShapeReader  # noqa: F401
from .landmask import GlobalLandmask  # noqa: F401
from .factory import reader_from_url  # noqa: F401
from .operators import (CombinedReader, ScaledReader,  # noqa: F401
                        GaussianBlendReader, combine_add, combine_sub)

__all__ = ["BaseReader", "ContinuousReader", "Environment", "DoubleGyre",
           "ConstantReader", "OscillatingReader", "ArtificialOceanEddy",
           "FailingReader", "TimeseriesReader", "CurrentFromTrack",
           "CurrentFromDrifter",
           "StructuredGridReader", "ArrayReader", "NetCDFReader",
           "ROMSReader",
           "LazyReader", "reader_from_url", "CombinedReader",
           "ScaledReader", "GaussianBlendReader", "combine_add",
           "combine_sub", "ShapeReader", "GlobalLandmask"]
