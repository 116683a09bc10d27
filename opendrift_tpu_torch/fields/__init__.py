from .base import BaseReader, ContinuousReader  # noqa: F401
from .environment import Environment  # noqa: F401
from .analytic import DoubleGyre, ConstantReader  # noqa: F401
from .grid import StructuredGridReader, ArrayReader  # noqa: F401
from .shape import ShapeReader  # noqa: F401
from .landmask import GlobalLandmask  # noqa: F401
