from .base import OpenDriftSimulation, Mode, StepContext  # noqa: F401
from .oceandrift import OceanDrift, Lagrangian3DArray  # noqa: F401
from .openoil import OpenOil  # noqa: F401
