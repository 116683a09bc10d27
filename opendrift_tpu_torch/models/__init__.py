from .base import OpenDriftSimulation, Mode, StepContext  # noqa: F401
from .oceandrift import OceanDrift, Lagrangian3DArray  # noqa: F401
from .windblow import WindBlow  # noqa: F401
from .seaicedrift import SeaIceDrift  # noqa: F401
from .pelagicegg import PelagicEggDrift  # noqa: F401
from .plastdrift import PlastDrift  # noqa: F401
from .sedimentdrift import SedimentDrift  # noqa: F401
from .leeway import Leeway  # noqa: F401
from .shipdrift import ShipDrift  # noqa: F401
from .openoil import OpenOil  # noqa: F401
from .openberg import OpenBerg  # noqa: F401
from .larvalfish import LarvalFish, LarvalFishExtended  # noqa: F401
from .sealice import SeaLice  # noqa: F401
from .radionuclides import RadionuclideDrift  # noqa: F401
from .chemicaldrift import ChemicalDrift  # noqa: F401
from .legacy import OpenHNS, OpenBergOld  # noqa: F401
from .model_template import ModelTemplate  # noqa: F401

__all__ = ["OpenDriftSimulation", "Mode", "StepContext", "OceanDrift",
           "Lagrangian3DArray", "WindBlow", "SeaIceDrift",
           "PelagicEggDrift", "PlastDrift", "SedimentDrift", "Leeway",
           "ShipDrift", "OpenOil", "OpenBerg", "LarvalFish",
           "LarvalFishExtended", "SeaLice", "RadionuclideDrift",
           "ChemicalDrift", "OpenHNS", "OpenBergOld", "ModelTemplate"]
