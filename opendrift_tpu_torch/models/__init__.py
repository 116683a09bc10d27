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

# the rest of the JAX package's zoo, still to be ported (ROADMAP A.12b):
# asking for one raises and names the item
NOT_YET_PORTED = ("RadionuclideDrift", "ChemicalDrift", "OpenHNS",
                  "OpenBergOld", "ModelTemplate", "eulerdrift")


def not_yet_ported(name):
    return NotImplementedError(
        f"{name} is not ported yet (ROADMAP A.12b: radionuclides, "
        "chemicaldrift, eulerdrift, legacy and model_template)")


def __getattr__(name):
    if name in NOT_YET_PORTED:
        raise not_yet_ported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
