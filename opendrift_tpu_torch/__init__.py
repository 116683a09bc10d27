"""opendrift_tpu_torch — the PyTorch/CUDA port of ``opendrift_tpu``.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or
anything of ``opendrift_tpu``; the JAX package is the reference every part
of the port is held against (``tests/test_torch_*.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The port grows one slice at a time (ROADMAP.md, queue A): so far an
OceanDrift run on gridded forcing with Visser vertical mixing, the
automatic coastline landmask and the polygon seeders, an OpenOil run
(weathering, wave entrainment, stranding), the whole reader layer, the
whole model zoo (:func:`get_model_names`) with the Eulerian solver
(``models.eulerdrift``), the post-processing of a result (density maps,
residence time, FTLE), the plots (matplotlib, imported inside each plot),
the GeoTIFF and GML oil seeders, the command-line scripts
(``python -m opendrift_tpu_torch.scripts.<name> --device ...``), LADiM
imports (:func:`import_from_ladim`) and a result's round trip through
:func:`open`.  The three mixing kernels are hand-written CUDA
(``csrc/visser_mixing.cu``); the host NaN fill is C++ built with g++
(``csrc/fieldpipe.cpp``).
"""

import importlib
import logging

__version__ = "0.1.0"

_MODEL_REGISTRY = {
    "OceanDrift": "opendrift_tpu_torch.models.oceandrift",
    "OpenOil": "opendrift_tpu_torch.models.openoil",
    "WindBlow": "opendrift_tpu_torch.models.windblow",
    "SeaIceDrift": "opendrift_tpu_torch.models.seaicedrift",
    "PelagicEggDrift": "opendrift_tpu_torch.models.pelagicegg",
    "PlastDrift": "opendrift_tpu_torch.models.plastdrift",
    "SedimentDrift": "opendrift_tpu_torch.models.sedimentdrift",
    "Leeway": "opendrift_tpu_torch.models.leeway",
    "ShipDrift": "opendrift_tpu_torch.models.shipdrift",
    "OpenBerg": "opendrift_tpu_torch.models.openberg",
    "LarvalFish": "opendrift_tpu_torch.models.larvalfish",
    "LarvalFishExtended": "opendrift_tpu_torch.models.larvalfish",
    "SeaLice": "opendrift_tpu_torch.models.sealice",
    "RadionuclideDrift": "opendrift_tpu_torch.models.radionuclides",
    "ChemicalDrift": "opendrift_tpu_torch.models.chemicaldrift",
    "OpenHNS": "opendrift_tpu_torch.models.legacy",
    "OpenBergOld": "opendrift_tpu_torch.models.legacy",
    "ModelTemplate": "opendrift_tpu_torch.models.model_template",
}


def get_model_names():
    """Names of the models the port provides: every model of the JAX
    package's zoo."""
    return list(_MODEL_REGISTRY)


def get_model(model_name):
    """Import and return a model class by name
    (reference opendrift/__init__.py:31-43)."""
    if model_name not in _MODEL_REGISTRY:
        raise ValueError(
            f"No drift model named {model_name}; "
            f"available: {list(_MODEL_REGISTRY)}")
    module = importlib.import_module(_MODEL_REGISTRY[model_name])
    return getattr(module, model_name)


def open(filename, device=None):
    """A simulation of the file's model class in Result mode, its result
    and config read from an output file (reference
    opendrift/__init__.py:46-88); on ``cuda`` unless ``device`` says
    otherwise, as every entry point."""
    from .export.io_netcdf import read_result
    from .models.base import Mode
    result = read_result(filename)
    cls = get_model(result.attrs.get("opendrift_class"))
    o = cls(loglevel=logging.WARNING, device=device)
    o.result = result
    o._config_from_attributes(result.attrs)
    o.mode = Mode.Result
    return o


def import_from_ladim(ladimfile, romsfile, device=None):
    """A LADiM output NetCDF file as an OceanDrift simulation in Result
    mode (reference opendrift/__init__.py:125-187), on ``cuda`` unless
    ``device`` says otherwise.

    LADiM stores ragged per-timestep particle records (``pid``,
    ``particle_count``, grid coordinates ``X``/``Y``); they are scattered
    into the dense (trajectory, time) layout of a result, with positions
    converted to lon/lat through the ROMS grid of ``romsfile`` (a path or
    a reader).  Each trajectory's last valid state is 'missing_data'.
    """
    import numpy as np
    from .utils import ncio
    from .utils.dataset import TrajectoryDataset, DataVar
    from .models.oceandrift import OceanDrift
    from .models.base import Mode

    if isinstance(romsfile, str):
        from .fields.roms import ROMSReader
        romsfile = ROMSReader(romsfile)
    f = ncio.NCFile(ladimfile)
    pid = np.asarray(f.variables["pid"][:], dtype=np.int64)
    particle_count = np.asarray(f.variables["particle_count"][:],
                                dtype=np.int64)
    x = np.asarray(f.variables["X"][:], dtype=np.float64)
    y = np.asarray(f.variables["Y"][:], dtype=np.float64)
    tvar = f.variables["time"]
    times = ncio.parse_cf_time(tvar.attrs["units"], tvar[:])

    end_index = np.cumsum(particle_count)
    start_index = np.concatenate(([0], end_index[:-1]))
    lon, lat = romsfile.xy2lonlat(x, y)
    n_time = len(times)
    n_elements = int(pid.max()) + 1
    lon_h = np.full((n_elements, n_time), np.nan, dtype=np.float32)
    lat_h = np.full((n_elements, n_time), np.nan, dtype=np.float32)
    status = np.full((n_elements, n_time), -128, dtype=np.int8)
    for n in range(n_time):
        sl = slice(start_index[n], start_index[n] + particle_count[n])
        active = pid[sl]
        lon_h[active, n] = lon[sl]
        lat_h[active, n] = lat[sl]
        status[active, n] = 0
    # the last valid state of each trajectory (reference :168-172)
    valid = status == 0
    has_any = valid.any(axis=1)
    last = np.where(has_any,
                    n_time - 1 - np.argmax(valid[:, ::-1], axis=1), 0)
    rows = np.arange(n_elements)[has_any]
    status[rows, last[has_any]] = 1

    o = OceanDrift(loglevel=logging.WARNING, device=device)
    o.result = TrajectoryDataset(
        variables={
            "lon": DataVar(("trajectory", "time"), lon_h,
                           {"units": "degrees_east"}),
            "lat": DataVar(("trajectory", "time"), lat_h,
                           {"units": "degrees_north"}),
            "status": DataVar(("trajectory", "time"), status,
                              {"valid_range": np.array([0, 1]),
                               "flag_values": np.array([0, 1]),
                               "flag_meanings": "active missing_data"}),
        },
        coords={"trajectory": np.arange(n_elements, dtype=np.int32),
                "time": np.array([np.datetime64(t, "ns") for t in times])},
        attrs={"opendrift_class": "OceanDrift",
               "source": f"LADiM import of {ladimfile}"})
    o.status_categories = ["active", "missing_data"]
    o.mode = Mode.Result
    return o


def versions():
    """The versions of the port and what it runs on (reference
    opendrift/__init__.py:90): torch, its CUDA and the card in place of
    the JAX package's jax and its devices."""
    import platform
    import numpy
    import scipy
    import torch
    if torch.cuda.is_available():
        devices = [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = "no CUDA device"
    return (f"------------------------------------------------------\n"
            f"Software and hardware:\n"
            f"  opendrift_tpu_torch version {__version__}\n"
            f"  platform {platform.platform()}\n"
            f"  python version {platform.python_version()}\n"
            f"  numpy version {numpy.__version__}\n"
            f"  scipy version {scipy.__version__}\n"
            f"  torch version {torch.__version__}\n"
            f"  torch CUDA version {torch.version.cuda}\n"
            f"  CUDA devices {devices}\n"
            f"------------------------------------------------------\n")
