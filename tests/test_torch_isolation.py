"""The port stands alone: no module of ``opendrift_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, the package imports with
JAX made unimportable, and its entry points ask for the card by default.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "opendrift_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "opendrift_tpu")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths.extend(os.path.join(root, f) for f in files
                     if f.endswith(".py"))
    return sorted(paths)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_the_sampler_slice_is_covered():
    """The modules of the packed-row sampler slice and the ``tools``
    sub-package are among the sources checked above."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("ops/gather.py", "ops/cuda_build.py", "ops/interp.py",
                 "tools/__init__.py", "tools/gather_ab.py", "interop.py",
                 "fields/grid.py", "fields/environment.py"):
        assert name in have, name
    assert os.path.exists(os.path.join(PORT, "csrc", "row_gather.cu"))


def test_the_landmask_slice_is_covered_and_keeps_its_own_copies():
    """The landmask slice's modules are among the sources checked above,
    and the port carries its own byte copies of the coastline raster and
    of the native field pipeline's source."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("fields/landmask.py", "fields/shape.py",
                 "utils/shapefile.py", "utils/native.py",
                 "export/io_parquet.py"):
        assert name in have, name
    for port_copy, original in (
            ("data/coastline_mask.npz", "opendrift_tpu/data/coastline_mask.npz"),
            ("csrc/fieldpipe.cpp", "native/fieldpipe.cpp")):
        with open(os.path.join(PORT, port_copy), "rb") as a, \
                open(os.path.join(REPO, original), "rb") as b:
            assert a.read() == b.read(), port_copy


def test_the_file_reader_slice_is_covered():
    """The NetCDF/ROMS slice's modules are among the sources checked above
    (and so import neither JAX nor the JAX package)."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("utils/ncio.py", "utils/crs.py", "fields/netcdf.py",
                 "fields/roms.py", "fields/regrid.py", "fields/lazy.py",
                 "fields/operators.py", "fields/factory.py",
                 "fields/catalog.py", "fields/grib.py", "fields/analytic.py",
                 "tools/synthetic_nc.py", "utils/grib1.py", "utils/grib2.py",
                 "utils/selafin.py", "fields/mesh.py",
                 "fields/unstructured.py", "tools/synthetic_grib.py",
                 "tools/synthetic_mesh.py"):
        assert name in have, name


def test_the_zoo_slice_is_covered():
    """The model zoo's modules are among the sources checked above (and so
    import neither JAX nor the JAX package), and the port carries its own
    byte copies of the Leeway object classes and ShipDrift's force
    table."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("models/windblow.py", "models/seaicedrift.py",
                 "models/leeway.py", "models/plastdrift.py",
                 "models/sedimentdrift.py", "models/pelagicegg.py",
                 "models/larvalfish.py", "models/openberg.py",
                 "models/shipdrift.py", "models/sealice.py",
                 "models/physics.py", "ops/physics.py", "rng.py"):
        assert name in have, name
    for table in ("leeway_objects.json", "shipdrift_wforce.json"):
        with open(os.path.join(PORT, "models", table), "rb") as a, \
                open(os.path.join(REPO, "opendrift_tpu", "models", table),
                     "rb") as b:
            assert a.read() == b.read(), table


def test_the_chemistry_slice_is_covered():
    """The rest of the zoo and the post-processing are among the sources
    checked above (and so import neither JAX nor the JAX package), and the
    port carries its own byte copies of the compound and emission-factor
    tables."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("models/radionuclides.py", "models/chemicaldrift.py",
                 "models/legacy.py", "models/model_template.py",
                 "models/eulerdrift.py", "models/postprocess.py",
                 "ops/speciation.py", "ops/lcs.py", "utils/trajectory.py"):
        assert name in have, name
    for table in ("chemical_compounds.json",
                  "chemical_emission_factors.json"):
        with open(os.path.join(PORT, "models", table), "rb") as a, \
                open(os.path.join(REPO, "opendrift_tpu", "models", table),
                     "rb") as b:
            assert a.read() == b.read(), table


def test_the_surface_plot_and_script_slice_is_covered():
    """The plots, the GeoTIFF and GML seeders' modules and the scripts are
    among the sources checked above (and so import neither JAX nor the JAX
    package), and the port carries its own byte copy of the default data
    sources' list."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("models/plot.py", "utils/plotting.py", "utils/geotiff.py",
                 "tools/synthetic_tiff.py", "scripts/__init__.py",
                 "scripts/opendrift_plot.py", "scripts/opendrift_animate.py",
                 "scripts/readerinfo.py", "scripts/hodograph.py",
                 "scripts/gui.py"):
        assert name in have, name
    with open(os.path.join(PORT, "scripts", "data_sources.txt"), "rb") as a, \
            open(os.path.join(REPO, "opendrift_tpu", "scripts",
                              "data_sources.txt"), "rb") as b:
        assert a.read() == b.read()


def _smoke_imports():
    """The port's modules that chip_smoke.py imports (at any depth of its
    functions)."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.startswith("opendrift_tpu_torch"):
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            mods.update(a.name for a in node.names
                        if a.name.startswith("opendrift_tpu_torch"))
    return sorted(mods)


def test_the_card_path_imports_no_matplotlib(tmp_path):
    """matplotlib is not on the card machine: in a fresh process, importing
    every port module chip_smoke.py imports, seeding OpenOil from a GeoTIFF
    and from a GML, running the readerinfo script and a GUI controller's
    run leaves matplotlib out of ``sys.modules``."""
    mods = _smoke_imports()
    assert "opendrift_tpu_torch.tools.synthetic_tiff" in mods
    assert "opendrift_tpu_torch.scripts.gui" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ModuleNotFoundError:\n"
        "        pass   # a name imported from a module, not a module\n"
        "from datetime import datetime\n"
        "import numpy as np\n"
        "from opendrift_tpu_torch.tools import synthetic_tiff as st\n"
        "from opendrift_tpu_torch.models import OpenOil\n"
        f"tif, gml = {str(tmp_path / 's.tif')!r}, "
        f"{str(tmp_path / 's.gml')!r}\n"
        "st.write_geotiff(tif, st.slick_categories((60, 50)), 4.0, 60.0,\n"
        "                 0.001, 0.0005)\n"
        "st.write_gml(gml, st.slick_polygons(4.0, 60.0, 3000.0),\n"
        "             datetime(2024, 3, 1))\n"
        "o = OpenOil(loglevel=40, device='cpu')\n"
        "o.seed_from_geotiff_thickness(tif, number=500,\n"
        "                              time=datetime(2024, 3, 1))\n"
        "o.seed_from_gml(gml, num_elements=500)\n"
        "from opendrift_tpu_torch.scripts import readerinfo\n"
        "readerinfo.main(['constant://x_wind=1', '--device', 'cpu'])\n"
        "from opendrift_tpu_torch.scripts.gui import GuiController\n"
        "c = GuiController(device='cpu')\n"
        "c.select_model('OceanDrift')\n"
        "s = c.simulation\n"
        "s.set_config('environment:fallback:land_binary_mask', 0)\n"
        "s.set_config('environment:fallback:x_sea_water_velocity', 0.1)\n"
        "s.set_config('environment:fallback:y_sea_water_velocity', 0.0)\n"
        "c.run(lon=4.0, lat=60.0, number=20, duration_hours=1,\n"
        "      time_step=1800, start_time=datetime(2024, 3, 1),\n"
        "      log=lambda m: None)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('matplotlib', 'jax',\n"
        "                                    'opendrift_tpu'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-500:]


def test_chemicaldrift_seeds_from_datetime64_without_pandas():
    """pandas is not on the card machine: with it unimportable,
    ChemicalDrift imports and seeds from a discharge field whose times are
    ``datetime64``."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'opendrift_tpu', 'pandas'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from datetime import datetime\n"
        "from opendrift_tpu_torch.models import ChemicalDrift\n"
        "o = ChemicalDrift(loglevel=40, device='cpu')\n"
        "data = np.zeros((2, 2, 2)); data[1, 0, 1] = 3.0\n"
        "times = np.array(['2021-04-01T00', '2021-04-01T06'],\n"
        "                 dtype='datetime64[ns]')\n"
        "o.seed_from_DataArray(data, longitude=[4.0, 4.1],\n"
        "                      latitude=[60.0, 60.1], time=times,\n"
        "                      chemical_compound='Copper',\n"
        "                      mass_element_ug=1e6)\n"
        "t = o._seedings[0]['time']\n"
        "t = t[0] if hasattr(t, '__len__') else t\n"
        "assert t == datetime(2021, 4, 1, 6), t\n"
        "print(len(o._seedings[0]['lon']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


def test_mesh_sampler_builds_without_matplotlib(monkeypatch):
    """matplotlib is not on the card machine: with it unimportable the
    port still builds a MeshSampler (its own rasteriser), and its tables
    equal the JAX package's built with matplotlib's trapezoid map."""
    import builtins
    import numpy as np
    from scipy.spatial import Delaunay
    from opendrift_tpu.fields.mesh import MeshSampler as JMeshSampler
    from opendrift_tpu_torch.fields.mesh import MeshSampler
    r = np.random.default_rng(2)
    x, y = r.uniform(10.0, 12.0, 600), r.uniform(67.0, 68.0, 600)
    tri = Delaunay(np.column_stack([x, y])).simplices
    cent = np.column_stack([x, y])[tri].mean(axis=1)
    tri = tri[np.hypot(cent[:, 0] - 11.0, cent[:, 1] - 67.5) > 0.2]
    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    port = MeshSampler(x, y, triangles=tri)
    monkeypatch.setattr(builtins, "__import__", real)
    want = JMeshSampler(x, y, triangles=tri).device_arrays()
    for k, v in port.device_arrays().items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert (port._raw < 0).any() and (port._raw >= 0).any()


def test_netcdf4_without_h5py_names_it(tmp_path, monkeypatch):
    """h5py is not on the card machine: a NetCDF-4 file raises an
    ImportError that names it, and NetCDF-3 files still open."""
    import builtins
    from opendrift_tpu_torch.utils import ncio
    path = tmp_path / "nc4.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    real = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name.split(".")[0] == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        ncio.open_dataset(str(path))
    from scipy.io import netcdf_file
    nc3 = str(tmp_path / "nc3.nc")
    f = netcdf_file(nc3, "w")
    f.createDimension("x", 2)
    f.createVariable("x", "d", ("x",))[:] = [1.0, 2.0]
    f.close()
    assert list(ncio.open_dataset(nc3).variables["x"][:]) == [1.0, 2.0]


def test_no_module_imports_matplotlib_at_module_level():
    """matplotlib is not on the card machine: a port module imports it
    only inside the function that needs it (``seed_letters``, the plots
    through ``utils/plotting.py``)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(n.split(".")[0] == "matplotlib" for n in names):
                bad.append(os.path.relpath(path, REPO))
    assert not bad


def test_gather_tool_runs_with_jax_unimportable():
    """``python -m opendrift_tpu_torch.tools.gather_ab`` on the CPU, in a
    process where JAX and the JAX package cannot be imported."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'opendrift_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from opendrift_tpu_torch.tools import gather_ab\n"
        "sys.exit(gather_ab.main(['200', '6', '1000', '--device', 'cpu']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("bit-equal to A") == 2


def test_imports_with_jax_unimportable():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'opendrift_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import opendrift_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'opendrift_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "p.get_model('OceanDrift')\n"
        "import chip_smoke\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_default_device_is_cuda(monkeypatch):
    """Without ``device=`` the port asks for the card and raises where
    there is none, rather than carrying on on the CPU."""
    from opendrift_tpu_torch.models import OceanDrift
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OceanDrift(loglevel=40)
    with pytest.raises(RuntimeError, match="CUDA"):
        OceanDrift(loglevel=40, device="cuda")
    assert OceanDrift(loglevel=40, device="cpu").device.type == "cpu"


def test_smoke_script_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and alone in a directory without the package."""
    script = os.path.join(REPO, "chip_smoke.py")
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{script!r}]\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(script).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_the_parallel_slice_loads_no_jax():
    """The parallel layer's modules and its two tools are among the
    sources checked above, and importing them in a fresh process, then
    running a tiled and a sharded run on CPU tiles, leaves JAX and the JAX
    package out of ``sys.modules``."""
    have = {os.path.relpath(p, PORT) for p in _port_sources()}
    mods = ["opendrift_tpu_torch.parallel",
            "opendrift_tpu_torch.parallel.mesh",
            "opendrift_tpu_torch.parallel.domain",
            "opendrift_tpu_torch.parallel.tiled",
            "opendrift_tpu_torch.parallel.multihost",
            "opendrift_tpu_torch.tools.concat_shards",
            "opendrift_tpu_torch.tools.multihost_dryrun"]
    for m in mods:
        rel = m.split(".", 1)[1].replace(".", "/")
        assert rel + ".py" in have or rel + "/__init__.py" in have, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from opendrift_tpu_torch.tools import multihost_dryrun as d\n"
        "for mode in ('particle', 'domain'):\n"
        "    o = d._simulation('cpu', mode, 4, 4, 32, False)\n"
        "    o.run(steps=2, time_step=900)\n"
        "    assert (o._sharding or o._dd) is not None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'opendrift_tpu'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
