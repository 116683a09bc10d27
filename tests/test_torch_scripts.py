"""The port's command-line scripts (``opendrift_tpu_torch/scripts``) and
the GUI's headless controller on the CPU (``--device cpu``,
``GuiController(device="cpu")``), against the JAX package's, by
``tests/test_misc_surface.py:63-84``, ``tests/test_gui_controller.py``
and ``tests/test_product_surface.py::test_cli_plot``.

Tolerances.  The plot scripts draw the same file in both packages: their
artists are held exactly (``tests/test_torch_plots.py``'s comparison).
The hodograph integrates currents sampled on each package's device:
float32 samples, held to 1e-6 km.  The controller's runs are held to the
slice tolerance of ``tests/test_torch_oceandrift.py``; its forms and
config handling are host code, held equal.
"""

import os
import subprocess
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch.tools import synthetic_nc

pytest.importorskip("matplotlib")
from test_torch_plots import artists, assert_same_artists, saved  # noqa
from test_torch_surface import _hold  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = datetime(2016, 2, 2)
HODOGRAPH_ATOL = 1e-6         # km
ROMS_SMALL = dict(nxi=60, neta=50, ns=12, nt=3, hmax=400.0,
                  centre=(14.0, 67.8))


@pytest.fixture(scope="module")
def result_file(tmp_path_factory):
    """A JAX package's OceanDrift result file (tests/test_product_surface.
    py:201-205's run), which both packages' scripts read."""
    from opendrift_tpu.models import OceanDrift
    d = tmp_path_factory.mktemp("scripts")
    path = str(d / "run.nc")
    o = OceanDrift(loglevel=50)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("environment:fallback:x_sea_water_velocity", 0.2)
    o.set_config("environment:fallback:y_sea_water_velocity", 0.1)
    o.seed_elements(4.0, 60.0, number=5, radius=500, time=T0)
    o.run(duration=timedelta(hours=3), time_step=3600, outfile=path)
    return path


@pytest.fixture(scope="module")
def roms_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts_roms")
    return synthetic_nc.write_roms(str(d / "roms.nc"), **ROMS_SMALL)


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


# ------------------------------------------------------------- scripts --

def test_cli_plot(result_file, tmp_path):
    """tests/test_product_surface.py:201-214: the plot script as a module,
    in a process of its own, with ``--device cpu``."""
    out = str(tmp_path / "traj.png")
    res = subprocess.run(
        [sys.executable, "-m", "opendrift_tpu_torch.scripts.opendrift_plot",
         result_file, "-o", out, "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-800:]
    assert os.path.getsize(out) > 5000
    assert f"Wrote {out}" in res.stdout


@pytest.mark.parametrize("linecolor", [None, "z"])
def test_plot_script_matches_jax(result_file, tmp_path, saved, monkeypatch,
                                 linecolor):
    """``opendrift_plot`` of one file in both packages: the same
    artists."""
    from opendrift_tpu.scripts import opendrift_plot as J
    from opendrift_tpu_torch.scripts import opendrift_plot as T
    extra = ["-c", linecolor] if linecolor else []
    _jax_main(J, [result_file, "-o", str(tmp_path / "j.png"), "-b", "0.2"]
              + extra, monkeypatch)
    T.main([result_file, "-o", str(tmp_path / "t.png"), "-b", "0.2",
            "--device", "cpu"] + extra)
    want, got = saved
    assert_same_artists(got, want)
    assert len(got) == (2 if linecolor else 1)


def test_animate_script_matches_jax(result_file, tmp_path, monkeypatch):
    """``opendrift_animate``: a GIF of one frame per output step, the
    frames equal to the JAX package's."""
    from PIL import Image
    from opendrift_tpu.scripts import opendrift_animate as J
    from opendrift_tpu_torch.scripts import opendrift_animate as T
    _jax_main(J, [result_file, "-o", str(tmp_path / "j.gif"), "--fps", "4"],
              monkeypatch)
    T.main([result_file, "-o", str(tmp_path / "t.gif"), "--fps", "4",
            "--device", "cpu"])
    got, want = Image.open(tmp_path / "t.gif"), Image.open(tmp_path / "j.gif")
    assert got.n_frames == want.n_frames == 4
    for i in range(got.n_frames):
        got.seek(i)
        want.seek(i)
        np.testing.assert_array_equal(np.asarray(got.convert("RGB")),
                                      np.asarray(want.convert("RGB")))


@pytest.mark.parametrize("source", ["constant", "roms"])
def test_readerinfo_script(source, roms_file, monkeypatch, capsys):
    """tests/test_misc_surface.py:76-82, and a ROMS file: the port prints
    what the JAX package prints."""
    from opendrift_tpu.scripts import readerinfo as J
    from opendrift_tpu_torch.scripts import readerinfo as T
    src = "constant://x_sea_water_velocity=0.3" if source == "constant" \
        else roms_file
    _jax_main(J, [src], monkeypatch)
    want = capsys.readouterr().out
    T.main([src, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "x_sea_water_velocity" in got


def test_readerinfo_plot_matches_jax(roms_file, tmp_path, monkeypatch,
                                     saved):
    """``readerinfo -p``: the first variable's first frame, as the JAX
    package draws it."""
    from opendrift_tpu.scripts import readerinfo as J
    from opendrift_tpu_torch.scripts import readerinfo as T
    import matplotlib.pyplot as plt
    monkeypatch.chdir(tmp_path)
    # both scripts draw into pyplot's current figure: start from none, so
    # that a figure another test left open is not drawn into
    plt.close("all")
    _jax_main(J, [roms_file, "-p"], monkeypatch)
    plt.close("all")
    T.main([roms_file, "-p", "--device", "cpu"])
    want, got = saved
    assert_same_artists(got, want)
    assert (tmp_path / "readerinfo.png").exists()


def test_hodograph_script(tmp_path, monkeypatch, saved):
    """tests/test_misc_surface.py:63-73: the progressive vector of an
    oscillating current, sampled with tensors on the CPU."""
    from opendrift_tpu.scripts import hodograph as J
    from opendrift_tpu_torch.scripts import hodograph as T
    src = ("oscillating://x_sea_water_velocity?amplitude=0.5"
           "&period_seconds=3600")
    _jax_main(J, [src, "--lon", "3.0", "--lat", "60.0", "-o",
                  str(tmp_path / "j.png")], monkeypatch)
    import matplotlib.pyplot as plt
    plt.close("all")
    out = str(tmp_path / "hodo.png")
    T.main([src, "--lon", "3.0", "--lat", "60.0", "-o", out,
            "--device", "cpu"])
    assert os.path.getsize(out) > 1000
    want, got = saved
    (gx, gy, _), (wx, wy, _) = got[0]["lines"][0], want[0]["lines"][0]
    assert len(gx) == 50
    np.testing.assert_allclose(gx, wx, rtol=0, atol=HODOGRAPH_ATOL)
    np.testing.assert_allclose(gy, wy, rtol=0, atol=HODOGRAPH_ATOL)
    for key in ("title", "xlabel", "ylabel"):
        assert got[0][key] == want[0][key]


@pytest.mark.parametrize("script", ["opendrift_plot", "opendrift_animate",
                                    "readerinfo", "hodograph", "gui"])
def test_scripts_ask_for_the_card_by_default(script, result_file,
                                             monkeypatch):
    """Without ``--device`` a script runs on ``cuda``, and without a card
    that raises rather than carrying on on the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"opendrift_tpu_torch.scripts.{script}")
    if script == "gui":
        with pytest.raises(RuntimeError, match="CUDA"):
            module.GuiController()
        return
    argv = {"opendrift_plot": [result_file, "-o", "x.png"],
            "opendrift_animate": [result_file, "-o", "x.gif"],
            "readerinfo": ["constant://x_wind=1"],
            "hodograph": ["constant://x_sea_water_velocity=0.1",
                          "--lon", "3", "--lat", "60"]}[script]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)


def test_console_names_in_pyproject():
    """The port's scripts have console names of their own, the JAX
    package's names with ``_torch`` at the end; the JAX names stay."""
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    for name, module in (("opendrift_plot", "opendrift_plot"),
                         ("opendrift_animate", "opendrift_animate"),
                         ("readerinfo", "readerinfo"),
                         ("hodograph", "hodograph"),
                         ("opendrift_gui", "gui")):
        assert f'{name} = "opendrift_tpu.scripts.{module}:main"' in text
        assert (f'{name}_torch = "opendrift_tpu_torch.scripts.{module}:main"'
                in text)


# ---------------------------------------------------- the GUI controller --

def _controllers():
    from opendrift_tpu.scripts.gui import GuiController as J
    from opendrift_tpu_torch.scripts.gui import GuiController as T
    return J(), T(device="cpu")


def test_controller_model_listing_and_seed_form():
    """tests/test_gui_controller.py:12-19."""
    jc, tc = _controllers()
    assert tc.available_models() == jc.available_models()
    assert "OceanDrift" in tc.available_models()
    tc.select_model("Leeway")
    jc.select_model("Leeway")
    assert tc.simulation.device.type == "cpu"
    items = dict(tc.seed_config_items())
    assert "seed:object_type" in items
    assert list(items) == [k for k, _ in jc.seed_config_items()]


def _ocean_point(roms_file):
    """A rho point well inside the synthetic ROMS file's ocean."""
    from opendrift_tpu_torch.fields.roms import ROMSReader
    r = ROMSReader(roms_file)
    wet = np.argwhere(r._mask > 0.5)
    j, i = wet[len(wet) // 2]
    return float(r._lon_rho[j, i]), float(r._lat_rho[j, i]), r.times[0]


def test_controller_end_to_end_run(roms_file):
    """tests/test_gui_controller.py:22-37 on the synthetic Nordic-4km-like
    ROMS file (the reference's is not here): both controllers' runs
    agree, and the elements move."""
    lon0, lat0, t0 = _ocean_point(roms_file)
    results = {}
    for pkg, ctl in zip(("jax", "torch"), _controllers()):
        ctl.select_model("OceanDrift")
        ctl.simulation.set_config("general:use_auto_landmask", False)
        ctl.simulation.set_config("drift:vertical_mixing", False)
        ctl.add_forcing(roms_file)
        logs = []
        o = ctl.run(lon=lon0, lat=lat0, radius=300, number=20,
                    start_time=t0, duration_hours=2, time_step=900,
                    log=logs.append)
        assert any("finished" in s for s in logs)
        results[pkg] = o.result
    lon = np.asarray(results["torch"]["lon"].values)
    assert np.isfinite(lon).all()
    assert np.abs(lon[:, -1] - lon[:, 0]).max() > 1e-4
    _hold(results["torch"], results["jax"], ("lon", "lat"))


def test_controller_warns_outside_coverage(roms_file):
    """tests/test_gui_controller.py:40-52."""
    _, _, t0 = _ocean_point(roms_file)
    for ctl in _controllers():
        ctl.select_model("OceanDrift")
        ctl.simulation.set_config("general:use_auto_landmask", False)
        ctl.simulation.set_config("environment:fallback:land_binary_mask", 0)
        ctl.add_forcing(roms_file)
        logs = []
        ctl.run(lon=0.0, lat=50.0, number=5, start_time=t0,
                duration_hours=0.5, time_step=900, log=logs.append)
        assert any("WARNING" in s and "outside" in s for s in logs)


def test_config_form_groups_and_apply():
    """tests/test_gui_controller.py:55-83: the generated forms equal the
    JAX package's but for the port's own keys, and apply alike."""
    jc, tc = _controllers()
    for c in (jc, tc):
        c.select_model("OceanDrift")
    groups, jgroups = tc.config_form_groups(), jc.config_form_groups()
    assert "seed" in groups and "drift" in groups
    assert groups == jgroups
    adv = tc.config_form_groups(max_level=3)
    tc_jax_forms = jc.config_form_groups(max_level=3)
    # the same keys, the parallel layer's (ROADMAP A.14) included, with
    # the same types, defaults, ranges and choices (descriptions may say
    # torch where the JAX package says jax)

    def form(groups):
        return {g: [(k, {f: v for f, v in spec.items()
                         if f != "description"})
                    for k, spec in items]
                for g, items in groups.items()}
    assert form(adv) == form(tc_jax_forms)
    assert "parallel" in adv and "export" in adv
    keys = [k for items in adv.values() for k, _ in items]
    assert "drift:advection_scheme" in keys
    assert "euler" in dict(adv["drift"])["drift:advection_scheme"]["enum"]
    for c in (jc, tc):
        n = c.apply_config_form({"drift:advection_scheme": "runge-kutta4",
                                 "seed:number": "500"}, log=lambda m: None)
        assert n == 2
        assert c.simulation.get_config("drift:advection_scheme") \
            == "runge-kutta4"
        assert c.simulation.get_config("seed:number") == 500
    with pytest.raises(Exception):
        tc.apply_config_form({"drift:advection_scheme": "warp-drive"})


def test_controller_cone_seeding():
    """tests/test_gui_controller.py:86-105: a cone between two positions
    released over an interval, in both packages."""
    results = {}
    t0 = datetime(2021, 1, 1)
    for pkg, c in zip(("jax", "torch"), _controllers()):
        c.select_model("OceanDrift")
        o = c.simulation
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("environment:fallback:x_sea_water_velocity", 0.1)
        o.set_config("environment:fallback:y_sea_water_velocity", 0.0)
        c.run(lon=4.0, lat=60.0, end_lon=5.0, end_lat=61.0,
              number=50, radius=0.0, start_time=t0,
              end_time=t0 + timedelta(hours=2),
              duration_hours=3.0, time_step=1800, log=lambda m: None)
        results[pkg] = o.result
    lon = np.asarray(results["torch"]["lon"].values)
    assert np.nanmin(lon) <= 4.01 and np.nanmax(lon) > 4.9
    _hold(results["torch"], results["jax"], ("lon", "lat"))
