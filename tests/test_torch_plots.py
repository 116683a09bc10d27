"""The port's plots on the CPU, against the JAX package, by the artists'
data rather than the pixels: the plotting mixin (``models/plot.py``), the
reader's ``plot``, the model plots (OceanDrift's vertical distributions,
OpenOil's budget, droplet spectrum and emulsion, Leeway's capsizing,
ChemicalDrift's mass, the radionuclide GUI plots, the Euler grid),
``write_geotiff``, ``plot_wind_drift_factor`` and ``plot_stokes_profile``;
and, with matplotlib made unimportable, an ``ImportError`` naming it.

Each figure a plot saves or returns is reduced to its artists (axes
limits, labels and titles, legend texts, line data, scatter offsets,
colours and colour limits, bar and image data).  Tolerances: the extents,
labels, legend (marker) conventions, colorbar limits and animation frame
counts are held exactly; so is the data where both packages' results are
bit-equal (the constant-current run of ``tests/test_plot_semantics.py``,
asserted so) or where both plot one file.  Elsewhere line and scatter
data are held to the slice tolerance of ``tests/test_torch_oceandrift.py``
(``MEDIAN_ATOL`` and at most ``OUTLIER_SHARE`` beyond ``OUTLIER_ATOL``,
applied to every coordinate), extents to ``OUTLIER_ATOL``; histogram bars
of depths may differ by ``BAR_SHARE`` of their counts, elements an ulp
from a bin edge.
"""

import os
from datetime import datetime, timedelta

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

MEDIAN_ATOL = 1e-6
OUTLIER_ATOL = 1e-4
OUTLIER_SHARE = 0.02
BAR_SHARE = 0.02
T0 = datetime(2021, 5, 1)


# ------------------------------------------------------------- artists ---

def _num(a):
    a = np.ma.filled(np.ma.asarray(a), np.nan) if np.ma.isMaskedArray(a) \
        else np.asarray(a)
    return a


def _axes_artists(ax):
    legend = ax.get_legend()
    out = {
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "title": ax.get_title(),
        "legend": [t.get_text() for t in legend.get_texts()]
        if legend else [],
        "legend_colors": [np.asarray(matplotlib.colors.to_rgba(
            h.get_color())) for h in legend.legend_handles
            if hasattr(h, "get_color")] if legend else [],
        "lines": [(_num(ln.get_xdata()), _num(ln.get_ydata()),
                   ln.get_color()) for ln in ax.get_lines()],
        "collections": [], "patches": [], "images": []}
    for c in ax.collections:
        entry = {"kind": type(c).__name__}
        if hasattr(c, "get_offsets"):
            entry["offsets"] = _num(c.get_offsets())
        arr = c.get_array()
        entry["array"] = None if arr is None else _num(arr)
        entry["clim"] = c.get_clim() if arr is not None else None
        entry["facecolors"] = np.asarray(c.get_facecolors())
        if type(c).__name__ in ("PolyCollection", "FillBetweenPolyCollection",
                                "QuadContourSet"):
            entry["paths"] = [p.vertices for p in c.get_paths()]
        out["collections"].append(entry)
    for p in ax.patches:
        out["patches"].append(np.array([p.get_x(), p.get_y(),
                                        p.get_width(), p.get_height()]))
    for im in ax.get_images():
        out["images"].append((_num(im.get_array()), im.get_extent()))
    return out


def artists(fig):
    """Every axes of ``fig`` (colorbars included) reduced to its data."""
    return [_axes_artists(ax) for ax in fig.axes]


@pytest.fixture
def saved(monkeypatch):
    """The artists of every figure saved while the fixture is active
    (``Figure.savefig`` and ``pyplot.savefig`` both go through it)."""
    got = []
    real = Figure.savefig

    def savefig(self, *args, **kw):
        # figures saved to a file; an animation writer's frame grabs go
        # to a buffer and are not recorded
        if args and isinstance(args[0], (str, os.PathLike)):
            got.append(artists(self))
        return real(self, *args, **kw)
    monkeypatch.setattr(Figure, "savefig", savefig)
    return got


def _close(got, want, exact):
    got, want = _num(got), _num(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or got.dtype.kind not in "fc" or got.size == 0:
        np.testing.assert_array_equal(got, want)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    d = np.abs(g - w)[~np.isnan(g)]
    if d.size:
        assert np.median(d) <= MEDIAN_ATOL, np.median(d)
        assert np.mean(d > OUTLIER_ATOL) <= OUTLIER_SHARE, d.max()


def assert_same_artists(got, want, exact=True, bars_exact=True):
    """Two ``artists`` lists agree: texts, legends, colours and colour
    limits exactly; numbers exactly or (``exact=False``) to the slice
    tolerance; bar heights exactly or within ``BAR_SHARE``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("xlabel", "ylabel", "title", "legend"):
            assert g[key] == w[key], key
        for key in ("xlim", "ylim"):
            if exact:
                assert g[key] == w[key], key
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=0,
                                           atol=OUTLIER_ATOL, err_msg=key)
        for a, b in zip(g["legend_colors"], w["legend_colors"]):
            np.testing.assert_array_equal(a, b)
        assert len(g["lines"]) == len(w["lines"])
        for (gx, gy, gc), (wx, wy, wc) in zip(g["lines"], w["lines"]):
            assert gc == wc
            _close(gx, wx, exact)
            _close(gy, wy, exact)
        assert [c["kind"] for c in g["collections"]] == \
            [c["kind"] for c in w["collections"]]
        for gc, wc in zip(g["collections"], w["collections"]):
            if "offsets" in gc:
                _close(gc["offsets"], wc["offsets"], exact)
            assert (gc["array"] is None) == (wc["array"] is None)
            if gc["array"] is not None:
                _close(gc["array"], wc["array"], exact)
                assert exact is False or gc["clim"] == wc["clim"]
            if gc["kind"] == "PathCollection" and exact:
                np.testing.assert_array_equal(gc["facecolors"],
                                              wc["facecolors"])
            for gp, wp in zip(gc.get("paths", []), wc.get("paths", [])):
                _close(gp, wp, exact)
        assert len(g["patches"]) == len(w["patches"])
        if g["patches"]:
            gp, wp = np.array(g["patches"]), np.array(w["patches"])
            if bars_exact:
                np.testing.assert_array_equal(gp, wp)
            else:
                # horizontal histograms: bar positions equal, counts within
                # BAR_SHARE of the elements
                np.testing.assert_array_equal(gp[:, [1, 3]], wp[:, [1, 3]])
                moved = np.abs(gp[:, 2] - wp[:, 2]).sum()
                assert moved <= BAR_SHARE * max(wp[:, 2].sum(), 1), moved
        assert len(g["images"]) == len(w["images"])
        for (ga, ge), (wa, we) in zip(g["images"], w["images"]):
            assert ge == we
            _close(ga, wa, exact)


# ---------------------------------------------------------- simulations --

def _models(pkg):
    if pkg == "jax":
        import opendrift_tpu.models as M
        return M, {}
    import opendrift_tpu_torch.models as M
    return M, {"device": "cpu"}


def _semantics_run(pkg, n=20, hours=6):
    """tests/test_plot_semantics.py:25-38's run."""
    M, kw = _models(pkg)
    o = M.OceanDrift(loglevel=50, **kw)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("environment:fallback:x_sea_water_velocity", 0.3)
    o.set_config("environment:fallback:y_sea_water_velocity", 0.1)
    o.set_config("drift:vertical_mixing", False)
    o.set_config("drift:vertical_advection", False)
    o.seed_elements(lon=np.linspace(4.0, 4.3, n),
                    lat=np.linspace(60.0, 60.2, n),
                    z=np.linspace(-1.0, -20.0, n), time=T0)
    o.run(duration=timedelta(hours=hours), time_step=1800)
    return o


@pytest.fixture(scope="module")
def sims():
    out = {pkg: _semantics_run(pkg) for pkg in ("jax", "torch")}
    for var in ("lon", "lat", "z", "status"):    # the data are bit-equal
        np.testing.assert_array_equal(out["torch"].result[var].values,
                                      out["jax"].result[var].values)
    return out


def _both(sims, fn):
    """``fn(simulation)`` of each package, each figure's artists."""
    res = {}
    for pkg in ("jax", "torch"):
        r = fn(sims[pkg])
        fig = r[0] if isinstance(r, tuple) else r
        fig = getattr(fig, "figure", fig)
        res[pkg] = artists(fig)
    plt.close("all")
    return res["torch"], res["jax"]


# -------------------------------------- tests/test_plot_semantics.py ----

@pytest.mark.parametrize("case", [
    "extent", "markers", "linecolor", "compare", "compare_file",
    "compare_dict"])
def test_trajectory_plot_matches_jax(sims, case, tmp_path):
    """``plot`` with a buffer, the marker convention, a linecolor
    colorbar and each kind of comparison overlay (test_plot_semantics.py's
    first four tests)."""
    kw = {"extent": dict(buffer=0.2), "markers": {},
          "linecolor": dict(linecolor="z")}.get(case, {})
    if case.startswith("compare"):
        others = {pkg: _semantics_run(pkg, n=5, hours=3)
                  for pkg in ("jax", "torch")}
        if case == "compare_file":
            path = str(tmp_path / "other.nc")
            from opendrift_tpu.export.io_netcdf import write_result
            write_result(others["jax"].result, path)
            others = {"jax": path, "torch": path}
        elif case == "compare_dict":
            track = {"lon": np.linspace(4.0, 4.4, 7),
                     "lat": np.linspace(60.0, 60.1, 7)}
            others = {"jax": track, "torch": track}
    got, want = {}, {}
    for pkg in ("jax", "torch"):
        extra = {"compare": others[pkg]} if case.startswith("compare") \
            else {}
        fig, ax = sims[pkg].plot(**kw, **extra)
        (got if pkg == "torch" else want)["a"] = artists(fig)
    plt.close("all")
    assert_same_artists(got["a"], want["a"])
    main = got["a"][0]
    lon = sims["torch"].result["lon"].values
    lat = sims["torch"].result["lat"].values
    if case == "extent":
        x0, x1 = main["xlim"]
        assert x0 <= np.nanmin(lon) - 0.15 and main["ylim"][1] >= \
            np.nanmax(lat) + 0.15
    if case == "markers":
        assert "start" in main["legend"] and "active" in main["legend"]
        sizes = [len(c["offsets"]) for c in main["collections"]]
        assert sizes.count(lon.shape[0]) >= 2
    if case == "linecolor":
        assert len(got["a"]) == 2 and got["a"][1]["ylabel"] == "z"
    if case.startswith("compare"):
        assert "compare 0" in main["legend"]


def test_density_array_of_the_semantics_run(sims):
    """test_plot_semantics.py's density-map scaling, both packages."""
    got = sims["torch"].get_density_array(pixelsize_m=2000.0)
    want = sims["jax"].get_density_array(pixelsize_m=2000.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    H = got[0] + got[1] + got[2]
    assert H.sum(axis=(1, 2)).max() == sims["torch"].result.dims[
        "trajectory"]


@pytest.mark.parametrize("color", [None, "z"])
def test_animation_frames_match_jax(sims, color):
    """The animation has one frame per output step (test_plot_semantics.py
    :116-120), and each frame's scatter equals the JAX package's."""
    anims = {pkg: sims[pkg].animation(color=color)
             for pkg in ("jax", "torch")}
    n = sims["torch"].result.dims["time"]
    for a in anims.values():
        assert (a._save_count or getattr(a, "save_count", None)) == n
    for ti in (0, n // 2, n - 1):
        frames = {}
        for pkg, a in anims.items():
            scat, title = a._func(ti)
            frames[pkg] = (scat.get_offsets(), scat.get_array(),
                           title.get_text())
        _close(frames["torch"][0], frames["jax"][0], exact=True)
        assert (frames["torch"][1] is None) == (frames["jax"][1] is None)
        if frames["jax"][1] is not None:
            _close(frames["torch"][1], frames["jax"][1], exact=True)
        assert frames["torch"][2] == frames["jax"][2]
    plt.close("all")


def test_animation_profile_and_gif(sims, tmp_path):
    """``animation_profile`` with a colour variable and a legend, written
    as a GIF (the radionuclide GUI's form)."""
    anims = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / f"{pkg}.gif")
        anims[pkg] = sims[pkg].animation_profile(
            filename=path, color="z", legend=["deep", "mid", "top"],
            legend_loc=3)
        assert os.path.getsize(path) > 1000
        anims[pkg] = (anims[pkg], artists(anims[pkg]._fig))
    assert_same_artists(anims["torch"][1], anims["jax"][1])
    scat, title = anims["torch"][0]._func(3)
    jscat, jtitle = anims["jax"][0]._func(3)
    _close(scat.get_offsets(), jscat.get_offsets(), exact=True)
    assert title.get_text() == jtitle.get_text()
    plt.close("all")


# -------------------------------- the other plots of the mixin and file --

@pytest.mark.parametrize("which", ["environment", "memory", "property",
                                   "property_mean", "vertical_mixin"])
def test_mixin_plots_match_jax(sims, which, saved, tmp_path):
    """``plot_environment`` (test_api_parity.py::test_plot_environment),
    ``plot_memory_usage`` (its series held by length, the host's memory
    differing), ``plot_property`` and the mixin's own
    ``plot_vertical_distribution`` (OceanDrift overrides it)."""
    from opendrift_tpu.models.plot import PlottingMixin as JMixin
    from opendrift_tpu_torch.models.plot import PlottingMixin as TMixin
    png = str(tmp_path / "p.png")
    calls = {
        "environment": lambda o, m: o.plot_environment(filename=png),
        "memory": lambda o, m: o.plot_memory_usage(filename=png),
        "property": lambda o, m: o.plot_property("lat", filename=png),
        "property_mean": lambda o, m: o.plot_property("lon", filename=png,
                                                      mean=True),
        "vertical_mixin": lambda o, m: m.plot_vertical_distribution(
            o, time_index=3, filename=png)}
    calls[which](sims["jax"], JMixin)
    calls[which](sims["torch"], TMixin)
    want, got = saved
    if which == "memory":
        assert len(got[0]["lines"][0][1]) == \
            len(sims["torch"].memory_usage) == len(want[0]["lines"][0][1])
        assert got[0]["ylabel"] == want[0]["ylabel"]
        return
    assert_same_artists(got, want)
    assert os.path.getsize(png) > 5000


def test_write_geotiff_matches_jax(sims, tmp_path):
    """test_api_parity.py:85-88: one RGBA TIFF, world file and .prj a step,
    byte-equal to the JAX package's on the same data."""
    paths = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        paths[pkg] = sims[pkg].write_geotiff(str(d / "d_%Y%m%d%H%M.tif"),
                                             pixelsize_km=1.0)
    assert len(paths["torch"]) == len(paths["jax"]) == 13
    from PIL import Image
    for a, b in zip(paths["torch"], paths["jax"]):
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
        for ext in (".tfw", ".prj"):
            assert open(a[:-4] + ext).read() == open(b[:-4] + ext).read()


def test_land_is_shaded_from_the_landmask(tmp_path):
    """A run near Lofoten with the automatic landmask: the plot's land
    contour is sampled on the model's device from the bundled raster and
    equals the JAX package's."""
    res = {}
    for pkg in ("jax", "torch"):
        M, kw = _models(pkg)
        o = M.OceanDrift(loglevel=50, **kw)
        o.set_config("environment:fallback:x_sea_water_velocity", 0.2)
        o.set_config("environment:fallback:y_sea_water_velocity", 0.0)
        o.set_config("drift:vertical_mixing", False)
        o.seed_elements(lon=np.full(5, 13.0), lat=np.linspace(68.0, 68.2, 5),
                        time=T0)
        o.run(duration=timedelta(hours=2), time_step=1800)
        fig, ax = o.plot(buffer=0.3)
        res[pkg] = artists(fig)
    plt.close("all")
    assert_same_artists(res["torch"], res["jax"])
    land = res["torch"][0]["collections"][0]
    assert land["kind"] == "QuadContourSet"
    assert sum(len(p) for p in land["paths"]) > 100


# --------------------------------------- tests/test_postprocess.py:82-127 -

@pytest.fixture(scope="module")
def gyre_runs():
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.models import OceanDrift
            from opendrift_tpu.fields import DoubleGyre
            o = OceanDrift(loglevel=40)
        else:
            from opendrift_tpu_torch.models import OceanDrift
            from opendrift_tpu_torch.fields import DoubleGyre
            o = OceanDrift(loglevel=40, device="cpu")
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:vertical_advection", False)
        dg = DoubleGyre(epsilon=0.25, omega=0.628, A=0.1)
        o.add_reader(dg)
        lon, lat = dg.xy2lonlat([0.9], [0.5])
        o.seed_elements(lon, lat, radius=0.15, number=400,
                        time=dg.initial_time, z=-np.linspace(0, 2, 400))
        o.run(duration=timedelta(seconds=10), time_step=0.25)
        out[pkg] = o
    return out


def test_gyre_plot_animation_and_property(gyre_runs, saved, tmp_path):
    """test_postprocess.py:82-95: the plot and the GIF with the land
    hidden, and a mean property, on the double gyre (the runs equal to
    float32 rounding: the slice tolerance)."""
    for pkg in ("jax", "torch"):
        o = gyre_runs[pkg]
        o.plot(filename=str(tmp_path / f"{pkg}.png"), hide_landmask=True)
        gif = tmp_path / f"{pkg}.gif"
        anim = o.animation(filename=str(gif), hide_landmask=True, fps=5)
        assert gif.stat().st_size > 10000
        assert anim._save_count == o.result.dims["time"]
        o.plot_property("lat", filename=str(tmp_path / f"{pkg}_p.png"),
                        mean=True)
    # the figures saved: JAX plot, JAX property, port plot, port property
    assert len(saved) == 4
    want, got = [saved[0], saved[1]], [saved[2], saved[3]]
    for g, w in zip(got, want):
        assert_same_artists(g, w, exact=False)
    assert (tmp_path / "torch.png").stat().st_size > 10000


def test_vertical_distribution_plots(saved, tmp_path):
    """test_postprocess.py:98-127: OceanDrift's depth histogram and its
    animation after a Sundby1983 mixing run, and Leeway's capsizing
    probability."""
    runs = {}
    for pkg in ("jax", "torch"):
        M, kw = _models(pkg)
        if pkg == "jax":
            from opendrift_tpu.fields.analytic import ConstantReader
        else:
            from opendrift_tpu_torch.fields.analytic import ConstantReader
        o = M.OceanDrift(loglevel=40, **kw)
        o.add_reader(ConstantReader({
            "x_sea_water_velocity": 0.0, "y_sea_water_velocity": 0.0,
            "land_binary_mask": 0.0,
            "sea_floor_depth_below_sea_level": 50.0}))
        o.set_config("drift:vertical_mixing", True)
        o.set_config("vertical_mixing:diffusivitymodel",
                     "windspeed_Sundby1983")
        o.set_config("environment:constant:x_wind", 10.0)
        o.set_config("environment:constant:y_wind", 0.0)
        o.seed_elements(lon=4, lat=60, z=-5.0, number=300, time=T0)
        o.run(duration=timedelta(hours=2), time_step=600)
        o.plot_vertical_distribution(filename=str(tmp_path / f"{pkg}.png"))
        anim = o.animate_vertical_distribution(
            filename=str(tmp_path / f"{pkg}.gif"), subsamplingstep=4)
        assert (tmp_path / f"{pkg}.gif").exists() and anim is None
        lw = M.Leeway(loglevel=40, **kw)
        lw.plot_capsize_probability(filename=str(tmp_path / f"{pkg}c.png"))
        runs[pkg] = o
    assert len(saved) == 4
    (jv, jc), (tv, tc) = saved[:2], saved[2:]
    # the depth ranges come from each run's deepest element: equal to the
    # metre (the floor of it), the bars within BAR_SHARE
    assert_same_artists(tv, jv, exact=True, bars_exact=False)
    assert_same_artists(tc, jc, exact=False)
    for ti in (0, 4, 8, 12):
        anims = {pkg: runs[pkg].animate_vertical_distribution(
            subsamplingstep=4) for pkg in ("jax", "torch")}
        got = {}
        for pkg, a in anims.items():
            a._func(ti)
            got[pkg] = artists(a._fig)
        assert_same_artists(got["torch"], got["jax"], bars_exact=False)
    plt.close("all")


# ------------------------------------------------------ the model plots --

def _oil_run(pkg):
    """tests/test_openoil.py:160-175's run."""
    M, kw = _models(pkg)
    if pkg == "jax":
        from opendrift_tpu.fields.analytic import ConstantReader
    else:
        from opendrift_tpu_torch.fields.analytic import ConstantReader
    o = M.OpenOil(loglevel=40, **kw)
    o.add_reader(ConstantReader({"x_sea_water_velocity": 0.1,
                                 "y_sea_water_velocity": 0.0,
                                 "x_wind": 8.0, "y_wind": 0.0,
                                 "land_binary_mask": 0.0,
                                 "sea_water_temperature": 10.0,
                                 "sea_water_salinity": 34.0}))
    o.seed_elements(4.0, 60.0, number=100, m3_per_hour=50.0,
                    time=datetime(2020, 1, 1), radius=100,
                    oil_type="GENERIC LIGHT CRUDE")
    o.run(duration=timedelta(hours=3), time_step=1800)
    return o


def test_openoil_plots_match_jax(saved, tmp_path, monkeypatch):
    """test_openoil.py:176-178 and the budget: the droplet spectrum, the
    emulsion's viscosity, density and water content, the stacked oil
    budget (the runs within the OpenOil slice tolerance)."""
    from opendrift_tpu.ops import pallas_mixing
    monkeypatch.setattr(pallas_mixing, "FORCE_INTERPRET", True)
    runs = {pkg: _oil_run(pkg) for pkg in ("jax", "torch")}
    for pkg, o in runs.items():
        o.plot_droplet_spectrum(filename=str(tmp_path / f"{pkg}s.png"))
        o.plot_oil_watercontent_and_viscosity(
            filename=str(tmp_path / f"{pkg}v.png"))
        o.plot_oil_budget(filename=str(tmp_path / f"{pkg}b.png"))
    assert len(saved) == 6
    (js, jv, jb), (ts, tv, tb) = saved[:3], saved[3:]
    # the spectrum's bins follow the extreme radii: texts and bar count
    assert [a["xlabel"] for a in ts] == [a["xlabel"] for a in js]
    assert len(ts[0]["patches"]) == len(js[0]["patches"]) == 50
    assert sum(p[3] for p in ts[0]["patches"]) == \
        sum(p[3] for p in js[0]["patches"])
    for g, w in ((tv, jv), (tb, jb)):
        for a, b in zip(g, w):
            for key in ("xlabel", "ylabel", "title", "legend"):
                assert a[key] == b[key]
            for (gx, gy, _), (wx, wy, _) in zip(a["lines"], b["lines"]):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_allclose(gy, wy, rtol=2e-2)
    # the budget's bands stack to the total, in each package
    for b, o in ((tb, runs["torch"]), (jb, runs["jax"])):
        top = b[0]["collections"][-1]["paths"][0][:, 1].max()
        total = np.asarray(o.get_oil_budget()["mass_total"]).max()
        np.testing.assert_allclose(top, total, rtol=1e-6)


def test_chemical_mass_plot_matches_jax(saved, tmp_path):
    """ChemicalDrift's stacked mass budget on the configuration of
    ``tests/test_torch_chemistry.py``'s non-dissolving case.  The JAX
    package's ``plot_mass`` raises on its result's times (ROADMAP C.9), so
    the port's bands are held to the JAX package's budget, at that file's
    ``MASS_TOL`` of the inventory."""
    from test_torch_chemistry import MASS_TOL, _chem_run
    ot = _chem_run("torch", "chemical_nondiss")
    ot.plot_mass(filename=str(tmp_path / "torch.png"))
    budget = _chem_run("jax", "chemical_nondiss").get_chemical_budget()
    (t,) = saved
    assert t[0]["legend"] == ["active", "degraded", "volatilized"]
    assert t[0]["ylabel"] == "mass [ug]"
    inventory = budget["mass_total_active"][0]
    top = np.zeros_like(np.asarray(budget["mass_total_active"], float))
    for band, key in zip(t[0]["collections"], ("mass_total_active",
                                               "mass_degraded",
                                               "mass_volatilized")):
        top = top + budget[key]
        # a band's upper edge: its highest vertex at each time
        v = band["paths"][0]
        edge = [v[v[:, 0] == x, 1].max() for x in np.unique(v[:, 0])]
        np.testing.assert_allclose(edge, top, rtol=0,
                                   atol=MASS_TOL * inventory)


def test_radionuclide_gui_plots_match_jax(tmp_path, saved):
    """test_models_wave2.py::test_radionuclide_gui_postproc: the
    concentration maps drawn from one concentration file (exact), and the
    specie-coloured profile animation with its categorical legend."""
    runs = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.models.radionuclides import RadionuclideDrift
            from opendrift_tpu.fields.analytic import ConstantReader
            kw = {}
        else:
            from opendrift_tpu_torch.models.radionuclides import \
                RadionuclideDrift
            from opendrift_tpu_torch.fields.analytic import ConstantReader
            kw = {"device": "cpu"}
        o = RadionuclideDrift(loglevel=40, **kw)
        o.add_reader(ConstantReader({
            "x_sea_water_velocity": 0.3, "y_sea_water_velocity": 0.0,
            "land_binary_mask": 0.0, "sea_water_temperature": 10.0,
            "sea_water_salinity": 34.0,
            "sea_floor_depth_below_sea_level": 20.0}))
        o.set_config("radionuclide:isotope", "137Cs")
        o.seed_elements(lon=4.0, lat=60.0, z=-2.0, number=120, time=T0)
        o.run(duration=timedelta(hours=6), time_step=1800)
        runs[pkg] = o
    conc = str(tmp_path / "conc_radio_gui.nc")
    runs["jax"].gui_postproc(filename=conc, pixelsize_m=2000.0)
    pngs = {pkg: runs[pkg].guipp_plotandsaveconc(
        conc, str(tmp_path / f"{pkg}_RadioConc"), zlayers=[0],
        specie=["Total", "LMM"]) for pkg in ("jax", "torch")}
    assert [os.path.basename(p)[len("torch"):] for p in pngs["torch"]] == \
        [os.path.basename(p)[len("jax"):] for p in pngs["jax"]]
    assert all(os.path.exists(p) for p in pngs["torch"])
    half = len(saved) // 2
    assert half == len(pngs["torch"]) > 0
    for g, w in zip(saved[half:], saved[:half]):
        assert_same_artists(g, w)
    anims = {}
    for pkg, o in runs.items():
        anims[pkg] = o.guipp_showanimationprofile(
            filename=str(tmp_path / f"{pkg}_prof.gif"), fps=4)
        assert os.path.exists(tmp_path / f"{pkg}_prof.gif")
    got, want = artists(anims["torch"]._fig), artists(anims["jax"]._fig)
    assert got[0]["legend"] == want[0]["legend"]
    assert len(got[0]["legend"]) == runs["torch"].nspecies
    for a, b in zip(got[0]["legend_colors"], want[0]["legend_colors"]):
        np.testing.assert_array_equal(a, b)
    assert got[0]["collections"][0]["clim"] == \
        want[0]["collections"][0]["clim"]
    assert anims["torch"]._save_count == anims["jax"]._save_count == \
        runs["torch"].result.dims["time"]
    plt.close("all")


def test_euler_grid_plot_matches_jax():
    """``EulerGrid.plot`` of a Gaussian blob, the field brought to the
    host."""
    from opendrift_tpu.models import eulerdrift as je
    from opendrift_tpu_torch.models import eulerdrift as te
    figs = {}
    for pkg, mod, kw in (("jax", je, {}), ("torch", te, {"device": "cpu"})):
        g = mod.EulerGrid.new(lon0=4.0, lat0=60.0, res=100.0,
                              shape=(40, 50), **kw)
        g.source_gaussian_blob(4.001, 60.001, A=2.0, N=9, sigma=300.0)
        figs[pkg] = artists(g.plot().figure)
    plt.close("all")
    assert len(figs["torch"]) == 2          # the field and its colorbar
    assert_same_artists(figs["torch"], figs["jax"])


def test_reader_plot_matches_jax(tmp_path, saved):
    """``BaseReader.plot`` of a gridded reader: its coverage outline and a
    variable sampled on the 80 x 80 grid over its extent, the port's on
    the CPU."""
    rng = np.random.default_rng(4)
    x = np.linspace(3.0, 5.0, 30)
    y = np.linspace(59.0, 60.5, 25)
    times = [T0 + timedelta(hours=h) for h in (0, 3)]
    data = {"x_sea_water_velocity":
            rng.standard_normal((2, 25, 30)).astype(np.float32)}
    from opendrift_tpu.fields import ArrayReader as JArray
    from opendrift_tpu_torch.fields import ArrayReader
    JArray(data, x, y, times).plot(variable="x_sea_water_velocity",
                                   filename=str(tmp_path / "j.png"))
    ArrayReader(data, x, y, times).plot(variable="x_sea_water_velocity",
                                        filename=str(tmp_path / "t.png"),
                                        device="cpu")
    j, t = saved
    assert t[0]["title"] == j[0]["title"]
    for g, w in zip(t, j):
        for (gx, gy, gc), (wx, wy, wc) in zip(g["lines"], w["lines"]):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        for gc, wc in zip(g["collections"], w["collections"]):
            assert (gc["array"] is None) == (wc["array"] is None)
            if gc["array"] is not None:
                np.testing.assert_allclose(gc["array"], wc["array"], rtol=0,
                                           atol=1e-6)
    assert len(t[0]["collections"]) == 1 and len(t) == 2


def test_wind_drift_factor_and_stokes_plots_match_jax():
    """``plot_wind_drift_factor`` (a polar histogram) and
    ``plot_stokes_profile`` in each of its views."""
    from opendrift_tpu.utils import trajectory as jt
    from opendrift_tpu.ops import physics as jph
    from opendrift_tpu_torch.utils import trajectory as tt
    from opendrift_tpu_torch.ops import physics as tph
    r = np.random.default_rng(8)
    wdf, az = r.uniform(0, 0.04, 500), r.uniform(-180, 180, 500)
    got = artists(tt.plot_wind_drift_factor(wdf, az, wmax_plot=0.05,
                                            show=False)[0])
    want = artists(jt.plot_wind_drift_factor(wdf, az, wmax_plot=0.05,
                                             show=False)[0])
    assert_same_artists(got, want)
    z = -np.linspace(0, 10, 20)
    profiles = [{"u": 0.1 * np.exp(z / 3), "v": 0.05 * np.exp(z / 4),
                 "z": z, "kwargs": {"label": "a"}},
                {"u": 0.2 * np.exp(z / 2), "v": 0 * z, "z": z}]
    view = ("vertical", "birdseye", "u", "v")
    got = artists(tph.plot_stokes_profile(profiles, view=view))
    want = artists(jph.plot_stokes_profile(profiles, view=view))
    assert len(got) == 4
    assert_same_artists(got, want)
    plt.close("all")


# ------------------------------------------------- without matplotlib ---

def test_every_plot_names_matplotlib_where_it_is_missing(sims, monkeypatch):
    """On a machine without matplotlib (the card machines) each plot raises
    an ImportError that names it."""
    import builtins
    from opendrift_tpu_torch.models import Leeway, eulerdrift
    from opendrift_tpu_torch.ops import physics as tph
    from opendrift_tpu_torch.utils import trajectory as tt
    o = sims["torch"]
    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)
    lw = Leeway(loglevel=40, device="cpu")
    grid = eulerdrift.EulerGrid.new(shape=(8, 8), device="cpu")
    calls = [o.plot, o.animation, lambda: o.animation_profile(),
             o.plot_environment, o.plot_memory_usage,
             lambda: o.plot_property("lon"),
             o.plot_vertical_distribution,
             o.animate_vertical_distribution,
             lambda: o.write_geotiff("x.tif"),
             lw.plot_capsize_probability, grid.plot,
             lambda: tt.plot_wind_drift_factor(np.ones(3), np.ones(3)),
             lambda: tph.plot_stokes_profile([])]
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    for call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call()
