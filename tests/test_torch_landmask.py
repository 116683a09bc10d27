"""The port's coastline landmask and polygon seeding against the JAX
package: ``GlobalLandmask``, ``ShapeReader`` and ``utils/shapefile.py``,
the automatic landmask's decisions, every polygon seeder, the
``arctic20_stranding`` golden and the coast path of ``chip_smoke.py`` at a
small size.

Tolerances: the raster lookups and the seeders are the same float32
(device) or float64 (host) arithmetic and the same numpy draws, so they
must be equal.  The JAX package divides by the raster's step in float32
when called eagerly, as here; inside a jitted step XLA may multiply by the
reciprocal instead, which moves a few exact half-cell positions to the
other cell (2-3 of 25,000), so the whole-slice run below is held to the
slice tolerance of ``chip_smoke.py`` with every status equal.
"""

import os
import struct
import sys
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu.fields.landmask import GlobalLandmask as JLandmask
from opendrift_tpu.fields.shape import ShapeReader as JShapeReader
from opendrift_tpu.utils import shapefile as jshapefile
from opendrift_tpu_torch.fields import GlobalLandmask, ShapeReader
from opendrift_tpu_torch.utils import shapefile as tshapefile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import parity_compare  # noqa: E402

T0 = datetime(2024, 3, 1)


def _points(lm, n=100_000, seed=0):
    """n float32 positions over the raster and beyond it; a quarter at
    exact half-cell positions (the round-half-to-even ties) and a few at
    whole cells and on the raster's edges."""
    r = np.random.default_rng(seed)
    lon = r.uniform(lm._lon0 - 2, lm._lon0 + 66, n).astype(np.float32)
    lat = r.uniform(lm._lat0 - 2, lm._lat0 + 122, n).astype(np.float32)
    k = n // 4
    ix = r.integers(-5, lm._mask.shape[1] + 5, k)
    iy = r.integers(-5, lm._mask.shape[0] + 5, k)
    lon[:k] = np.float32(lm._lon0) + (ix + 0.5) * np.float32(lm._dlon)
    lat[:k] = np.float32(lm._lat0) + (iy + 0.5) * np.float32(lm._dlat)
    lon[k:2 * k] = np.float32(lm._lon0) + ix * np.float32(lm._dlon)
    lat[k:2 * k] = np.float32(lm._lat0) + iy * np.float32(lm._dlat)
    lon[-4:] = [lm._lon0, lm._lon0 - 1e-3, np.nan, 400.0]
    lat[-4:] = [lm._lat0, lm._lat0, 60.0, np.inf]
    return lon, lat


def _sample_both(j, t, lon, lat):
    jv, jc = j.sample(j.device_state(), ["land_binary_mask"], 0.0,
                      jnp.asarray(lon), jnp.asarray(lat), None)
    t.device = "cpu"
    tv, tc = t.sample(t.device_state(), ["land_binary_mask"], 0.0,
                      torch.as_tensor(lon), torch.as_tensor(lat), None)
    return (np.asarray(jv["land_binary_mask"]), np.asarray(jc),
            tv["land_binary_mask"].numpy(), tc.numpy())


def test_global_landmask_matches_jax():
    j, t = JLandmask(), GlobalLandmask()
    np.testing.assert_array_equal(t._mask, j._mask)
    np.testing.assert_array_equal(t._covered, j._covered)
    lon, lat = _points(t)
    jv, jc, tv, tc = _sample_both(j, t, lon, lat)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    assert 0.05 < tc.mean() < 0.5 and 0 < tv[tc].mean() < 1
    np.testing.assert_array_equal(t.covers_positions(lon, lat),
                                  j.covers_positions(lon, lat))
    np.testing.assert_array_equal(t.contains(lon, lat), j.contains(lon, lat))


def test_landmask_device_state_is_built_once():
    """The raster goes to the device once; each window gets the same
    tensors, and the environment's copy passes them through."""
    from opendrift_tpu_torch.interop import device_state_from_numpy
    lm = GlobalLandmask()
    lm.device = torch.device("cpu")
    a = lm.device_state()
    b = lm.device_state(T0, T0 + timedelta(hours=3))
    assert a is b and a["mask"].dtype == torch.float32 \
        and a["covered"].dtype == torch.bool
    c = device_state_from_numpy(b, torch.device("cpu"))
    assert all(c[k] is b[k] for k in b)


def test_landmask_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GlobalLandmask().device_state()


# ------------------------------------------------------- shapefiles -------

def _write_shp(path, rings):
    """A Polygon shapefile of one record holding ``rings`` (the .shx and
    .dbf are not read)."""
    pts = np.vstack(rings)
    parts = np.cumsum([0] + [len(r) for r in rings[:-1]])
    content = struct.pack("<i", 5) + struct.pack("<4d", *pts.min(0),
                                                 *pts.max(0))
    content += struct.pack("<ii", len(rings), len(pts))
    content += struct.pack(f"<{len(rings)}i", *parts)
    content += pts.astype("<f8").tobytes()
    rec = struct.pack(">ii", 1, len(content) // 2) + content
    header = struct.pack(">i", 9994) + b"\0" * 20 \
        + struct.pack(">i", (100 + len(rec)) // 2) \
        + struct.pack("<ii", 1000, 5) \
        + struct.pack("<4d", *pts.min(0), *pts.max(0)) + b"\0" * 32
    with open(path, "wb") as f:
        f.write(header + rec)


RING = np.array([[14.0, 67.5], [15.2, 67.55], [15.4, 68.3], [14.2, 68.4],
                 [13.8, 67.9], [14.0, 67.5]])
HOLE = np.array([[14.4, 67.8], [14.6, 68.0], [14.9, 67.9], [14.4, 67.8]])
GEOGCS = ('GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID['
          '"WGS_1984",6378137.0,298.257223563]],PRIMEM["Greenwich",0.0],'
          'UNIT["Degree",0.0174532925199433]]')
PROJCS = ('PROJCS["WGS_1984_UTM_Zone_33N",' + GEOGCS
          + ',PROJECTION["Transverse_Mercator"],PARAMETER["False_Easting",'
          '500000.0],PARAMETER["Central_Meridian",15.0],UNIT["Meter",1.0]]')


@pytest.fixture
def shp(tmp_path):
    path = str(tmp_path / "coast.shp")
    _write_shp(path, [RING, HOLE])
    (tmp_path / "coast.prj").write_text(GEOGCS)
    return path


def test_shapefile_parsing_matches_jax(shp):
    got = tshapefile.shapefile_polygons(shp)
    want = jshapefile.shapefile_polygons(shp)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lons = np.linspace(13.7, 15.5, 91)
    lats = np.linspace(67.4, 68.5, 57)
    m = tshapefile.rasterize_polygons(got, lons, lats)
    np.testing.assert_array_equal(
        m, jshapefile.rasterize_polygons(want, lons, lats))
    assert m.any() and not m.all()
    # the hole is water
    assert not tshapefile.rasterize_polygons(got, [14.6], [67.92])[0, 0]


def test_shape_reader_matches_jax(shp):
    j = JShapeReader(shp, resolution_deg=0.01)
    t = ShapeReader(shp, resolution_deg=0.01)
    np.testing.assert_array_equal(t._mask, j._mask)
    r = np.random.default_rng(4)
    lon = r.uniform(13.5, 15.7, 20_000).astype(np.float32)
    lat = r.uniform(67.3, 68.6, 20_000).astype(np.float32)
    jv, jc, tv, tc = _sample_both(j, t, lon, lat)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(t.contains(lon, lat), j.contains(lon, lat))


def test_global_landmask_dispatches_to_a_shapefile(shp, monkeypatch):
    lm = GlobalLandmask(shapefile=shp, resolution_deg=0.02)
    assert isinstance(lm, ShapeReader) and lm.name == "global_landmask"
    monkeypatch.setenv("OPENDRIFT_LANDMASK_SHP", shp)
    assert isinstance(GlobalLandmask(resolution_deg=0.02), ShapeReader)
    with pytest.raises(FileNotFoundError):
        GlobalLandmask(shapefile=shp + ".missing")


def test_projected_prj_names_its_queue(shp):
    """A .prj that declares a projection: the rings are inverse-projected
    through ``from_esri_wkt`` (ported with ROADMAP A.9) as the JAX package
    does it, to 1e-9 degrees (float64 on both sides)."""
    with open(os.path.splitext(shp)[0] + ".prj", "w") as f:
        f.write(PROJCS)
    got = tshapefile.shapefile_polygons(shp)
    want = jshapefile.shapefile_polygons(shp)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
        assert not np.allclose(g, RING if len(g) == len(RING) else HOLE)
    # without the conversion the rings are read as they are
    raw = tshapefile.shapefile_polygons(shp, to_lonlat=False)
    np.testing.assert_array_equal(raw[0], RING)


def test_points_in_ring_matches_matplotlib():
    """10^5 points a ring, a tenth of them on a lattice through the
    vertices and along the edges: equal everywhere, edges included."""
    from matplotlib.path import Path
    r = np.random.default_rng(5)
    for i in range(6):
        n = int(r.integers(3, 40))
        ang = np.sort(r.uniform(0, 2 * np.pi, n))
        ring = np.column_stack([np.cos(ang), np.sin(ang)]) \
            * r.uniform(0.3, 1.0, n)[:, None]
        if i % 2:
            ring = r.uniform(-1, 1, (n, 2))      # self-intersecting
        if i % 3 == 0:
            ring = np.round(ring * 8) / 8
        pts = r.uniform(-1.1, 1.1, (100_000, 2))
        pts[:10_000] = np.round(pts[:10_000] * 8) / 8
        pts[10_000:10_000 + n] = ring
        want = Path(ring).contains_points(pts)
        got = tshapefile.points_in_ring(pts[:, 0], pts[:, 1], ring)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1


# ------------------------------------------------------------ seeders -----

def _models():
    from opendrift_tpu.models import OceanDrift as J
    from opendrift_tpu_torch.models import OceanDrift as T
    return J(loglevel=40, seed=3), T(loglevel=40, seed=3, device="cpu")


def _assert_same_seedings(oj, ot):
    assert len(oj._seedings) == len(ot._seedings) > 0
    for sj, st in zip(oj._seedings, ot._seedings):
        assert set(sj) == set(st)
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


WKT_POLY = "POLYGON ((12.3 67.8, 12.85 67.8, 12.85 68.0, 12.3 68.0, 12.3 67.8))"
WKT_MULTI = ("MULTIPOLYGON (((4 60, 4.5 60, 4.5 60.3, 4 60)), "
             "((5 61, 5.4 61.1, 5.1 61.4, 5 61)))")
GEOJSON = {"type": "FeatureCollection", "features": [
    {"type": "Feature", "properties": {"time": "2024-03-01T06:00:00Z"},
     "geometry": {"type": "Polygon", "coordinates": [
         [[4.0, 60.0], [4.6, 60.1], [4.3, 60.5], [4.0, 60.0]]]}},
    {"type": "Feature", "properties": {"z": -5.0},
     "geometry": {"type": "Point", "coordinates": [4.2, 60.2]}},
    {"type": "Feature", "properties": {},
     "geometry": {"type": "LineString",
                  "coordinates": [[4.0, 60.0], [4.4, 60.3]]}}]}


@pytest.mark.parametrize("seeder", [
    "within_polygon", "wkt_polygon", "wkt_multipolygon", "wkt_point",
    "geojson", "shapefile", "repeated_segment", "letters"])
def test_polygon_seeders_match_jax(seeder, shp):
    oj, ot = _models()
    for o in (oj, ot):
        if seeder == "within_polygon":
            o.seed_within_polygon(RING[:, 0], RING[:, 1], number=5000,
                                  time=T0, z=-2.0)
        elif seeder == "wkt_polygon":
            o.seed_from_wkt(WKT_POLY, time=T0, number=3000)
        elif seeder == "wkt_multipolygon":
            o.seed_from_wkt(WKT_MULTI, time=[T0, T0 + timedelta(hours=2)],
                            number=700)
        elif seeder == "wkt_point":
            o.seed_from_wkt("POINT (4.5 60.2)", time=T0, number=9,
                            radius=500)
        elif seeder == "geojson":
            o.seed_from_geojson(GEOJSON, time=T0, number=400)
        elif seeder == "shapefile":
            o.seed_from_shapefile(shp, number=2500, time=T0)
        elif seeder == "repeated_segment":
            o.seed_repeated_segment([4.0, 4.5], [60.0, 60.3], T0,
                                    end_time=T0 + timedelta(hours=3),
                                    time_interval=timedelta(hours=1),
                                    number_per_segment=50)
        else:
            o.seed_letters("OD", 4.0, 60.0, T0, number=300)
    _assert_same_seedings(oj, ot)
    assert oj.num_elements_scheduled_total == ot.num_elements_scheduled_total


def test_points_within_polygon_matches_jax():
    oj, ot = _models()
    r = np.random.default_rng(6)
    lon, lat = r.uniform(13.5, 15.7, 100_000), r.uniform(67.3, 68.6, 100_000)
    want = oj.points_within_polygon(lon, lat, RING[:, 0], RING[:, 1])
    got = ot.points_within_polygon(lon, lat, RING[:, 0], RING[:, 1])
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_seed_letters_names_matplotlib(monkeypatch):
    _, ot = _models()
    monkeypatch.setitem(sys.modules, "matplotlib.textpath", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ot.seed_letters("A", 4.0, 60.0, T0, number=10)


def test_seeding_outside_a_polygon_raises():
    _, ot = _models()
    with pytest.raises(ValueError, match="projected"):
        ot.seed_within_polygon([1e5, 2e5, 2e5], [1e6, 1e6, 2e6],
                               number=3, time=T0)


# ----------------------------------------------- the automatic landmask ---

def _auto_case(pkg, case):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        o = OceanDrift(loglevel=40, device="cpu")
    o.set_config("environment:fallback:x_sea_water_velocity", 0.2)
    if case == "uncovered":
        lon, lat = 3.0, 59.5     # outside the raster's coverage
    else:
        lon, lat = 12.5, 67.9
    if case == "none":
        o.set_config("general:coastline_action", "none")
        lon, lat = 3.0, 59.5
    if case == "disabled":
        o.set_config("general:use_auto_landmask", False)
    o.seed_elements(lon=lon, lat=lat, number=5, time=T0)
    try:
        o.prepare_run(900.0, 2, total_steps=2)
    except ValueError as e:
        return o, str(e)
    return o, None


@pytest.mark.parametrize("case", ["covered", "uncovered", "none",
                                  "disabled"])
def test_auto_landmask_decisions_match_jax(case):
    oj, ej = _auto_case("jax", case)
    ot, et = _auto_case("torch", case)
    assert et == ej
    names = [r.name for r, _ in ot.env._plan]
    assert names == [r.name for r, _ in oj.env._plan]
    assert ot.env.fallback_values.get("land_binary_mask") \
        == oj.env.fallback_values.get("land_binary_mask")
    if case == "covered":
        assert names[-1] == "global_landmask" and et is None
        assert ot.env.has_reader_for("land_binary_mask")
    elif case == "none":
        assert et is None
        assert ot.env.fallback_values["land_binary_mask"] == 0.0
    else:
        reason = ("does not cover" if case == "uncovered"
                  else "use_auto_landmask is False")
        assert reason in et and "stranding" in et


# ------------------------------------------------------------- goldens ----

def test_arctic20_stranding_golden():
    """The reference OpenDrift's stranding trajectories on the bundled
    coastline, through the port, at the bounds of
    tests/test_reference_trajectory_parity.py."""
    from test_reference_trajectory_parity import TOLERANCES
    from opendrift_tpu_torch.models import OceanDrift
    golden, cfg = parity_compare.load_golden("arctic20_stranding")
    o = OceanDrift(loglevel=40, device="cpu")
    o.set_config("environment:fallback:x_sea_water_velocity", cfg["u"])
    o.set_config("environment:fallback:y_sea_water_velocity", cfg["v"])
    o.set_config("drift:advection_scheme", "euler")
    o.set_config("drift:vertical_mixing", False)
    o.set_config("drift:vertical_advection", False)
    o.set_config("general:coastline_action", "stranding")
    o.set_config("general:use_auto_landmask", False)
    o.add_reader(GlobalLandmask())
    o.seed_elements(lon=np.asarray(cfg["seed_lon"]),
                    lat=np.asarray(cfg["seed_lat"]),
                    time=datetime(2021, 3, 1))
    o.run(duration=timedelta(seconds=cfg["duration_s"]),
          time_step=cfg["time_step"])
    stats = parity_compare.compare("arctic20_stranding", o, golden)
    max_tol, final_tol = TOLERANCES["arctic20_stranding"]
    assert stats["shape_ref"] == stats["shape_our"]
    assert stats["finite_mismatch"] == 0, stats
    assert stats["max_m"] < max_tol, stats
    assert stats["final_mean_m"] < final_tol, stats
    stranded = o.status_categories.index("stranded")
    assert (o.result["status"].values[:, -1] == stranded).any()


# ---------------------------------------------------------- the slice -----

def _coast_run(pkg, n=4096, intervals=2):
    """chip_smoke.coast_simulation's set-up on the 60 x 60 grid, through
    either package."""
    if pkg == "torch":
        o = chip_smoke.coast_simulation("cpu", n, forcing_kw=dict(nx=60,
                                                                   ny=60))
    else:
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields.grid import ArrayReader
        current, wind, x, y, depths, times = chip_smoke.coast_forcing(
            nx=60, ny=60)
        o = OceanDrift(loglevel=40, seed=0)
        o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                                 name="ocean"))
        o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:vertical_mixing", True)
        o.set_config("vertical_mixing:diffusivitymodel",
                     "windspeed_Large1994")
        o.set_config("vertical_mixing:timestep", 60.0)
        o.set_config("drift:horizontal_diffusivity", 10.0)
        r = np.random.default_rng(1)
        o.seed_from_wkt(chip_smoke.COAST_WKT, time=times[0], number=n,
                        z=-r.uniform(0.0, 20.0, n))
    o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
          time_step_output=9000)
    return o


def test_coast_slice_matches_jax():
    """A default OceanDrift run on the coast path's ocean (NaN currents on
    land through the native fill, the automatic landmask, stranding,
    RK4, Visser mixing, horizontal diffusion): every status equal, lon,
    lat and z within the slice tolerance."""
    oj, ot = _coast_run("jax"), _coast_run("torch")
    assert [r.name for r, _ in ot.env._plan] \
        == [r.name for r, _ in oj.env._plan] \
        == ["ocean", "wind", "global_landmask"]
    status = ot.result["status"].values
    np.testing.assert_array_equal(status, np.asarray(
        oj.result["status"].values))
    stranded = (status[:, -1] == ot.status_categories.index("stranded"))
    assert 0.05 < stranded.mean() < 0.95
    for var in ("lon", "lat", "z"):
        err, ok = chip_smoke.agree(
            ot.result[var].values, oj.result[var].values,
            chip_smoke.SLICE_MEDIAN_ATOL[var],
            chip_smoke.SLICE_OUTLIER_ATOL[var],
            chip_smoke.SLICE_OUTLIER_SHARE)
        assert ok, (var, err)
    chip_smoke.check_coast_result(ot, 4096, 3)
