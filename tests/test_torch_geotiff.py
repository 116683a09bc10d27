"""The satellite oil seeders of the port on the CPU, against the JAX
package: ``utils/geotiff.py`` ``read_geotiff``, ``OpenOil.
seed_from_geotiff_thickness`` and ``OpenOil.seed_from_gml``, on files
written by ``opendrift_tpu_torch/tools/synthetic_tiff.py`` and by
``_write_tiff`` of ``tests/test_api_longtail.py``; then a GeoTIFF-seeded
OpenOil run of both packages.

Tolerances.  The reader and both seeders are host numpy: held bit-equal
(the decoded raster and its affine; the seeded lon, lat, film thickness,
mass and time).  ``seed_from_gml``'s inside test is the port's
``points_in_ring`` against matplotlib's ``Path.contains_points`` in the
JAX package: the same float64 predicate, so the same points.  The run is
held to ``tests/test_torch_openoil.py``'s slice bounds (``SLICE_BOUNDS``,
``OUTLIER_SHARE``), the bounds of its OpenOil runs.
"""

from datetime import datetime, timedelta

import numpy as np
import pytest

from opendrift_tpu.utils import geotiff as jgeotiff
from opendrift_tpu.ops import pallas_mixing
from opendrift_tpu_torch.tools import synthetic_tiff
from opendrift_tpu_torch.utils import geotiff as tgeotiff
from opendrift_tpu_torch.utils.shapefile import points_in_ring
from test_api_longtail import _write_tiff
from test_torch_openoil import SLICE_BOUNDS, _assert_slice_close, _forcing

T0 = datetime(2024, 3, 1)
DETECTED = datetime(2015, 11, 16, 0, 26, 18, 770000)


def _oil(pkg, **kw):
    if pkg == "jax":
        from opendrift_tpu.models.openoil import OpenOil
        return OpenOil(loglevel=40, **kw)
    from opendrift_tpu_torch.models.openoil import OpenOil
    return OpenOil(loglevel=40, device="cpu", **kw)


def _slick(shape=(200, 160), seed=0):
    return synthetic_tiff.slick_categories(
        shape, semi_axes_px=(0.42 * shape[0], 0.38 * shape[1]), seed=seed)


# ------------------------------------------------------------ the reader --

@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("compression", ["none", "lzw", "packbits"])
def test_read_geotiff_bit_equal(tmp_path, compression, byteorder):
    """A categorical slick through each compression and byte order: the
    port's raster and affine equal the JAX package's and the data
    written."""
    cat = _slick()
    path = str(tmp_path / "slick.tif")
    synthetic_tiff.write_geotiff(path, cat, -88.3, 29.1, 0.0005, 0.00045,
                                 compression=compression, rows_per_strip=7,
                                 byteorder=byteorder)
    got, affine = tgeotiff.read_geotiff(path)
    want, jaffine = jgeotiff.read_geotiff(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cat)
    assert affine == jaffine == (-88.3, 0.0005, 29.1, -0.00045)


@pytest.mark.parametrize("dtype", ["uint16", "int16", "float32"])
def test_read_geotiff_sample_types(tmp_path, dtype):
    """Wider samples through LZW: bit-equal to the JAX package's read."""
    r = np.random.default_rng(3)
    data = (r.standard_normal((37, 53)) * 900).astype(dtype)
    data[:10] = data[0, 0]                  # runs, for the codes to grow
    path = str(tmp_path / "wide.tif")
    synthetic_tiff.write_geotiff(path, data, 4.0, 61.0, 0.01, 0.02,
                                 compression="lzw")
    got, affine = tgeotiff.read_geotiff(path)
    want, jaffine = jgeotiff.read_geotiff(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    assert got.dtype == want.dtype and affine == jaffine


def test_read_geotiff_of_the_jax_tests_writer(tmp_path):
    """tests/test_api_longtail.py:144-160's raster, written by its own
    ``_write_tiff``."""
    data = np.zeros((8, 10), np.uint8)
    data[2:5, 3:7] = 2
    data[5:7, 1:4] = 4
    path = str(tmp_path / "slick.tif")
    _write_tiff(path, data)
    got, affine = tgeotiff.read_geotiff(path)
    want, jaffine = jgeotiff.read_geotiff(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    assert affine == jaffine == (-88.0, 0.01, 29.0, -0.02)


@pytest.mark.parametrize("size", [1, 300, 5000, 200_000])
def test_lzw_and_packbits_round_trip(size):
    """The writer's LZW (past the 4093-entry table clear and through the
    code that names the entry being made) and PackBits streams decode to
    their input with the JAX package's decoders and the port's."""
    r = np.random.default_rng(size)
    runs = np.repeat(r.integers(0, 5, size), r.integers(1, 40, size))
    data = bytes(runs[:size].astype(np.uint8)) + b"a" * (size // 3)
    for enc, jdec, tdec in (
            (synthetic_tiff.lzw_encode, jgeotiff._lzw_decode,
             tgeotiff._lzw_decode),
            (synthetic_tiff.packbits_encode, jgeotiff._unpackbits,
             tgeotiff._unpackbits)):
        blob = enc(data)
        assert jdec(blob, len(data)) == tdec(blob, len(data)) == data


# ----------------------------------------------------------- the seeders --

@pytest.mark.parametrize("number", [400, 20_000])
def test_seed_from_geotiff_thickness_bit_equal(tmp_path, number):
    """The JAX tests' raster (tests/test_api_longtail.py:144-160) and a
    synthetic slick of about 50 m pixels: lon, lat, film thickness, mass
    and time of every seeding equal the JAX package's; each category's
    count is round(number x area x thickness / sum), and the masses sum to
    area x thickness x 1000 kg/m3."""
    small = np.zeros((8, 10), np.uint8)
    small[2:5, 3:7] = 2
    small[5:7, 1:4] = 4
    p_small = str(tmp_path / "small.tif")
    _write_tiff(p_small, small)
    p_slick = str(tmp_path / "slick.tif")
    dlon, dlat = synthetic_tiff.pixel_degrees(50.0, 60.0)
    synthetic_tiff.write_geotiff(p_slick, _slick(), 3.9, 59.9, dlon, dlat)
    for path in (p_small, p_slick):
        seeded = {}
        for pkg in ("jax", "torch"):
            o = _oil(pkg, seed=7)
            o.seed_from_geotiff_thickness(path, number=number, time=T0,
                                          z=0.0)
            seeded[pkg] = o._seedings
        assert len(seeded["torch"]) == len(seeded["jax"]) >= 2
        for a, b in zip(seeded["torch"], seeded["jax"]):
            for k in ("lon", "lat", "oil_film_thickness", "mass_oil",
                      "time"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        data, (lon0, dl, lat0, dla) = tgeotiff.read_geotiff(path)
        rows = lat0 + dla * (np.arange(data.shape[0]) + 0.5)
        area = (abs(dl) * 111320.0 * np.cos(np.radians(rows))[:, None]
                * abs(dla) * 110540.0)
        areas = np.array([(area * (data == c)).sum() for c in (1, 2, 3, 4)])
        thick = np.array([0.04, 0.44, 4.4, 16.0])
        counts = np.round(number * areas * thick
                          / (areas * thick).sum()).astype(int)
        got = {round(float(np.ravel(s["oil_film_thickness"])[0]) * 1e6, 6):
               len(s["lon"]) for s in seeded["torch"]}
        assert got == {float(t): int(c) for t, c in zip(thick, counts)
                       if c}
        mass = sum(float(np.sum(s["mass_oil"])) for s in seeded["torch"])
        np.testing.assert_allclose(mass, (areas * thick).sum() * 1e-3,
                                   rtol=1e-6)


def _gml(tmp_path, count=3):
    rings = synthetic_tiff.slick_polygons(4.0, 59.8, 6000.0, count=count,
                                          seed=count)
    path = str(tmp_path / f"slicks{count}.gml")
    synthetic_tiff.write_gml(path, rings, DETECTED)
    return path, rings


@pytest.mark.parametrize("count", [1, 3])
def test_seed_from_gml_bit_equal(tmp_path, count):
    """A small KSAT-style GML that the test writes (the reference's file is
    not here): the seeded points and the detection time equal the JAX
    package's, every point lies inside a slick, and the count is about
    ``num_elements``."""
    path, rings = _gml(tmp_path, count)
    seeded = {}
    for pkg in ("jax", "torch"):
        o = _oil(pkg)
        o.seed_from_gml(path, num_elements=1000, z=0.0)
        seeded[pkg] = o._seedings[-1]
        assert 800 < o.num_elements_scheduled() < 1200
    for k in ("lon", "lat", "time"):
        np.testing.assert_array_equal(seeded["torch"][k], seeded["jax"][k])
    assert seeded["torch"]["time"][0] == DETECTED
    lon, lat = seeded["torch"]["lon"], seeded["torch"]["lat"]
    inside = np.zeros(len(lon), bool)
    for rl, ra in rings:
        inside |= points_in_ring(lon, lat, np.column_stack([rl, ra]))
    assert inside.all()


def test_seed_from_gml_without_slicks_raises(tmp_path):
    path = str(tmp_path / "empty.gml")
    synthetic_tiff.write_gml(path, [], DETECTED)
    with pytest.raises(ValueError, match="No slick polygons"):
        _oil("torch").seed_from_gml(path)


# ------------------------------------------------------------- the slice --

def test_geotiff_seeded_openoil_run_matches_jax(tmp_path, monkeypatch):
    """An OpenOil run seeded from a synthetic slick west of a coast, in
    both packages: the same seeds, every status equal but for 1%, the run
    within the OpenOil slice bounds, oil stranded on the coast."""
    monkeypatch.setattr(pallas_mixing, "FORCE_INTERPRET", True)
    ocean, wind, wave, x, y, depths, times = _forcing(coast=True)
    path = str(tmp_path / "slick.tif")
    dlon, dlat = synthetic_tiff.pixel_degrees(50.0, 59.8)
    synthetic_tiff.write_geotiff(path, _slick((120, 120)), 4.05 - 60 * dlon,
                                 59.8 + 60 * dlat, dlon, dlat)
    runs = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.fields import ArrayReader
        else:
            from opendrift_tpu_torch.fields import ArrayReader
        o = _oil(pkg)
        for forcing in (ocean, wind, wave):
            o.add_reader(ArrayReader(forcing, x, y, times,
                                     depths=depths if forcing is ocean
                                     else None))
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("vertical_mixing:diffusivitymodel",
                     "windspeed_Large1994")
        o.seed_from_geotiff_thickness(path, number=256, time=times[0],
                                      oil_type="GENERIC MEDIUM CRUDE", z=0.0)
        o.run(duration=timedelta(hours=4), time_step=900,
              time_step_output=3600)
        runs[pkg] = o
    oj, ot = runs["jax"], runs["torch"]
    st = np.asarray(ot.result["status"].values)
    sj = np.asarray(oj.result["status"].values)
    assert st.shape == sj.shape and st.shape[1] == 5
    assert np.mean(st != sj) <= 0.01
    assert (st[:, -1] == ot.status_categories.index("stranded")).any()
    for var in ("lon", "lat", "z", "mass_oil", "mass_evaporated",
                "mass_dispersed", "water_fraction"):
        assert var in SLICE_BOUNDS
        _assert_slice_close(ot.result[var].values, oj.result[var].values, var)
