"""The port's GRIB parsers and ``GribReader`` against the JAX package's, on
files written by the port's own writer (``opendrift_tpu_torch/tools/
synthetic_grib.py``) from seeded numpy fields.

Tolerances: the parsers are host numpy copies, so every header field and
every decoded value must be equal (NaN where NaN); packed tables are
bit-equal; reader samples are the same float32 expressions on the CPU and
must agree within ``EXACT_ATOL`` (measured equal).  The writer's own
quantisation is held to the packing's step (``10**-D * 2**E / 2``).
"""

import builtins
from datetime import datetime, timedelta

import numpy as np
import pytest

import torch_nc_fixtures as F

from opendrift_tpu.fields.grib import GribReader as JGribReader
from opendrift_tpu.utils import grib1 as jgrib1
from opendrift_tpu.utils import grib2 as jgrib2
from opendrift_tpu_torch.fields.grib import GribReader
from opendrift_tpu_torch.tools import synthetic_grib as SG
from opendrift_tpu_torch.utils import grib1, grib2

EXACT_ATOL = 1e-6
T0 = datetime(2024, 3, 1, 6)

GRIB1_FIELDS = ("table_version", "centre", "parameter", "level_type",
                "level", "ref_time", "lead_seconds", "valid_time", "D",
                "standard_name", "parameter_key", "grid_template", "shape",
                "proj4", "scan_neg_j", "E", "R", "nbits",
                "packing_template", "offset")
GRIB2_FIELDS = ("centre", "ref_time", "n_points", "grid_template", "shape",
                "proj4", "scan_neg_j", "discipline", "product_template",
                "parameter_category", "parameter_number", "lead_seconds",
                "valid_time", "level_type", "level", "standard_name",
                "parameter_key", "n_values", "packing_template", "R", "E",
                "D", "nbits", "offset")


def _field(shape, seed):
    return np.random.default_rng(seed).uniform(-9.0, 9.0, shape)


def _assert_same_messages(port, jax_, fields):
    assert len(port) == len(jax_) > 0
    for p, j in zip(port, jax_):
        for name in fields:
            assert getattr(p, name) == getattr(j, name), name
        np.testing.assert_array_equal(p.x, j.x)
        np.testing.assert_array_equal(p.y, j.y)
        a, b = p.values(), j.values()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


GRIB1_CASES = {
    "latlon_n_to_s": dict(grid=("latlon", 70.0, 0.0, 60.0, 14.5)),
    "latlon_s_to_n": dict(grid=("latlon", 60.0, 0.0, 70.0, 14.5),
                          scan_neg_j=False),
    "latlon_bitmap": dict(grid=("latlon", 70.0, -8.0, 60.0, 6.5),
                          mask=True),
    "stere_bitmap": dict(grid=("stere", 60.0, 0.0, 58.0, 20000, 20000,
                               False), scan_neg_j=False, mask=True),
    "stere_n_to_s": dict(grid=("stere", 72.0, 5.0, 58.0, 20000, 20000,
                               False)),
    "stere_south": dict(grid=("stere", -60.0, 10.0, 0.0, 25000, 25000,
                              True), scan_neg_j=False),
}


@pytest.mark.parametrize("case", sorted(GRIB1_CASES))
def test_grib1_messages_equal_jax(case, tmp_path):
    """Edition 1: every header field and every value equal the JAX
    parser's, for lat-lon and polar stereographic grids, either scan
    direction, with and without a bitmap."""
    kw = dict(GRIB1_CASES[case])
    f = _field((6, 8), seed=len(case))
    if kw.pop("mask", False):
        kw["mask"] = np.random.default_rng(1).uniform(size=f.shape) > 0.25
    msgs = [SG.grib1_message(f + k, param=param, ref_time=T0, p1=k, **kw)
            for k in (0, 6) for param in (33, 34)]
    path = str(tmp_path / "m.grib1")
    with open(path, "wb") as fh:
        fh.write(b"".join(msgs))
    port, jax_ = grib1.Grib1File(path), jgrib1.Grib1File(path)
    _assert_same_messages(port.messages, jax_.messages, GRIB1_FIELDS)
    m = port.messages[0]
    step = 10.0 ** -m.D * 2.0 ** m.E
    got = m.values() if not m.scan_neg_j else m.values()[::-1]
    want = np.where(kw["mask"], f, np.nan) if "mask" in kw else f
    np.testing.assert_allclose(got, want, rtol=0, atol=step / 2 + 1e-5)


@pytest.mark.parametrize("unit,p1,p2,tri", [
    (1, 12, 0, 0), (1, 0, 0, 1), (1, 0, 6, 4), (2, 3, 0, 0),
    (1, 1, 44, 10), (0, 30, 0, 113), (254, 90, 0, 0), (11, 0, 2, 3)])
def test_grib1_time_range_indicators_equal_jax(unit, p1, p2, tri):
    """Edition 1's time units and time-range indicators: the valid time
    equals the JAX parser's."""
    msg = SG.grib1_message(np.ones((4, 5)) * 3.0,
                           ("latlon", 70.0, 0.0, 60.0, 10.0), param=11,
                           ref_time=T0, unit=unit, p1=p1, p2=p2, tri=tri)
    p, j = grib1.Grib1Message("x", msg, 0), jgrib1.Grib1Message("x", msg, 0)
    assert p.valid_time == j.valid_time and p.lead_seconds == j.lead_seconds


def test_grib1_unsupported_indicator_raises_in_both():
    msg = SG.grib1_message(np.ones((4, 5)), ("latlon", 70.0, 0.0, 60.0,
                                             10.0), param=11, ref_time=T0,
                           tri=51)
    for mod in (grib1, jgrib1):
        with pytest.raises(NotImplementedError, match="time-range"):
            mod.Grib1Message("x", msg, 0)


GRIB2_GRIDS = {
    "latlon": ("latlon", 60.0, 2.0, 66.0, 10.0),
    "latlon_east_of_180": ("latlon", 60.0, 350.0, 66.0, 10.0),
    "stere": ("stere", 60.0, -10.0, 60.0, 0.0, 20000.0, 20000.0, False),
    "lcc": ("lcc", 60.0, -10.0, 63.0, 0.0, 2500.0, 2500.0, 63.0, 63.0),
}


@pytest.mark.parametrize("grid", sorted(GRIB2_GRIDS))
@pytest.mark.parametrize("scan_neg_j", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_grib2_messages_equal_jax(grid, scan_neg_j, mask, tmp_path):
    """Edition 2, simple packing: grid templates 3.0, 3.20 and 3.30 (a
    first longitude above 180 on 3.0), either scan direction, with and
    without a bitmap; every header field and value equals the JAX
    parser's."""
    f = _field((7, 9), seed=3)
    m = np.random.default_rng(2).uniform(size=f.shape) > 0.2 if mask \
        else None
    msgs = [SG.grib2_message(f * s, GRIB2_GRIDS[grid], key, T0,
                             lead_hours=k, scan_neg_j=scan_neg_j, mask=m)
            for k, s in ((0, 1.0), (3, -0.5))
            for key in ((0, 2, 2), (0, 2, 3), (10, 1, 2), (0, 9, 9))]
    path = str(tmp_path / "m.grib2")
    with open(path, "wb") as fh:
        fh.write(b"".join(msgs))
    port, jax_ = grib2.Grib2File(path), jgrib2.Grib2File(path)
    _assert_same_messages(port.messages, jax_.messages, GRIB2_FIELDS)
    first = port.messages[0]
    step = 10.0 ** -first.D * 2.0 ** first.E
    got = first.values()[::-1] if scan_neg_j else first.values()
    want = np.where(m, f, np.nan) if mask else f
    np.testing.assert_allclose(got, want, rtol=0, atol=step / 2 + 1e-5)


def _has_openjpeg():
    try:
        from PIL import features
    except ImportError:
        return False
    return bool(features.check("jpg_2000"))


@pytest.mark.parametrize("mask", [False, True])
def test_grib2_jpeg2000_equals_jax(mask, tmp_path):
    """Template 5.40 decoded through Pillow equals the JAX parser's (the
    test needs a Pillow with OpenJPEG to write the file)."""
    if not _has_openjpeg():
        pytest.skip("Pillow with OpenJPEG is not installed")
    f = _field((10, 12), seed=4)
    m = np.random.default_rng(3).uniform(size=f.shape) > 0.3 if mask \
        else None
    path = str(tmp_path / "j2k.grib2")
    with open(path, "wb") as fh:
        fh.write(SG.grib2_message(f, GRIB2_GRIDS["stere"], (0, 3, 5), T0,
                                  mask=m, jpeg2000=True))
    port, jax_ = grib2.Grib2File(path), jgrib2.Grib2File(path)
    assert port.messages[0].packing_template == 40
    _assert_same_messages(port.messages, jax_.messages, GRIB2_FIELDS)


def test_jpeg2000_without_pillow_names_it(tmp_path, monkeypatch):
    """The card machine has no Pillow: a JPEG2000 message raises an
    ImportError that names it, and simple packing still decodes."""
    if not _has_openjpeg():
        pytest.skip("Pillow with OpenJPEG is not installed")
    f = _field((5, 6), seed=5)
    j2k = str(tmp_path / "j2k.grib2")
    simple = str(tmp_path / "simple.grib2")
    with open(j2k, "wb") as fh:
        fh.write(SG.grib2_message(f, GRIB2_GRIDS["latlon"], (0, 2, 2), T0,
                                  jpeg2000=True))
    with open(simple, "wb") as fh:
        fh.write(SG.grib2_message(f, GRIB2_GRIDS["latlon"], (0, 2, 2), T0))
    real = builtins.__import__

    def no_pillow(name, *args, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("No module named 'PIL'")
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pillow)
    with pytest.raises(ImportError, match="Pillow"):
        grib2.Grib2File(j2k).messages[0].values()
    assert np.isfinite(grib2.Grib2File(simple).messages[0].values()).all()


def _reader_pair(path, **kw):
    return JGribReader(path, **kw), GribReader(path, **kw)


def _assert_readers_agree(j, t, lon, lat, interval=3 * 3600.0):
    assert t.variables == j.variables and t.times == j.times
    assert t.proj4 == j.proj4
    np.testing.assert_array_equal(t.x, j.x)
    np.testing.assert_array_equal(t.y, j.y)
    jstate, host, tstate = F.prepare_pair(j, t, interval_seconds=interval)
    F.assert_tables_equal(host, jstate)
    names = [v for v in t.variables if v not in t._derived]
    z = np.zeros_like(lon)
    for trel in (0.0, 1234.0, interval):
        jv, jc, tv, tc = F.sample_pair(j, t, jstate, tstate, names, trel,
                                       lon, lat, z)
        np.testing.assert_array_equal(tc, jc)
        assert tc.mean() > 0.5
        for v in names:
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=0,
                                       atol=EXACT_ATOL)


def test_grib_reader_matches_jax_east_of_180(tmp_path):
    """A lat-lon file whose first longitude is 350 (stored 0-360, running
    past 360): the reader's x axis, its packed table and its samples at
    longitudes on both sides of 0 equal the JAX reader's."""
    grid = GRIB2_GRIDS["latlon_east_of_180"]
    msgs = [SG.grib2_message(_field((13, 21), seed=k) + k, grid, key, T0,
                             lead_hours=3 * k)
            for k in range(3) for key in ((0, 2, 2), (0, 2, 3))]
    path = str(tmp_path / "wrap.grib2")
    with open(path, "wb") as fh:
        fh.write(b"".join(msgs))
    j, t = _reader_pair(path)
    assert t.x[0] == 350.0 and t.x[-1] == 370.0
    r = np.random.default_rng(6)
    lon = r.uniform(-12.0, 12.0, 400)
    lat = r.uniform(59.5, 66.5, 400)
    _assert_readers_agree(j, t, lon, lat)


def test_grib_reader_matches_jax_on_mixed_editions(tmp_path):
    """A file holding GRIB1 and GRIB2 messages on one lat-lon grid, with a
    variable mapped by ``variable_map``."""
    grid2 = grid1 = ("latlon", 60.0, 0.0, 65.5, 6.5)
    f = _field((12, 14), seed=7)
    msgs = [SG.grib2_message(f + k, grid2, (0, 2, 2), T0, lead_hours=k)
            for k in (0, 1, 2)]
    msgs += [SG.grib1_message(-f + k, grid1, param=34, ref_time=T0, p1=k,
                              scan_neg_j=False) for k in (0, 1, 2)]
    msgs += [SG.grib2_message(f * 0.1, grid2, (0, 19, 1), T0, lead_hours=k)
             for k in (0, 1, 2)]
    path = str(tmp_path / "mixed.grib")
    with open(path, "wb") as fh:
        fh.write(b"".join(msgs))
    vmap = {(0, 19, 1): "sea_ice_area_fraction"}
    j, t = _reader_pair(path, variable_map=vmap)
    assert {"sea_ice_area_fraction", "x_wind", "y_wind"} <= set(t.variables)
    r = np.random.default_rng(8)
    _assert_readers_agree(j, t, r.uniform(0.0, 6.5, 300),
                          r.uniform(60.0, 65.5, 300), interval=3600.0)


def test_ecmwf_wind_file_reads_as_the_jax_package_reads_it(tmp_path):
    """The smoke run's wind file: 0.1 degrees over 8-20 E, 65-71 N, rows
    north to south, u and v at 16 bits, hourly; the reader agrees with the
    JAX reader (both mirror a north-to-south lat-lon GRIB2 grid north to
    south, ROADMAP C.5)."""
    path = SG.write_ecmwf_wind(str(tmp_path / "ecmwf.grib2"), nt=3)
    m = grib2.Grib2File(path).messages[0]
    assert m.scan_neg_j and m.y[0] == 71.0
    j, t = _reader_pair(path)
    assert set(t.variables) == {"x_wind", "y_wind", "wind_speed"}
    assert (len(t.x), len(t.y)) == (121, 61) and len(t.times) == 3
    assert t.times[1] - t.times[0] == timedelta(hours=1)
    r = np.random.default_rng(9)
    _assert_readers_agree(j, t, r.uniform(8.0, 20.0, 500),
                          r.uniform(65.0, 71.0, 500), interval=3600.0)
