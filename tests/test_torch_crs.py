"""The port's projections (``opendrift_tpu_torch/utils/crs.py``) against the
JAX package's on the same seeded points.

Tolerances:

* float64 on the host (numpy on both sides, the same formulas): ``fwd``,
  ``inv`` and ``convergence`` equal bit for bit, which is stricter than the
  1e-9 degrees asked of them.
* float32 on the device (torch on the CPU against jax.numpy on the CPU):
  the libraries' ``sin``/``atan2``/``log``/``pow`` differ by an ulp, and
  the projections' intermediate values (up to 3e6-9e6 m) carry float32
  ulps of 0.25-1 m.  ``fwd`` may differ by ``INDEX_ATOL[case]`` in
  grid-index units of the case's cell: twice the largest difference
  measured on these points, 1e-3 to 8e-3 of a cell of 800 m or more and
  3e-2/4e-2 of a 100 m UTM/tmerc cell.  The JAX package's own float32
  ``fwd`` is as far from float64 (measured: 5e-5 to 2e-2 cells).
  Analytic convergences (stere, lcc, merc) within ``GAMMA_ATOL`` radians.
  The numeric convergence (tmerc/utm, ob_tran: a 1e-4 degree finite
  difference of float32 coordinates) cancels most of its digits in float32
  in both packages; the port's error against the float64 value may be at
  most ``NUMERIC_GAMMA_FACTOR`` times the JAX package's own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opendrift_tpu.utils import crs as J
from opendrift_tpu_torch.utils import crs as T
from opendrift_tpu_torch.utils.xp import tnp

N = 10_000
INDEX_ATOL = {"stere_norkyst": 2e-3, "merc": 2e-3, "merc_sphere": 8e-3,
              "lcc_arome": 1e-3, "lcc_two_parallels": 2e-3, "utm33": 4e-2,
              "utm33_south": 4e-2, "tmerc": 3e-2, "ob_tran": 3e-3}
GAMMA_ATOL = 1e-6
NUMERIC_GAMMA_FACTOR = 1.5

# name: (proj4, (lon0, lon1, lat0, lat1) of the points, cell size)
CASES = {
    "stere_norkyst": ("+proj=stere +lat_0=90 +lon_0=70 +lat_ts=60 "
                      "+R=6371000", (10, 18, 66, 70), 800.0),
    "merc": ("+proj=merc +lat_ts=60 +lon_0=10 +ellps=WGS84",
             (0, 20, 55, 70), 1000.0),
    "merc_sphere": ("+proj=merc +lat_ts=0 +R=6371000", (0, 20, -60, 60),
                    1000.0),
    "lcc_arome": ("+proj=lcc +lat_0=63.3 +lon_0=15 +lat_1=63.3 "
                  "+lat_2=63.3 +R=6371000", (5, 25, 60, 72), 2500.0),
    "lcc_two_parallels": ("+proj=lcc +lat_0=50 +lon_0=-100 +lat_1=33 "
                          "+lat_2=45 +ellps=WGS84", (-120, -80, 25, 50),
                          3000.0),
    "utm33": ("+proj=utm +zone=33 +ellps=WGS84", (12, 18, 55, 70), 100.0),
    "utm33_south": ("+proj=utm +zone=33 +south +ellps=WGS84",
                    (12, 18, -40, -20), 100.0),
    "tmerc": ("+proj=tmerc +lon_0=9 +lat_0=0 +k_0=0.9996 +x_0=500000 "
              "+ellps=WGS84", (5, 13, 50, 65), 100.0),
    "ob_tran": ("+proj=ob_tran +o_proj=longlat +o_lat_p=30 +lon_0=190 "
                "+R=6371000", (0, 30, 50, 70), 0.025),
}
NUMERIC = ("utm33", "utm33_south", "tmerc", "ob_tran")


def _points(case):
    (a, b, c, d) = CASES[case][1]
    r = np.random.default_rng(sorted(CASES).index(case))
    return r.uniform(a, b, N), r.uniform(c, d, N)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_float64_equal(case):
    proj4 = CASES[case][0]
    j, t = J.from_proj4(proj4), T.from_proj4(proj4)
    assert type(t).__name__ == type(j).__name__
    lon, lat = _points(case)
    xj, yj = j.fwd(np, lon, lat)
    xt, yt = t.fwd(np, lon, lat)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    for got, want in zip(t.inv(np, xt, yt), j.inv(np, xj, yj)):
        np.testing.assert_array_equal(got, want)
    # the round trip itself is 1e-9 degrees or better
    lon2, lat2 = t.inv(np, xt, yt)
    assert np.abs((lon2 - lon + 180) % 360 - 180).max() < 1e-7
    assert np.abs(lat2 - lat).max() < 1e-7
    np.testing.assert_array_equal(t.convergence(np, lon, lat),
                                  j.convergence(np, lon, lat))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_float32_within_index_tolerance(case):
    proj4, _, cell = CASES[case]
    j, t = J.from_proj4(proj4), T.from_proj4(proj4)
    lon, lat = (a.astype(np.float32) for a in _points(case))
    xj, yj = (np.asarray(v, np.float64) for v in
              jax.jit(lambda a, b: j.fwd(jnp, a, b))(lon, lat))
    xt, yt = (v.double().numpy() for v in
              t.fwd(tnp, torch.from_numpy(lon), torch.from_numpy(lat)))
    for got, want in ((xt, xj), (yt, yj)):
        err = np.abs(got - want).max() / cell
        assert err <= INDEX_ATOL[case], (case, err)
    gj = np.asarray(jax.jit(lambda a, b: j.convergence(jnp, a, b))(lon, lat),
                    np.float64)
    gt = t.convergence(tnp, torch.from_numpy(lon),
                       torch.from_numpy(lat)).double().numpy()
    if case in NUMERIC:
        g64 = j.convergence(np, lon.astype(np.float64), lat.astype(np.float64))
        jax_err = np.abs(gj - g64).max()
        assert np.abs(gt - g64).max() <= NUMERIC_GAMMA_FACTOR * jax_err + 1e-6
    else:
        assert np.abs(gt - gj).max() <= GAMMA_ATOL
    # inverse on the device too (its outputs are degrees)
    lj = [np.asarray(v, np.float64) for v in jax.jit(
        lambda a, b: j.inv(jnp, a, b))(xj.astype(np.float32),
                                        yj.astype(np.float32))]
    lt = [v.double().numpy() for v in t.inv(
        tnp, torch.from_numpy(xj.astype(np.float32)),
        torch.from_numpy(yj.astype(np.float32)))]
    for got, want in zip(lt, lj):
        assert np.abs((got - want + 180) % 360 - 180).max() < 1e-4


@pytest.mark.parametrize("wkt,proj", [
    ('PROJCS["WGS_1984_UTM_Zone_33N",GEOGCS["GCS_WGS_1984",DATUM['
     '"D_WGS_1984",SPHEROID["WGS_1984",6378137.0,298.257223563]],'
     'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
     'PROJECTION["Transverse_Mercator"],PARAMETER["False_Easting",500000.0],'
     'PARAMETER["False_Northing",0.0],PARAMETER["Central_Meridian",15.0],'
     'PARAMETER["Scale_Factor",0.9996],PARAMETER["Latitude_Of_Origin",0.0],'
     'UNIT["Meter",1.0]]', "TransverseMercatorCRS"),
    ('PROJCS["Lambert",GEOGCS["GCS_Sphere",DATUM["D_Sphere",SPHEROID['
     '"Sphere",6371000.0,0.0]]],PROJECTION["Lambert_Conformal_Conic"],'
     'PARAMETER["Central_Meridian",15.0],PARAMETER["Standard_Parallel_1",'
     '63.3],PARAMETER["Latitude_Of_Origin",63.3]]', "LambertConformalCRS"),
    ('PROJCS["Merc",GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID['
     '"WGS_1984",6378137.0,298.257223563]]],PROJECTION["Mercator"],'
     'PARAMETER["Central_Meridian",10.0],PARAMETER["Standard_Parallel_1",'
     '60.0]]', "MercatorCRS"),
    ('PROJCS["Stere",GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID['
     '"WGS_1984",6378137.0,298.257223563]]],PROJECTION["Stereographic"],'
     'PARAMETER["Central_Meridian",70.0],PARAMETER["Latitude_Of_Origin",'
     '90.0]]', "StereographicCRS"),
    ('GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID["WGS_1984",'
     '6378137.0,298.257223563]]]', "LatLonCRS"),
])
def test_from_esri_wkt_matches_jax(wkt, proj):
    j, t = J.from_esri_wkt(wkt), T.from_esri_wkt(wkt)
    assert type(t).__name__ == type(j).__name__ == proj
    assert t.proj4 == j.proj4
    lon, lat = _points("utm33")
    for got, want in zip(t.fwd(np, lon, lat), j.fwd(np, lon, lat)):
        np.testing.assert_array_equal(got, want)


def test_from_proj4_accepts_every_projection_and_names_the_rest():
    for name in ("merc", "lcc", "tmerc", "utm", "ob_tran", "stere",
                 "latlong"):
        t = T.from_proj4(f"+proj={name} +lat_1=60 +ellps=WGS84")
        assert type(t).__name__ == type(J.from_proj4(t.proj4)).__name__
    with pytest.raises(NotImplementedError, match="aeqd"):
        T.from_proj4("+proj=aeqd")
    with pytest.raises(NotImplementedError, match="lambert_azimuthal"):
        T.from_esri_wkt('PROJCS["x",PROJECTION["Lambert_Azimuthal_Equal_'
                        'Area"]]')
