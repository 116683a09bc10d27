"""The post-processing of ``opendrift_tpu_torch`` (``models/
postprocess.py``: histograms, density arrays and files, residence time,
centre of gravity, ``clone``, FTLE through ``ops/lcs.py``) and
``utils/trajectory.py`` on the CPU, against the JAX package.

Tolerances.  A double-gyre run of the two packages ends with positions
equal to float32 rounding.  The bin edges follow the extreme positions,
so they agree to ``EDGE_RTOL`` of the grid's span; the histograms,
density arrays and files are equal but for elements an ulp from a bin
edge: ``EDGE_SHARE`` of the counts at most (0 measured).  The
centre of gravity is held to ``POS_ATOL`` degrees.  FTLE fields come from
finite differences of final positions over ``delta``: an ulp of a final
position (1e-7 of the domain) is 1e-5 of a 0.02 cell, so the fields are
held to ``FTLE_ATOL`` (in 1/s; 5e-6 measured) where both are finite,
with their ridges (the top 5% of the field) in the same cells but for
``EDGE_SHARE``.  The trajectory utilities are the same float64 numpy:
1e-12 relative.
"""

import os
from datetime import datetime, timedelta

import numpy as np
import pytest

EDGE_SHARE = 0.005
EDGE_RTOL = 1e-6
POS_ATOL = 1e-5
FTLE_ATOL = 1e-4


def _gyre(pkg, n=400):
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
    return o, dg


@pytest.fixture(scope="module")
def gyre_runs():
    out = []
    for pkg in ("jax", "torch"):
        o, dg = _gyre(pkg)
        lon, lat = dg.xy2lonlat([0.9], [0.5])
        o.seed_elements(lon, lat, radius=0.15, number=400,
                        time=dg.initial_time, z=-np.linspace(0, 2, 400))
        o.run(duration=timedelta(seconds=10), time_step=0.25)
        out.append(o)
    return out


def _same_edges(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    span = want.max() - want.min() if want.size > 1 else abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=EDGE_RTOL * span)


def _equal_but_edges(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    moved = np.abs(got - want).sum()
    assert moved <= EDGE_SHARE * max(np.abs(want).sum(), 1.0), moved


def test_lonlat_bins_and_histogram(gyre_runs):
    oj, ot = gyre_runs
    for a, b in zip(ot.get_lonlat_bins(0.2), oj.get_lonlat_bins(0.2)):
        _same_edges(a, b)
    Ht, lon_t, lat_t = ot.get_histogram(pixelsize_m=0.2)
    Hj, lon_j, lat_j = oj.get_histogram(pixelsize_m=0.2)
    _same_edges(lon_t, lon_j)
    _same_edges(lat_t, lat_j)
    _equal_but_edges(Ht, Hj)
    assert Ht.shape[0] == ot.result.dims["time"]
    np.testing.assert_allclose(Ht[0].sum(), 400)
    np.testing.assert_allclose(Ht[-1].sum(), 400)
    w = np.linspace(0.5, 2.0, 400)
    _equal_but_edges(ot.get_histogram(0.2, weights=w)[0],
                     oj.get_histogram(0.2, weights=w)[0])


def test_density_arrays_and_files(gyre_runs, tmp_path):
    from scipy.io import netcdf_file
    oj, ot = gyre_runs
    for a, b in zip(ot.get_density_array(0.2), oj.get_density_array(0.2)):
        _equal_but_edges(a, b)
    H_surf, H_sub, H_str, _, _ = ot.get_density_array(0.2)
    assert H_sub.sum() > 0 and H_surf.sum() > 0 and H_str.sum() == 0
    for a, b in zip(ot.get_density_array(0.2, weight="z"),
                    oj.get_density_array(0.2, weight="z")):
        _equal_but_edges(a, b)
    Pt = ot.get_density_array_proj(20000.0, density_proj="+proj=utm "
                                   "+zone=31 +ellps=WGS84 +units=m")
    Pj = oj.get_density_array_proj(20000.0, density_proj="+proj=utm "
                                   "+zone=31 +ellps=WGS84 +units=m")
    _equal_but_edges(Pt[0], Pj[0])
    for a, b in ((Pt[1], Pj[1]), (Pt[2], Pj[2])):
        _same_edges(a, b)
    assert Pt[0].sum(axis=(1, 2)).max() == 400
    for kind in ("latlon", "proj"):
        files = []
        for o, tag in ((oj, "jax"), (ot, "port")):
            path = str(tmp_path / f"{kind}_{tag}.nc")
            if kind == "latlon":
                o.write_netcdf_density_map(path, pixelsize_m=0.2)
            else:
                o.write_netcdf_density_map_proj(
                    path, pixelsize_m=0.002, llcrnrlon=-1e-6,
                    llcrnrlat=-1e-6, urcrnrlon=2e-5, urcrnrlat=1e-5)
            files.append(netcdf_file(path, "r", mmap=False))
        assert set(files[1].variables) == set(files[0].variables)
        for var in files[0].variables:
            a = files[1].variables[var][:]
            b = files[0].variables[var][:]
            if var.startswith("density"):
                _equal_but_edges(a, b)
            elif var == "time":
                np.testing.assert_array_equal(a, b)
            else:
                _same_edges(a, b)
        if kind == "latlon":
            total = files[1].variables["density_surface"][:].sum() \
                + files[1].variables["density_submerged"][:].sum()
            assert total == pytest.approx(400 * ot.result.dims["time"])
        for f in files:
            f.close()
    # write_geotiff is ported: one TIFF, world file and .prj a step, as
    # the JAX package writes (their pixels: tests/test_torch_plots.py)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = oj.write_geotiff(str(tmp_path / "jax" / "g.tif"),
                            pixelsize_km=20.0)
    got = ot.write_geotiff(str(tmp_path / "port" / "g.tif"),
                           pixelsize_km=20.0)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == ot.result.dims["time"]
    assert all(os.path.exists(p[:-4] + ".tfw") for p in got)


def test_residence_time_and_center_of_gravity(gyre_runs):
    oj, ot = gyre_runs
    Rt, _, _ = ot.get_residence_time(pixelsize_m=0.2)
    Rj, _, _ = oj.get_residence_time(pixelsize_m=0.2)
    _equal_but_edges(Rt, Rj)
    assert Rt.sum() == pytest.approx(400 * ot.result.dims["time"])
    for surface in (False, True):
        for a, b in zip(ot.center_of_gravity(onlysurface=surface),
                        oj.center_of_gravity(onlysurface=surface)):
            np.testing.assert_allclose(a, b, atol=POS_ATOL)


def test_clone_keeps_class_config_readers_and_device():
    o, dg = _gyre("torch")
    o.set_config("drift:horizontal_diffusivity", 3.0)
    c = o.clone()
    assert type(c) is type(o) and c is not o
    assert c.device == o.device
    assert c.get_config("drift:horizontal_diffusivity") == 3.0
    assert c.get_config("drift:advection_scheme") == "runge-kutta4"
    assert list(c.env.readers.values()) == [dg]
    assert c.result is None and not c._seedings


def test_ftle_double_gyre_matches_jax():
    """``calculate_ftle`` forward (RLCS) and backward (ALCS) on the double
    gyre at a 0.02 spacing (5,000 seeds) in both packages: the fields
    agree and carry the ridge structure of the LCS benchmark."""
    fields = []
    for pkg in ("jax", "torch"):
        o, dg = _gyre(pkg)
        fields.append(o.calculate_ftle(
            reader=dg, delta=0.02, domain=[0.0, 2.0, 0.0, 1.0],
            time=dg.initial_time, time_step=0.2,
            duration=timedelta(seconds=8)))
    lj, lt = fields
    _same_edges(lt["lon"], lj["lon"])
    for name in ("RLCS", "ALCS"):
        a, b = lt[name][0], lj[name][0]
        assert a.shape == (50, 100)
        ok = np.isfinite(a) & np.isfinite(b)
        assert ok.mean() > 0.99 and np.array_equal(np.isfinite(a),
                                                   np.isfinite(b))
        assert np.abs(a[ok] - b[ok]).max() <= FTLE_ATOL, name
        ridge_a = a >= np.nanpercentile(b, 95)
        ridge_b = b >= np.nanpercentile(b, 95)
        assert np.mean(ridge_a != ridge_b) <= EDGE_SHARE * 10, name
        assert np.nanmax(a) > 0.1
        assert np.nanmax(a) > 3 * np.nanmedian(np.abs(a))


def test_ftle_function_matches_jax():
    from opendrift_tpu.ops.lcs import ftle as jftle
    from opendrift_tpu_torch.ops.lcs import ftle
    r = np.random.default_rng(0)
    X, Y = r.standard_normal((2, 30, 40))
    np.testing.assert_array_equal(ftle(X, Y, 0.1, -8.0),
                                  jftle(X, Y, 0.1, -8.0))


# ---------------------------------------------------- trajectory utilities --

def _synthetic_trajectory(wdf_true, N=20, dt=600.0, cu=0.3, cv=0.1,
                          wu=8.0, wv=4.0):
    from opendrift_tpu_torch.utils import geodesic
    t0 = datetime(2020, 1, 1)
    lat, lon = [60.0], [4.0]
    for _ in range(N - 1):
        la, lo = geodesic.geodesic_step(
            np, np.float64(lat[-1]), np.float64(lon[-1]),
            cu + wdf_true * wu, cv + wdf_true * wv, dt)
        lat.append(float(la))
        lon.append(float(lo))
    return dict(
        time=[t0 + timedelta(seconds=dt * i) for i in range(N)],
        lon=np.array(lon), lat=np.array(lat),
        x_wind=np.full(N, wu), y_wind=np.full(N, wv),
        x_sea_water_velocity=np.full(N, cu),
        y_sea_water_velocity=np.full(N, cv))


@pytest.mark.parametrize("min_period", [None, timedelta(seconds=1200)])
def test_wind_drift_factor_matches_jax(min_period):
    from opendrift_tpu.utils import trajectory as J
    from opendrift_tpu_torch.utils import trajectory as T
    traj = _synthetic_trajectory(0.03, N=24)
    traj["lon"] = traj["lon"] + np.linspace(0, 1e-3, 24)
    got = T.wind_drift_factor_from_trajectory(traj, min_period=min_period)
    want = J.wind_drift_factor_from_trajectory(traj, min_period=min_period)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    clean = T.wind_drift_factor_from_trajectory(_synthetic_trajectory(0.03))
    assert np.allclose(clean[0], 0.03, atol=1e-6)
    assert np.all(np.abs(clean[1]) < 0.1)
    # the polar histogram is ported (its artists: tests/test_torch_plots.py)
    import matplotlib
    matplotlib.use("Agg")
    fig, ax = T.plot_wind_drift_factor(*clean, show=False)
    jfig, jax_ = J.plot_wind_drift_factor(*clean, show=False)
    np.testing.assert_array_equal(ax.collections[0].get_array(),
                                  jax_.collections[0].get_array())


def test_distances_lengths_and_skill_score_match_jax():
    from opendrift_tpu.utils import trajectory as J
    from opendrift_tpu_torch.utils import trajectory as T
    r = np.random.default_rng(3)
    lon = 4.0 + np.cumsum(r.uniform(0, 0.01, 30))
    lat = 60.0 + np.cumsum(r.uniform(-0.005, 0.01, 30))
    lon_m = lon + r.normal(0, 0.003, 30)
    lat_m = lat + r.normal(0, 0.003, 30)
    np.testing.assert_allclose(
        T.distance_between_trajectories(lon, lat, lon_m, lat_m),
        J.distance_between_trajectories(lon, lat, lon_m, lat_m),
        rtol=1e-12)
    np.testing.assert_allclose(T.trajectory_length(lon, lat),
                               J.trajectory_length(lon, lat), rtol=1e-12)
    for tol in (0.5, 1.0, 3.0):
        ss = T.skillscore_liu_weissberg(lon, lat, lon_m, lat_m, tol)
        assert ss == pytest.approx(J.skillscore_liu_weissberg(
            lon, lat, lon_m, lat_m, tol), rel=1e-12)
        assert 0.0 <= ss < 1.0
    assert T.skillscore_liu_weissberg(lon, lat, lon, lat) == 1.0
    assert T.skillscore_liu_weissberg(lon[:1].repeat(3), lat[:1].repeat(3),
                                      lon[:3], lat[:3]) == 0.0
