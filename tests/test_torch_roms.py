"""The port's ROMS reader (``fields/roms.py``) against the JAX package's on
synthetic Nordic-4km-like files (``opendrift_tpu_torch.tools.synthetic_nc``
at small sizes: a curvilinear C-grid of a polar stereographic plane over
Lofoten, so ``angle`` varies and the bundled coastline raster gives the
mask, Vtransform 2 / Vstretching 4).

Tolerances:

* The sigma machinery (``s_stretch``, ``sdepth``, ``zslice_columns``) and
  every packed table (unstaggering, the staggered masks before the
  ``angle`` rotation, sigma to z, the grey-dilation coastal fill, the
  regrid resample) are bit-equal.
* ``CurvilinearIndexCRS.fwd`` on the device: the same float32 expression
  on both sides, but XLA contracts the affine part into multiply-adds;
  within ``INDEX_ATOL`` grid-index units (measured: 1.3e-4).
* Samples of u, v, temp, AKs and the rest, both sampling modes: within
  ``EXACT_ATOL`` (measured equal).
* Runs: ``tests/test_torch_oceandrift.py``'s slice tolerance; 'block'
  bisection against the refetch as ``tests/test_roms.py`` holds it.
"""

from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nc_fixtures as F
from test_torch_oceandrift import _assert_close

from opendrift_tpu.fields import roms as jroms
from opendrift_tpu_torch.fields import roms as troms
from opendrift_tpu_torch.tools import synthetic_nc
from opendrift_tpu_torch.utils.xp import tnp

EXACT_ATOL = 1e-6
INDEX_ATOL = 1e-3
SMALL = dict(nxi=60, neta=50, ns=12, nt=3, hmax=400.0, centre=(14.0, 67.8))
INTERVAL_S = 3 * 3600.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("roms")
    return {
        "staggered": synthetic_nc.write_roms(str(d / "roms.nc"), **SMALL),
        "rho_theta": synthetic_nc.write_roms(
            str(d / "roms_rho.nc"), staggered=False, stretching_curve=False,
            **SMALL)}


@pytest.mark.parametrize("vstretching", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("stagger", ["rho", "w"])
def test_s_stretch_exact(vstretching, stagger):
    for n, ts, tb in ((32, 7.0, 2.0), (12, 5.0, 0.4)):
        np.testing.assert_array_equal(
            troms.s_stretch(n, ts, tb, stagger, vstretching),
            jroms.s_stretch(n, ts, tb, stagger, vstretching))


@pytest.mark.parametrize("vtransform", [1, 2])
def test_sdepth_and_zslice_exact(vtransform):
    r = np.random.default_rng(vtransform)
    h = r.uniform(20.0, 3000.0, (9, 11))
    zeta = r.uniform(-0.5, 0.5, (9, 11))
    s = -1.0 + (np.arange(16) + 0.5) / 16
    C = troms.s_stretch(16, 7.0, 2.0, "rho", 4)
    z = troms.sdepth(h, zeta, 20.0, C, s, vtransform)
    np.testing.assert_array_equal(
        z, jroms.sdepth(h, zeta, 20.0, C, s, vtransform))
    assert np.all(np.diff(z, axis=0) > 0)
    data = r.standard_normal((16, 9, 11)).astype(np.float32)
    depths = troms.DEFAULT_DEPTHS[:20]
    np.testing.assert_array_equal(
        troms.zslice_columns(data, z, depths),
        jroms.zslice_columns(data, z, depths))


@pytest.fixture(scope="module")
def pairs(files):
    """(JAX reader, port reader, JAX state, port host state, port state)
    for each layout and sampling mode, built once."""
    out = {}
    for layout, path in files.items():
        for sampling in ("native", "regrid"):
            j = jroms.ROMSReader(path, sampling=sampling)
            t = troms.ROMSReader(path, sampling=sampling)
            out[layout, sampling] = (j, t) + F.prepare_pair(
                j, t, interval_seconds=INTERVAL_S)
    return out


def _positions(t, n=3000, seed=0):
    r = np.random.default_rng(seed)
    lon = r.uniform(t._lon_rho.min() - 0.2, t._lon_rho.max() + 0.2, n)
    lat = r.uniform(t._lat_rho.min() - 0.1, t._lat_rho.max() + 0.1, n)
    return lon, lat, -r.uniform(0.0, 300.0, n)


@pytest.mark.parametrize("sampling", ["native", "regrid"])
@pytest.mark.parametrize("layout", ["staggered", "rho_theta"])
def test_tables_bit_equal_and_samples_match(pairs, sampling, layout):
    j, t, jstate, host, tstate = pairs[layout, sampling]
    assert t.variables == j.variables
    assert "ocean_vertical_diffusivity" in t.variables
    np.testing.assert_array_equal(t.depths, j.depths)
    np.testing.assert_array_equal(t._Cs_r, j._Cs_r)
    assert t._sampler.pair_mode == j._sampler.pair_mode
    F.assert_tables_equal(host, jstate)
    lon, lat, z = _positions(t, seed=len(layout))
    names = [v for v in t.variables if v not in t._derived]
    for trel in (0.0, 5000.0):
        jv, jc, tv, tc = F.sample_pair(j, t, jstate, tstate, names, trel,
                                       lon, lat, z)
        np.testing.assert_array_equal(tc, jc)
        assert 0.3 < tc.mean() <= 1.0
        for v in names:
            np.testing.assert_array_equal(np.isnan(tv[v]), np.isnan(jv[v]))
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=0,
                                       atol=EXACT_ATOL, err_msg=v)
    # the rotation by a varying angle reached the currents
    assert np.ptp(t._angle) > 0.1
    np.testing.assert_array_equal(t.covers_positions(lon, lat),
                                  j.covers_positions(lon, lat))


@pytest.mark.parametrize("sampling", ["native", "regrid"])
def test_aks_profiles_match_jax(pairs, sampling):
    """The profiles the profile kernel receives on a ROMS run: AKs (on the
    w levels) at the model's 26 levels of 2 m, equal to the JAX
    package's."""
    j, t, jstate, _, tstate = pairs["staggered", sampling]
    lon, lat, _ = _positions(t, n=500, seed=21)
    zlevels = -np.arange(0.0, 52.0, 2.0, dtype=np.float32)
    names = ["ocean_vertical_diffusivity"]
    jv, jc = j.sample_profiles(jstate, names, jnp.float32(1800.0),
                               jnp.asarray(lon, jnp.float32),
                               jnp.asarray(lat, jnp.float32),
                               jnp.asarray(zlevels))
    tv, tc = t.sample_profiles(tstate, names, np.float32(1800.0),
                               torch.as_tensor(lon, dtype=torch.float32),
                               torch.as_tensor(lat, dtype=torch.float32),
                               zlevels)
    tc, jc = tc.numpy(), np.asarray(jc)
    np.testing.assert_array_equal(tc, jc)
    got, want = tv[names[0]].numpy(), np.asarray(jv[names[0]])
    assert got.shape == want.shape == (26, 500)
    np.testing.assert_allclose(got[:, tc], want[:, jc], rtol=0,
                               atol=EXACT_ATOL)
    assert (got[:, tc] > 0).all() and np.ptp(got[:, tc]) > 1e-3


def test_curvilinear_index_crs_matches_jax(pairs):
    j, t = pairs["staggered", "native"][:2]
    lon, lat, _ = _positions(t, n=10_000, seed=9)
    for got, want in zip(t.crs.fwd(np, lon, lat), j.crs.fwd(np, lon, lat)):
        np.testing.assert_array_equal(got, want)
    lon32, lat32 = lon.astype(np.float32), lat.astype(np.float32)
    jx, jy = (np.asarray(a) for a in jax.jit(
        lambda a, b: j.crs.fwd(jnp, a, b))(lon32, lat32))
    tx, ty = (a.numpy() for a in t.crs.fwd(tnp, torch.from_numpy(lon32),
                                           torch.from_numpy(lat32)))
    for got, want in ((tx, jx), (ty, jy)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert np.abs(got[ok] - want[ok]).max() <= INDEX_ATOL
    assert 0.3 < np.mean(~np.isnan(tx)) < 1.0
    # the raster table goes to a device once
    st = t.crs._device_state(torch.device("cpu"))
    assert t.crs._device_state(torch.device("cpu")) is st
    for got, want in zip(t.crs.inv(np, tx[:50], ty[:50]),
                         j.crs.inv(np, tx[:50], ty[:50])):
        np.testing.assert_array_equal(got, want)


def test_truncate_depth_matches_jax_and_refetch(files):
    """drift:truncate_ocean_model_below_m: the table keeps the levels down
    to the depth and one below (Z 1 at 0 m), equal to the JAX package's;
    exact within the kept range, clamped below."""
    r = np.random.default_rng(3)
    t0 = troms.ROMSReader(files["staggered"])
    ocean = t0._mask
    lon = r.choice(t0._lon_rho[ocean], 300) + r.uniform(-0.01, 0.01, 300)
    lat = r.choice(t0._lat_rho[ocean], 300) + r.uniform(-0.005, 0.005, 300)

    def mk(trunc):
        j = jroms.ROMSReader(files["staggered"])
        t = troms.ROMSReader(files["staggered"])
        for rd in (j, t):
            rd.truncate_depth = trunc
        return (j, t) + F.prepare_pair(j, t)

    full, surf, ten = mk(None), mk(0.0), mk(10.0)
    for j, t, jstate, host, _ in (full, surf, ten):
        assert t._sampler.Z == j._sampler.Z
        F.assert_tables_equal(host, jstate)
    assert full[1]._sampler.Z > ten[1]._sampler.Z > surf[1]._sampler.Z == 1

    def du(a, b, z):
        zz = np.full(lon.shape, z)
        _, _, va, ca = F.sample_pair(a[0], a[1], a[2], a[4],
                                     ["x_sea_water_velocity"], 1800.0,
                                     lon, lat, zz)
        _, _, vb, cb = F.sample_pair(b[0], b[1], b[2], b[4],
                                     ["x_sea_water_velocity"], 1800.0,
                                     lon, lat, zz)
        return np.nanmax(np.abs(va["x_sea_water_velocity"]
                                - vb["x_sea_water_velocity"]))

    assert du(full, surf, 0.0) == 0.0
    assert du(full, ten, -8.0) == 0.0
    assert du(full, surf, -5.0) > 0.0


def _run(pkg, path, sampling="native", mixing="environment", n=64,
         hours=2, **cfg):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields.roms import ROMSReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields.roms import ROMSReader
        o = OceanDrift(loglevel=40, device="cpu")
    r = ROMSReader(path, sampling=sampling)
    o.add_reader(r)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", mixing)
    o.set_config("vertical_mixing:timestep", 60.0)
    for k, v in cfg.items():
        o.set_config(k, v)
    rng = np.random.default_rng(4)
    o.seed_elements(lon=rng.uniform(12.0, 12.8, n),
                    lat=rng.uniform(67.6, 68.0, n),
                    z=-rng.uniform(0.0, 20.0, n), time=r.times[0])
    o.run(duration=timedelta(hours=hours), time_step=900,
          time_step_output=3600)
    return o


@pytest.mark.parametrize("sampling,mixing", [
    ("native", "environment"), ("regrid", "windspeed_Large1994")])
def test_run_matches_jax(files, sampling, mixing):
    """A default OceanDrift run (the reader's own mask_rho as landmask),
    RK4: natively sampled with 'environment' mixing on the reader's AKs
    profiles (the profile kernel's plain version), regridded with
    Large1994 (the windspeed kernel's)."""
    oj = _run("jax", files["staggered"], sampling, mixing)
    ot = _run("torch", files["staggered"], sampling, mixing)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)
    z = ot.result["z"].values
    assert not np.array_equal(z[:, 0], z[:, -1])


def test_block_bisection_matches_refetch(files):
    """general:coastline_bisection='block' strands the same elements as
    the refetch, crossing points within a native cell (tests/test_roms.py
    holds the JAX package to the same bounds)."""
    def run(mode):
        o = _run("torch", files["staggered"], mixing="constant", n=200,
                 hours=12, **{
                     "drift:vertical_advection": False,
                     "drift:advection_single_fetch": True,
                     "general:coastline_bisection": mode,
                     "drift:horizontal_diffusivity": 20.0,
                     "environment:fallback:ocean_vertical_diffusivity":
                         1e-3})
        status = np.asarray(o.result["status"].values)[:, -1]
        lon = np.asarray(o.result["lon"].values)
        lat = np.asarray(o.result["lat"].values)
        last = [np.array([row[np.isfinite(row)][-1] for row in a])
                for a in (lon, lat)]
        return (status == o.status_categories.index("stranded"),) + \
            tuple(last)

    s_ref, lon_ref, lat_ref = run("refetch")
    s_blk, lon_blk, lat_blk = run("block")
    assert s_ref.sum() > 10
    assert (s_ref != s_blk).mean() < 0.05
    both = s_ref & s_blk
    dm = np.hypot((lon_ref - lon_blk)[both] * 42000,
                  (lat_ref - lat_blk)[both] * 111000)
    assert np.median(dm) < 4000 and np.percentile(dm, 95) < 8000
