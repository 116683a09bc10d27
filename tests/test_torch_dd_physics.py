"""The port's domain decomposition under the full physics of
``tests/test_engine_dd.py``'s second half: 3D z-level forcing, profile
vertical mixing, stranding against the coastline raster, a coarse
secondary wind grid, a ROMS file as the tiled primary and a backward run.
Each 8-tile run over ``["cpu"] * 8`` is held against the JAX package's
8-device tiled run (draw for draw, slice tolerance) and the port's plain
run."""

from datetime import timedelta

import numpy as np
import pytest

import torch_dd_fixtures as X


def _forcing_3d(pkg, ny=96, nx=40, u_surface=0.35, u_deep=0.05,
                with_K=False):
    _, F, _ = X.packages(pkg)
    lon = np.linspace(2.0, 6.0, nx)
    lat = np.linspace(59.0, 60.2, ny)
    depths = np.array([0.0, 5.0, 10.0, 20.0, 40.0], np.float64)
    nz = len(depths)
    uu = np.empty((2, nz, ny, nx), np.float32)
    for k, d in enumerate(depths):
        uu[:, k] = u_surface + (u_deep - u_surface) * d / depths[-1]
    vv = np.full((2, nz, ny, nx), 0.35, np.float32)
    data = {"x_sea_water_velocity": uu, "y_sea_water_velocity": vv}
    if with_K:
        K = np.empty((2, nz, ny, nx), np.float32)
        for k, d in enumerate(depths):
            K[:, k] = 0.02 * max(1.0 - d / 30.0, 0.0) + 1e-5
        data["ocean_vertical_diffusivity"] = K
    return F.ArrayReader(data, x=lon, y=lat, depths=depths,
                         times=[X.T0, X.T0 + timedelta(hours=48)])


def _run_3d(pkg, dd, steps=32, mixing=False, number=64):
    o = X.model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "euler")
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_advection", True)
    o.set_config("environment:fallback:upward_sea_water_velocity", -2e-4)
    if mixing:
        o.set_config("drift:vertical_mixing", True)
        o.set_config("vertical_mixing:diffusivitymodel", "environment")
        o.set_config(
            "environment:fallback:sea_floor_depth_below_sea_level", 60.0)
    else:
        o.set_config("drift:vertical_mixing", False)
    o.add_reader(_forcing_3d(pkg, with_K=mixing))
    z0 = np.linspace(-1.0, -35.0, number)
    o.seed_elements(np.full(number, 4.0), np.full(number, 59.2),
                    z=z0, number=number, radius=0, time=X.T0)
    o.run(steps=steps, time_step=900)
    return o


def test_dd_3d_zlevel_matches_gold():
    gold = _run_3d("torch", False)
    tiled = _run_3d("torch", True)
    X.assert_matches_gold(tiled, gold)
    X.assert_matches_gold(tiled, gold, ("z",), atol=1e-3)
    lon = X.values(tiled, "lon")
    assert lon[0, -1] - lon[0, 0] > lon[-1, -1] - lon[-1, 0] + 0.02
    X.assert_matches_jax(tiled, _run_3d("jax", True), ("lon", "lat", "z"))


def test_dd_profile_mixing_statistics():
    """Profile ('environment') mixing in every tile: the draws are keyed
    by element ID and the tile's folded key, so the port's tiled run is
    the JAX package's draw for draw; against the plain run the final z
    population agrees in its moments."""
    tiled = _run_3d("torch", True, mixing=True, number=512)
    gold = _run_3d("torch", False, mixing=True, number=512)
    z_t = X.values(tiled, "z")[:, -1]
    z_g = X.values(gold, "z")[:, -1]
    assert np.isfinite(z_t).all()
    assert abs(z_t.mean() - z_g.mean()) < 2.0, (z_t.mean(), z_g.mean())
    assert abs(z_t.std() - z_g.std()) < 2.0, (z_t.std(), z_g.std())
    X.assert_matches_jax(tiled, _run_3d("jax", True, mixing=True,
                                        number=512), ("lon", "lat", "z"))


def _stranding(pkg, dd):
    _, F, _ = X.packages(pkg)
    o = X.model(pkg, dd)
    ny, nx = 80, 40
    lon = np.linspace(15.5, 19.5, nx)
    lat = np.linspace(69.0, 70.4, ny)
    uu = np.full((2, ny, nx), 0.8, np.float32)
    vv = np.full((2, ny, nx), 0.3, np.float32)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_advection", False)
    o.set_config("general:coastline_action", "stranding")
    o.set_config("general:use_auto_landmask", False)
    o.add_reader(F.ArrayReader(
        {"x_sea_water_velocity": uu, "y_sea_water_velocity": vv},
        x=lon, y=lat, times=[X.T0, X.T0 + timedelta(hours=72)]))
    if pkg == "jax":
        from opendrift_tpu.fields.landmask import GlobalLandmask
    else:
        from opendrift_tpu_torch.fields.landmask import GlobalLandmask
    o.add_reader(GlobalLandmask())
    o.seed_elements(np.linspace(16.2, 16.8, 48), np.linspace(69.3, 69.9, 48),
                    number=48, radius=0, time=X.T0)
    o.run(steps=48, time_step=1800)
    return o


def test_dd_stranding_against_raster():
    gold = _stranding("torch", False)
    tiled = _stranding("torch", True)
    np.testing.assert_array_equal(X.values(gold, "status"),
                                  X.values(tiled, "status"))
    assert (X.values(gold, "status")[:, -1] == 1).any()
    X.assert_matches_gold(tiled, gold)
    X.assert_matches_jax(tiled, _stranding("jax", True))


def _coarse_wind(pkg, dd):
    _, F, _ = X.packages(pkg)
    o = X.model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_advection", False)
    o.add_reader(X.forcing(pkg))
    wlon = np.linspace(1.0, 7.0, 8)
    wlat = np.linspace(58.5, 60.7, 10)
    wx = np.broadcast_to(np.linspace(4.0, 8.0, 10)[None, :, None],
                         (2, 10, 8)).astype(np.float32)
    wy = np.full((2, 10, 8), -2.0, np.float32)
    o.add_reader(F.ArrayReader(
        {"x_wind": wx, "y_wind": wy}, x=wlon, y=wlat,
        times=[X.T0, X.T0 + timedelta(hours=48)], name="coarse_wind"))
    o.seed_elements(4.0, 59.2, number=64, radius=4000, time=X.T0,
                    wind_drift_factor=0.03)
    o.run(steps=32, time_step=900)
    return o


def test_dd_secondary_coarse_wind_reader():
    gold = _coarse_wind("torch", False)
    tiled = _coarse_wind("torch", True)
    # only the current grid is tiled; the wind stays replicated
    assert len(tiled._dd.tiled_idx) == 1
    X.assert_matches_gold(tiled, gold)
    assert (X.values(gold, "lon")[:, -1]
            > X.values(gold, "lon")[:, 0] + 0.05).all()
    X.assert_matches_jax(tiled, _coarse_wind("jax", True))


@pytest.fixture(scope="module")
def roms_file(tmp_path_factory):
    """A small Nordic-like ROMS file (curvilinear, sigma levels, land)
    that both packages read."""
    from opendrift_tpu_torch.tools.synthetic_nc import write_roms
    path = str(tmp_path_factory.mktemp("roms") / "nordic_like.nc")
    write_roms(path, nxi=40, neta=44, ns=6, nt=3)
    return path


def _roms(pkg, dd, path):
    _, F, _ = X.packages(pkg)
    if pkg == "jax":
        from opendrift_tpu.fields.roms import ROMSReader
    else:
        from opendrift_tpu_torch.fields.roms import ROMSReader
    o = X.model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("general:use_auto_landmask", False)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_advection", False)
    o.set_config("drift:vertical_mixing", False)
    if dd:
        # native-index ROMS grids are coarse: 8 Y bands would be thinner
        # than the halo, so tile 4x2
        o.set_config("parallel:tile_grid", "4x2")
    r = ROMSReader(path)
    o.add_reader(r)
    o.seed_elements(np.linspace(11.4, 12.6, 24), np.linspace(67.3, 67.8, 24),
                    number=24, radius=0, time=r.times[0])
    o.run(steps=16, time_step=1800)
    return o


def test_dd_roms_file_reader(roms_file):
    gold = _roms("torch", False, roms_file)
    tiled = _roms("torch", True, roms_file)
    assert tiled._dd.primary._curvilinear
    np.testing.assert_allclose(X.values(tiled, "lon"),
                               X.values(gold, "lon"), atol=5e-5)
    np.testing.assert_allclose(X.values(tiled, "lat"),
                               X.values(gold, "lat"), atol=5e-5)
    X.assert_matches_jax(tiled, _roms("jax", True, roms_file))


def _backward(pkg, dd):
    o = X.model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_advection", False)
    o.set_config("parallel:tile_capacity_factor", 8.0)
    o.add_reader(X.forcing(pkg))
    o.seed_elements(4.5, 59.9, number=64, radius=4000,
                    time=X.T0 + timedelta(hours=10))
    o.run(steps=32, time_step=-900)
    return o


def test_dd_backward_run_matches_gold():
    gold = _backward("torch", False)
    tiled = _backward("torch", True)
    X.assert_matches_gold(tiled, gold)
    X.assert_matches_jax(tiled, _backward("jax", True))
