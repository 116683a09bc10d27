"""The port's engine-level domain decomposition
(``opendrift_tpu_torch/parallel/tiled.py``) against the JAX package's
(``tests/test_engine_dd.py``, the first eight of its tests): the port's
8-tile runs over ``["cpu"] * 8`` reproduce the JAX package's 8-device
tiled runs draw for draw, within the slice tolerance, and the port's own
plain run at ``atol=2e-5``.  The rest are in
``tests/test_torch_dd_physics.py``."""

import numpy as np
import pytest

import torch_dd_fixtures as X


def test_tiled_run_matches_replicated_gold():
    gold = X.run("torch", dd=False)
    tiled = X.run("torch", dd=True)
    jtiled = X.run("jax", dd=True)
    assert tiled._dd is not None and (tiled._dd.n_ty, tiled._dd.n_tx) \
        == (8, 1)
    assert X.values(gold, "lon").shape == X.values(tiled, "lon").shape
    X.assert_matches_gold(tiled, gold)
    np.testing.assert_array_equal(X.values(gold, "status"),
                                  X.values(tiled, "status"))
    X.assert_matches_jax(tiled, jtiled)
    X.assert_same_tiles(tiled, jtiled)


@pytest.mark.parametrize("scheme,steps,single_fetch", [
    ("euler", 24, False), ("runge-kutta", 24, True)])
def test_tiled_run_matches_gold_euler_and_block_rk(scheme, steps,
                                                   single_fetch):
    kw = dict(scheme=scheme, steps=steps, single_fetch=single_fetch)
    gold = X.run("torch", dd=False, **kw)
    tiled = X.run("torch", dd=True, **kw)
    X.assert_matches_gold(tiled, gold, ("lat",))
    X.assert_matches_jax(tiled, X.run("jax", dd=True, **kw))


def test_migration_conserves_all_elements():
    o = X.run("torch", dd=True, number=120, steps=48)
    lon, lat = X.values(o, "lon"), X.values(o, "lat")
    assert lon.shape[0] == 120
    assert np.isfinite(lon).all() and np.isfinite(lat).all()
    assert (lat[:, -1] > lat[:, 0] + 0.1).all()
    # the elements really crossed tiles, one migration a step
    assert sum(o._dd.leavers) > 0 and len(o._dd.leavers) == 48
    X.assert_matches_jax(o, X.run("jax", dd=True, number=120, steps=48))


def test_clumped_overflow_keeps_every_element():
    """Converging flow packs every particle into one tile; with minimal
    headroom the receiving tile fills up, unacknowledged leavers stay put
    and retry, and the stuck count is surfaced.  With headroom the same
    run matches the plain one."""
    lat_c = 59.6

    def v_conv(lat):
        return np.where(lat < lat_c, 0.5, -0.5).astype(np.float32)

    kw = dict(number=160, steps=64, v_of_lat=v_conv, lat0=59.6,
              radius=30000)
    tight = X.run("torch", dd=True, capacity_factor=1.0, **kw)
    lat = X.values(tight, "lat")
    assert lat.shape[0] == 160
    assert np.isfinite(lat).all()
    d0 = np.abs(lat[:, 0] - lat_c)
    d1 = np.abs(lat[:, -1] - lat_c)
    assert (d1 <= d0 + 1e-6).all()
    assert (d1 < 0.02).mean() > 0.6
    assert tight._dd.last_in_transit > 0
    jtight = X.run("jax", dd=True, capacity_factor=1.0, **kw)
    X.assert_matches_jax(tight, jtight)
    assert tight._dd.last_in_transit == jtight._dd.last_in_transit

    roomy = X.run("torch", dd=True, capacity_factor=8.0, **kw)
    gold = X.run("torch", dd=False, **kw)
    X.assert_matches_gold(roomy, gold, ("lat",))
    assert roomy._dd.last_in_transit == 0


def _diffusion(pkg, dd):
    o = X.model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_advection", False)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    o.add_reader(X.forcing(pkg))
    o.seed_elements(4.0, 59.2, number=400, radius=2000, time=X.T0)
    o.run(steps=20, time_step=1800)
    return o


def test_dd_stochastic_diffusion_statistics():
    """Horizontal diffusion under decomposition: each tile draws with its
    own folded key, so the run matches the JAX package's tiled run draw
    for draw, and the plain run in its spread."""
    o = _diffusion("torch", True)
    lat = X.values(o, "lat")
    assert np.isfinite(lat).all()
    spread = lat[:, -1].std() * 111320.0
    seed_spread = lat[:, 0].std() * 111320.0
    assert spread > seed_spread + 100.0
    s2 = X.values(_diffusion("torch", False), "lat")[:, -1].std() * 111320.0
    assert abs(spread - s2) / s2 < 0.35
    X.assert_matches_jax(o, _diffusion("jax", True))


def test_2d_tile_grid_matches_gold():
    kw = dict(number=96, steps=36, lat0=59.3, radius=15000,
              capacity_factor=16.0, forcing_kw=dict(ny=64, nx=64, u=0.45))
    gold = X.run("torch", dd=False, **kw)
    for tg in ("4x2", "2x4"):
        tiled = X.run("torch", dd=True, tile_grid=tg, **kw)
        X.assert_matches_gold(tiled, gold)
        assert (tiled._dd.n_ty, tiled._dd.n_tx) \
            == tuple(int(v) for v in tg.split("x"))
        assert tiled._dd.halo_x > 0
        assert tiled._dd.last_in_transit == 0
        X.assert_matches_jax(tiled, X.run("jax", dd=True, tile_grid=tg,
                                          **kw))


@pytest.mark.parametrize("tile_grid", ["3x5", "nonsense"])
def test_tile_grid_validation(tile_grid):
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="tile_grid"):
            X.run(pkg, dd=True, number=8, steps=2, tile_grid=tile_grid)


def test_dd_requires_gridded_current():
    for pkg in ("jax", "torch"):
        _, F, _ = X.packages(pkg)
        o = X.model(pkg, True)
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.add_reader(F.ConstantReader({"x_sea_water_velocity": 0.1,
                                       "y_sea_water_velocity": 0.0}))
        o.seed_elements(4.0, 60.0, number=8, time=X.T0)
        with pytest.raises(ValueError, match="domain_decomposition"):
            o.run(steps=2, time_step=600)


def test_one_tile_is_reported_unsharded():
    """A mesh of one tile, or no set_mesh on the CPU, runs the plain
    path: no decomposition context, no sharding."""
    o = X.model("torch", True)
    o.set_mesh(["cpu"])
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.add_reader(X.forcing("torch"))
    o.seed_elements(4.0, 59.2, number=8, time=X.T0)
    o.run(steps=2, time_step=600)
    assert o._dd is None and o._sharding is None
    o = X.run("torch", dd=False, number=8, steps=2)
    assert o._dd is None and o._sharding is None
