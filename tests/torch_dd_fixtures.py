"""Shared set-ups of the port's domain-decomposition tests
(``tests/test_torch_dd.py``, ``tests/test_torch_dd_physics.py``): the
configurations of ``tests/test_engine_dd.py``, built in either package.
The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port with ``set_mesh(["cpu"] * 8)``."""

from datetime import datetime, timedelta

import numpy as np

T0 = datetime(2021, 3, 1)
MESH = ["cpu"] * 8
# the slice tolerance of tests/test_torch_oceandrift.py:31-32
MEDIAN_ATOL = {"lon": 1e-6, "lat": 1e-6, "z": 1e-4}
OUTLIER_ATOL = {"lon": 1e-4, "lat": 1e-4, "z": 0.1}
OUTLIER_SHARE = 0.02
# tiled against plain, as tests/test_engine_dd.py holds it
GOLD_ATOL = 2e-5


def packages(pkg):
    if pkg == "jax":
        import opendrift_tpu.models as M
        import opendrift_tpu.fields as F
        return M, F, {}
    import opendrift_tpu_torch.models as M
    import opendrift_tpu_torch.fields as F
    return M, F, {"device": "cpu"}


def model(pkg, dd, cls="OceanDrift", loglevel=50):
    """A simulation of ``pkg`` ('jax' or 'torch'); the port's takes the
    8-tile CPU mesh when ``dd``."""
    M, _, kw = packages(pkg)
    o = getattr(M, cls)(loglevel=loglevel, **kw)
    o.set_config("parallel:domain_decomposition", dd)
    if pkg == "torch" and dd:
        o.set_mesh(MESH)
    return o


def forcing(pkg, ny=96, nx=40, v_of_lat=None, u=0.25):
    _, F, _ = packages(pkg)
    lon = np.linspace(2.0, 6.0, nx)
    lat = np.linspace(59.0, 60.2, ny)
    uu = np.full((2, ny, nx), u, np.float32)
    vv = np.empty((2, ny, nx), np.float32)
    if v_of_lat is None:
        vv[:] = 0.4
    else:
        vv[:] = np.broadcast_to(v_of_lat(lat)[None, :, None], (2, ny, nx))
    return F.ArrayReader(
        {"x_sea_water_velocity": uu, "y_sea_water_velocity": vv},
        x=lon, y=lat, times=[T0, T0 + timedelta(hours=48)])


def run(pkg, dd, scheme="runge-kutta4", number=64, steps=40, dt=900,
        v_of_lat=None, capacity_factor=2.0, lat0=59.2, radius=4000,
        single_fetch=False, tile_grid=None, forcing_kw=None):
    """``tests/test_engine_dd.py::_run`` in either package."""
    o = model(pkg, dd)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", scheme)
    o.set_config("drift:vertical_advection", False)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:vertical_mixing", False)
    o.set_config("parallel:tile_capacity_factor", capacity_factor)
    if tile_grid is not None:
        o.set_config("parallel:tile_grid", tile_grid)
    if single_fetch:
        o.set_config("drift:advection_single_fetch", True)
    o.add_reader(forcing(pkg, v_of_lat=v_of_lat, **(forcing_kw or {})))
    o.seed_elements(4.0, lat0, number=number, radius=radius, time=T0)
    o.run(steps=steps, time_step=dt)
    return o


def values(o, var):
    return np.asarray(o.result[var].values)


def assert_slice_close(got, want, var):
    """The port against the JAX package: NaN where NaN, the median
    difference and the outlier share within the slice tolerance."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want)), var
    d = np.abs(got - want)[~np.isnan(want)]
    assert np.median(d) <= MEDIAN_ATOL[var], (var, np.median(d))
    assert np.mean(d > OUTLIER_ATOL[var]) <= OUTLIER_SHARE, (var, d.max())


def assert_matches_jax(ot, oj, variables=("lon", "lat")):
    """The port's tiled run reproduces the JAX package's tiled run: the
    same statuses, positions within the slice tolerance."""
    np.testing.assert_array_equal(values(ot, "status"), values(oj, "status"))
    for var in variables:
        assert_slice_close(values(ot, var), values(oj, var), var)


def assert_matches_gold(tiled, gold, variables=("lon", "lat"),
                        atol=GOLD_ATOL):
    for var in variables:
        np.testing.assert_allclose(values(tiled, var), values(gold, var),
                                   atol=atol)


def assert_same_tiles(ot, oj):
    """The per-tile buffers themselves: the JAX package's final state in
    its flat ``t*cap+s`` layout, taken into per-tile states by
    ``interop.tile_states_from_numpy``, holds the same elements in the
    same slots of the same tiles as the port's, and back through
    ``tile_states_to_numpy`` it is the flat layout again."""
    from opendrift_tpu_torch import interop
    jflat = {k: np.asarray(v) for k, v in oj.state.data.items()}
    tflat = interop.element_state_to_numpy(ot.state)
    jt = interop.tile_states_from_numpy(jflat, 8, MESH)
    tt = interop.tile_states_from_numpy(tflat, 8, MESH)
    assert [s.capacity for s in jt] == [s.capacity for s in tt] \
        == [ot._dd.cap] * 8
    for a, b in zip(tt, jt):
        ids = a.data["ID"].numpy()
        np.testing.assert_array_equal(ids, b.data["ID"].numpy())
        np.testing.assert_array_equal(a.data["status"].numpy(),
                                      b.data["status"].numpy())
        occ = ids > 0
        for var in ("lon", "lat"):
            np.testing.assert_allclose(a.data[var].numpy()[occ],
                                       b.data[var].numpy()[occ], atol=1e-4)
    back = interop.tile_states_to_numpy(jt)
    for k in ("ID", "status", "lon"):
        np.testing.assert_array_equal(back[k], jflat[k])
