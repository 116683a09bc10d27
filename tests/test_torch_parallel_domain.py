"""The port's standalone domain-decomposition stepper
(``opendrift_tpu_torch/parallel/domain.py``) against the JAX package's
(``opendrift_tpu/parallel/domain.py``) on its 8-virtual-device mesh: the
counterparts of the four tests of ``tests/test_domain_decomposition.py``,
the port's mesh being ``["cpu"] * 8``.  Same field, same particles; the
trajectories agree to float32 rounding, the migration keeps every ID."""

from datetime import timedelta

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from opendrift_tpu.parallel import domain as J
from opendrift_tpu_torch.parallel import domain as T

MESH = ["cpu"] * 8
ATOL = 1e-3          # metres: float32 rounding of two eager programs


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("tiles",))


def _make_field(ny=64, nx=32):
    dy = dx = 100.0
    y, x = np.mgrid[0:ny, 0:nx]
    u = 0.5 + 0.3 * np.sin(2 * np.pi * y / ny)
    v = 0.8 * np.cos(2 * np.pi * x / nx)
    blocks = np.stack([u, v]).astype(np.float32)[:, None]
    return blocks, 0.0, dy, 0.0, dx


def _truth(blocks, x, y, dt, nsteps, dy, dx):
    u, v = blocks[0, 0], blocks[1, 0]
    ny, nx = u.shape
    x, y = x.copy(), y.copy()
    for _ in range(nsteps):
        xi = np.clip(x / dx, 0, nx - 1.001)
        yi = np.clip(y / dy, 0, ny - 1.001)
        x0 = np.floor(xi).astype(int)
        y0 = np.floor(yi).astype(int)
        fx, fy = xi - x0, yi - y0

        def bil(f):
            return (f[y0, x0] * (1 - fy) * (1 - fx)
                    + f[y0, x0 + 1] * (1 - fy) * fx
                    + f[y0 + 1, x0] * fy * (1 - fx)
                    + f[y0 + 1, x0 + 1] * fy * fx)
        x = x + bil(u) * dt
        y = y + bil(v) * dt
    return x, y


def _both(blocks, y0, dy, x0, dx, px, py, cap, dt, nsteps, leavers,
          migrate_every=1):
    """(JAX particles, port particles) after the same tiled advance."""
    out = []
    for pkg in (J, T):
        grid = pkg.TiledGrid(blocks, [0.0], y0, dy, x0, dx, n_tiles=8,
                             halo=3)
        p = pkg.assign_particles_to_tiles(px, py, grid, cap=cap)
        if pkg is J:
            mesh = _jax_mesh()
            p = {k: jnp.asarray(v) for k, v in p.items()}
            core, times = grid.device_arrays(mesh)
            adv = J.make_tiled_stepper(grid, mesh, dt, nsteps, leavers,
                                       migrate_every)
            p = jax.device_get(adv(core, times, p, jnp.float32(0.0)))
        else:
            p = {k: torch.as_tensor(v) for k, v in p.items()}
            core, times = grid.device_arrays(MESH)
            adv = T.make_tiled_stepper(grid, MESH, dt, nsteps, leavers,
                                       migrate_every)
            p = {k: v.numpy() for k, v in
                 adv(core, times, p, np.float32(0.0)).items()}
        out.append(p)
    return out


def test_halo_trajectories_match_single_device():
    blocks, y0, dy, x0, dx = _make_field()
    rng = np.random.RandomState(1)
    N = 300
    px = rng.uniform(200, 2800, N).astype(np.float32)
    py = rng.uniform(200, 6000, N).astype(np.float32)
    jp, tp = _both(blocks, y0, dy, x0, dx, px, py, 256, 30.0, 40, 64)
    got_x, got_y = T.gather_particles(tp)
    want_x, want_y = _truth(blocks, px.astype(np.float64),
                            py.astype(np.float64), 30.0, 40, dy, dx)
    assert np.isfinite(got_x).all()
    np.testing.assert_allclose(got_x, want_x, atol=0.5)
    np.testing.assert_allclose(got_y, want_y, atol=0.5)
    jx, jy = J.gather_particles(jp)
    np.testing.assert_allclose(got_x, jx, atol=ATOL)
    np.testing.assert_allclose(got_y, jy, atol=ATOL)
    # the same elements sit in the same slots of the same tiles
    np.testing.assert_array_equal(tp["pid"], jp["pid"])
    np.testing.assert_array_equal(tp["alive"], jp["alive"])


@pytest.mark.parametrize("migrate_every", [1, 4])
def test_migration_conserves_particles(migrate_every):
    blocks, y0, dy, x0, dx = _make_field()
    blocks[1] = 1.5
    N = 200
    rng = np.random.RandomState(2)
    px = rng.uniform(100, 3000, N).astype(np.float32)
    py = rng.uniform(100, 1000, N).astype(np.float32)
    jp, tp = _both(blocks, y0, dy, x0, dx, px, py, 300, 30.0, 60, 64,
                   migrate_every)
    pid = tp["pid"][tp["alive"]]
    assert len(pid) == N
    assert sorted(pid.tolist()) == list(range(N))
    per_tile = tp["alive"].sum(axis=1)
    assert per_tile[0] == 0 and per_tile[1] == 0
    assert per_tile[3] + per_tile[4] == N
    np.testing.assert_array_equal(per_tile, jp["alive"].sum(axis=1))
    np.testing.assert_array_equal(tp["pid"], jp["pid"])


def test_determinism_across_runs():
    blocks, y0, dy, x0, dx = _make_field()
    px = np.linspace(300, 2800, 50).astype(np.float32)
    py = np.linspace(300, 6000, 50).astype(np.float32)
    grid = T.TiledGrid(blocks, [0.0], y0, dy, x0, dx, n_tiles=8, halo=3)
    outs = []
    for _ in range(2):
        p = {k: torch.as_tensor(v) for k, v in
             T.assign_particles_to_tiles(px, py, grid, cap=128).items()}
        core, times = grid.device_arrays(MESH)
        adv = T.make_tiled_stepper(grid, MESH, 30.0, 30, 32)
        outs.append(T.gather_particles(adv(core, times, p, 0.0)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    jp, tp = _both(blocks, y0, dy, x0, dx, px, py, 128, 30.0, 30, 32)
    np.testing.assert_allclose(outs[0][0], J.gather_particles(jp)[0],
                               atol=ATOL)


def test_full_run_sharded_bit_identical():
    """Public run() with parallel:particle_sharding over ["cpu"] * 8 is
    bit-identical to the unsharded run (partitionable draws: each tile
    draws the counters of its global slots), and equal to the JAX
    package's sharded run within the slice tolerance."""
    from opendrift_tpu.models import OceanDrift as JOceanDrift
    from opendrift_tpu.fields import DoubleGyre as JDoubleGyre
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import DoubleGyre

    def run(pkg, sharded):
        if pkg == "jax":
            o, dg = JOceanDrift(loglevel=40), JDoubleGyre(
                epsilon=0.25, omega=0.628, A=0.1)
        else:
            o, dg = OceanDrift(loglevel=40, device="cpu"), DoubleGyre(
                epsilon=0.25, omega=0.628, A=0.1)
            if sharded:
                o.set_mesh(MESH)
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:horizontal_diffusivity", 5.0)
        o.set_config("parallel:particle_sharding", sharded)
        o.add_reader(dg)
        lon, lat = dg.xy2lonlat([0.9], [0.5])
        o.seed_elements(lon, lat, radius=0.1, number=2048,
                        time=dg.initial_time)
        o.run(duration=timedelta(seconds=5), time_step=0.5)
        return o

    s, u = run("torch", True), run("torch", False)
    assert s._sharding is not None and s._sharding.mesh.n_tiles == 8
    assert u._sharding is None
    for var in ("lon", "lat"):
        assert np.array_equal(s.result[var].values, u.result[var].values,
                              equal_nan=True)
    j = run("jax", True)
    np.testing.assert_allclose(s.result["lon"].values,
                               j.result["lon"].values, atol=1e-5)
    np.testing.assert_allclose(s.result["lat"].values,
                               j.result["lat"].values, atol=1e-5)
