"""Particle sharding in the port (``opendrift_tpu_torch/parallel/mesh.py``):
a run over ``set_mesh(["cpu"] * k)`` is bit-equal to the unsharded run,
as the JAX package's sharded run is to its own
(``tests/test_domain_decomposition.py::test_full_run_sharded_bit_identical``).
Each tile draws the threefry counters of its global slots, and the steps
that reduce over every element see the whole element axis, also for a
model with a (C, N) mass matrix (OpenOil).

Each shard here is a multiple of 16 elements long: on the CPU, PyTorch's
vectorised transcendentals (16 float32 lanes under AVX-512) take a scalar
path for an array's ragged tail, which may round differently by an ulp,
so an element's value could depend on its place in a shorter array.  On
the card every element takes the same path; ``chip_smoke.py`` holds a
2M-element sharded run bit-equal to the plain one there."""

from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch import rng
from opendrift_tpu_torch.parallel import mesh as M

T0 = datetime(2020, 1, 1)


@pytest.mark.parametrize("draw", ["bits", "uniform", "normal",
                                  "exponential"])
def test_partitioned_draws_are_slices_of_the_global_draw(draw):
    key = rng.fold_in(rng.PRNGKey(7), 3)
    fn = {"bits": lambda k, s: rng.bits(k, s),
          "uniform": lambda k, s: rng.uniform(k, s),
          "normal": lambda k, s: rng.normal(k, s),
          "exponential": lambda k, s: rng.exponential(k, s)}[draw]
    full = fn(key, (3, 40))
    for offset in (0, 8, 32):
        with rng.element_partition(offset, 8, 40):
            part = fn(key, (3, 8))
            other = fn(key, (3, 5))       # another length: not the axis
        assert torch.equal(part, full[:, offset:offset + 8])
        assert torch.equal(other, fn(key, (3, 5)))
    assert torch.equal(rng.bits(key, (3, 8), partition=(8, 40)),
                       rng.bits(key, (3, 40))[:, 8:16])


def test_gathered_is_the_identity_outside_a_sharded_step():
    x = torch.arange(5.0)
    assert M.gathered(x) is x


def _forcing(seed=0, nx=24, ny=20, nz=6, nt=4):
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0, 2, 5, 10, 20, 40][:nz], np.float32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    f = np.float32
    ocean = {
        "x_sea_water_velocity": (0.3 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f),
        "y_sea_water_velocity": (0.3 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f),
        "sea_floor_depth_below_sea_level": r.uniform(
            30, 80, (ny, nx)).astype(f),
        "sea_water_temperature": r.uniform(5, 12, (nt, nz, ny, nx)).astype(f),
        "sea_water_salinity": r.uniform(33, 35, (nt, nz, ny, nx)).astype(f)}
    wind = {"x_wind": (5 + 3 * r.standard_normal((nt, ny, nx))).astype(f),
            "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(f)}
    wave = {"sea_surface_wave_significant_height":
            r.uniform(0.5, 2.5, (nt, ny, nx)).astype(f),
            "sea_surface_wave_stokes_drift_x_velocity":
            r.uniform(0.0, 0.1, (nt, ny, nx)).astype(f),
            "sea_surface_wave_stokes_drift_y_velocity":
            r.uniform(-0.03, 0.03, (nt, ny, nx)).astype(f)}
    return ocean, wind, wave, x, y, depths, times


def _assert_runs_equal(a, b, state_keys=()):
    assert list(a.result.variables) == list(b.result.variables)
    for name in a.result.variables:
        va, vb = a.result[name].values, b.result[name].values
        assert va.shape == vb.shape, name
        assert np.array_equal(va, vb, equal_nan=True), name
    n = a._n_real_elements
    for k in state_keys:
        sa = a.state.data[k][..., :n].numpy()
        sb = b.state.data[k][..., :n].numpy()
        assert np.array_equal(sa, sb, equal_nan=True), k


@pytest.mark.parametrize("n,tiles", [(128, 8), (250, 8), (95, 3)])
def test_oceandrift_sharded_run_is_bit_equal(n, tiles):
    """3D gridded forcing, RK4, Visser mixing and horizontal diffusion;
    an element count that does not split evenly is padded with
    never-released elements and still equals the plain run."""
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader
    ocean, wind, _, x, y, depths, times = _forcing()

    def run(mesh):
        o = OceanDrift(loglevel=40, device="cpu")
        if mesh:
            o.set_mesh(mesh)
        o.add_reader(ArrayReader(ocean, x, y, times, depths=depths))
        o.add_reader(ArrayReader(wind, x, y, times))
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:vertical_mixing", True)
        o.set_config("drift:horizontal_diffusivity", 10.0)
        o.set_config("drift:current_uncertainty", 0.05)
        o.seed_elements(lon=4.0, lat=59.8, radius=5000, number=n,
                        time=times[0], z=-np.linspace(0, 15, n))
        o.run(duration=timedelta(hours=4), time_step=900,
              time_step_output=3600)
        return o

    s, u = run(["cpu"] * tiles), run(None)
    assert s._sharding is not None and u._sharding is None
    assert s._sharding.mesh.n_tiles == tiles
    assert s._n_padded_elements == -(-n // tiles) * tiles
    assert s.result["lon"].shape == (n, 5)
    _assert_runs_equal(s, u, ("lon", "lat", "z", "status"))


def test_openoil_sharded_run_is_bit_equal():
    """OpenOil's (C, N) mass matrix shards on its last axis; its mean
    droplet volume, slick thickness histogram and wave-height test reduce
    over every element, as in the plain run."""
    from opendrift_tpu_torch.models import OpenOil
    from opendrift_tpu_torch.fields import ArrayReader
    ocean, wind, wave, x, y, depths, times = _forcing()

    def run(mesh):
        o = OpenOil(loglevel=40, device="cpu")
        if mesh:
            o.set_mesh(mesh)
        o.add_reader(ArrayReader(ocean, x, y, times, depths=depths))
        o.add_reader(ArrayReader(wind, x, y, times))
        o.add_reader(ArrayReader(wave, x, y, times))
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("processes:update_oilfilm_thickness", True)
        o.set_config("drift:horizontal_diffusivity", 5.0)
        o.seed_elements(lon=4.2, lat=59.8, radius=3000, number=128,
                        time=times[0], z=0.0, m3_per_hour=80.0)
        o.run(duration=timedelta(hours=3), time_step=900,
              time_step_output=3600)
        return o

    s, u = run(["cpu"] * 4), run(None)
    assert s._sharding is not None
    assert s.state.data["mass_components"].shape[-1] == 128
    assert s.state.data["mass_components"].dim() == 2
    _assert_runs_equal(s, u, ("mass_components", "diameter", "z",
                              "oil_film_thickness"))
    # the run really entrained and weathered oil
    assert (u.result["z"].values[:, -1] < 0).any()
    assert np.nanmax(u.result["mass_evaporated"].values) > 0
