"""The CUDA kernels' wrappers (opendrift_tpu_torch/ops/mixing.py) and the
card path of the port, without JAX, so the file also runs on a machine
that has a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py

Tests marked ``gpu`` skip without a card.  Tolerances: a kernel and its
plain version evaluate the same float32 expressions in the same order,
and the kernels are built without contracted multiply-adds
(``-fmad=false``), so they must agree to the bit.  A run on the card
against the same run on the CPU is held to the slice tolerance of
tests/test_torch_oceandrift.py.
"""

from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch.ops import mixing

MODELS = list(mixing.WINDSPEED_MODELS)


def _inputs(n, device, seed=0):
    r = np.random.default_rng(seed)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < 0.05] = 0.0
    zmin = -r.uniform(5.0, 80.0, n)
    f = {"z": np.maximum(z, zmin), "moving": (r.random(n) > 0.05) * 1.0,
         "w": r.normal(0.0, 1e-4, n), "wind": r.uniform(0.0, 20.0, n),
         "mld": r.uniform(10.0, 60.0, n), "zmin": zmin}
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
         for k, v in f.items()}
    t["elem"] = torch.as_tensor(r.integers(1 << 24, (1 << 31) - 1, n),
                                dtype=torch.int32, device=device)
    L, h = 26, 2.0
    K = 1e-2 * np.exp(-np.arange(L) * h / 20.0)[:, None] * r.uniform(
        0.5, 1.5, n)[None]
    t["Kprof"] = torch.as_tensor(K, dtype=torch.float32, device=device)
    t["gradK"] = torch.as_tensor(-np.gradient(K, axis=0) / h,
                                 dtype=torch.float32, device=device)
    return t, int(r.integers(0, 1 << 32)), h


def _windspeed(t, seed, model, at_surface, plain=False):
    kw = dict(ntimes=15, dt_mix=60.0, model=model, bg=1.2e-5,
              mixing_at_surface=at_surface)
    args = (t["z"], t["moving"], t["w"], t["wind"], t["mld"], t["zmin"])
    if plain:
        return mixing.visser_mixing_plain(*args, t["elem"], seed, **kw)
    return mixing.visser_mixing(*args, seed, elem=t["elem"], **kw)


def _profile(t, seed, h, at_surface, plain=False):
    kw = dict(ntimes=15, dt_mix=60.0, h=h, mixing_at_surface=at_surface)
    args = (t["z"], t["moving"], t["w"], t["Kprof"], t["gradK"], t["zmin"])
    if plain:
        return mixing.visser_mixing_profile_plain(*args, t["elem"], seed,
                                                  **kw)
    return mixing.visser_mixing_profile(*args, seed, elem=t["elem"], **kw)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("at_surface", [False, True])
def test_cpu_tensors_take_the_plain_versions(monkeypatch, at_surface):
    """On CPU tensors the wrappers neither build nor launch a kernel."""
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")
    monkeypatch.setattr(mixing, "load_library", no_build)
    t, seed, h = _inputs(3001, "cpu")
    counts = (mixing.visser_mixing.launches,
              mixing.visser_mixing_profile.launches)
    for model in MODELS:
        assert torch.equal(_windspeed(t, seed, model, at_surface),
                           _windspeed(t, seed, model, at_surface, True))
    assert torch.equal(_profile(t, seed, h, at_surface),
                       _profile(t, seed, h, at_surface, True))
    assert counts == (mixing.visser_mixing.launches,
                      mixing.visser_mixing_profile.launches)


def test_other_devices_raise():
    """Only a CPU tensor takes the plain version; a tensor on a device
    that has no kernel raises instead of running the plain version."""
    z = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mixing.visser_mixing(z, z, z, z, z, z, 0, ntimes=2, dt_mix=60.0,
                             model="stepfunction", bg=1e-5,
                             mixing_at_surface=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mixing.visser_mixing_profile(
            z, z, z, torch.zeros(3, 8, device="meta"),
            torch.zeros(3, 8, device="meta"), z, 0, ntimes=2, dt_mix=60.0,
            h=1.0, mixing_at_surface=False)


def test_plain_versions_keep_the_physical_bounds():
    t, seed, h = _inputs(2000, "cpu", seed=1)
    for model in MODELS:
        z = _windspeed(t, seed, model, False, True)
        assert torch.isfinite(z).all()
        assert (z <= 0).all() and (z >= t["zmin"]).all()
        frozen = t["moving"] == 0
        # frozen elements feel only buoyancy, which moving=0 also stops
        assert torch.equal(z[frozen], t["z"][frozen].clamp_max(0.0))
        surface = (t["z"] == 0) & ~frozen
        assert (z[surface] == 0).all()           # no mixing at the surface


@pytest.mark.gpu
@pytest.mark.parametrize("at_surface", [False, True])
def test_kernels_bit_equal_to_plain_on_the_card(at_surface):
    _card()
    t, seed, h = _inputs(100_003, "cuda")
    for model in MODELS:
        before = mixing.visser_mixing.launches
        got = _windspeed(t, seed, model, at_surface)
        assert mixing.visser_mixing.launches == before + 1
        assert torch.equal(got, _windspeed(t, seed, model, at_surface, True))
    before = mixing.visser_mixing_profile.launches
    got = _profile(t, seed, h, at_surface)
    assert mixing.visser_mixing_profile.launches == before + 1
    assert torch.equal(got, _profile(t, seed, h, at_surface, True))
    torch.cuda.synchronize()


def _run(device, model):
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader
    r = np.random.default_rng(0)
    nt, nz, ny, nx = 4, 6, 20, 24
    t0 = datetime(2020, 1, 1)
    times = [t0 + timedelta(hours=3 * i) for i in range(nt)]
    depths = np.array([0, 2, 5, 10, 20, 40], np.float32)
    x, y = np.linspace(3.0, 5.0, nx), np.linspace(59.0, 60.5, ny)
    f32 = np.float32
    o = OceanDrift(loglevel=40, device=device)
    o.add_reader(ArrayReader({
        "x_sea_water_velocity": (0.3 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f32),
        "y_sea_water_velocity": (0.3 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f32),
        "sea_floor_depth_below_sea_level": r.uniform(
            30, 80, (ny, nx)).astype(f32)}, x, y, times, depths=depths))
    o.add_reader(ArrayReader({
        "x_wind": (5 + 3 * r.standard_normal((nt, ny, nx))).astype(f32),
        "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(f32)},
        x, y, times))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", model)
    o.set_config("environment:fallback:ocean_vertical_diffusivity", 1e-3)
    o.seed_elements(lon=r.uniform(3.5, 4.5, 512),
                    lat=r.uniform(59.4, 60.1, 512),
                    z=-r.uniform(0, 20, 512), time=t0)
    o.run(duration=timedelta(hours=5), time_step=900, time_step_output=3600)
    return o.result


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["windspeed_Large1994", "constant"])
def test_run_on_the_card_matches_the_cpu(model):
    _card()
    kernel = (mixing.visser_mixing_profile if model == "constant"
              else mixing.visser_mixing)
    before = kernel.launches
    card = _run("cuda", model)
    assert kernel.launches == before + 20          # one launch per step
    cpu = _run("cpu", model)
    bounds = {"lon": (1e-6, 1e-4), "lat": (1e-6, 1e-4), "z": (1e-4, 0.1)}
    for var, (median_atol, outlier_atol) in bounds.items():
        a = np.asarray(card[var].values, np.float64)
        b = np.asarray(cpu[var].values, np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        d = np.abs(a - b)[~np.isnan(b)]
        assert np.median(d) <= median_atol and np.mean(
            d > outlier_atol) <= 0.02, (var, d.max())
