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

import importlib
import pkgutil
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch import examples
from opendrift_tpu_torch.ops import mixing, pack, philox
from opendrift_tpu_torch.tools import kernel_check, pack_ab

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


OIL_ARGS = ("z", "diam", "moving", "wind", "mld", "zmin", "p_ent", "d_cand",
            "zb", "kw", "kw2", "nu_w")


def _oil_inputs(n, device, seed=2):
    """The oil kernel's inputs: those of ``_inputs`` with 30% of the
    elements at the surface, entrainment probabilities over (0, 0.3),
    carried diameters (a third at the schema's default 0), intrusion
    depths and the Tkalich factors."""
    t, seed_u32, _ = _inputs(n, device, seed)
    r = np.random.default_rng(seed + 100)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < 0.3] = 0.0
    diam = r.uniform(1e-5, 2e-3, n)
    diam[r.random(n) < 0.33] = 0.0
    rhopr = r.uniform(0.8, 0.99, n)
    nu_w = r.uniform(1e-6, 1.8e-6, n)
    f = {"z": z, "diam": diam, "p_ent": r.uniform(0.0, 0.3, n),
         "d_cand": r.uniform(1e-6, 3e-3, n), "zb": r.uniform(0.0, 6.0, n),
         "kw": 2.0 * 9.81 * (1.0 - rhopr) / (9.0 * nu_w),
         "kw2": np.sqrt(16.0 * 9.81 * (1.0 - rhopr) / 3.0), "nu_w": nu_w}
    for k, v in f.items():
        t[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
    t["z"] = torch.maximum(t["z"], t["zmin"])
    return t, seed_u32


def _oil(t, seed, model, at_surface, keep_diam, plain=False):
    kw = dict(ntimes=15, dt_mix=60.0, model=model, bg=1.2e-5,
              mixing_at_surface=at_surface, keep_diam=keep_diam)
    args = [t[k] for k in OIL_ARGS]
    if plain:
        return mixing.visser_mixing_oil_plain(*args, t["elem"], seed, **kw)
    return mixing.visser_mixing_oil(*args, seed, elem=t["elem"], **kw)


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


@pytest.mark.parametrize("keep_diam", [False, True])
@pytest.mark.parametrize("at_surface", [False, True])
def test_oil_wrapper_takes_the_plain_version_on_cpu(monkeypatch, at_surface,
                                                    keep_diam):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")
    monkeypatch.setattr(mixing, "load_library", no_build)
    t, seed = _oil_inputs(3001, "cpu")
    count = mixing.visser_mixing_oil.launches
    for model in MODELS:
        got = _oil(t, seed, model, at_surface, keep_diam)
        want = _oil(t, seed, model, at_surface, keep_diam, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        z, diam = got
        assert torch.isfinite(z).all() and torch.isfinite(diam).all()
        assert (z <= 0).all() and (z >= t["zmin"]).all()
        assert torch.equal(diam, t["diam"]) == keep_diam
        entrained = diam != t["diam"]
        assert torch.equal(diam[entrained], t["d_cand"][entrained])
    assert count == mixing.visser_mixing_oil.launches


def test_oil_wrapper_checks_its_arguments():
    t, seed = _oil_inputs(64, "cpu")
    with pytest.raises(ValueError, match="no mixing kernel"):
        _oil(t, seed, "constant", False, False)
    with pytest.raises(ValueError, match="expected shape"):
        _oil({**t, "p_ent": torch.zeros(3)}, seed, "stepfunction", False,
             False)
    z = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mixing.visser_mixing_oil(z, z, z, z, z, z, z, z, z, z, z, z, 0,
                                 ntimes=2, dt_mix=60.0, model="stepfunction",
                                 bg=1e-5, mixing_at_surface=False,
                                 keep_diam=False)


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 257, 100_001])
def test_mixing_kernels_equal_plain_on_edge_cases_on_the_card(n):
    """The shared check inputs: NaN seafloors, mixed layers thinner than 1 m
    and outside the reciprocal's range (0, subnormal, huge, inf, NaN),
    frozen elements, entrainment probabilities of 0 and 1; equal by value,
    NaN where the plain version is NaN."""
    _card()
    from opendrift_tpu_torch.tools import kernel_check as ladder
    t, seed, h = ladder.kernel_inputs(n, "cuda")
    to, oil_seed = ladder.oil_kernel_inputs(n, "cuda")
    for model in MODELS:
        assert ladder.same(_windspeed(t, seed, model, False),
                           _windspeed(t, seed, model, False, True))
        for keep_diam in (False, True):
            got = _oil(to, oil_seed, model, False, keep_diam)
            want = _oil(to, oil_seed, model, False, keep_diam, True)
            assert ladder.same(got[0], want[0])
            assert ladder.same(got[1], want[1])
    assert ladder.same(_profile(t, seed, h, False),
                       _profile(t, seed, h, False, True))


@pytest.mark.gpu
@pytest.mark.parametrize("case", kernel_check.PROFILE_EDGE_CASES)
def test_profile_kernel_equals_plain_on_its_edge_cases_on_the_card(case):
    """The profile kernel's edge cases (chip_smoke.py check_profile_edges):
    blocks spanning every level, walks of 10 levels a substep, 2 and 201
    levels, NaN depths; equal by value, NaN where the plain version is
    NaN."""
    _card()
    t, seed, h = kernel_check.profile_edge_inputs(case, 100_003, "cuda")
    for at_surface in (False, True):
        before = mixing.visser_mixing_profile.launches
        got = _profile(t, seed, h, at_surface)
        assert mixing.visser_mixing_profile.launches == before + 1
        assert kernel_check.same(got, _profile(t, seed, h, at_surface, True))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_reciprocal_quotient_is_the_division_for_every_depth_on_the_card():
    """Exhaustive: every float32 mixed-layer depth of the range that takes
    the reciprocal against every numerator the walk can divide by it
    (some 1e13 quotients, seconds on an H100), bit for bit against ``/``."""
    _card()
    lo, hi = mixing.RECIPROCAL_MLD_RANGE
    compared, differing, where = mixing.reciprocal_quotient_sweep(lo, hi)
    assert compared > 1e13 and differing == 0, (compared, differing, where)
    # a thin mixed layer has few levels: 0 to 3, and four more numerators
    assert mixing.reciprocal_quotient_sweep(0.25, 0.25) == (8, 0, None)


def test_quotient_sweep_needs_a_card_and_a_normal_range():
    with pytest.raises(ValueError, match="CUDA device"):
        mixing.reciprocal_quotient_sweep(1.0, 2.0, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="positive normal"):
            mixing.reciprocal_quotient_sweep(0.0, 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("keep_diam", [False, True])
@pytest.mark.parametrize("at_surface", [False, True])
def test_oil_kernel_equals_plain_on_the_card(at_surface, keep_diam):
    """Equal by value on both outputs (+0 and -0 count as equal)."""
    _card()
    t, seed = _oil_inputs(100_003, "cuda")
    for model in MODELS:
        before = mixing.visser_mixing_oil.launches
        z, diam = _oil(t, seed, model, at_surface, keep_diam)
        assert mixing.visser_mixing_oil.launches == before + 1
        pz, pdiam = _oil(t, seed, model, at_surface, keep_diam, True)
        assert torch.equal(z, pz) and torch.equal(diam, pdiam)
        if not at_surface:     # held at the surface, entrained from it
            assert (z[t["z"] == 0] < 0).any()
    torch.cuda.synchronize()


def _run(device, model, **config):
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
    for key, value in config.items():
        o.set_config(key, value)
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


PHILOX_KEY = (276534068, 1641862660, 276534068, 1641862660)
PHILOX_CARRY_KEY = (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFD, 0xFFFFFFFF)


@pytest.mark.gpu
@pytest.mark.parametrize("key,lead,last,offset,n_global", [
    (PHILOX_KEY, 1, 1, 0, 1), (PHILOX_KEY, 3, 5, 2, 11),
    (PHILOX_KEY, 2, 13, 91, 100),
    (PHILOX_KEY, 1, 2_000_000, 0, 2_000_000),
    (PHILOX_KEY, 2, 2_000_000, 1_000_003, 4_000_006),
    (PHILOX_CARRY_KEY, 2, 4097, 0, 4097)])
def test_philox_bits_equal_plain_on_the_card(key, lead, last, offset,
                                             n_global):
    _card()
    before = philox.philox_bits.launches
    got = philox.philox_bits(key, lead, last, offset, n_global, "cuda")
    want = philox.philox_bits_plain(key, lead, last, offset, n_global,
                                    "cuda")
    torch.cuda.synchronize()
    assert philox.philox_bits.launches == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.gpu
def test_rbg_run_on_the_card_matches_the_cpu():
    """general:rng='rbg' with horizontal diffusion: the normals through
    the Philox kernel on the card, its plain version on the CPU; every
    status equal, the slice tolerance."""
    _card()
    before = philox.philox_bits.launches
    config = {"general:rng": "rbg", "drift:horizontal_diffusivity": 10.0}
    card = _run("cuda", "windspeed_Large1994", **config)
    assert philox.philox_bits.launches >= before + 20   # once a step
    cpu = _run("cpu", "windspeed_Large1994", **config)
    np.testing.assert_array_equal(card["status"].values,
                                  cpu["status"].values)
    bounds = {"lon": (1e-6, 1e-4), "lat": (1e-6, 1e-4), "z": (1e-4, 0.1)}
    for var, (median_atol, outlier_atol) in bounds.items():
        a = np.asarray(card[var].values, np.float64)
        b = np.asarray(cpu[var].values, np.float64)
        d = np.abs(a - b)[~np.isnan(b)]
        assert np.median(d) <= median_atol and np.mean(
            d > outlier_atol) <= 0.02, (var, d.max())


@pytest.mark.gpu
def test_openoil_run_on_the_card_goes_through_the_oil_kernel():
    _card()
    from opendrift_tpu_torch.models import OpenOil
    from opendrift_tpu_torch.fields import ConstantReader
    results = {}
    for device in ("cuda", "cpu"):
        o = OpenOil(loglevel=40, device=device)
        o.add_reader(ConstantReader({
            "x_wind": 11.0, "y_wind": 2.0, "x_sea_water_velocity": 0.1,
            "y_sea_water_velocity": 0.0,
            "sea_floor_depth_below_sea_level": 60.0}))
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.seed_elements(lon=4.0, lat=60.0, number=512, radius=500,
                        time=datetime(2020, 1, 1), m3_per_hour=10.0)
        before = (mixing.visser_mixing_oil.launches,
                  mixing.visser_mixing.launches)
        o.run(duration=timedelta(hours=2), time_step=900,
              time_step_output=3600)
        after = (mixing.visser_mixing_oil.launches,
                 mixing.visser_mixing.launches)
        steps = 8 if device == "cuda" else 0
        assert after == (before[0] + steps, before[1])
        results[device] = o
    card, cpu = results["cuda"], results["cpu"]
    assert card.state.data["mass_components"].device.type == "cuda"
    assert card.state.data["mass_components"].dtype == torch.float32
    np.testing.assert_array_equal(card.result["status"].values,
                                  cpu.result["status"].values)
    for var, atol in (("mass_oil", 1e-3), ("mass_evaporated", 1e-3),
                      ("mass_dispersed", 1e-3), ("water_fraction", 1e-5)):
        np.testing.assert_allclose(card.result[var].values,
                                   cpu.result[var].values, rtol=1e-4,
                                   atol=atol, err_msg=var)
    z_card = np.asarray(card.result["z"].values, np.float64)
    z_cpu = np.asarray(cpu.result["z"].values, np.float64)
    assert np.mean(np.abs(z_card - z_cpu) > 0.1) <= 0.05
    assert (z_card[:, -1] < 0).any()


def _plast_run(n=200_003):
    from opendrift_tpu_torch.models import PlastDrift
    from opendrift_tpu_torch.fields import ArrayReader
    r = np.random.default_rng(2)
    nt, ny, nx = 3, 20, 24
    t0 = datetime(2021, 4, 1)
    times = [t0 + timedelta(hours=3 * i) for i in range(nt)]
    x, y = np.linspace(3.0, 5.0, nx), np.linspace(59.0, 60.5, ny)
    f32 = np.float32
    o = PlastDrift(loglevel=40, device="cuda")
    o.add_reader(ArrayReader({
        "x_sea_water_velocity": (0.2 * r.standard_normal(
            (nt, ny, nx))).astype(f32),
        "y_sea_water_velocity": (0.2 * r.standard_normal(
            (nt, ny, nx))).astype(f32),
        "x_wind": (8 + 3 * r.standard_normal((nt, ny, nx))).astype(f32),
        "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(f32)},
        x, y, times))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("vertical_mixing:mixingmodel", "randomwalk")
    o.seed_elements(lon=r.uniform(3.5, 4.5, n), lat=r.uniform(59.4, 60.1, n),
                    z=-r.uniform(0, 5, n), time=t0,
                    terminal_velocity=r.uniform(0.0, 0.01, n))
    o.run(duration=timedelta(hours=2), time_step=900, time_step_output=3600)
    return o.result


@pytest.mark.gpu
def test_plastdrift_randomwalk_runs_k1_once_a_step_and_equals_plain(
        monkeypatch):
    """PlastDrift with 'randomwalk' (Sundby1983, rising elements) launches
    the windspeed kernel once a step; the same run with the kernel's plain
    version in its place, on the same card, is equal to the bit."""
    _card()
    before = mixing.visser_mixing.launches
    card = _plast_run()
    assert mixing.visser_mixing.launches == before + 8
    kernel = mixing.visser_mixing

    def plain(z, moving, w, wind, mld, zmin, seed, *, elem, **kw):
        return mixing.visser_mixing_plain(z, moving, w, wind, mld, zmin,
                                          elem, seed, **kw)
    monkeypatch.setattr(mixing, "visser_mixing", plain)
    yardstick = _plast_run()
    assert kernel.launches == before + 8
    for var in ("lon", "lat", "z", "status"):
        np.testing.assert_array_equal(card[var].values,
                                      yardstick[var].values, err_msg=var)
    z = np.asarray(card["z"].values)
    assert (z <= 0).all() and (z[:, -1] > -1).mean() > (z[:, 0] > -1).mean()


# ------------------------------------------------ the row-gather kernels --

from opendrift_tpu_torch.ops import gather  # noqa: E402
from opendrift_tpu_torch.tools import gather_ab  # noqa: E402

GATHER_CASES = [      # R, C, N, table type, index type
    (250_000, 24, 200_003, torch.float32, torch.int32),   # the tool's shape
    (2_000, 24, 200_003, torch.float32, torch.int64),     # fits shared memory
    (40_000, 88, 100_001, torch.float32, torch.int64),    # an 'xyz' ocean row
    (5_000, 22, 100_001, torch.float32, torch.int32),     # 88 B: 8-byte copies
    (5_000, 23, 100_001, torch.float32, torch.int64),     # 92 B: 4-byte copies
    (3_000, 5, 100_001, torch.float16, torch.int64),      # 10 B: 2-byte copies
    (3_000, 48, 100_001, torch.float16, torch.int32),     # compensated data
    (100, 2_000, 3_001, torch.float32, torch.int32),      # one row a stage
    (5_000, 4, 100_001, torch.float32, torch.int64),      # 16 B rows
    (50, 1_024, 3_001, torch.float32, torch.int32),       # 4096 B rows
    (7, 3, 5, torch.int32, torch.int32)]


def _gather_case(R, C, N, dtype, idx_dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    table = (torch.randn((R, C), generator=g) * 100).to(dtype)
    if dtype.is_floating_point:
        table[0, 0] = float("nan")
        table[min(1, R - 1), C - 1] = -0.0
    idx = torch.randint(-3, R + 3, (N,), generator=g).to(idx_dtype)
    return table.to(device), idx.to(device)


def test_gather_on_cpu_tensors_takes_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")
    monkeypatch.setattr(gather, "load_library", no_build)
    counts = (gather.gather_rows_async.launches,
              gather.gather_rows_smem.launches)
    table, idx = _gather_case(300, 24, 1001, torch.float32, torch.int32,
                              "cpu")
    want = gather.gather_rows_plain(table, idx)
    assert gather_ab.bit_equal(gather.gather_rows_async(table, idx), want)
    assert gather_ab.bit_equal(gather.gather_rows_smem(table, idx), want)
    assert counts == (gather.gather_rows_async.launches,
                      gather.gather_rows_smem.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_gather_kernels_bit_equal_to_plain_on_card(case):
    """Both kernels against ``index_select`` on the card, bit for bit (NaN
    payloads and signed zeros included), out-of-range indices clamped, the
    ragged tail masked; each launch counted once."""
    _card()
    R, C, N, dtype, idx_dtype = case
    table, idx = _gather_case(R, C, N, dtype, idx_dtype, "cuda")
    want = gather.gather_rows_plain(table, idx)
    before = gather.gather_rows_async.launches
    got = gather.gather_rows_async(table, idx)
    torch.cuda.synchronize()
    assert gather.gather_rows_async.launches == before + 1
    assert gather_ab.bit_equal(got, want)
    if R * C * table.element_size() <= gather.SMEM_TABLE_MAX_BYTES:
        before = gather.gather_rows_smem.launches
        got = gather.gather_rows_smem(table, idx)
        torch.cuda.synchronize()
        assert gather.gather_rows_smem.launches == before + 1
        assert gather_ab.bit_equal(got, want)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            gather.gather_rows_smem(table, idx)


@pytest.mark.gpu
def test_gather_kernels_on_a_misaligned_view_and_no_indices():
    """A table that starts 4 bytes into an allocation takes the 4-byte
    copies; an empty index launches nothing."""
    _card()
    base = torch.randn(1 + 1000 * 24, device="cuda")
    table = base[1:].view(1000, 24)
    assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    idx = torch.randint(0, 1000, (50_001,), device="cuda")
    want = gather.gather_rows_plain(table, idx)
    assert gather_ab.bit_equal(gather.gather_rows_async(table, idx), want)
    assert gather_ab.bit_equal(gather.gather_rows_smem(table, idx), want)
    before = gather.gather_rows_async.launches
    empty = gather.gather_rows_async(table, idx[:0])
    assert tuple(empty.shape) == (0, 24)
    assert gather.gather_rows_async.launches == before


@pytest.mark.gpu
def test_gather_ab_tool_on_card(capsys):
    _card()
    assert gather_ab.main(["2000", "24", "100000"]) == 0
    out = capsys.readouterr().out
    assert out.count("bit-equal to A") == 2 and "CUDA events" in out


@pytest.mark.gpu
@pytest.mark.parametrize("offset,route", [(0, "bulk"), (2, "ring"),
                                          (4, "bulk")])
def test_gather_route_of_a_view_on_the_card(offset, route):
    """A table ``offset`` float32 elements into its storage: 8 bytes in it
    takes the ring, 0 or 16 bytes in the bulk copies; both bit-equal."""
    _card()
    base = torch.randn(offset + 40_000 * 24, device="cuda")
    table = base[offset:].view(40_000, 24)
    idx = torch.randint(-3, 40_003, (200_001,), device="cuda")
    want = gather.gather_rows_plain(table, idx)
    got = gather.gather_rows_async(table, idx)
    torch.cuda.synchronize()
    assert gather.gather_route(96, table.data_ptr(), got.data_ptr()) == route
    assert gather_ab.bit_equal(got, want)


# ------------------------------------------------------ the chemistry slice --

@pytest.mark.gpu
def test_speciation_step_on_the_card_matches_the_cpu():
    """The speciation step on the card draws the CPU's uniforms to the bit;
    the destinations agree but where ``exp`` of the two devices rounds a
    probability across a uniform (tests/test_torch_chemistry.py's
    ``SPECIATION_SHARE``, 1%)."""
    _card()
    from opendrift_tpu_torch import rng
    from opendrift_tpu_torch.ops.speciation import speciation_step
    r = np.random.default_rng(0)
    n, S = 200_003, 5
    specie = torch.as_tensor(r.integers(0, S, n).astype(np.int32))
    rates = torch.as_tensor((10.0 ** r.uniform(-7, -3, (n, S))).astype(
        np.float32))
    active = torch.as_tensor(r.random(n) < 0.95)
    key = rng.fold_in(rng.PRNGKey(7), 3)
    got = speciation_step(specie.cuda(), rates.cuda(), 1800.0, key,
                          active.cuda())
    want = speciation_step(specie, rates, 1800.0, key, active)
    for a, b in zip(got, want):
        assert np.mean(a.cpu().numpy() != b.numpy()) <= 0.01
    assert got[0].dtype == torch.int32 and got[1].any()


@pytest.mark.gpu
def test_chemicaldrift_run_on_the_card_matches_the_cpu():
    """A small ChemicalDrift run (Phenanthrene, degradation and
    volatilization) on the card and on the CPU from one seed: statuses
    equal, positions within the slice tolerance, species equal but for 1%,
    no mixing kernel launched (the generic per-substep loop), and each
    element's mass kept."""
    _card()
    from opendrift_tpu_torch.tools import zoo_setups
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    before = [k.launches for k in kernels]
    runs = []
    for device in ("cuda", "cpu"):
        cfg = zoo_setups.config("chemical_stat", 2000)
        cfg["duration_s"] = 6 * cfg["time_step"]
        o, run_kw = zoo_setups.setup("chemical_stat", cfg, device)
        o.run(**run_kw)
        runs.append(o.result)
    assert [k.launches for k in kernels] == before
    card, cpu = runs
    np.testing.assert_array_equal(card["status"].values,
                                  cpu["status"].values)
    bounds = {"lon": (1e-6, 1e-4), "lat": (1e-6, 1e-4), "z": (1e-4, 0.1)}
    for var, (median_atol, outlier_atol) in bounds.items():
        a = np.asarray(card[var].values, np.float64)
        b = np.asarray(cpu[var].values, np.float64)
        d = np.abs(a - b)[~np.isnan(b)]
        assert np.median(d) <= median_atol and np.mean(
            d > outlier_atol) <= 0.02, (var, d.max())
    assert np.mean(card["specie"].values != cpu["specie"].values) <= 0.01
    total = sum(np.asarray(card[v].values, np.float64)
                for v in ("mass", "mass_degraded", "mass_volatilized"))
    np.testing.assert_allclose(total, np.broadcast_to(total[:, :1],
                                                      total.shape), rtol=1e-4)


EXAMPLES = sorted(m.name for m in pkgutil.iter_modules(examples.__path__)
                  if m.name.startswith("example_"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_its_default_device(name, capsys):
    """Each example as a user runs it, with no argument, so on the card,
    runs to its end and prints its summary: a result tensor handed to
    numpy without a copy to the host raises here, where a run with
    ``--device cpu`` does not show it."""
    _card()
    module = importlib.import_module(f"opendrift_tpu_torch.examples.{name}")
    module.main([])
    assert capsys.readouterr().out.strip()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(pack_ab.CASES))
def test_pack_window_kernel_byte_equal_to_plain_on_the_card(case):
    """The window assembly kernel against its plain version: the benchmark
    forecast's tables (16 levels, 300 x 260 cells, 8 base columns, 'xy'
    with the u/v companion), 'xyz', float16, two members, the wind's 2D
    table and an odd column count; one launch writes every table."""
    _card()
    srcs, tables, args = pack_ab.case_inputs(case, torch.device("cuda"))
    before = pack.pack_window.launches
    got = pack.pack_window(srcs, tables, *args)
    assert pack.pack_window.launches == before + 1
    want = [pack.assemble_rows_plain(srcs, cols, *args) for cols in tables]
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(tables)
    for a, b in zip(got, want):
        assert pack_ab.bytes_equal(a, b)


def _norkyst_forecast(path, host_tables, monkeypatch):
    from opendrift_tpu_torch.fields import grid
    from opendrift_tpu_torch.fields.netcdf import NetCDFReader
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.ops.pack import WindowTable
    if host_tables:
        device_state = grid.StructuredGridReader.device_state

        def on_host(self, *a):
            return {k: (np.asarray(v) if isinstance(v, WindowTable) else v)
                    for k, v in device_state(self, *a).items()}
        monkeypatch.setattr(grid.StructuredGridReader, "device_state",
                            on_host)
    o = OceanDrift(loglevel=50, device="cuda", seed=11)
    o.add_reader(NetCDFReader(path))
    o.set_config("drift:vertical_mixing", True)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(7)
    n = 50_000
    o.seed_elements(lon=r.uniform(13.8, 14.2, n),
                    lat=r.uniform(67.9, 68.1, n),
                    z=-r.uniform(0.0, 20.0, n), time=datetime(2024, 3, 1))
    o.run(duration=timedelta(hours=2), time_step=900, time_step_output=3600)
    return o


@pytest.mark.gpu
def test_norkyst_forecast_through_the_kernel_equals_the_host_packed_one(
        tmp_path, monkeypatch):
    """A 2-hour NorKyst800-like forecast (16 levels) through
    ``NetCDFReader``: its windows assembled on the card by the kernel give
    the result of the same forecast on tables packed on the host and
    copied whole, bit for bit."""
    _card()
    from opendrift_tpu_torch.tools import synthetic_nc
    path = str(tmp_path / "norkyst.nc")
    synthetic_nc.write_norkyst(path, nx=160, ny=140, nz=16, nt=5)
    before = pack.pack_window.launches
    card = _norkyst_forecast(path, False, monkeypatch)
    assert pack.pack_window.launches == before + 3  # 2 windows, the repack
    assert card.counters["readers.windows_assembled_on_device"] == 3
    host = _norkyst_forecast(path, True, monkeypatch)
    assert pack.pack_window.launches == before + 3
    for var in ("lon", "lat", "z", "status"):
        a = np.asarray(card.result[var].values)
        b = np.asarray(host.result[var].values)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _oil_forecast(n=200_000):
    from opendrift_tpu_torch.models import OpenOil
    from opendrift_tpu_torch.fields import ConstantReader
    o = OpenOil(loglevel=40, device="cuda", seed=6)
    o.add_reader(ConstantReader({
        "x_wind": 11.0, "y_wind": 2.0, "x_sea_water_velocity": 0.1,
        "y_sea_water_velocity": 0.05,
        "sea_floor_depth_below_sea_level": 60.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    t0 = datetime(2020, 1, 1)
    o.seed_elements(lon=4.0, lat=60.0, number=n, radius=2000,
                    time=[t0, t0 + timedelta(hours=2)], m3_per_hour=50.0)
    o.run(duration=timedelta(hours=4), time_step=900, time_step_output=3600)
    return o


@pytest.mark.gpu
def test_an_oil_result_assembled_on_the_card_equals_the_per_interval_one(
        monkeypatch):
    """A 200,000-element OpenOil forecast released over two hours: the
    frames kept on the card and assembled there give the result, byte for
    byte, of the frames copied to the host at each interval, which a
    budget the frames exceed selects."""
    _card()
    from opendrift_tpu_torch.models import base
    kept = _oil_forecast()
    assert kept.counters["run.frames_kept_on_device"] == 5
    assert kept.counters["run.results_assembled_on_device"] == 1
    frame_bytes = kept.counters["run.d2h_bytes"]
    monkeypatch.setattr(base, "_frame_budget", lambda device: frame_bytes)
    assert "run.frames_kept_on_device" in _oil_forecast().counters
    monkeypatch.setattr(base, "_frame_budget",
                        lambda device: frame_bytes - 1)
    copied = _oil_forecast()
    assert "run.frames_kept_on_device" not in copied.counters
    assert "run.results_assembled_on_device" not in copied.counters
    assert copied.counters["run.d2h_bytes"] == frame_bytes
    assert list(kept.result.variables) == list(copied.result.variables)
    for name in copied.result.variables:
        a, b = kept.result[name].values, copied.result[name].values
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.flags.c_contiguous and a.tobytes() == b.tobytes(), name
    lon = kept.result["lon"].values
    assert np.isnan(lon[-1, 0]) and np.isfinite(lon[-1, -1])
