"""The port's OpenOil (opendrift_tpu_torch/models/openoil) and its oil
mixing kernel's wrapper against the JAX package, on the CPU, from the same
seeded numpy inputs.

Tolerances, with their reasons:

* The oil mixing kernel (``visser_mixing_oil``; its plain version here,
  the JAX package's emulation ``interpret=True`` there) gets identical
  inputs.  Its draws are integer math: the three chained SplitMix32 draws
  of a substep, every entrainment decision and so the diameter are held
  EXACTLY.  z is held at ``Z_ATOL`` = 2e-5 m with at most ``FLIP_SHARE`` of
  the elements beyond it, the bound of tests/test_torch_mixing.py for the
  windspeed kernel: XLA's CPU backend contracts multiply-adds and folds
  constant factors (``Kz * 60 * 6``) that the port rounds one by one, an
  ulp that can move an element across a nearest-level boundary
  (``round(|z|)``).  Measured: at most 3e-5 m on 29% of 1003 elements with
  Large1994, none beyond 5e-6 m with the step function.
* Elementwise weathering, entrainment rate, spectra and rise velocity:
  rtol 1e-5 (float32; exp, log and non-integer powers differ by an ulp or
  two between the libraries); masses also 1e-5 kg absolute, see
  ``_assert_states_close``.
* Whole runs: per variable a median bound, and at most ``OUTLIER_SHARE``
  of the values beyond an outlier bound.  The candidate diameters come
  from normals that agree within 4 ulp and from a mean over all elements,
  so an entrainment test ``u < p`` can flip for a rare element, which
  then sits at another depth.
"""

import os
import sys
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_compare  # noqa: E402
from opendrift_tpu.ops import pallas_mixing  # noqa: E402
from opendrift_tpu.models.openoil import oil_db as joil_db  # noqa: E402
from opendrift_tpu_torch import interop, rng  # noqa: E402
from opendrift_tpu_torch.ops import mixing  # noqa: E402
from opendrift_tpu_torch.models.openoil import oil_db as toil_db  # noqa: E402

Z_ATOL = 2e-5
FLIP_SHARE = 0.01
RTOL = 1e-5
MASS_ATOL = 1e-5        # kg
T0 = datetime(2020, 1, 1)
OIL_ARGS = ("z", "diam", "moving", "wind", "mld", "zmin", "p_ent", "d_cand",
            "zb", "kw", "kw2", "nu_w")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------ the kernel --

def _kernel_inputs(n=1003, seed=3):
    """N not a multiple of 128, 30% of the elements at the surface, a third
    with the schema's default diameter 0, IDs above 2^24."""
    r = np.random.default_rng(seed)
    f = np.float32
    z = -r.uniform(0, 30, n).astype(f)
    z[r.random(n) < 0.3] = 0
    zmin = -r.uniform(5, 80, n).astype(f)
    diam = r.uniform(1e-5, 2e-3, n).astype(f)
    diam[r.random(n) < 0.33] = 0
    rhopr = r.uniform(0.8, 0.99, n)
    nu = r.uniform(1e-6, 1.8e-6, n)
    d = dict(z=np.maximum(z, zmin), diam=diam,
             moving=(r.random(n) > 0.05).astype(f),
             wind=r.uniform(0, 20, n).astype(f),
             mld=r.uniform(10, 60, n).astype(f), zmin=zmin,
             p_ent=r.uniform(0, 0.3, n).astype(f),
             d_cand=r.uniform(1e-6, 3e-3, n).astype(f),
             zb=r.uniform(0, 6, n).astype(f),
             kw=(2 * 9.81 * (1 - rhopr) / (9 * nu)).astype(f),
             kw2=np.sqrt(16 * 9.81 * (1 - rhopr) / 3).astype(f),
             nu_w=nu.astype(f))
    elem = r.integers(1 << 24, (1 << 31) - 1, n).astype(np.int32)
    return d, elem, int(r.integers(0, 1 << 32))


@pytest.mark.parametrize("mixing_at_surface", [False, True])
@pytest.mark.parametrize("keep_diam", [False, True])
@pytest.mark.parametrize("model", list(mixing.WINDSPEED_MODELS))
def test_oil_kernel_wrapper_matches_pallas_emulation(model, keep_diam,
                                                     mixing_at_surface):
    d, elem, seed = _kernel_inputs()
    kw = dict(ntimes=15, dt_mix=60.0, model=model, bg=1.2e-5,
              mixing_at_surface=mixing_at_surface, keep_diam=keep_diam)
    want_z, want_d = pallas_mixing.visser_mixing_oil(
        *(jnp.asarray(d[k]) for k in OIL_ARGS), jnp.uint32(seed),
        elem=jnp.asarray(elem), interpret=True, **kw)
    before = mixing.visser_mixing_oil.launches
    got_z, got_d = mixing.visser_mixing_oil(
        *(_t(d[k]) for k in OIL_ARGS), seed, elem=_t(elem, torch.int32), **kw)
    assert mixing.visser_mixing_oil.launches == before   # the plain version
    assert got_z.dtype == got_d.dtype == torch.float32
    # every entrainment decision, so the diameter, exactly
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    changed = got_d.numpy() != d["diam"]
    assert changed.any() != keep_diam
    dz = np.abs(got_z.numpy() - np.asarray(want_z))
    assert np.isfinite(got_z.numpy()).all()
    assert (dz > Z_ATOL).mean() <= FLIP_SHARE, ((dz > Z_ATOL).mean(),
                                                dz.max())
    assert (got_z <= 0).all() and (got_z >= _t(d["zmin"])).all()
    if not mixing_at_surface and not keep_diam:
        # an element held at the surface can be entrained in the same
        # substep: some that started at z = 0 are now below it
        assert (got_z[_t(d["z"]) == 0] < 0).any()


def test_oil_kernel_draws_bit_equal():
    """The three chained draws of a substep, against the JAX package's
    hash on uint32."""
    d, elem, seed = _kernel_inputs(n=257)
    base_j = pallas_mixing._splitmix32(
        pallas_mixing._as_u32(jnp.asarray(elem))
        + jnp.uint32(seed) * jnp.uint32(0x9e3779b9))
    base_t = mixing._element_base(_t(elem, torch.int32), seed)
    for i in (0, 7, 14):
        bits = pallas_mixing._splitmix32(
            base_j + jnp.uint32(i) * jnp.uint32(0x85ebca6b))
        bits1 = pallas_mixing._splitmix32(bits + jnp.uint32(0xc2b2ae35))
        bits2 = pallas_mixing._splitmix32(bits1 + jnp.uint32(0x27d4eb2f))
        tb = mixing._substep_bits(base_t, i)
        tb1 = mixing.splitmix32((tb + 0xc2b2ae35) & 0xFFFFFFFF)
        tb2 = mixing.splitmix32((tb1 + 0x27d4eb2f) & 0xFFFFFFFF)
        for got, want in ((tb, bits), (tb1, bits1), (tb2, bits2)):
            np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                          np.asarray(want))
            unit = jax.lax.shift_right_logical(want, jnp.uint32(8)).astype(
                jnp.float32) * jnp.float32(1.0 / 16777216.0)
            np.testing.assert_array_equal(mixing._unit(got).numpy(),
                                          np.asarray(unit))


def test_oil_kernel_zero_diameter_has_no_nan():
    """``Oil.diameter`` defaults to 0: sqrt, Reynolds number and rise
    velocity are 0 there, not NaN, and nothing rises."""
    n = 64
    z = torch.full((n,), -3.0)
    out_z, out_d = mixing.visser_mixing_oil(
        z, torch.zeros(n), 0.0, 5.0, 30.0, -50.0, 0.0, 1e-3, 2.0, 4e4, 1.5,
        1.3e-6, 11, ntimes=15, dt_mix=60.0, model="windspeed_Large1994",
        bg=1.2e-5, mixing_at_surface=False, keep_diam=False)
    assert torch.equal(out_z, z) and torch.equal(out_d, torch.zeros(n))


# --------------------------------------------------------------- OilType --

@pytest.mark.parametrize("name", ["GENERIC MEDIUM CRUDE", "STATFJORD",
                                  "TROLL, STATOIL"])
def test_oiltype_matches_jax(name):
    assert toil_db.get_oil_names() == joil_db.get_oil_names()
    assert toil_db.find_oil(name) == joil_db.find_oil(name)
    oj, ot = joil_db.OilType(name), toil_db.OilType(name)
    r = np.random.default_rng(0)
    T = (273.15 + r.uniform(-2, 30, 301)).astype(np.float32)
    for fn in ("density_at_temp", "kvis_at_temp", "vapor_pressure"):
        want = np.asarray(getattr(oj, fn)(jnp.asarray(T)))
        got = getattr(ot, fn)(_t(T))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert ot.vapor_pressure(_t(T)).shape == (len(ot.boiling_point), 301)
    assert ot.oil_water_surface_tension() == oj.oil_water_surface_tension()
    np.testing.assert_allclose(ot.kvis_at_temp(288.15),
                               float(oj.kvis_at_temp(288.15)), rtol=1e-6)
    assert ot.density_at_temp(288.15) == oj.density_at_temp(288.15)
    with pytest.raises(ValueError, match="not found"):
        toil_db.OilType("NO SUCH OIL")


# ----------------------------------------------- one process at a time ----

def _model(pkg, oil="GENERIC MEDIUM CRUDE", n=264, **config):
    if pkg == "jax":
        from opendrift_tpu.models import OpenOil
        o = OpenOil(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OpenOil
        o = OpenOil(loglevel=40, device="cpu")
    o.set_config("environment:fallback:land_binary_mask", 0)
    for k, v in config.items():
        o.set_config(k, v)
    o.seed_elements(lon=4.0, lat=60.0, number=n, time=T0, oil_type=oil,
                    m3_per_hour=50.0)
    return o


def _contexts(oil="GENERIC MEDIUM CRUDE", n=264, seed=0, **config):
    """A step context on each package over the same random oil state and
    environment (n a multiple of the 8 virtual JAX devices, so the JAX
    package pads nothing)."""
    from opendrift_tpu.models.base import StepContext as JCtx
    from opendrift_tpu.elements.elements import ElementState as JState
    from opendrift_tpu_torch.models.base import StepContext as TCtx
    r = np.random.default_rng(seed)
    f = np.float32
    oj, ot = _model("jax", oil, n, **config), _model("torch", oil, n,
                                                     **config)
    _, _, sj, _ = oj.prepare_run(900.0, 1)
    _, _, st, _ = ot.prepare_run(900.0, 1)
    assert set(st.data) == set(sj.data)
    assert st.data["mass_components"].shape == sj.data[
        "mass_components"].shape == (len(ot.oiltype.mass_fraction), n)
    arrays = {k: np.asarray(v) for k, v in sj.data.items()}
    mass = r.uniform(20, 60, n).astype(f)
    z = -r.uniform(0, 25, n).astype(f)
    z[r.random(n) < 0.5] = 0
    arrays.update(
        status=(r.random(n) < 0.1).astype(np.int32) * 2,   # 10% retired
        z=z, mass_oil=mass,
        mass_components=(ot.oiltype.mass_fraction[:, None]
                         * mass[None, :]).astype(f),
        mass_evaporated=(mass * r.uniform(0, 0.4, n)).astype(f),
        age_seconds=r.uniform(0, 2 * 86400, n).astype(f),
        water_fraction=r.uniform(0, 0.5, n).astype(f),
        fraction_evaporated=r.uniform(0, 0.4, n).astype(f),
        interfacial_area=r.uniform(0, 1e5, n).astype(f),
        bulltime=np.where(r.random(n) < 0.5, 0, 3600).astype(f),
        density=r.uniform(850, 990, n).astype(f),
        viscosity=r.uniform(1e-5, 5e-3, n).astype(f),
        oil_film_thickness=r.uniform(1e-5, 2e-3, n).astype(f),
        diameter=np.where(z < 0, r.uniform(1e-5, 2e-3, n), 0).astype(f),
        lon=(4 + r.uniform(-0.05, 0.05, n)).astype(f),
        lat=(60 + r.uniform(-0.03, 0.03, n)).astype(f))
    env = {
        "x_wind": r.uniform(-4, 16, n), "y_wind": r.uniform(-6, 6, n),
        "sea_water_temperature": r.uniform(0, 20, n),
        "sea_water_salinity": r.uniform(30, 35.5, n),
        "sea_surface_wave_significant_height": r.uniform(0.3, 4, n),
        "sea_surface_wave_period_at_variance_spectral_density_maximum":
            r.uniform(4, 11, n),
        "sea_surface_wave_mean_period_from_variance_spectral_density_"
        "second_frequency_moment": np.zeros(n),
        "ocean_mixed_layer_thickness": r.uniform(10, 60, n),
        "sea_floor_depth_below_sea_level": r.uniform(30, 200, n),
        "sea_surface_height": np.zeros(n),
        "x_sea_water_velocity": r.normal(0, 0.3, n),
        "y_sea_water_velocity": r.normal(0, 0.3, n),
        "sea_surface_wave_stokes_drift_x_velocity": r.uniform(0, 0.1, n),
        "sea_surface_wave_stokes_drift_y_velocity": r.uniform(0, 0.05, n),
        "sea_ice_area_fraction": r.uniform(0, 1, n) * (r.random(n) < 0.3),
        "sea_ice_x_velocity": r.normal(0, 0.1, n),
        "sea_ice_y_velocity": r.normal(0, 0.1, n)}
    env = {k: v.astype(f) for k, v in env.items()}
    params = {"dt": 900.0, "hdiff": 0.0, "max_age": np.inf}
    zlev = oj._profile_zlevels()
    cj = JCtx(oj, JState({k: jnp.asarray(v) for k, v in arrays.items()}),
              {k: jnp.asarray(v) for k, v in env.items()}, None, None,
              np.float32(0), params, jax.random.PRNGKey(5), zlev)
    ct = TCtx(ot, interop.element_state_from_numpy(arrays, "cpu"),
              {k: _t(v) for k, v in env.items()}, None, None, np.float32(0),
              params, rng.PRNGKey(5), zlev)
    return oj, cj, ot, ct


def _assert_states_close(ct, cj, rtol=RTOL):
    """Every state variable at ``rtol``; the masses also get ``MASS_ATOL``:
    a lost fraction ``1 - exp(-x)`` with small x carries an absolute error
    of an ulp of 1 (6e-8), times an element's mass of up to 60 kg."""
    for k, want in cj.state.data.items():
        got = ct.state.data[k]
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, k
        assert got.numpy().dtype == want.dtype, k
        atol = MASS_ATOL if k.startswith("mass_") else 1e-30
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=k)


PROCESSES = {
    "evaporation": {"processes:evaporation": True},
    "emulsification": {"processes:emulsification": True},
    "dispersion": {"processes:dispersion": True},
    "biodegradation_adcroft": {"processes:biodegradation": True},
    "biodegradation_half_time": {"processes:biodegradation": True,
                                 "biodegradation:method": "half_time"},
    "all": {"processes:evaporation": True, "processes:emulsification": True,
            "processes:dispersion": True, "processes:biodegradation": True},
}


@pytest.mark.parametrize("oil", ["GENERIC MEDIUM CRUDE", "TROLL, STATOIL"])
@pytest.mark.parametrize("process", list(PROCESSES))
def test_weathering_process_matches_jax(process, oil):
    """Each weathering process alone (and all together), on the (C, N) mass
    matrix and the bulk state; TROLL has temperature-dependent SINTEF
    maximum water fractions, the device-tensor branch of emulsification."""
    config = {f"processes:{p}": False for p in (
        "evaporation", "emulsification", "dispersion", "biodegradation")}
    config.update(PROCESSES[process])
    oj, cj, ot, ct = _contexts(oil, **config)
    before = {k: v.clone() for k, v in ct.state.data.items()}
    oj.oil_weathering(cj)
    ot.oil_weathering(ct)
    _assert_states_close(ct, cj)
    d = ct.state.data
    assert d["mass_components"].dtype == torch.float32
    changed = {k for k in d if not torch.equal(d[k], before[k])}
    expect = {"evaporation": "mass_evaporated",
              "emulsification": "water_fraction",
              "dispersion": "mass_dispersed"}.get(process, "mass_oil")
    if not process.startswith("biodegradation"):
        assert expect in changed, changed
    else:
        assert "mass_biodegraded" in changed
    # inactive elements keep their masses
    inactive = d["status"] != 0
    for k in ("mass_oil", "mass_components", "water_fraction"):
        assert torch.equal(d[k][..., inactive], before[k][..., inactive]), k
    # what left the slick is in the budget
    total = lambda s: (s["mass_oil"] + s["mass_evaporated"]  # noqa: E731
                       + s["mass_dispersed"] + s["mass_biodegraded"])
    np.testing.assert_allclose(total(d).numpy(), total(before).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(d["mass_components"].sum(0).numpy(),
                               d["mass_oil"].numpy(), rtol=2e-5)


@pytest.mark.parametrize("what", [
    "oil_wave_entrainment_rate", "droplets_johansen", "droplets_li",
    "terminal_velocity_inner", "update_terminal_velocity",
    "update_surface_oilfilm_thickness", "prepare_vertical_mixing",
    "advect_oil"])
def test_entrainment_and_rise_functions_match_jax(what):
    config = {}
    if what == "droplets_li":
        config["wave_entrainment:droplet_size_distribution"] = \
            "Li et al. (2017)"
    oj, cj, ot, ct = _contexts(seed=1, **config)
    if what == "oil_wave_entrainment_rate":
        got, want = ot.oil_wave_entrainment_rate(ct), \
            oj.oil_wave_entrainment_rate(cj)
        assert (got.numpy() > 0).any()
    elif what.startswith("droplets"):
        (got, sd_t), (want, sd_j) = ot._droplet_diameter_distribution(ct), \
            oj._droplet_diameter_distribution(cj)
        assert sd_t == pytest.approx(sd_j)
        assert got.ndim == 0
    elif what == "terminal_velocity_inner":
        mix = np.random.default_rng(2).uniform(1e-5, 3e-3, 264).astype(
            np.float32)
        got = ot.terminal_velocity_inner(ct, ct.state.data["z"], None, None,
                                         mix={"diameter": _t(mix)})
        want = oj.terminal_velocity_inner(cj, cj.state.data["z"], None, None,
                                          mix={"diameter": jnp.asarray(mix)})
        assert (np.asarray(want) > 0).all()      # both Reynolds branches
    elif what == "prepare_vertical_mixing":
        oj.prepare_vertical_mixing(cj)
        ot.prepare_vertical_mixing(ct)
        np.testing.assert_allclose(
            ct._oil_entrainment_probability.numpy(),
            np.asarray(cj._oil_entrainment_probability), rtol=RTOL,
            atol=1.2e-7)     # 1 - exp(-x): two ulps of 1
        # normals within 4 ulp, then exp(log(dV_50) + 0.92 * draw)
        got, want = ct._droplet_diameter_if_entrained, \
            cj._droplet_diameter_if_entrained
        assert ct._key_counter == cj._key_counter == 1
    else:
        getattr(oj, what)(cj)
        getattr(ot, what)(ct)
        if what == "advect_oil":
            cj.flush_positions()
            ct.flush_positions()
            np.testing.assert_allclose(
                ct.state.data["lon"].numpy(),
                np.asarray(cj.state.data["lon"]), rtol=0, atol=1e-6)
        _assert_states_close(ct, cj)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_oilfilm_thickness_with_nothing_at_the_surface():
    """The bin bounds are +-inf then; no element changes and none is NaN."""
    oj, cj, ot, ct = _contexts(seed=3)
    deep = {"z": np.full(264, -4.0, np.float32)}
    cj.state = cj.state.replace(z=jnp.asarray(deep["z"]))
    ct.state = ct.state.replace(z=_t(deep["z"]))
    before = ct.state.data["oil_film_thickness"].clone()
    oj.update_surface_oilfilm_thickness(cj)
    ot.update_surface_oilfilm_thickness(ct)
    assert torch.equal(ct.state.data["oil_film_thickness"], before)
    _assert_states_close(ct, cj)


# -------------------------------------------------------- the whole slice -

def _forcing(seed=0, nx=24, ny=20, nz=6, nt=4, coast=False):
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0, 2, 5, 10, 20, 40][:nz], np.float32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    f = np.float32
    ocean = {
        "x_sea_water_velocity": (0.15 + 0.1 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f),
        "y_sea_water_velocity": (0.1 * r.standard_normal(
            (nt, nz, ny, nx))).astype(f),
        "sea_water_temperature": r.uniform(4, 12, (nt, nz, ny, nx)).astype(f),
        "sea_water_salinity": r.uniform(32, 35, (nt, nz, ny, nx)).astype(f),
        "sea_floor_depth_below_sea_level":
            r.uniform(30, 80, (ny, nx)).astype(f)}
    if coast:
        land = np.zeros((ny, nx), f)
        land[:, 14:] = 1.0
        ocean["land_binary_mask"] = land
    wind = {"x_wind": (9 + 2 * r.standard_normal((nt, ny, nx))).astype(f),
            "y_wind": (2 * r.standard_normal((nt, ny, nx))).astype(f)}
    wave = {"sea_surface_wave_significant_height":
                r.uniform(1.0, 3.0, (nt, ny, nx)).astype(f),
            "sea_surface_wave_period_at_variance_spectral_density_maximum":
                r.uniform(5, 9, (nt, ny, nx)).astype(f),
            "sea_surface_wave_stokes_drift_x_velocity":
                r.uniform(0.0, 0.1, (nt, ny, nx)).astype(f),
            "sea_surface_wave_stokes_drift_y_velocity":
                r.uniform(-0.03, 0.03, (nt, ny, nx)).astype(f)}
    return ocean, wind, wave, x, y, depths, times


def _oil_simulation(pkg, n=256, coast=False, model="windspeed_Large1994",
                    **config):
    ocean, wind, wave, x, y, depths, times = _forcing(coast=coast)
    if pkg == "jax":
        from opendrift_tpu.models import OpenOil
        from opendrift_tpu.fields import ArrayReader
        o = OpenOil(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OpenOil
        from opendrift_tpu_torch.fields import ArrayReader
        o = OpenOil(loglevel=40, device="cpu")
    o.add_reader(ArrayReader(ocean, x, y, times, depths=depths))
    o.add_reader(ArrayReader(wind, x, y, times))
    o.add_reader(ArrayReader(wave, x, y, times))
    if not coast:
        o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    if model is not None:
        o.set_config("vertical_mixing:diffusivitymodel", model)
    for k, v in config.items():
        o.set_config(k, v)
    o.seed_elements(lon=4.2, lat=59.8, radius=3000, number=n, time=times[0],
                    z=0.0, m3_per_hour=80.0)
    return o


SLICE_BOUNDS = {            # variable: (median atol, outlier atol)
    "lon": (1e-6, 1e-3), "lat": (1e-6, 1e-3), "z": (1e-4, 0.1),
    "mass_oil": (1e-4, 1e-2), "mass_evaporated": (1e-4, 1e-2),
    "mass_dispersed": (1e-4, 1e-2), "water_fraction": (1e-5, 1e-3),
    "viscosity": (1e-7, 1e-5), "density": (1e-2, 1.0),
    "diameter": (1e-8, 1e-5), "terminal_velocity": (1e-6, 1e-3)}
OUTLIER_SHARE = 0.05


def _assert_slice_close(got, want, var):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, var
    both = ~np.isnan(got) & ~np.isnan(want)
    assert np.mean(np.isnan(got) != np.isnan(want)) <= 0.01, var
    d = np.abs(got - want)[both]
    median_atol, outlier_atol = SLICE_BOUNDS[var]
    assert np.median(d) <= median_atol, (var, np.median(d))
    assert np.mean(d > outlier_atol) <= OUTLIER_SHARE, (
        var, np.mean(d > outlier_atol), d.max())


def test_openoil_slice_matches_jax_from_a_carried_state(monkeypatch):
    """Two intervals of K = 4 steps of both packages from one initial
    state: the JAX package's, carried across as numpy (``mass_components``
    among it).  The JAX side runs its oil kernel's emulation; the port the
    wrapper's plain version."""
    monkeypatch.setattr(pallas_mixing, "FORCE_INTERPRET", True)
    K, dt = 4, 900.0
    oj = _oil_simulation("jax")
    ot = _oil_simulation("torch")
    j_adv, _, j_state, j_key = oj.prepare_run(dt, K, total_steps=2 * K)
    t_adv, _, t_state, t_key = ot.prepare_run(dt, K, total_steps=2 * K)
    first = {k: np.asarray(v) for k, v in j_state.data.items()}
    assert set(t_state.data) == set(first)
    for k, v in t_state.data.items():       # the port seeds the same state
        np.testing.assert_allclose(v.numpy(), first[k], rtol=1e-6, err_msg=k)
    t_state = interop.element_state_from_numpy(first, "cpu")
    assert t_state.data["mass_components"].shape == (10, 256)
    before = mixing.visser_mixing_oil.launches
    for k in range(2):
        t0 = np.float32(k * K * dt)
        j_state, j_snap = j_adv(j_state, oj.env.build_device_states(), t0,
                                jax.random.fold_in(j_key, k))
        t_state, t_snap = t_adv(t_state, ot.env.build_device_states(), t0,
                                rng.fold_in(t_key, k))
    assert mixing.visser_mixing_oil.launches == before
    np.testing.assert_array_equal(t_state.data["status"].numpy(),
                                  np.asarray(j_state.data["status"]))
    for var in SLICE_BOUNDS:
        _assert_slice_close(t_state.data[var].numpy(), j_state.data[var], var)
    got = t_state.data["mass_components"].numpy()
    want = np.asarray(j_state.data["mass_components"])
    assert np.mean(np.abs(got - want) > 1e-2) <= OUTLIER_SHARE
    z = t_state.data["z"].numpy()
    assert (z < 0).any() and (z == 0).any()          # entrained and not
    assert (t_state.data["diameter"].numpy()[z < 0] > 0).all()
    assert "mass_components" not in t_snap         # as the JAX package
    assert "mass_components" not in j_snap


def test_openoil_run_with_a_coast_matches_jax(monkeypatch):
    """``run()`` on both packages with the default 'environment'
    diffusivity model (no reader serves it) and a reader-served landmask:
    oil strands, and the budgets agree."""
    monkeypatch.setattr(pallas_mixing, "FORCE_INTERPRET", True)
    runs = {}
    for pkg in ("jax", "torch"):
        o = _oil_simulation(pkg, coast=True, model=None)
        o.run(duration=timedelta(hours=4), time_step=900,
              time_step_output=3600)
        runs[pkg] = o
    oj, ot = runs["jax"], runs["torch"]
    sj = np.asarray(oj.result["status"].values)
    st = np.asarray(ot.result["status"].values)
    assert st.shape == sj.shape == (256, 5)
    assert np.mean(st != sj) <= 0.01
    stranded = ot.status_categories.index("stranded")
    assert (st[:, -1] == stranded).sum() > 10
    for var in ("lon", "lat", "z", "mass_oil", "mass_evaporated",
                "mass_dispersed", "water_fraction"):
        _assert_slice_close(ot.result[var].values, oj.result[var].values, var)
    bj, bt = oj.get_oil_budget(), ot.get_oil_budget()
    assert set(bj) == set(bt)
    for k in bj:
        np.testing.assert_allclose(bt[k], np.asarray(bj[k]), rtol=2e-2,
                                   atol=1e-3 * bt["mass_total"][0],
                                   err_msg=k)
    np.testing.assert_allclose(ot.cumulative_oil_entrainment_fraction(),
                               oj.cumulative_oil_entrainment_fraction(),
                               atol=0.02)


GENERIC_LOOP_CASES = {
    "constant": dict(model="constant"),
    "use_pallas_off": {"vertical_mixing:use_pallas": False},
    "TSprofiles": {"vertical_mixing:TSprofiles": True,
                   "vertical_mixing:profile_levels": 11},
    "TSprofiles_keep_diameter": {"vertical_mixing:TSprofiles": True,
                                 "vertical_mixing:profile_levels": 11},
}


def test_fast_path_conditions_raise_not_fall_back(monkeypatch):
    """Where the oil kernel does not apply the step once raised; it takes
    the generic per-substep loop now, and never the oil kernel's wrapper
    or its plain version."""
    def refuse(*args, **kw):
        raise AssertionError("the oil kernel's path was taken")
    monkeypatch.setattr(mixing, "visser_mixing_oil", refuse)
    monkeypatch.setattr(mixing, "visser_mixing_oil_plain", refuse)
    for case in ("constant", "use_pallas_off", "TSprofiles"):
        o = _oil_simulation("torch", n=16, **GENERIC_LOOP_CASES[case])
        o.run(duration=timedelta(hours=1), time_step=900)
        z = o.result["z"].values
        assert np.isfinite(z[:, -1]).all() and (z[:, -1] < 0).any(), case
    with pytest.raises(AssertionError, match="oil kernel's path"):
        _oil_simulation("torch", n=16).run(duration=timedelta(hours=1),
                                           time_step=900)


@pytest.mark.parametrize("case", list(GENERIC_LOOP_CASES))
def test_generic_loop_matches_jax(case):
    """The per-substep loop with ``surface_wave_mixing`` (entrainment draws
    keyed by element ID and the substep key) and, for TSprofiles, the
    Tkalich rise velocity at the T and S interpolated from 11-level
    profiles at the element's depth, against the JAX package's loop (which
    the JAX package takes on the CPU whenever its kernel is not forced).
    The loop draws otherwise than the oil kernel, so it is held against
    the loop, never against the kernel."""
    runs = {}
    for pkg in ("jax", "torch"):
        o = _oil_simulation(pkg, **GENERIC_LOOP_CASES[case])
        if case.endswith("keep_diameter"):
            o.keep_droplet_diameter = True
        o.run(duration=timedelta(hours=3), time_step=900,
              time_step_output=3600)
        runs[pkg] = o
    oj, ot = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z", "diameter", "mass_oil", "mass_evaporated",
                "mass_dispersed", "water_fraction", "terminal_velocity"):
        _assert_slice_close(ot.result[var].values, oj.result[var].values, var)
    z = ot.result["z"].values[:, -1]
    assert (z < 0).any() and (z == 0).any()          # entrained and not
    if case.startswith("TSprofiles"):
        assert ot.env.required_profiles == [
            "sea_water_temperature", "sea_water_salinity"]


def test_surface_wave_mixing_matches_jax():
    """One call of the hook on the same context: the same elements
    entrained to the same depths with the same diameters (the draws are
    integer hashes: equal to the bit)."""
    _, cj, _, ct = _contexts()
    for ctx, xp in ((ct, torch), (cj, jnp)):
        n = ctx.state.data["z"].shape[0]
        r = np.random.default_rng(5)
        asarray = (lambda a: torch.as_tensor(a)) if xp is torch \
            else jnp.asarray
        ctx._oil_entrainment_probability = asarray(
            r.uniform(0, 0.6, n).astype(np.float32))
        ctx._droplet_diameter_if_entrained = asarray(
            r.uniform(1e-5, 2e-3, n).astype(np.float32))
        z = -r.uniform(0, 5, n).astype(np.float32)
        z[::2] = 0.0
        ctx._mix = {"z": asarray(z),
                    "diameter": asarray(np.full(n, 1e-4, np.float32))}
    mt = ct.sim.surface_wave_mixing(ct, dict(ct._mix), 60.0,
                                    rng.fold_in(rng.PRNGKey(3), 7))
    mj = cj.sim.surface_wave_mixing(cj, dict(cj._mix), 60.0,
                                    jax.random.fold_in(
                                        jax.random.PRNGKey(3), 7))
    zt, zj = mt["z"].numpy(), np.asarray(mj["z"])
    assert ((zt < 0) & (np.asarray(ct._mix["z"]) == 0)).sum() > 10
    np.testing.assert_array_equal(zt < 0, zj < 0)
    np.testing.assert_allclose(zt, zj, rtol=1e-6)
    np.testing.assert_array_equal(mt["diameter"].numpy(),
                                  np.asarray(mj["diameter"]))


# --------------------------------------------------- the reference golden -

def _run_budget_golden(cfg):
    """The port's copy of tools/parity_compare.py ``run_openoil_budget``."""
    from opendrift_tpu_torch.models import OpenOil
    o = OpenOil(loglevel=40, device="cpu")
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("environment:fallback:x_wind", cfg["wind_u"])
    o.set_config("environment:fallback:y_wind", cfg["wind_v"])
    o.set_config("environment:fallback:x_sea_water_velocity", cfg["u"])
    o.set_config("environment:fallback:y_sea_water_velocity", cfg["v"])
    o.set_config("environment:fallback:sea_water_temperature", cfg["sst"])
    o.set_config("drift:vertical_mixing", False)
    o.set_config("processes:dispersion", False)
    o.set_config("processes:evaporation", True)
    o.set_config("processes:emulsification", True)
    o.set_config("processes:biodegradation", True)
    o.set_config("seed:m3_per_hour", cfg["m3_per_hour"])
    n = cfg["n"]
    o.seed_elements(lon=4.5, lat=60.0, radius=0, number=n,
                    time=datetime(2022, 5, 1), oil_type=cfg["oil_type"],
                    wind_drift_factor=np.full(n, cfg["wind_drift_factor"]))
    o.run(duration=timedelta(seconds=cfg["duration_s"]),
          time_step=cfg["time_step"],
          time_step_output=cfg["time_step_output"])
    return o


def _run_full_golden(cfg):
    """The port's copy of ``run_openoil_full``."""
    from opendrift_tpu_torch.models import OpenOil
    o = OpenOil(loglevel=40, device="cpu")
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("environment:fallback:x_wind", cfg["wind_u"])
    o.set_config("environment:fallback:y_wind", 0.0)
    o.set_config("environment:fallback:x_sea_water_velocity", cfg["u"])
    o.set_config("environment:fallback:y_sea_water_velocity", 0.0)
    o.set_config("environment:fallback:sea_water_temperature", cfg["sst"])
    o.set_config("environment:fallback:sea_floor_depth_below_sea_level",
                 cfg["seafloor"])
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:timestep", cfg["dt_mix"])
    o.set_config("processes:dispersion", True)
    o.set_config("processes:evaporation", True)
    o.set_config("processes:emulsification", True)
    o.set_config("seed:m3_per_hour", cfg["m3_per_hour"])
    o.seed_elements(lon=4.5, lat=60.0, radius=0, number=cfg["n"],
                    time=datetime(2022, 5, 1), oil_type=cfg["oil_type"])
    o.run(duration=timedelta(seconds=cfg["duration_s"]),
          time_step=cfg["time_step"],
          time_step_output=cfg["time_step_output"])
    return o


def test_weathering_budget_matches_reference_golden():
    """The reference OpenDrift's surface weathering budget, at the bounds
    of tests/test_reference_stat_parity.py."""
    golden, cfg = parity_compare.load_golden("openoil_budget_surface")
    res = _run_budget_golden(cfg).result
    tot0 = np.nansum(np.asarray(golden["mass_oil"], np.float64), axis=0)[0]
    for var, tol in (("mass_oil", 0.01), ("mass_evaporated", 0.01),
                     ("mass_biodegraded", 0.005)):
        g = np.nansum(np.asarray(golden[var], np.float64), axis=0)
        m = np.nansum(np.asarray(res[var].values, np.float64), axis=0)
        n = min(len(g), len(m))
        rel = np.abs(m[:n] - g[:n]) / tot0
        assert rel.max() < tol, (var, rel.max())
    for var, tol in (("water_fraction", 0.02), ("oil_film_thickness", 1e-4)):
        g = np.nanmean(np.asarray(golden[var], np.float64), axis=0)[-1]
        m = np.nanmean(np.asarray(res[var].values, np.float64), axis=0)[-1]
        assert abs(m - g) < tol, (var, m, g)
    g = np.nanmean(np.asarray(golden["viscosity"], np.float64), axis=0)[-1]
    m = np.nanmean(np.asarray(res["viscosity"].values, np.float64),
                   axis=0)[-1]
    assert abs(m - g) / g < 0.05, ("viscosity", m, g)


def test_full_weathering_budget_matches_reference_golden():
    """Dispersion, wave entrainment and mixing with resurfacing, through
    the oil kernel's plain version: the statistical bounds of
    tests/test_reference_stat_parity.py on budget, emulsion and droplets."""
    golden, cfg = parity_compare.load_golden("openoil_full_stat")
    res = _run_full_golden(cfg).result
    val = lambda v: np.asarray(res[v].values, np.float64)  # noqa: E731
    tot_g = np.nansum(np.asarray(golden["mass_oil"], np.float64), axis=0)[0]
    tot_o = np.nansum(val("mass_oil"), axis=0)[0]
    for var, tol in (("mass_oil", 0.06), ("mass_evaporated", 0.04),
                     ("mass_dispersed", 0.05)):
        g = np.nansum(np.asarray(golden[var], np.float64), axis=0)[-1]
        m = np.nansum(val(var), axis=0)[-1]
        assert abs(m / tot_o - g / tot_g) < tol, (var, m / tot_o, g / tot_g)
    assert np.nansum(val("mass_dispersed"), axis=0)[-1] / tot_o > 0.45
    wf_g = np.nanmean(np.asarray(golden["water_fraction"])[:, -1])
    assert abs(np.nanmean(val("water_fraction")[:, -1]) - wf_g) < 0.03
    dg = np.asarray(golden["diameter"])[:, -1]
    zg = np.asarray(golden["z"])[:, -1]
    do, zo = val("diameter")[:, -1], val("z")[:, -1]
    med_g = np.median(dg[(zg < 0) & (dg > 0)])
    med_o = np.median(do[(zo < 0) & (do > 0)])
    assert 0.5 < med_o / med_g < 2.0, (med_o, med_g)
    assert 0.1 < (zo == 0).mean() < 0.7
    assert -40.0 < np.nanmean(zo) < -5.0
    assert np.nanpercentile(zo, 5) > -80.0


# ------------------------------------------- state with a (C, N) array ----

def test_component_matrix_through_release_retirement_and_interop():
    """``mass_components`` is (C, N), the element axis last: it passes
    release over time, retirement, the snapshot (which leaves it out, as
    the JAX package's does) and the numpy bridge."""
    runs = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.models import OpenOil
            o = OpenOil(loglevel=40)
        else:
            from opendrift_tpu_torch.models import OpenOil
            o = OpenOil(loglevel=40, device="cpu")
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("environment:fallback:x_wind", 7.0)
        o.set_config("drift:vertical_mixing", False)
        o.set_config("drift:max_age_seconds", 3 * 3600.0)
        o.set_config("drift:current_uncertainty", 0.0)
        o.set_config("drift:wind_uncertainty", 0.0)
        # released over 8 hours: the last are never released in 6
        o.seed_elements(lon=4.0, lat=60.0, number=64,
                        time=[T0, T0 + timedelta(hours=8)], m3_per_hour=10.0)
        o.run(duration=timedelta(hours=6), time_step=1800,
              time_step_output=3600)
        runs[pkg] = o
    oj, ot = runs["jax"], runs["torch"]
    mc = ot.state.data["mass_components"]
    C = len(ot.oiltype.mass_fraction)
    assert mc.shape == (C, 64) and mc.dtype == torch.float32
    status = ot.state.data["status"].numpy()
    np.testing.assert_array_equal(status, np.asarray(oj.state.data["status"]))
    assert {-1, 0, 2} <= set(status.tolist())     # waiting, active, retired
    np.testing.assert_allclose(mc.numpy(),
                               np.asarray(oj.state.data["mass_components"]),
                               rtol=1e-4)
    # not yet released: the seeded matrix, untouched
    waiting = status == -1
    seeded = ot.oiltype.mass_fraction[:, None] * \
        ot.state.data["mass_oil"].numpy()[None, :]
    np.testing.assert_array_equal(mc.numpy()[:, waiting], seeded[:, waiting])
    assert (mc.numpy()[0, status == 2] < seeded[0, status == 2]).all()
    np.testing.assert_allclose(mc.sum(0).numpy(),
                               ot.state.data["mass_oil"].numpy(), rtol=1e-5)
    assert "mass_components" not in ot.result.variables
    assert "mass_components" not in oj.result.variables
    back = interop.element_state_to_numpy(
        interop.element_state_from_numpy(
            {k: np.asarray(v) for k, v in oj.state.data.items()}, "cpu"))
    np.testing.assert_array_equal(back["mass_components"],
                                  np.asarray(oj.state.data["mass_components"]))
    assert back["mass_components"].dtype == np.float32


def test_seed_cone_matches_jax():
    """``seed_cone`` between two points with a radius and a release
    interval, and OpenOil's mass per element from ``seed:m3_per_hour``:
    the same host arrays on both packages (one numpy generator seed)."""
    seedings = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from opendrift_tpu.models import OpenOil
            o = OpenOil(loglevel=40, seed=3)
        else:
            from opendrift_tpu_torch.models import OpenOil
            o = OpenOil(loglevel=40, seed=3, device="cpu")
        o.set_config("seed:m3_per_hour", 25.0)
        o.seed_cone(lon=[4.0, 4.6], lat=[60.0, 60.2], radius=[100, 2500],
                    number=300, time=[T0, T0 + timedelta(hours=5)],
                    oil_type="STATFJORD")
        o.seed_cone(lon=4.2, lat=60.1, time=T0, radius=500, number=20)
        seedings[pkg] = o
    oj, ot = seedings["jax"], seedings["torch"]
    assert ot.num_elements_scheduled_total == 320
    assert ot.get_oil_name() == oj.get_oil_name() == "STATFJORD"
    for sj, st in zip(oj._seedings, ot._seedings):
        assert set(sj) == set(st)
        for k in sj:
            if k == "time":
                assert list(sj[k]) == list(st[k])
            elif k == "viscosity":       # exp in float32 there, float64 here
                np.testing.assert_allclose(st[k], sj[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    with pytest.raises(ValueError, match="1 or 2 points"):
        ot.seed_cone(lon=[4, 5, 6], lat=[60, 60, 60], time=T0)


def test_registry_and_defaults():
    import opendrift_tpu_torch
    from opendrift_tpu.models import OpenOil as JOpenOil
    cls = opendrift_tpu_torch.get_model("OpenOil")
    assert "OpenOil" in opendrift_tpu_torch.get_model_names()
    ot, oj = cls(loglevel=40, device="cpu"), JOpenOil(loglevel=40)
    assert list(cls.ElementType.variables) == list(
        JOpenOil.ElementType.variables)
    assert cls.required_variables == JOpenOil.required_variables
    for key in ("drift:vertical_mixing", "drift:vertical_advection",
                "drift:current_uncertainty", "drift:wind_uncertainty",
                "drift:max_speed", "seed:oil_type", "seed:m3_per_hour",
                "processes:dispersion", "processes:biodegradation",
                "wave_entrainment:droplet_size_distribution"):
        assert ot.get_config(key) == oj.get_config(key), key
    ot.set_oiltype("STATFJORD")
    assert ot.get_oil_name() == "STATFJORD"
    assert ot.required_profiles() == ["ocean_vertical_diffusivity"]
