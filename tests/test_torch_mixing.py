"""The port's Visser mixing (opendrift_tpu_torch/ops/mixing.py) against
the JAX package's ``ops/pallas_mixing.py`` and its ``fori_loop`` path.

On the CPU the port's wrappers take their plain versions; the JAX side
runs its kernels' emulation (``interpret=True``), as its own tests do.

Tolerances: the SplitMix32 draws are integer math and must be bit-equal.
z is held at ``Z_ATOL`` = 2e-5 m after 15-20 substeps, with at most
``FLIP_SHARE`` of the elements beyond it: XLA's CPU backend contracts some
multiply-adds that the port rounds twice, and an ulp of difference can
move an element across a nearest-level boundary (``round(|z|)``), after
which the two walks feel different diffusivities.
"""

from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu.ops import pallas_mixing
from opendrift_tpu_torch.ops import mixing

Z_ATOL = 2e-5
FLIP_SHARE = 0.01
N = 1000          # not a multiple of the TPU kernel's 128 lanes


def _inputs(seed=3, n=N):
    r = np.random.default_rng(seed)
    z = -r.uniform(0.0, 30.0, n).astype(np.float32)
    z[r.random(n) < 0.05] = 0.0
    zmin = -r.uniform(5.0, 80.0, n).astype(np.float32)
    return {
        "z": np.maximum(z, zmin),
        "moving": (r.random(n) > 0.05).astype(np.float32),
        "w": r.normal(0.0, 1e-4, n).astype(np.float32),
        "wind": r.uniform(0.0, 20.0, n).astype(np.float32),
        "mld": r.uniform(10.0, 60.0, n).astype(np.float32),
        "zmin": zmin,
        "elem": r.integers(1 << 24, (1 << 31) - 1, n).astype(np.int32),
        "seed": int(r.integers(0, 1 << 32)),
    }


def _close(got, want, atol=Z_ATOL, share=FLIP_SHARE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    far = np.abs(got - want) > atol
    assert far.mean() <= share, (far.mean(), np.abs(got - want).max())


def _t(a, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype)


def test_draws_bit_equal():
    d = _inputs()
    seed_u32 = jnp.uint32(d["seed"])
    base_j = pallas_mixing._splitmix32(
        pallas_mixing._as_u32(jnp.asarray(d["elem"]))
        + seed_u32 * jnp.uint32(0x9e3779b9))
    base_t = mixing._element_base(_t(d["elem"], torch.int32), d["seed"])
    np.testing.assert_array_equal(base_t.numpy().astype(np.uint32),
                                  np.asarray(base_j))
    for i in (0, 1, 14, 1000):
        bits = pallas_mixing._splitmix32(
            base_j + jnp.uint32(i) * jnp.uint32(0x85ebca6b))
        R = jax.lax.shift_right_logical(bits, jnp.uint32(8)).astype(
            jnp.float32) * jnp.float32(2.0 / 16777216.0) - 1.0
        np.testing.assert_array_equal(mixing._draw(base_t, i).numpy(),
                                      np.asarray(R))


@pytest.mark.parametrize("mixing_at_surface", [False, True])
@pytest.mark.parametrize("model", list(mixing.WINDSPEED_MODELS))
def test_windspeed_plain_matches_pallas_emulation(model, mixing_at_surface):
    d = _inputs()
    kw = dict(ntimes=15, dt_mix=60.0, model=model, bg=1.2e-5,
              mixing_at_surface=mixing_at_surface)
    want = pallas_mixing.visser_mixing(
        d["z"], d["moving"], d["w"], d["wind"], d["mld"], d["zmin"],
        jnp.uint32(d["seed"]), elem=jnp.asarray(d["elem"]), interpret=True,
        **kw)
    before = mixing.visser_mixing.launches
    got = mixing.visser_mixing(
        _t(d["z"]), _t(d["moving"]), _t(d["w"]), _t(d["wind"]), _t(d["mld"]),
        _t(d["zmin"]), d["seed"], elem=_t(d["elem"], torch.int32), **kw)
    assert mixing.visser_mixing.launches == before   # the plain version
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want)
    assert (got <= 0).all() and (got >= _t(d["zmin"])).all()


def _profiles(n, L=26, h=2.0, seed=4):
    r = np.random.default_rng(seed)
    decay = np.exp(-np.arange(L) * h / 20.0)[:, None]
    K = (1e-2 * decay * r.uniform(0.5, 1.5, n)[None]).astype(np.float32)
    gradK = (-np.gradient(K, axis=0) / h).astype(np.float32)
    return K, gradK, h


@pytest.mark.parametrize("mixing_at_surface", [False, True])
def test_profile_plain_matches_pallas_emulation(mixing_at_surface):
    d = _inputs()
    K, gradK, h = _profiles(N)
    kw = dict(ntimes=20, dt_mix=60.0, h=h, mixing_at_surface=mixing_at_surface)
    want = pallas_mixing.visser_mixing_profile(
        d["z"], d["moving"], d["w"], K, gradK, d["zmin"],
        jnp.uint32(d["seed"]), elem=jnp.asarray(d["elem"]), interpret=True,
        **kw)
    got = mixing.visser_mixing_profile(
        _t(d["z"]), _t(d["moving"]), _t(d["w"]), _t(K), _t(gradK),
        _t(d["zmin"]), d["seed"], elem=_t(d["elem"], torch.int32), **kw)
    _close(got, want)


def test_wrapper_broadcasts_scalars_and_checks_shapes():
    d = _inputs(n=64)
    kw = dict(ntimes=3, dt_mix=60.0, model="windspeed_Large1994", bg=0.0,
              mixing_at_surface=False)
    full = mixing.visser_mixing(
        _t(d["z"]), torch.ones(64), torch.zeros(64), torch.full((64,), 8.0),
        torch.full((64,), 40.0), torch.full((64,), -60.0), 7, **kw)
    scal = mixing.visser_mixing(_t(d["z"]), 1.0, 0.0, 8.0, 40.0, -60.0, 7,
                                **kw)
    assert torch.equal(full, scal)        # default elem = slot index
    with pytest.raises(ValueError):
        mixing.visser_mixing(_t(d["z"]), torch.ones(3), 0.0, 8.0, 40.0,
                             -60.0, 7, **kw)
    with pytest.raises(ValueError):
        mixing.visser_mixing(_t(d["z"]), 1.0, 0.0, 8.0, 40.0, -60.0, 7,
                             **{**kw, "model": "constant"})


def _oceandrift(pkg, model, n=64):
    """A small 3D mixing run through the model (ConstantReader forcing)."""
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields import ConstantReader
        o = OceanDrift(loglevel=40)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        from opendrift_tpu_torch.fields import ConstantReader
        o = OceanDrift(loglevel=40, device="cpu")
    o.add_reader(ConstantReader({"x_wind": 9.0, "y_wind": 2.0,
                                "x_sea_water_velocity": 0.1,
                                "y_sea_water_velocity": 0.0,
                                "sea_floor_depth_below_sea_level": 40.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", model)
    o.set_config("environment:fallback:ocean_vertical_diffusivity", 2e-3)
    r = np.random.default_rng(5)
    o.seed_elements(lon=4.0, lat=60.0, number=n, time=datetime(2020, 1, 1),
                    z=-r.uniform(0.0, 30.0, n))
    o.run(duration=timedelta(minutes=40), time_step=600)
    return o


@pytest.mark.parametrize("model", ["windspeed_Large1994", "constant"])
def test_model_matches_jax_fori_loop_path(model):
    """The JAX package on the CPU takes its generic ``fori_loop`` mixing
    path (models/oceandrift.py:586), with the same per-element SplitMix32
    draws as the kernels; the port's model routes to a kernel wrapper."""
    oj = _oceandrift("jax", model)
    assert not oj._pallas_mixing_applicable(model)
    kernel = (mixing.visser_mixing_profile if model == "constant"
              else mixing.visser_mixing)
    ot = _oceandrift("torch", model)
    assert kernel.launches == 0          # the CPU takes the plain version
    _close(ot.result["z"].values, np.asarray(oj.result["z"].values))



def _physics_args(n=401, seed=6):
    r = np.random.default_rng(seed)
    f = np.float32
    return {"wind": r.uniform(0.0, 25.0, n).astype(f),
            "depth": r.uniform(0.0, 80.0, n).astype(f),
            "mld": r.uniform(5.0, 60.0, n).astype(f),
            "su": r.normal(0.0, 0.2, n).astype(f),
            "sv": r.normal(0.0, 0.2, n).astype(f),
            "hs": r.uniform(0.5, 6.0, n).astype(f),
            "tp": r.uniform(3.0, 14.0, n).astype(f),
            "z": -r.uniform(0.0, 20.0, n).astype(f)}


@pytest.mark.parametrize("name,keys", [
    ("verticaldiffusivity_Sundby1983", ("wind", "depth", "mld")),
    ("verticaldiffusivity_Large1994", ("wind", "depth", "mld")),
    ("verticaldiffusivity_stepfunction", ("depth",)),
    ("wave_period_from_wind", ("wind",)),
    ("significant_wave_height_from_wind", ("wind",)),
    ("stokes_drift_profile_monochromatic", ("su", "sv", "hs", "tp", "z")),
    ("stokes_drift_profile_exponential", ("su", "sv", "hs", "tp", "z")),
    ("stokes_drift_profile_phillips", ("su", "sv", "hs", "tp", "z")),
])
def test_physics_parameterisations_match_jax(name, keys):
    """The elementwise physics the kernels and the step evaluate
    (ops/physics.py), against the JAX package's, at float32 rtol 1e-5
    (erfc and exp may differ by an ulp or two between the libraries)."""
    from opendrift_tpu.ops import physics as jph
    from opendrift_tpu_torch.ops import physics as tph
    a = _physics_args()
    extra = (1.2e-5,) if name.endswith(("Sundby1983", "Large1994")) else ()
    want = getattr(jph, name)(*(jnp.asarray(a[k]) for k in keys), *extra)
    got = getattr(tph, name)(*(_t(a[k]) for k in keys), *extra)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-9)
