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
from opendrift_tpu_torch.tools import kernel_check

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


@pytest.mark.parametrize("case", kernel_check.PROFILE_EDGE_CASES)
def test_profile_plain_matches_pallas_emulation_on_edge_cases(case):
    """The profile kernel's edge cases on the card (chip_smoke.py
    check_profile_edges) through the plain version here and the JAX
    kernel's emulation: the first and last levels in every block, 2 and
    201 levels, walks of 10 levels a substep, NaN depths."""
    t, seed, h = kernel_check.profile_edge_inputs(case, N, "cpu", block=64)
    args = [t[k] for k in ("z", "moving", "w", "Kprof", "gradK", "zmin")]
    kw = dict(ntimes=15, dt_mix=60.0, h=h, mixing_at_surface=False)
    want = pallas_mixing.visser_mixing_profile(
        *(a.numpy() for a in args), jnp.uint32(seed),
        elem=jnp.asarray(t["elem"].numpy()), interpret=True, **kw)
    got = mixing.visser_mixing_profile(*args, seed, elem=t["elem"], **kw)
    _close(got, want)


@pytest.mark.parametrize("L,n", [(3, 8), (5, 13), (26, 257), (2, 1)])
def test_profile_bound_bytes_counts_sectors_like_a_brute_force(L, n):
    r = np.random.default_rng(L * 100 + n)
    visited = r.random((L, n)) < 0.2
    visited[0, 0] = True
    b = mixing.profile_bound_bytes(torch.as_tensor(visited))
    # a sector is 8 floats of the flat level-major (L * N) array
    sectors = {(lvl * n + e) // 8 for lvl, e in zip(*np.nonzero(visited))}
    pairs = int(visited.sum())
    assert b["pairs"] == pairs and b["sectors"] == len(sectors)
    assert b["total"] == n * 24 + pairs * 8           # 4 B a pair
    assert b["sector_total"] == n * 24 + len(sectors) * 64
    if n % 8 == 0:      # then the sectors are the (level, element // 8)
        assert len(sectors) == len({(lvl, e // 8) for lvl, e in
                                    zip(*np.nonzero(visited))})
    assert b["sector_total"] >= b["total"]


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


# ------------------------------------------- the kernels' reciprocal quotient

def _rn32_sum(c, p):
    """RN_float32(c + p) for a float32 array ``c`` and a float64 array ``p``
    of exact values: the sum is taken in float64 with its rounding error
    (TwoSum), and where the float64 sum sits exactly half-way between two
    float32 the error decides the side, so nothing is rounded twice."""
    f32 = np.float32
    c = c.astype(np.float64)
    s = c + p
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    out = s.astype(f32)
    o64 = out.astype(np.float64)
    lo = np.nextafter(out, f32(-np.inf))
    hi = np.nextafter(out, f32(np.inf))
    tie_lo = (s - lo.astype(np.float64) == o64 - s) & (s != o64)
    tie_hi = (hi.astype(np.float64) - s == s - o64) & (s != o64)
    out = np.where(tie_lo & (err < 0), lo, out)
    return np.where(tie_hi & (err > 0), hi, out)


def _fma32(a, b, c):
    """One float32 fused multiply-add, a * b + c with a single rounding: the
    product of two float32 is exact in float64."""
    return _rn32_sum(c, a.astype(np.float64) * b.astype(np.float64))


def _reciprocal_quotient(a, mld):
    """csrc/visser_mixing.cu's quotient: r = 1 / mld once (correctly
    rounded), then q = a * r; q = fma(fma(-mld, q, a), r, q)."""
    r = (np.float32(1.0) / mld).astype(np.float32)
    q = (a * r).astype(np.float32)
    return _fma32(_fma32(-mld, q, a), r, q)


def _levels_of(mld):
    """Every numerator the kernels divide by ``mld``: the integer levels 0
    to mld + 2 and the clipped level mld + 1 with its neighbours."""
    top = int(min(np.floor(float(mld)) + 3, 5000))
    return np.concatenate([
        np.arange(0, top + 1, dtype=np.float32),
        np.array([mld, mld + np.float32(1), mld + np.float32(2)],
                 dtype=np.float32)])


def test_fma_emulation_matches_exact_rationals():
    from fractions import Fraction
    f32 = np.float32

    def rn32(x):
        c = f32(float(x))
        near = (np.nextafter(c, f32(-np.inf)), c, np.nextafter(c, f32(np.inf)))
        return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                        int(f32(v).view(np.uint32)) & 1))

    r = np.random.default_rng(8)
    b = np.exp(r.uniform(np.log(2.0 ** -20), np.log(2.0 ** 20), 600)
               ).astype(f32)
    a = (b * r.uniform(0.0, 1.2, 600)).astype(f32)
    # products that land near half-way points, where a second rounding shows
    c = (a * b).astype(f32)
    c = np.where(np.arange(600) % 2 == 0, np.nextafter(c, f32(0)), -c)
    got = _fma32(a, b, c)
    for i in range(600):
        want = rn32(Fraction(float(a[i])) * Fraction(float(b[i]))
                    + Fraction(float(c[i])))
        assert got[i] == want, (a[i], b[i], c[i])


@pytest.mark.parametrize("lo,hi,count", [
    (2.0 ** -20, 0.5, 6000), (0.5, 10.0, 6000), (10.0, 60.0, 12000),
    (60.0, 400.0, 1500), (400.0, 2.0 ** 20, 150)])
def test_reciprocal_quotient_equals_division(lo, hi, count):
    """For a dense sample of mixed-layer depths inside the range that takes
    the reciprocal, every level's quotient is the float32 division's."""
    r = np.random.default_rng(9)
    mlds = np.exp(r.uniform(np.log(lo), np.log(hi), count)).astype(np.float32)
    # depths next to a power of two, where a reciprocal is least accurate
    mlds[:64] = np.nextafter(np.float32(2.0) ** r.integers(
        int(np.ceil(np.log2(lo))) + 1, int(np.floor(np.log2(hi))) + 1, 64
    ).astype(np.float32), np.float32(0))
    lo32, hi32 = (np.float32(v) for v in mixing.RECIPROCAL_MLD_RANGE)
    assert ((mlds >= lo32) & (mlds <= hi32)).all()
    a = np.concatenate([_levels_of(m) for m in mlds])
    m = np.concatenate([np.full(_levels_of(m).shape, m) for m in mlds])
    np.testing.assert_array_equal(_reciprocal_quotient(a, m),
                                  (a / m).astype(np.float32))


def test_reciprocal_quotient_on_the_hardest_depths():
    """The quotients nearest a rounding boundary: for a level a = a' 2^j
    (a' odd, below 64) the mixed-layer depths B 2^k with |a' 2^s - K B| <= 3
    for an odd 25-bit K put a / mld within 2^-23 ulp of the half-way point
    K; the all-ones depths 2^k (1 - 2^-24) are among them."""
    f32 = np.float32
    K = np.arange(2 ** 24 + 1, 2 ** 25, 2, dtype=np.int64)
    hard = []
    for odd in range(1, 64, 2):
        A = odd << (23 - (odd.bit_length() - 1))
        for shift in (24, 25):                 # a / mld in [1, 2) or [.5, 1)
            T = A << shift
            B = (T + K // 2) // K
            d = T - K * B
            ok = (np.abs(d) <= 3) & (d != 0) & (B >= 2 ** 23) & (B < 2 ** 24)
            hard += [(odd, int(b)) for b in B[ok]]
    assert (1, 2 ** 24 - 1) in hard and len(hard) > 50
    a, m = [], []
    for odd, B in hard:
        for k in range(-30, -12):              # mld from 2^-7 to 2^11
            mld = f32(B * 2.0 ** k)
            for j in range(12):
                if odd * 2 ** j <= float(mld) + 2:
                    a.append(odd * 2 ** j)
                    m.append(mld)
    a, m = np.array(a, f32), np.array(m, f32)
    assert a.size > 3000
    np.testing.assert_array_equal(_reciprocal_quotient(a, m),
                                  (a / m).astype(np.float32))


def test_reciprocal_guard_sends_odd_depths_to_the_division():
    """Zero, subnormal, tiny, huge, infinite, NaN and negative mixed-layer
    depths fail the guard (both comparisons are false for NaN), and the
    kernels' source states the same range."""
    import os
    lo, hi = (np.float32(v) for v in mixing.RECIPROCAL_MLD_RANGE)
    with np.errstate(over="ignore", under="ignore"):
        odd = np.array([0.0, -0.0, 1e-45, 1e-40, 1e-7, 2.0 ** -21, 2.0 ** 21,
                        1e7, 3e38, np.inf, -np.inf, np.nan, -5.0],
                       dtype=np.float32)
    assert not ((odd >= lo) & (odd <= hi)).any()
    inside = np.array([2.0 ** -20, 0.05, 1.0, 50.0, 2.0 ** 20], np.float32)
    assert ((inside >= lo) & (inside <= hi)).all()
    assert float(lo) == 2.0 ** -20 and float(hi) == 2.0 ** 20
    src = os.path.join(os.path.dirname(mixing.__file__), "..", "csrc",
                       "visser_mixing.cu")
    with open(src) as f:
        text = f.read()
    assert "kReciprocalMin = 0x1p-20f" in text
    assert "kReciprocalMax = 0x1p+20f" in text
    # nothing on the reciprocal's way leaves the normal range at the ends
    for mld in (lo, hi):
        a = _levels_of(mld)
        q = _reciprocal_quotient(a, np.full(a.shape, mld))
        np.testing.assert_array_equal(q, (a / mld).astype(np.float32))
        assert np.isfinite(q).all()


# ------------------------------------------------------------- edge cases --

def _edge_inputs(n, seed=11):
    """``_inputs`` with, in turns over the elements: a NaN seafloor, a mixed
    layer thinner than 1 m (one starting at the surface), a frozen element
    and an untouched one."""
    d = _inputs(seed=seed, n=n)
    i = np.arange(n)
    d["zmin"][i % 5 == 1] = np.nan
    thin = i % 5 == 2
    d["mld"][thin] = np.random.default_rng(seed).uniform(
        0.05, 1.0, int(thin.sum())).astype(np.float32)
    d["z"][i % 10 == 2] = 0.0
    d["moving"][i % 5 == 3] = 0.0
    return d


@pytest.mark.parametrize("n", [1, 7, 1001])
@pytest.mark.parametrize("model", list(mixing.WINDSPEED_MODELS))
def test_windspeed_plain_matches_pallas_emulation_on_edge_cases(model, n):
    """NaN seafloors, mixed layers thinner than 1 m, frozen elements, one
    element and odd sizes, at the tolerance of the test above."""
    d = _edge_inputs(n)
    kw = dict(ntimes=15, dt_mix=60.0, model=model, bg=1.2e-5,
              mixing_at_surface=False)
    want = np.asarray(pallas_mixing.visser_mixing(
        d["z"], d["moving"], d["w"], d["wind"], d["mld"], d["zmin"],
        jnp.uint32(d["seed"]), elem=jnp.asarray(d["elem"]), interpret=True,
        **kw))
    got = mixing.visser_mixing(
        _t(d["z"]), _t(d["moving"]), _t(d["w"]), _t(d["wind"]), _t(d["mld"]),
        _t(d["zmin"]), d["seed"], elem=_t(d["elem"], torch.int32), **kw)
    assert got.shape == (n,)
    _close(got, want)
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(d["zmin"]))
    frozen = (d["moving"] == 0) & ~np.isnan(d["zmin"])
    # a frozen element keeps its depth (the surface stick aside)
    np.testing.assert_array_equal(got[frozen], d["z"][frozen])
