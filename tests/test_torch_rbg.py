"""``general:rng='rbg'`` in the port (``opendrift_tpu_torch/rng.py``
``RbgKey``, ``ops/philox.py``) against ``jax.random`` with ``impl='rbg'``
and against the JAX package's rbg runs, on the CPU.

Tolerances: keys, ``fold_in``, ``split`` and ``bits`` are integer hashes
and must be bit-equal (the JAX package under test runs on the CPU, whose
rbg stream is XLA's Philox4x32-10 expansion); ``uniform`` is exact, as for
threefry; ``normal`` and ``exponential`` take the same uniforms through
functions whose ``log1p`` may differ by an ulp between the libraries, so
they keep the bounds of ``tests/test_torch_rng.py`` (4 ulp) and of
``tests/test_torch_zoo.py`` (2 ulp).  Whole runs keep the slice tolerance
of each model's own test file.
"""

import os
import sys
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from opendrift_tpu.ops import pallas_mixing  # noqa: E402
from opendrift_tpu_torch import rng  # noqa: E402
from opendrift_tpu_torch.ops import philox  # noqa: E402
import test_torch_chemistry as chem  # noqa: E402
import test_torch_oceandrift as ocean  # noqa: E402
import test_torch_openoil as oil  # noqa: E402
import test_torch_zoo as zoo  # noqa: E402
import torch_dd_fixtures as X  # noqa: E402

M32 = 0xFFFFFFFF
RBG = {"general:rng": "rbg"}
NORMAL_ULPS = 4.0
EXPONENTIAL_ULPS = 2.0


def _jkey(seed):
    return jax.random.key(seed, impl="rbg")


def _words(jk):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(jk)))


def _wrap(words):
    return jax.random.wrap_key_data(np.asarray(words, np.uint32), impl="rbg")


# ------------------------------------------------------------------ keys --

@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 + 5])
def test_key_data_fold_in_and_split_bit_equal(seed):
    jk, tk = _jkey(seed), rng.rbg_key(seed)
    assert _words(jk) == tuple(tk)
    for data in (0, 3, 987654, 2 ** 31 + 5):
        assert _words(jax.random.fold_in(jk, data)) == \
            tuple(rng.fold_in(tk, data))
    jn = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jk, 3),
                                               7), 1)
    tn = rng.fold_in(rng.fold_in(rng.fold_in(tk, 3), 7), 1)
    assert _words(jn) == tuple(tn)
    assert [_words(k) for k in jax.random.split(jk, 3)] == \
        [tuple(k) for k in rng.split(tk, 3)]


def test_seven_folded_with_three():
    assert tuple(rng.rbg_key(7)) == (0, 7, 0, 7)
    assert tuple(rng.fold_in(rng.rbg_key(7), 3)) == (
        276534068, 1641862660, 276534068, 1641862660)


def test_keys_pickle_and_compare():
    import pickle
    k = rng.fold_in(rng.rbg_key(5), 2)
    assert pickle.loads(pickle.dumps(k)) == k
    assert k != rng.fold_in(rng.PRNGKey(5), 2)


# ------------------------------------------------------------------ bits --

@pytest.mark.parametrize("shape", [(), (1,), (13,), (3, 5), (2, 4097)])
def test_bits_bit_equal(shape):
    jk = jax.random.fold_in(_jkey(11), 4)
    tk = rng.fold_in(rng.rbg_key(11), 4)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    got = rng.bits(tk, shape, device="cpu")
    if shape == ():
        assert isinstance(got, int) and got == int(want)
    else:
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("w01", [(5, 6), (M32, M32)])
def test_bits_carry_into_the_high_counter(w01):
    """s1 = 2^64 - 3: the counter wraps after three blocks and carries
    into s0 (which wraps too for s0 = 2^64 - 1)."""
    s1 = 2 ** 64 - 3
    words = (*w01, s1 & M32, s1 >> 32)
    want = np.asarray(jax.random.bits(_wrap(words), (3, 11)))
    got = rng.bits(rng.RbgKey(*words), (3, 11)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_mulhilo_is_exact_at_the_extremes():
    """The plain version's 16-bit split against Python's exact product."""
    xs = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, M32]
    t = torch.tensor(xs, dtype=torch.int64)
    for m in (0xD2511F53, 0xCD9E8D57, M32):
        hi, lo = philox._mulhilo(t, m)
        for x, h, l in zip(xs, hi.tolist(), lo.tolist()):
            assert (h, l) == ((x * m) >> 32, (x * m) & M32)


def test_uniform_exact():
    jk, tk = _jkey(5), rng.rbg_key(5)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-1.0, 2.5)):
        want = np.asarray(jax.random.uniform(jk, (4099,), minval=lo,
                                             maxval=hi))
        got = rng.uniform(tk, (4099,), lo, hi, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_normal_and_exponential_within_ulps():
    jk = jax.random.fold_in(_jkey(2), 9)
    tk = rng.fold_in(rng.rbg_key(2), 9)
    for fn, jfn, shape, bound in (
            (rng.normal, jax.random.normal, (2, 5000), NORMAL_ULPS),
            (rng.exponential, jax.random.exponential, (5000,),
             EXPONENTIAL_ULPS)):
        want = np.asarray(jfn(jk, shape))
        got = fn(tk, shape, device="cpu").numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= bound, (fn.__name__, ulps.max())


@pytest.mark.parametrize("draw", ["bits", "uniform", "normal",
                                  "exponential"])
def test_partitioned_draw_is_the_slice_of_the_global_draw(draw):
    """A shard of 8 of 40 elements at offsets inside and across Philox
    blocks (words of a counter split over two shards)."""
    key = rng.fold_in(rng.rbg_key(7), 3)
    fn = {"bits": rng.bits, "uniform": rng.uniform, "normal": rng.normal,
          "exponential": rng.exponential}[draw]
    full = fn(key, (3, 40))
    for offset in (0, 3, 8, 30, 32):
        with rng.element_partition(offset, 8, 40):
            part = fn(key, (3, 8))
        assert torch.equal(part, full[:, offset:offset + 8]), offset
    assert torch.equal(rng.bits(key, (3, 5), partition=(35, 40)),
                       rng.bits(key, (3, 40))[:, 35:40])


def test_a_padded_last_shard_runs_past_the_row():
    """The last shard of a padded sharded run (13 slots a tile, 100
    elements) draws past ``n_global``: its real slots are the slice of
    the global draw, its padding the next row's words."""
    key = rng.fold_in(rng.rbg_key(7), 3)
    stream = rng.bits(key, (3 * 100 + 4,))
    part = rng.bits(key, (3, 13), partition=(91, 100))
    for r in range(3):
        assert torch.equal(part[r], stream[r * 100 + 91:r * 100 + 104])
    assert torch.equal(part[:, :9], rng.bits(key, (3, 100))[:, 91:])


def test_the_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU draw must not reach the kernel")
    monkeypatch.setattr(philox, "load_library", no_build)
    count = philox.philox_bits.launches
    got = philox.philox_bits((1, 2, 3, 4), 2, 9, 5, 20, device="cpu")
    assert torch.equal(got, philox.philox_bits_plain((1, 2, 3, 4), 2, 9, 5,
                                                     20))
    assert philox.philox_bits.launches == count
    with pytest.raises(ValueError, match="cuda or cpu"):
        philox.philox_bits((1, 2, 3, 4), 1, 8, device="meta")
    with pytest.raises(ValueError, match="not a partition"):
        philox.philox_bits((1, 2, 3, 4), 2, 9, -1, 20)


def test_cuda_without_a_card_raises():
    """No fallback: a draw on ``cuda`` builds and launches the kernel, and
    without nvcc or a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        rng.bits(rng.rbg_key(1), (16,), device="cuda")


# ------------------------------------------------------------ whole runs --

def _oceandrift(pkg):
    o = ocean._simulation(pkg, "windspeed_Large1994", 10.0)
    o.set_config("general:rng", "rbg")
    o.run(duration=timedelta(hours=5), time_step=900, time_step_output=3600)
    return o


def test_oceandrift_rk4_mixing_and_diffusion_run_matches_jax():
    """3D RK4, Large1994 mixing through K1's plain version with its seed
    from rbg bits, and horizontal diffusion's rbg normals."""
    oj, ot = _oceandrift("jax"), _oceandrift("torch")
    assert ot.result["lon"].shape == oj.result["lon"].shape == (ocean.N, 6)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        ocean._assert_close(ot.result[var].values, oj.result[var].values,
                            var)
    threefry = ocean._run("torch", "windspeed_Large1994", 10.0)
    assert not np.array_equal(threefry.result["lon"].values[:, -1],
                              ot.result["lon"].values[:, -1])


def test_openoil_run_matches_jax(monkeypatch):
    """OpenOil through K3's plain version (the JAX side its Pallas
    emulation), its mixing seed and entrainment salt from rbg bits."""
    monkeypatch.setattr(pallas_mixing, "FORCE_INTERPRET", True)
    runs = {}
    for pkg in ("jax", "torch"):
        o = oil._oil_simulation(pkg, n=256, **RBG)
        o.run(duration=timedelta(hours=3), time_step=900,
              time_step_output=3600)
        runs[pkg] = o
    oj, ot = runs["jax"], runs["torch"]
    sj = np.asarray(oj.result["status"].values)
    st = np.asarray(ot.result["status"].values)
    assert st.shape == sj.shape == (256, 4)
    assert np.mean(st != sj) <= 0.01
    for var in ("lon", "lat", "z", "mass_oil", "mass_evaporated",
                "mass_dispersed", "water_fraction"):
        oil._assert_slice_close(ot.result[var].values, oj.result[var].values,
                                var)
    z = ot.result["z"].values[:, -1]
    assert (z < 0).any() and (z == 0).any()


@pytest.mark.parametrize("name", ["Leeway", "PlastDrift"])
def test_zoo_run_matches_jax(name):
    """Leeway's capsizing and jibing uniforms; PlastDrift 'analytical'
    (its exponential depths)."""
    oj = zoo._zoo_run("jax", name, **RBG)
    ot = zoo._zoo_run("torch", name, **RBG)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        zoo._assert_close(ot.result[var].values, oj.result[var].values, var,
                          ocean.MEDIAN_ATOL[var], ocean.OUTLIER_ATOL[var])
    for var in zoo._case(name)[4]:
        want = np.asarray(oj.result[var].values, np.float64)
        scale = np.abs(want[~np.isnan(want)])
        atol = zoo.VAR_ATOL + zoo.VAR_RTOL * (np.median(scale)
                                              if scale.size else 0)
        zoo._assert_close(ot.result[var].values, want, var, atol, 10 * atol)


def test_chemicaldrift_run_matches_jax():
    """ChemicalDrift's speciation uniforms (``rng.split``) and diameter
    normals."""
    oj = chem._chem_run("jax", "chemical_nondiss", **RBG)
    ot = chem._chem_run("torch", "chemical_nondiss", **RBG)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        zoo._assert_close(ot.result[var].values, oj.result[var].values, var,
                          ocean.MEDIAN_ATOL[var], ocean.OUTLIER_ATOL[var])
    sp_t = np.asarray(ot.result["specie"].values)
    assert np.mean(sp_t != np.asarray(oj.result["specie"].values)) \
        <= chem.SPECIATION_SHARE
    assert (sp_t[:, -1] != sp_t[:, 0]).any()


def _sharded_against_jax_and_plain(n, tiles, jax_sharded=True):
    """The JAX package's run (over its 8 virtual devices, or unsharded),
    the port's ``tiles``-tile run and its plain run of ``n`` elements: the
    sharded run equals the plain one bit for bit, the plain one the JAX
    package's within the slice tolerance."""
    from opendrift_tpu_torch.models import OceanDrift as TOceanDrift

    def run(pkg, mesh=None):
        if pkg == "jax":
            from opendrift_tpu.models import OceanDrift
            from opendrift_tpu.fields import ArrayReader
            o = OceanDrift(loglevel=40)
            o.set_config("parallel:particle_sharding", jax_sharded)
        else:
            from opendrift_tpu_torch.fields import ArrayReader
            o = TOceanDrift(loglevel=40, device="cpu")
            if mesh:
                o.set_mesh(mesh)
        current, wind, x, y, depths, times = ocean._forcing()
        o.add_reader(ArrayReader(current, x, y, times, depths=depths))
        o.add_reader(ArrayReader(wind, x, y, times))
        o.set_config("environment:fallback:land_binary_mask", 0)
        o.set_config("general:rng", "rbg")
        o.set_config("drift:vertical_mixing", True)
        o.set_config("drift:horizontal_diffusivity", 10.0)
        o.set_config("drift:current_uncertainty", 0.05)
        o.seed_elements(lon=4.0, lat=59.8, radius=5000, number=n,
                        time=times[0], z=-np.linspace(0, 15, n))
        o.run(duration=timedelta(hours=4), time_step=900,
              time_step_output=3600)
        return o

    oj, sharded, plain = run("jax"), run("torch", ["cpu"] * tiles), \
        run("torch")
    assert sharded._sharding is not None and plain._sharding is None
    assert sharded._n_padded_elements == -(-n // tiles) * tiles
    for var in ("lon", "lat", "z", "status"):
        assert np.array_equal(sharded.result[var].values,
                              plain.result[var].values, equal_nan=True), var
    np.testing.assert_array_equal(plain.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        ocean._assert_close(plain.result[var].values, oj.result[var].values,
                            var)


def test_particle_sharded_run_matches_jax_and_the_plain_run():
    """The JAX package shards its elements over its 8 virtual devices and
    draws what its plain run draws; the port's 8-tile run draws the slice
    of the global Philox stream, so it equals the plain run bit for bit
    and the JAX package's run within the slice tolerance."""
    _sharded_against_jax_and_plain(128, 8)


def test_padded_particle_sharded_run_matches_jax_and_the_plain_run():
    """250 elements over 8 tiles are padded to 256: the last tile's draws
    run 6 words past the element axis, into slots that are never
    released, and the run still equals the plain one.  The port's sharded
    run draws the plain run's counters whatever the padding (as under
    threefry since the parallel layer came); the JAX package's own
    sharded run draws rows of the padded 256, so it is held against the
    JAX package's unsharded run.  (Shards of 32, a multiple of 16, keep
    the CPU's vectorised transcendentals on one path; see
    tests/test_torch_sharding.py.)"""
    _sharded_against_jax_and_plain(250, 8, jax_sharded=False)


def _tiled_diffusion(pkg):
    o = X.model(pkg, True)
    o.set_config("general:rng", "rbg")
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:vertical_advection", False)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    o.add_reader(X.forcing(pkg))
    o.seed_elements(4.0, 59.2, number=400, radius=2000, time=X.T0)
    o.run(steps=20, time_step=1800)
    return o


def test_tiled_run_matches_jax():
    """Domain decomposition over 8 tiles: each tile folds its index into
    the rbg key and draws over its own slots, in both packages."""
    ot = _tiled_diffusion("torch")
    lat = X.values(ot, "lat")
    assert np.isfinite(lat).all()
    assert lat[:, -1].std() > lat[:, 0].std()
    X.assert_matches_jax(ot, _tiled_diffusion("jax"))


def test_rng_implementation_config():
    """The port's copy of tests/test_engine_features.py
    ``test_rng_implementation_config``: 'rbg' keeps the diffusion
    statistics of the default threefry, from another stream."""
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields.analytic import ConstantReader

    res = {}
    for impl in ("threefry", "rbg"):
        o = OceanDrift(loglevel=40, device="cpu")
        o.add_reader(ConstantReader({"x_sea_water_velocity": 0.0,
                                     "y_sea_water_velocity": 0.0,
                                     "land_binary_mask": 0.0}))
        o.set_config("general:rng", impl)
        o.set_config("drift:horizontal_diffusivity", 20.0)
        o.seed_elements(lon=4.0, lat=60.0, number=4000,
                        time=datetime(2020, 1, 1))
        o.run(duration=timedelta(hours=6), time_step=600)
        res[impl] = np.asarray(o.result["lon"].values)[:, -1]
    for impl in res:
        assert np.isfinite(res[impl]).all()
    s_t, s_r = res["threefry"].std(), res["rbg"].std()
    assert abs(s_t - s_r) / s_t < 0.15
    assert not np.allclose(res["threefry"], res["rbg"])
