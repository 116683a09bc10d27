"""The port's ``ArrayReader`` (opendrift_tpu_torch/fields/grid.py) against
the JAX package's: the same row-tier choice, packed tables and u/v
companion table bit for bit, and the same sampled values.

Tolerances: the host packing is the same numpy code and must be
bit-equal.  Sampled values are float32 blends in the same order; XLA's
CPU backend may fuse a multiply-add that torch rounds twice, so they are
held at rtol 1e-6 plus atol 1e-6 (currents and winds of O(1-10)).
"""

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu.fields import ArrayReader as JArrayReader
from opendrift_tpu_torch.fields import ArrayReader as TArrayReader
from opendrift_tpu.ops import interp as jinterp
from opendrift_tpu_torch.fields import grid as tgrid
from opendrift_tpu_torch.interop import corner_block_to_numpy, \
    device_state_from_numpy, device_state_to_numpy, table_to_numpy
from opendrift_tpu_torch.ops import interp as tinterp

RTOL = ATOL = 1e-6
T0 = datetime(2021, 6, 1)


def _forcing(seed=0, nx=24, ny=20, nz=6, nt=5):
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    depths = np.array([0.0, 2.0, 5.0, 10.0, 20.0, 40.0][:nz], np.float32)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    u = (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32)
    v = (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32)
    u[:, 3:, :2, :3] = np.nan                # missing cells to be filled
    current = {"x_sea_water_velocity": u, "y_sea_water_velocity": v,
               "sea_floor_depth_below_sea_level":
                   r.uniform(30.0, 80.0, (ny, nx)).astype(np.float32)}
    wind = {"x_wind": (5 + 3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32),
            "y_wind": (3 * r.standard_normal((nt, ny, nx))).astype(
                np.float32)}
    return current, wind, x, y, depths, times


def _pair(data, x, y, times, depths=None, extent=None):
    readers = []
    for cls in (JArrayReader, TArrayReader):
        rd = cls(data, x, y, times, depths=depths)
        rd.set_run_epoch(T0)
        rd.pair_hint = "xy"
        rd.prepare(extent=extent, start_time=T0,
                   end_time=T0 + timedelta(hours=5), max_speed=2.0,
                   interval_seconds=9000.0, variables=list(data))
        readers.append(rd)
    return readers


def _positions(n=257, seed=3):
    r = np.random.default_rng(seed)
    lon = r.uniform(2.9, 5.1, n).astype(np.float32)   # some outside
    lat = r.uniform(59.1, 60.4, n).astype(np.float32)
    z = -r.uniform(0.0, 50.0, n).astype(np.float32)
    return lon, lat, z


def _check_sample(jr, tr, jstate, tstate, varnames, t):
    lon, lat, z = _positions()
    jv, jc = jr.sample(jstate, varnames, jnp.float32(t), jnp.asarray(lon),
                       jnp.asarray(lat), jnp.asarray(z))
    tv, tc = tr.sample(tstate, varnames, np.float32(t), torch.as_tensor(lon),
                       torch.as_tensor(lat), torch.as_tensor(z))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert set(tv) == set(jv)
    for v in varnames:
        np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which,tier", [("current", "xyz"), ("wind", "xy")])
def test_tables_bit_equal_and_samples_match(which, tier):
    current, wind, x, y, depths, times = _forcing()
    data, dz = (current, depths) if which == "current" else (wind, None)
    jr, tr = _pair(data, x, y, times, depths=dz,
                   extent=(3.5, 59.4, 4.5, 60.1))
    jstate = jr.device_state(T0, T0 + timedelta(seconds=9000))
    host = tr.device_state(T0, T0 + timedelta(seconds=9000))
    assert jr._sampler.pair_mode == tr._sampler.pair_mode == tier
    assert (jr._ix, jr._iy) == (tr._ix, tr._iy)
    assert jr._sampler.col_of == tr._sampler.col_of
    assert set(host) == set(jstate)
    for k in host:
        np.testing.assert_array_equal(host[k], np.asarray(jstate[k]))
    tstate = device_state_from_numpy(host, "cpu")
    for k, v in device_state_to_numpy(tstate).items():
        np.testing.assert_array_equal(v, host[k])
    names = list(data)
    for t in (0.0, 5000.0, 9000.0):
        _check_sample(jr, tr, jstate, tstate, names, t)
    if which == "current":
        # the RK stage refetch: u/v only, from the narrow companion
        assert "packed_uv" in host
        _check_sample(jr, tr, jstate, tstate,
                      ["x_sea_water_velocity", "y_sea_water_velocity"],
                      4321.0)


def test_window_moves_with_time():
    current, _, x, y, depths, times = _forcing(nt=5)
    jr, tr = _pair(current, x, y, times, depths=depths)
    for start in (T0 + timedelta(hours=4), T0 + timedelta(hours=9)):
        js = jr.device_state(start, start + timedelta(seconds=9000))
        ts = tr.device_state(start, start + timedelta(seconds=9000))
        np.testing.assert_array_equal(ts["times"], np.asarray(js["times"]))
        np.testing.assert_array_equal(ts["packed"], np.asarray(js["packed"]))


# ------------------------------------------------ tiers and storages ------

@pytest.mark.parametrize("shape,want_xy,tier", [
    ((16, 200, 200, 11), True, "xyz"),     # 28 MB x 8 = 225 MB
    ((16, 200, 200, 14), True, "xy"),      # 36 MB: x 8 over, x 4 under
    ((1, 200, 200, 4), True, "xy"),        # a 2D reader is never 'xyz'
    ((16, 200, 200, 11), False, "x"),      # nobody asked for the wide tiers
    ((16, 400, 400, 8), True, "x"),        # 82 MB: only x 2 under
    ((16, 400, 400, 13), True, "none"),    # 133 MB: x 2 over the budget
    ((16, 200, 200, 0), True, "none")])
def test_tier_choice_by_bytes(shape, want_xy, tier):
    """The tier follows the table's bytes against the 256 MB budget, the
    JAX package's rule (fields/grid.py:351-362 there)."""
    assert tgrid.ROW_BUDGET_BYTES == 256e6
    assert tgrid.choose_pair_mode(*shape, want_xy) == tier


def _state_pair(jr, tr):
    end = T0 + timedelta(seconds=9000)
    jstate = jr.device_state(T0, end)
    host = tr.device_state(T0, end)
    return jstate, host, device_state_from_numpy(host, "cpu")


def _assert_tables_equal(host, jstate):
    """Every entry of the port's host state equals the JAX device state's,
    table storages member by member and bit for bit."""
    assert set(host) == set(jstate)
    for k in host:
        got = table_to_numpy(host[k])
        want = table_to_numpy(jstate[k])
        if isinstance(got, dict):
            assert got["kind"] == want["kind"]
            for member in got:
                if member in ("data", "scale"):
                    assert got[member].shape == want[member].shape
                    np.testing.assert_array_equal(
                        got[member].view(np.uint8),
                        want[member].view(np.uint8))
                elif member == "dtype":
                    assert np.dtype(got[member]) == np.dtype(want[member])
                else:
                    assert got[member] == want[member]
        else:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("xy_pair", ["0", None])
def test_x_tier_tables_and_samples_match_jax(xy_pair, monkeypatch):
    """OPENDRIFT_XY_PAIR=0 overrides the model's hint: the 'x' tier, with
    no u/v companion; unset, the hint decides ('xyz')."""
    if xy_pair is None:
        monkeypatch.delenv("OPENDRIFT_XY_PAIR", raising=False)
    else:
        monkeypatch.setenv("OPENDRIFT_XY_PAIR", xy_pair)
    current, _, x, y, depths, times = _forcing()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jstate, host, tstate = _state_pair(jr, tr)
    tier = "x" if xy_pair == "0" else "xyz"
    assert jr._sampler.pair_mode == tr._sampler.pair_mode == tier
    assert ("packed_uv" in host) == (tier == "xyz")
    _assert_tables_equal(host, jstate)
    for t in (0.0, 5000.0):
        _check_sample(jr, tr, jstate, tstate, list(current), t)


def test_none_tier_table_and_samples_match_jax(monkeypatch):
    """The unpaired tier, reached here by a budget cut to the test's size
    (the real one needs a table over 128 MB): the port's table equals the
    JAX packer's for pair_mode 'none', and samples through it match the JAX
    sampler on that table."""
    monkeypatch.setattr(tgrid, "ROW_BUDGET_BYTES", 1e5)
    current, _, x, y, depths, times = _forcing()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jr.device_state(T0, T0 + timedelta(seconds=9000))
    host = tr.device_state(T0, T0 + timedelta(seconds=9000))
    s = tr._sampler
    assert s.pair_mode == "none" and "packed_uv" not in host
    plan = jr._pack_plan
    want = jr._pack_member(0, plan["tidx"], plan["col_of"], plan["Z"],
                           plan["C"], "none").reshape(host["packed"].shape)
    np.testing.assert_array_equal(host["packed"], want)
    js = jinterp.PackedSampler(s.Z, s.Y, s.X, s.F, s.col_of, "none")
    lon, lat, z = _positions()
    tstate = device_state_from_numpy(host, "cpu")
    tv, _ = tr.sample(tstate, list(current), np.float32(4000.0),
                      torch.as_tensor(lon), torch.as_tensor(lat),
                      torch.as_tensor(z))
    xi, yi = tr._grid_indices(torch.as_tensor(lon), torch.as_tensor(lat))
    rows = js.gather_rows(jnp.asarray(want), jnp.asarray(xi.numpy()),
                          jnp.asarray(yi.numpy()),
                          jnp.asarray(np.maximum(-z, 0.0)),
                          jnp.asarray(host["depths"]))
    jv = js.values(rows, jnp.asarray(host["times"]), jnp.float32(4000.0),
                   list(current))
    for v in current:
        np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["current", "wind"])
@pytest.mark.parametrize("packed_dtype", ["float16", "float16x2"])
def test_packed_dtype_tables_and_samples_match_jax(packed_dtype, which):
    """Narrow-row storage per reader: float16 rows, or compensated float16
    pairs whose u/v companion stays float32 (as in the JAX package)."""
    current, wind, x, y, depths, times = _forcing()
    data, dz = (current, depths) if which == "current" else (wind, None)
    jr, tr = _pair(data, x, y, times, depths=dz)
    jr.packed_dtype = tr.packed_dtype = packed_dtype
    jstate, host, tstate = _state_pair(jr, tr)
    _assert_tables_equal(host, jstate)
    if packed_dtype == "float16x2":
        assert isinstance(host["packed"], tinterp.CompensatedTable)
        assert isinstance(tstate["packed"], tinterp.CompensatedTable)
        assert torch.is_tensor(tstate["packed"].data)
    else:
        assert tstate["packed"].dtype == torch.float16
    if which == "current":
        assert host["packed_uv"].dtype == (
            np.float32 if packed_dtype == "float16x2" else np.float16)
    for t in (0.0, 5000.0):
        _check_sample(jr, tr, jstate, tstate, list(data), t)
    # against the exact rows: the storage's own error bound
    _, tr32 = _pair(data, x, y, times, depths=dz)
    exact = device_state_from_numpy(
        tr32.device_state(T0, T0 + timedelta(seconds=9000)), "cpu")
    lon, lat, z = (torch.as_tensor(a) for a in _positions())
    names = [v for v in data if v != "sea_floor_depth_below_sea_level"]
    got, _ = tr.sample(tstate, names, np.float32(5000.0), lon, lat, z)
    ref, _ = tr32.sample(exact, names, np.float32(5000.0), lon, lat, z)
    rel = 2.0 ** -9 if packed_dtype == "float16" else 2.0 ** -19
    for v in names:
        scale = float(np.nanmax(np.abs(data[v])))
        assert float((got[v] - ref[v]).abs().max()) <= rel * scale, v


def test_packed_dtype_unknown_is_refused():
    _, wind, x, y, _, times = _forcing()
    _, tr = _pair(wind, x, y, times)
    tr.packed_dtype = "bfloat16"
    with pytest.raises(ValueError, match="packed_dtype"):
        tr.device_state(T0, T0 + timedelta(seconds=9000))


@pytest.mark.parametrize("explicit", [None, "float32"])
def test_auto_compensate_follows_the_row_threshold(explicit):
    """A reader that sets ``packed_auto_compensate`` takes compensated
    storage from 2^15 rows on, on the tiers below 'xyz', unless its
    packed_dtype says otherwise."""
    r = np.random.default_rng(4)
    nx, ny, nt = 190, 180, 3                    # 34,200 rows >= 2^15
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    times = [T0 + timedelta(hours=3 * i) for i in range(nt)]
    wind = {"x_wind": r.standard_normal((nt, ny, nx)).astype(np.float32),
            "y_wind": r.standard_normal((nt, ny, nx)).astype(np.float32)}
    jr, tr = _pair(wind, x, y, times)
    for rd in (jr, tr):
        rd.packed_auto_compensate = True
        if explicit:
            rd.packed_dtype = explicit
    jstate, host, _ = _state_pair(jr, tr)
    assert tr._sampler.pair_mode == "xy"
    assert isinstance(host["packed"], tinterp.CompensatedTable) == (
        explicit is None)
    _assert_tables_equal(host, jstate)
    # a small table stays float32
    current, _, x, y, depths, times = _forcing()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jr.packed_auto_compensate = tr.packed_auto_compensate = True
    jstate, host, _ = _state_pair(jr, tr)
    assert not isinstance(host["packed"], tinterp.CompensatedTable)
    assert host["packed"].dtype == np.float32
    _assert_tables_equal(host, jstate)


@pytest.mark.parametrize("split", ["u16", "u8"])
def test_split_table_env_matches_jax(split, monkeypatch):
    monkeypatch.setenv("OPENDRIFT_SPLIT_TABLE", split)
    monkeypatch.delenv("OPENDRIFT_NO_SPLIT_TABLE", raising=False)
    current, _, x, y, depths, times = _forcing()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jstate, host, tstate = _state_pair(jr, tr)
    assert isinstance(host["packed"], tinterp.SplitTable)
    assert isinstance(jstate["packed"], jinterp.SplitTable)
    _assert_tables_equal(host, jstate)
    _check_sample(jr, tr, jstate, tstate, list(current), 5000.0)


# ------------------------------------- corner blocks and profiles ---------

def _coast_data():
    current, wind, x, y, depths, times = _forcing()
    land = np.zeros((len(y), len(x)), np.float32)
    land[:, -5:] = 1.0
    current = dict(current, land_binary_mask=land,
                   ocean_vertical_diffusivity=np.abs(
                       current["y_sea_water_velocity"]) * 0.05)
    return current, x, y, depths, times


@pytest.mark.parametrize("xy_pair", ["0", None])
@pytest.mark.parametrize("keep", [None, "all"])
def test_corner_block_and_sample_from_block_match_jax(keep, xy_pair,
                                                      monkeypatch):
    """``corner_block`` gathered at the elements, ``sample_from_block`` and
    ``uv_from_block`` evaluated there and at displaced positions, on the
    'xyz' and the 'x' tier."""
    if xy_pair is None:
        monkeypatch.delenv("OPENDRIFT_XY_PAIR", raising=False)
    else:
        monkeypatch.setenv("OPENDRIFT_XY_PAIR", xy_pair)
    current, x, y, depths, times = _coast_data()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jstate, host, tstate = _state_pair(jr, tr)
    assert jr.supports_uv_block() and tr.supports_uv_block()
    keep_vars = list(current) if keep == "all" else None
    lon, lat, z = _positions()
    jb, jc = jr.corner_block(jstate, jnp.asarray(lon), jnp.asarray(lat),
                             jnp.asarray(z), keep_vars=keep_vars)
    tb, tc = tr.corner_block(tstate, torch.as_tensor(lon),
                             torch.as_tensor(lat), torch.as_tensor(z),
                             keep_vars=keep_vars)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got, want = corner_block_to_numpy(tb), corner_block_to_numpy(jb)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    names = keep_vars or ["x_sea_water_velocity", "y_sea_water_velocity"]
    r = np.random.default_rng(8)
    for shift, t in ((0.0, 0.0), (0.01, 4321.0), (0.02, 30000.0)):
        lo = (lon + r.uniform(-shift, shift, lon.shape)).astype(np.float32)
        la = (lat + r.uniform(-shift, shift, lat.shape)).astype(np.float32)
        jv, jcov = jr.sample_from_block(jstate, jb, jnp.float32(t),
                                        jnp.asarray(lo), jnp.asarray(la),
                                        names)
        tv, tcov = tr.sample_from_block(tstate, tb, np.float32(t),
                                        torch.as_tensor(lo),
                                        torch.as_tensor(la), names)
        np.testing.assert_array_equal(tcov.numpy(), np.asarray(jcov))
        for v in names:
            np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                       rtol=RTOL, atol=ATOL)
        ju, jvv = jr.uv_from_block(jstate, jb, jnp.float32(t),
                                   jnp.asarray(lo), jnp.asarray(la))
        tu, tvv = tr.uv_from_block(tstate, tb, np.float32(t),
                                   torch.as_tensor(lo), torch.as_tensor(la))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tvv.numpy(), np.asarray(jvv), rtol=RTOL,
                                   atol=ATOL)


def test_unpaired_reader_supports_no_block(monkeypatch):
    monkeypatch.setattr(tgrid, "ROW_BUDGET_BYTES", 1e5)
    current, x, y, depths, times = _coast_data()
    _, tr = _pair(current, x, y, times, depths=depths)
    tr.device_state(T0, T0 + timedelta(seconds=9000))
    assert tr._sampler.pair_mode == "none" and not tr.supports_uv_block()


@pytest.mark.parametrize("names", [
    ["ocean_vertical_diffusivity"],
    ["x_sea_water_velocity", "sea_floor_depth_below_sea_level",
     "ocean_vertical_diffusivity"],
    ["sea_floor_depth_below_sea_level"]])
def test_sample_profiles_matches_jax(names):
    """Profiles at fixed z-levels: a packed-row sample per level for the
    3D variables, other variables sampled once and repeated."""
    current, x, y, depths, times = _coast_data()
    jr, tr = _pair(current, x, y, times, depths=depths)
    jstate, host, tstate = _state_pair(jr, tr)
    zlevels = np.linspace(0.0, -50.0, 11, dtype=np.float32)
    lon, lat, _ = _positions()
    jv, jc = jr.sample_profiles(jstate, names, jnp.float32(5000.0),
                                jnp.asarray(lon), jnp.asarray(lat), zlevels)
    tv, tc = tr.sample_profiles(tstate, names, np.float32(5000.0),
                                torch.as_tensor(lon), torch.as_tensor(lat),
                                zlevels)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert set(tv) == set(jv)
    for v in names:
        assert tuple(tv[v].shape) == (11, len(lon))
        np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                   rtol=RTOL, atol=ATOL)


def test_environment_get_profiles_matches_jax():
    """``Environment.get_profiles``: the reader's profiles where it covers
    the position, the fallback elsewhere; and ``uv_block_plan_index``
    names the reader that serves both current components."""
    from opendrift_tpu.fields.environment import Environment as JEnv
    from opendrift_tpu_torch.fields.environment import Environment as TEnv
    current, x, y, depths, times = _coast_data()
    required = {v: {"fallback": 0.0} for v in current}
    required["ocean_vertical_diffusivity"] = {"fallback": 0.02,
                                              "profiles": True}
    required["sea_water_temperature"] = {"fallback": 10.0, "profiles": True}
    names = ["ocean_vertical_diffusivity", "sea_water_temperature"]
    zlevels = np.linspace(0.0, -50.0, 11, dtype=np.float32)
    lon, lat, _ = _positions()
    out = {}
    for pkg, env, cls in (("jax", JEnv(required), JArrayReader),
                          ("torch", TEnv(required, device="cpu"), TArrayReader)):
        env.add_reader(cls(current, x, y, times, depths=depths))
        env.finalize(T0, required_profiles=names)
        env.prepare_readers(extent=(3.5, 59.4, 4.5, 60.1), start_time=T0,
                            end_time=T0 + timedelta(hours=5), max_speed=2.0,
                            interval_seconds=9000.0, pair_hint="xy")
        states = env.build_device_states(T0, T0 + timedelta(seconds=9000))
        assert env.uv_block_plan_index() == 0
        if pkg == "jax":
            prof = env.get_profiles(states, names, jnp.float32(4000.0),
                                    jnp.asarray(lon), jnp.asarray(lat),
                                    zlevels)
            out[pkg] = {k: np.asarray(v) for k, v in prof.items()}
        else:
            prof = env.get_profiles(states, names, np.float32(4000.0),
                                    torch.as_tensor(lon),
                                    torch.as_tensor(lat), zlevels)
            out[pkg] = {k: v.numpy() for k, v in prof.items()}
    for v in names:
        assert out["torch"][v].shape == (11, len(lon))
        np.testing.assert_allclose(out["torch"][v], out["jax"][v], rtol=RTOL,
                                   atol=ATOL)
    assert (out["torch"]["sea_water_temperature"] == 10.0).all()
    k = out["torch"]["ocean_vertical_diffusivity"]
    assert (k == 0.02).any() and (k != 0.02).any()    # fallback and reader
