"""The port's packed-row sampler and host fills (opendrift_tpu_torch/ops/
interp.py) against the JAX package's ``ops/interp.py``.

Tolerances: the host fills and the time weights are the same numpy/float32
arithmetic and must be bit-equal.  The sampled values are the same
float32 blends in the same order; XLA's CPU backend may fuse a
multiply-add that torch rounds twice, so they are held at rtol 1e-6 plus
atol 1e-6 (the values are O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu.ops import interp as jinterp
from opendrift_tpu_torch.ops import interp as tinterp

RTOL = ATOL = 1e-6


def _table(Z, Y, X, C, k, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal((Z * Y * X, C * k)).astype(np.float32)


def _positions(Y, X, n=333, seed=1):
    r = np.random.default_rng(seed)
    # a few positions outside the grid exercise the index clamps
    xi = r.uniform(-0.5, X - 0.5, n).astype(np.float32)
    yi = r.uniform(-0.5, Y - 0.5, n).astype(np.float32)
    depth = r.uniform(0.0, 60.0, n).astype(np.float32)
    return xi, yi, depth


K_OF = {"none": 1, "x": 2, "xy": 4, "xyz": 8}


@pytest.mark.parametrize("pair_mode,Z", [("xyz", 5), ("xy", 5), ("xy", 1),
                                         ("x", 5), ("x", 1), ("none", 5),
                                         ("none", 1)])
def test_packed_sampler_matches_jax(pair_mode, Z):
    Y, X, F = 7, 9, 3
    col_of = {"u": (0, "t"), "v": (F, "t"), "h": (2 * F, "static"),
              "mask": (2 * F + 1, "near")}
    C = 2 * F + 2
    k = K_OF[pair_mode]
    packed = _table(Z, Y, X, C, k)
    depths = np.array([0.0, 5.0, 10.0, 30.0, 50.0][:Z], np.float32)
    xi, yi, depth = _positions(Y, X)
    times = np.array([0.0, 3600.0, 7200.0], np.float32)
    js = jinterp.PackedSampler(Z, Y, X, F, col_of, pair_mode)
    ts = tinterp.PackedSampler(Z, Y, X, F, col_of, pair_mode)
    ncol = [col_of["mask"][0]]
    jrows, jnear = js.gather_rows(jnp.asarray(packed), jnp.asarray(xi),
                                  jnp.asarray(yi), jnp.asarray(depth),
                                  jnp.asarray(depths), nearest_cols=ncol)
    trows, tnear = ts.gather_rows(torch.as_tensor(packed),
                                  torch.as_tensor(xi), torch.as_tensor(yi),
                                  torch.as_tensor(depth),
                                  torch.as_tensor(depths), nearest_cols=ncol)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tnear[ncol[0]].numpy(),
                                  np.asarray(jnear[ncol[0]]))
    for t in (0.0, 1234.5, 7200.0, 9000.0):
        jv = js.values(jrows, jnp.asarray(times), jnp.float32(t),
                       ["u", "v", "h"])
        tv = ts.values(trows, times, t, ["u", "v", "h"])
        for name in ("u", "v", "h"):
            np.testing.assert_allclose(tv[name].numpy(),
                                       np.asarray(jv[name]), rtol=RTOL,
                                       atol=ATOL)


def test_other_tiers_not_ported():
    # every tier of the JAX package is ported now: what is refused is a
    # name that is no tier (and the legacy bools still map as there)
    for mode in ("x", "none", "xy", "xyz"):
        assert tinterp.PackedSampler(1, 4, 4, 2, {}, mode).pair_mode == mode
    assert tinterp.PackedSampler(1, 4, 4, 2, {}, True).pair_mode == \
        jinterp.PackedSampler(1, 4, 4, 2, {}, True).pair_mode == "x"
    with pytest.raises(ValueError):
        tinterp.PackedSampler(1, 4, 4, 2, {}, "xz")


@pytest.mark.parametrize("t", [-100.0, 0.0, 1800.0, 3599.9, 3600.0, 10800.0,
                               20000.0])
def test_time_weights_bit_equal(t):
    times = np.array([0.0, 3600.0, 7200.0, 10800.0], np.float32)
    jti, jtw = jinterp.time_weights(jnp.asarray(times), jnp.float32(t), 4)
    tti, ttw = tinterp.time_weights(times, t, 4)
    assert tti == int(jti)
    assert np.float32(ttw) == np.float32(jtw)


def test_take_rows_clamps():
    packed = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    rows = tinterp.take_rows(packed, torch.tensor([-3, 0, 3, 9]))
    want = np.asarray(jinterp.take_rows(jnp.asarray(packed.numpy()),
                                        jnp.asarray([-3, 0, 3, 9])))
    np.testing.assert_array_equal(rows.numpy(), want)


def _coast_field():
    """(5, 60, 70): a wavy coast with an island on two levels, 50% random
    NaNs on a third, one all-NaN level and one with no NaN at all."""
    r = np.random.default_rng(2)
    field = r.standard_normal((5, 60, 70)).astype(np.float32)
    Y, X = np.mgrid[0:60, 0:70]
    land = (X > 45 + 6 * np.sin(Y / 5.0)) \
        | ((X - 20) ** 2 + (Y - 30) ** 2 < 40)
    field[0][land] = np.nan
    field[1][land | (Y < 3)] = np.nan
    field[2][r.random((60, 70)) < 0.5] = np.nan
    field[3] = np.nan
    return field


@pytest.mark.parametrize("route", ["native", "no_compiler"])
def test_host_fills_bit_equal(monkeypatch, route):
    """Both packages' host fills, bit for bit: through the native chamfer
    transform, the JAX package's default (an all-NaN level comes out 0),
    and both forced down their no-compiler fallbacks (scipy's Euclidean
    fill, which leaves an all-NaN level NaN)."""
    from opendrift_tpu.utils import native as jnative
    from opendrift_tpu_torch.utils import native as tnative
    if route == "no_compiler":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "get_lib", lambda: None)
        assert tinterp.fill_route() == "scipy"
    else:
        assert jnative.get_lib() is not None
        assert tinterp.fill_route() == "native"
    field = _coast_field()
    want_fill, want_any = jinterp.fill_invalid(field.copy())
    got_fill, got_any = tinterp.fill_invalid(field.copy())
    assert got_any == want_any
    np.testing.assert_array_equal(got_fill, want_fill)
    assert np.isfinite(got_fill[[0, 1, 2, 4]]).all()
    if route == "native":
        assert (got_fill[3] == 0.0).all()
    else:
        assert np.isnan(got_fill[3]).all()
    np.testing.assert_array_equal(got_fill[4], field[4])
    np.testing.assert_array_equal(tinterp.fill_towards_seafloor(field.copy()),
                                  jinterp.fill_towards_seafloor(field.copy()))


# ------------------------------------------------------- corner blocks ----

def _block_case(pair_mode, Z, seed=3):
    Y, X, F = 7, 9, 3
    col_of = {"u": (0, "t"), "v": (F, "t"), "w": (2 * F, "t"),
              "h": (3 * F, "static"), "mask": (3 * F + 1, "near")}
    C = 3 * F + 2
    packed = _table(Z, Y, X, C, K_OF[pair_mode], seed)
    depths = np.array([0.0, 5.0, 10.0, 30.0, 50.0][:Z], np.float32)
    xi, yi, depth = _positions(Y, X, seed=seed + 1)
    times = np.array([0.0, 3600.0, 7200.0], np.float32)
    return (Z, Y, X, F, col_of), packed, depths, xi, yi, depth, times


@pytest.mark.parametrize("keep", [None, ["u", "v"], ["v", "mask", "h", "u"]])
@pytest.mark.parametrize("pair_mode,Z", [("xyz", 5), ("xy", 5), ("xy", 1),
                                         ("x", 5), ("x", 1)])
def test_corner_block_matches_jax(pair_mode, Z, keep):
    """A block gathered once and evaluated at the gather positions and at
    displaced ones, for the full row and for kept-variable subsets: the
    same float32 blends in the same order (tolerance as above)."""
    dims, packed, depths, xi, yi, depth, times = _block_case(pair_mode, Z)
    js = jinterp.PackedSampler(*dims, pair_mode)
    ts = tinterp.PackedSampler(*dims, pair_mode)
    jb = js.gather_corner_block(jnp.asarray(packed), jnp.asarray(xi),
                                jnp.asarray(yi), jnp.asarray(depth),
                                jnp.asarray(depths), keep_vars=keep)
    tb = ts.gather_corner_block(torch.as_tensor(packed), torch.as_tensor(xi),
                                torch.as_tensor(yi), torch.as_tensor(depth),
                                torch.as_tensor(depths), keep_vars=keep)
    for got, want in zip(tb[:4], jb[:4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert tb[4] == jb[4]
    names = keep or ["u", "v", "w", "h", "mask"]
    r = np.random.default_rng(9)
    saved = dict(ts.col_of)
    for shift in (0.0, 0.3):
        dx = (r.uniform(-shift, shift, xi.shape)).astype(np.float32)
        dy = (r.uniform(-shift, shift, xi.shape)).astype(np.float32)
        for t in (0.0, 1234.5, 9000.0):
            for want_names in (names, names[:2]):
                jv = js.eval_corner_block(jb, jnp.asarray(xi + dx),
                                          jnp.asarray(yi + dy),
                                          jnp.asarray(times), jnp.float32(t),
                                          want_names)
                tv = ts.eval_corner_block(tb, torch.as_tensor(xi + dx),
                                          torch.as_tensor(yi + dy), times, t,
                                          want_names)
                assert set(tv) == set(jv)
                for name in want_names:
                    np.testing.assert_allclose(tv[name].numpy(),
                                               np.asarray(jv[name]),
                                               rtol=RTOL, atol=ATOL)
    assert ts.col_of == saved      # the evaluation swaps nothing in


@pytest.mark.parametrize("pair_mode", ["x", "xy", "xyz"])
def test_corner_block_equals_gather_rows_at_gather_position(pair_mode):
    """Evaluated where it was gathered, a block gives what gather_rows
    gives but for the order of the z and x/y blends: 1e-5 on O(1) values."""
    dims, packed, depths, xi, yi, depth, times = _block_case(pair_mode, 5)
    ts = tinterp.PackedSampler(*dims, pair_mode)
    args = [torch.as_tensor(a) for a in (packed, xi, yi, depth, depths)]
    ncol = [dims[4]["mask"][0]]
    rows, near = ts.gather_rows(*args, nearest_cols=ncol)
    want = ts.values(rows, times, 1234.5, ["u", "v", "w", "h"])
    block = ts.gather_corner_block(*args)
    got = ts.eval_corner_block(block, args[1], args[2], times, 1234.5,
                               ["u", "v", "w", "h", "mask"])
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5)
    # z-blended, then corner-selected: equal to the plane-0 nearest value
    # only where both bracketing planes hold the same mask; here they are
    # random, so compare against the JAX package instead
    js = jinterp.PackedSampler(*dims, pair_mode)
    jb = js.gather_corner_block(*[jnp.asarray(a.numpy()) for a in args])
    jm = js.eval_corner_block(jb, jnp.asarray(xi), jnp.asarray(yi),
                              jnp.asarray(times), jnp.float32(0.0), ["mask"])
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(jm["mask"]),
                               rtol=RTOL, atol=ATOL)


def test_corner_block_refuses_unpaired_rows():
    ts = tinterp.PackedSampler(1, 4, 4, 2, {"u": (0, "t")}, "none")
    z = torch.zeros(3)
    with pytest.raises(ValueError):
        ts.gather_corner_block(torch.zeros(16, 2), z, z, z, torch.zeros(1))


# ------------------------------------------------------ table storages ----

def _wide_range_table(rows=4000, seed=5):
    r = np.random.default_rng(seed)
    t = r.standard_normal((rows, 6)).astype(np.float32)
    t[:, 1] *= 1e5            # pressure-like: beyond float16's range
    t[:, 2] *= 1e-6           # micro-velocities: float16 subnormals
    t[:, 3] = 0.0             # an all-zero column
    t[:, 4] = np.abs(t[:, 4]) * 300.0
    return t


def test_compensated_table_matches_jax_and_is_accurate():
    arr = _wide_range_table()
    jt = jinterp.CompensatedTable.from_array(arr)
    tt = tinterp.CompensatedTable.from_array(arr)
    assert tt.shape == jt.shape and tt.dtype == torch.float32
    # the same float16 pairs and scales, to the bit
    np.testing.assert_array_equal(tt.data.view(np.uint16),
                                  np.asarray(jt.data).view(np.uint16))
    np.testing.assert_array_equal(tt.scale, np.asarray(jt.scale))
    lin = np.random.default_rng(6).integers(-3, arr.shape[0] + 3, 777)
    got = tinterp.take_rows(tt.to("cpu"), torch.as_tensor(lin)).numpy()
    want = np.asarray(jinterp.take_rows(jt, jnp.asarray(lin)))
    # (hi + lo) * scale in float32 on both sides: one rounding each
    np.testing.assert_array_equal(got, want)
    exact = arr[np.clip(lin, 0, arr.shape[0] - 1)]
    colmax = np.abs(arr).max(axis=0)
    # the representation's own bound: 2^-21 of the column's scale
    assert (np.abs(got - exact) <= 2.0 ** -20 * np.maximum(colmax, 1e-30)
            ).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("store", ["u16", "u8"])
def test_split_table_bit_exact(store, dtype):
    if store == "u16" and dtype == np.float16:
        factor = 1                                   # same-width storage
    else:
        factor = np.dtype(dtype).itemsize // {"u16": 2, "u8": 1}[store]
    arr = _wide_range_table().astype(dtype)
    arr[0, 0] = np.nan
    arr[1, 0] = -0.0
    jstore = {"u16": jnp.uint16, "u8": jnp.uint8}[store]
    jt = jinterp.SplitTable.from_array(jnp.asarray(arr), jstore)
    tt = tinterp.SplitTable.from_array(arr, store)
    assert tt.factor == jt.factor == factor
    assert tt.shape == jt.shape == arr.shape
    assert tt.dtype == {np.float32: torch.float32,
                        np.float16: torch.float16}[dtype]
    # the stored bits are the JAX package's (uint16 kept as int16 here)
    np.testing.assert_array_equal(
        tt.data.view(np.uint8), np.asarray(jt.data).view(np.uint8))
    lin = np.random.default_rng(7).integers(-3, arr.shape[0] + 3, 555)
    got = tinterp.take_rows(tt.to("cpu"), torch.as_tensor(lin))
    want = np.asarray(jinterp.take_rows(jt, jnp.asarray(lin)))
    bits = np.uint32 if dtype == np.float32 else np.uint16
    assert got.dtype == tt.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(bits), want.view(bits))
    np.testing.assert_array_equal(
        got.numpy().view(bits),
        arr[np.clip(lin, 0, arr.shape[0] - 1)].view(bits))


@pytest.mark.parametrize("rows,dtype,want", [
    (1000, np.float32, None), (300_000, np.float32, "u16"),
    (600_000, np.float32, "u8"), (700_000, np.float32, None),
    (600_000, np.float16, "u8")])
def test_maybe_split_table_thresholds(rows, dtype, want, monkeypatch):
    """The automatic choice follows the JAX package's thresholds."""
    monkeypatch.delenv("OPENDRIFT_NO_SPLIT_TABLE", raising=False)
    arr = np.zeros((rows, 1), dtype)
    got = tinterp.maybe_split_table(arr)
    jgot = jinterp.maybe_split_table(jnp.asarray(arr))
    if want is None:
        assert got is arr and not isinstance(jgot, jinterp.SplitTable)
    else:
        assert isinstance(got, tinterp.SplitTable)
        assert got.factor == jgot.factor
        assert got.data.dtype.itemsize == {"u16": 2, "u8": 1}[want]
    assert tinterp.maybe_split_table(arr, force=False) is arr
    monkeypatch.setenv("OPENDRIFT_NO_SPLIT_TABLE", "1")
    assert tinterp.maybe_split_table(arr, force="u8") is arr


@pytest.mark.parametrize("storage", ["float16x2", "u16", "u8", "float16"])
@pytest.mark.parametrize("pair_mode", ["xyz", "x"])
def test_sampler_on_table_storages(storage, pair_mode):
    """gather_rows and a corner block through each storage against the
    JAX sampler on the same storage."""
    dims, packed, depths, xi, yi, depth, times = _block_case(pair_mode, 5)
    if storage == "float16x2":
        jp = jinterp.CompensatedTable.from_array(packed)
        tp = tinterp.CompensatedTable.from_array(packed).to("cpu")
    elif storage == "float16":
        jp = jnp.asarray(packed.astype(np.float16))
        tp = torch.as_tensor(packed.astype(np.float16))
    else:
        jp = jinterp.SplitTable.from_array(
            jnp.asarray(packed), {"u16": jnp.uint16, "u8": jnp.uint8}[storage])
        tp = tinterp.SplitTable.from_array(packed, storage).to("cpu")
    js = jinterp.PackedSampler(*dims, pair_mode)
    ts = tinterp.PackedSampler(*dims, pair_mode)
    jrows = js.gather_rows(jp, jnp.asarray(xi), jnp.asarray(yi),
                           jnp.asarray(depth), jnp.asarray(depths))
    trows = ts.gather_rows(tp, torch.as_tensor(xi), torch.as_tensor(yi),
                           torch.as_tensor(depth), torch.as_tensor(depths))
    # float16 rows blend in float32 after promotion by the float32 weights
    # on both sides; one float16 input rounding is shared
    tol = dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(trows.numpy().astype(np.float32),
                               np.asarray(jrows, np.float32), **tol)
    jb = js.gather_corner_block(jp, jnp.asarray(xi), jnp.asarray(yi),
                                jnp.asarray(depth), jnp.asarray(depths),
                                keep_vars=["u", "v"])
    tb = ts.gather_corner_block(tp, torch.as_tensor(xi), torch.as_tensor(yi),
                                torch.as_tensor(depth),
                                torch.as_tensor(depths), keep_vars=["u", "v"])
    for got, want in zip(tb[:2], jb[:2]):
        np.testing.assert_allclose(got.numpy().astype(np.float32),
                                   np.asarray(want, np.float32), **tol)


# ------------------------------------------------- unpacked block groups --

@pytest.mark.parametrize("Z", [1, 4])
def test_interp_xyzt_matches_jax(Z):
    V, F, Y, X = 3, 3, 6, 8
    r = np.random.default_rng(11)
    blocks = r.standard_normal((V, F, Z, Y, X)).astype(np.float32)
    times = np.array([0.0, 3600.0, 7200.0], np.float32)
    depths = np.array([0.0, 10.0, 25.0, 60.0][:Z], np.float32)
    xi, yi, depth = _positions(Y, X, seed=12)
    for t in (-5.0, 0.0, 1800.0, 7200.0, 8000.0):
        want = jinterp.interp_xyzt(jnp.asarray(blocks), jnp.asarray(times),
                                   jnp.asarray(xi), jnp.asarray(yi),
                                   jnp.asarray(depth), jnp.asarray(depths),
                                   jnp.float32(t))
        got = tinterp.interp_xyzt(torch.as_tensor(blocks), times,
                                  torch.as_tensor(xi), torch.as_tensor(yi),
                                  torch.as_tensor(depth),
                                  torch.as_tensor(depths), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-6)      # 16 weighted terms summed


def test_interp_nearest_xyt_matches_jax():
    V, F, Y, X = 2, 3, 6, 8
    r = np.random.default_rng(13)
    blocks = (r.random((V, F, Y, X)) > 0.5).astype(np.float32)
    times = np.array([0.0, 3600.0, 7200.0], np.float32)
    xi, yi, _ = _positions(Y, X, seed=14)
    for t in (-5.0, 0.0, 1700.0, 1900.0, 7200.0, 8000.0):
        want = jinterp.interp_nearest_xyt(jnp.asarray(blocks),
                                          jnp.asarray(times), jnp.asarray(xi),
                                          jnp.asarray(yi), jnp.float32(t))
        got = tinterp.interp_nearest_xyt(torch.as_tensor(blocks), times,
                                         torch.as_tensor(xi),
                                         torch.as_tensor(yi), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
