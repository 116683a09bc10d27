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


@pytest.mark.parametrize("pair_mode,Z", [("xyz", 5), ("xy", 5), ("xy", 1)])
def test_packed_sampler_matches_jax(pair_mode, Z):
    Y, X, F = 7, 9, 3
    col_of = {"u": (0, "t"), "v": (F, "t"), "h": (2 * F, "static"),
              "mask": (2 * F + 1, "near")}
    C = 2 * F + 2
    k = 8 if pair_mode == "xyz" else 4
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
    with pytest.raises(NotImplementedError):
        tinterp.PackedSampler(1, 4, 4, 2, {}, "x")


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


def test_host_fills_bit_equal(monkeypatch):
    # the JAX package fills through its native library when it is built;
    # its scipy path (the one the port keeps) is the reference here, as
    # the two may break ties between equidistant cells differently
    from opendrift_tpu.utils import native
    monkeypatch.setattr(native, "fill_nearest", lambda out: False)
    monkeypatch.setattr(native, "fill_seafloor", lambda out: False)
    r = np.random.default_rng(2)
    field = r.standard_normal((4, 11, 13)).astype(np.float32)
    field[r.random(field.shape) < 0.3] = np.nan
    field[2] = np.nan                       # an all-missing level
    want_fill, want_any = jinterp.fill_invalid(field.copy())
    got_fill, got_any = tinterp.fill_invalid(field.copy())
    assert got_any == want_any
    np.testing.assert_array_equal(got_fill, want_fill)
    np.testing.assert_array_equal(tinterp.fill_towards_seafloor(field.copy()),
                                  jinterp.fill_towards_seafloor(field.copy()))
