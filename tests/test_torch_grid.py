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
from opendrift_tpu_torch.interop import device_state_from_numpy, \
    device_state_to_numpy

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
