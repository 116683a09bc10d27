"""The port's geodesy (opendrift_tpu_torch/utils/geodesic.py, run on torch
through ``utils.xp.tnp``) against the JAX package's ``utils/geodesic.py``.

Tolerances: the float64 numpy helpers are the same code and must be
bit-equal.  On float32 tensors both packages run the same operation
sequence, but the libraries' sin/cos/atan2 may differ by an ulp and XLA
may fuse a multiply-add, so positions are held at a few float32 ulps of
the coordinate (``ULPS``; one ulp of a latitude near 60 degrees is
0.8 m): 2 for the closed-form steps, 4 for the Vincenty solve with its
dozen transcendentals (4 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu.utils import geodesic as jgeo
from opendrift_tpu_torch.utils import geodesic as tgeo
from opendrift_tpu_torch.utils.xp import tnp


def _steps(n=500, seed=0):
    r = np.random.default_rng(seed)
    f32 = np.float32
    lat = r.uniform(-80.0, 80.0, n).astype(f32)
    lon = r.uniform(-180.0, 180.0, n).astype(f32)
    u = r.normal(0.0, 1.0, n).astype(f32)
    v = r.normal(0.0, 1.0, n).astype(f32)
    u[:5] = 0.0
    v[:5] = 0.0                                       # no motion
    return lat, lon, u, v


ULPS = {"geodesic_step": 4, "geodesic_step_second_order": 2,
        "geodesic_step_fast": 2}


def _ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("name", ["geodesic_step",
                                  "geodesic_step_second_order",
                                  "geodesic_step_fast"])
@pytest.mark.parametrize("dt", [900.0, -3600.0])
def test_steps_match_jax(name, dt):
    lat, lon, u, v = _steps()
    jlat, jlon = getattr(jgeo, name)(jnp, *map(jnp.asarray, (lat, lon, u, v)),
                                     dt)
    tlat, tlon = getattr(tgeo, name)(tnp, *map(torch.as_tensor,
                                               (lat, lon, u, v)), dt)
    assert tlat.dtype == torch.float32
    assert _ulps(tlat.numpy(), np.asarray(jlat)).max() <= ULPS[name]
    assert _ulps(tlon.numpy(), np.asarray(jlon)).max() <= ULPS[name]
    np.testing.assert_array_equal(tlat.numpy()[:5], lat[:5])


def test_host_direct_and_inverse_bit_equal():
    r = np.random.default_rng(1)
    lat = r.uniform(-70, 70, 200)
    lon = r.uniform(-180, 180, 200)
    az = r.uniform(0, 360, 200)
    dist = np.abs(r.normal(0, 5000.0, 200))
    want = jgeo.direct_np(lat, lon, az, dist)
    got = tgeo.direct_np(lat, lon, az, dist)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    want = jgeo.inverse_np(lat, lon, want[0], want[1])
    got = tgeo.inverse_np(lat, lon, got[0], got[1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the round trip recovers the distance to a millimetre
    np.testing.assert_allclose(got[2], dist, atol=1e-3)


def test_wrap_longitude():
    lon = torch.tensor([-540.0, -180.0, 0.0, 179.9, 180.0, 360.5])
    want = np.asarray(jgeo.wrap_longitude(jnp, jnp.asarray(lon.numpy())))
    np.testing.assert_allclose(tgeo.wrap_longitude(tnp, lon).numpy(), want,
                               atol=1e-5)
