"""The seeding's release times and the result's assembly, made in bulk on
the host (``models/base.py``): the same values as the element-at-a-time
versions they replace, bit for bit, and the result's arrays C-ordered."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from opendrift_tpu_torch.export.io_netcdf import valid_mask
from opendrift_tpu_torch.models import OceanDrift, OpenOil
from opendrift_tpu_torch.models.base import _spread_times

T0 = datetime(2024, 3, 1)


def _one_at_a_time(t0, t1, number):
    frac = np.linspace(0, 1, number)
    return np.array([t0 + frac[i] * (t1 - t0) for i in range(number)])


@pytest.mark.parametrize("t0, t1, number", [
    (T0, T0 + timedelta(hours=6), 200_003),
    (T0 + timedelta(hours=6), T0, 7_777),          # backwards
    (datetime(2020, 1, 1, 0, 0, 0, 123),
     datetime(2020, 1, 3, 5, 7, 9, 999_999), 30_001),
    (T0, T0, 5),
    (T0, T0 + timedelta(hours=1), 1),
    (T0.replace(tzinfo=timezone.utc),
     T0.replace(tzinfo=timezone.utc) + timedelta(hours=2), 101),
])
def test_spread_times_equal_the_timedelta_products(t0, t1, number):
    got = _spread_times(t0, t1, number)
    want = _one_at_a_time(t0, t1, number)
    assert got.dtype == want.dtype == object
    assert all(type(t) is datetime for t in got[:3])
    assert list(got) == list(want)


def test_a_release_over_time_seeds_the_same_times():
    o = OceanDrift(loglevel=50, device="cpu")
    o.seed_elements(lon=np.full(1001, 4.0), lat=np.full(1001, 60.0),
                    time=[T0, T0 + timedelta(hours=6)])
    assert list(o._seedings[0]["time"]) == list(
        _one_at_a_time(T0, T0 + timedelta(hours=6), 1001))


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "cpu_tensor"])
@pytest.mark.parametrize("shape, dtype", [
    ((20000,), np.float32), ((20000,), np.int32), ((3, 20000), np.float32),
    ((20000,), np.uint16), ((20000,), np.bool_)])
def test_the_assembled_columns_equal_numpys_stack(shape, dtype, as_tensor):
    """Frames of strided numpy arrays, or of CPU tensors over them: each
    column C-ordered and byte-equal to ``np.stack(..., axis=-1)``, floats
    NaN where ``valid_mask`` is false."""
    import torch
    o = OceanDrift(loglevel=50, device="cpu")
    o.time_step = timedelta(minutes=15)
    o.time_step_output = timedelta(hours=1)
    rng = np.random.default_rng(1)
    t = 7
    status = rng.integers(-1, 3, (20000, t)).astype(np.int32)
    status[:500] = np.sort(status[:500], axis=1)    # released, then dead
    frames = [{"status": status[:, k][:19997],
               "x": (rng.random(shape) * 100).astype(dtype)[..., :19997]}
              for k in range(t)]
    want = {n: np.stack([f[n] for f in frames], axis=-1) for n in frames[0]}
    if as_tensor:
        frames = [{n: torch.from_numpy(v) for n, v in f.items()}
                  for f in frames]
    result = o._assemble_result(frames, [T0 + timedelta(hours=k)
                                         for k in range(t)])
    if np.issubdtype(dtype, np.floating):
        want["x"] = np.where(valid_mask(want["status"], 0), want["x"],
                             np.nan)
    for name in ("status", "x"):
        got = result[name].values
        assert got.dtype == want[name].dtype and got.flags.c_contiguous
        assert got.shape == want[name].shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want[name].view(np.uint8))


def test_the_assembled_result_equals_the_former_assembly():
    """An OpenOil result's columns: each (N, T) and C-ordered, NaN where an
    element was not yet released or had left the water before the frame,
    its values those of ``np.stack(..., axis=-1)`` and ``np.where``."""
    o = OpenOil(loglevel=50, device="cpu")
    o.time_step = timedelta(minutes=15)
    o.time_step_output = timedelta(hours=1)
    rng = np.random.default_rng(2)
    n, t = 500, 6
    status = np.where(rng.random((n, t)) < 0.2, 1, 0).astype(np.int32)
    status[:50, :2] = -1                       # not yet released
    frames = [{"lon": rng.random(n).astype(np.float32),
               "status": status[:, k].copy(),
               "mass_oil": rng.random(n).astype(np.float32)}
              for k in range(t)]
    times = [T0 + timedelta(hours=k) for k in range(t)]
    result = o._assemble_result(frames, times)
    valid = valid_mask(status, 0)
    for name in ("lon", "status", "mass_oil"):
        got = result[name].values
        want = np.stack([f[name] for f in frames], axis=-1)
        if name != "status":
            want = np.where(valid, want, np.nan)
        assert got.shape == (n, t) and got.flags.c_contiguous
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
