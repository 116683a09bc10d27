"""A run's output frames kept on the device and its result assembled there
(``models/base.py`` ``run`` and ``_assemble_result``), on the CPU: the
result byte-equal to the one from frames copied to the host at each
interval, which a budget the frames exceed selects."""

from datetime import datetime, timedelta

import numpy as np
import pytest

from opendrift_tpu_torch.export import read_result
from opendrift_tpu_torch.fields import ArrayReader, ConstantReader
from opendrift_tpu_torch.models import OceanDrift, OpenOil
from opendrift_tpu_torch.models import base

T0 = datetime(2024, 3, 1)
HOURS = 6


def _per_interval(monkeypatch):
    monkeypatch.setattr(base, "_frame_budget", lambda device: 0)


def _stranding(n=400):
    """An eastward current carries elements onto a reader-served coast."""
    nx, ny, nt = 40, 30, 3
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    r = np.random.default_rng(7)
    land = np.zeros((ny, nx), np.float32)
    land[:, 26:] = 1.0
    data = {"x_sea_water_velocity": (0.6 + 0.05 * r.standard_normal(
                (nt, ny, nx))).astype(np.float32),
            "y_sea_water_velocity": (0.1 * r.standard_normal(
                (nt, ny, nx))).astype(np.float32),
            "land_binary_mask": land}
    o = OceanDrift(loglevel=50, device="cpu", seed=3)
    o.add_reader(ArrayReader(data, x, y,
                             [T0 + timedelta(hours=6 * i) for i in range(nt)]))
    o.set_config("drift:horizontal_diffusivity", 5.0)
    o.seed_elements(lon=r.uniform(3.8, 4.45, n), lat=r.uniform(59.2, 60.3, n),
                    time=T0)
    return o


def _spill(n=300):
    """Oil released evenly over the first three hours."""
    o = OpenOil(loglevel=50, device="cpu", seed=4)
    o.add_reader(ConstantReader({
        "x_wind": 9.0, "y_wind": 2.0, "x_sea_water_velocity": 0.1,
        "y_sea_water_velocity": 0.05,
        "sea_floor_depth_below_sea_level": 60.0}))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.seed_elements(lon=4.0, lat=60.0, number=n, radius=300,
                    time=[T0, T0 + timedelta(hours=3)], m3_per_hour=5.0)
    return o


def _run(o, **kw):
    o.run(duration=timedelta(hours=HOURS), time_step=1800,
          time_step_output=3600, **kw)
    return o


def _assert_byte_equal(got, want):
    assert list(got.variables) == list(want.variables)
    np.testing.assert_array_equal(got.coords["time"], want.coords["time"])
    for name in want.variables:
        a, b = got[name].values, want[name].values
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.flags.c_contiguous, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("make", [_stranding, _spill],
                         ids=["stranding", "release_over_time"])
def test_the_result_from_kept_frames_equals_the_per_interval_one(
        make, monkeypatch):
    kept = _run(make())
    with monkeypatch.context() as m:
        _per_interval(m)
        copied = _run(make())
    _assert_byte_equal(kept.result, copied.result)
    status = kept.result["status"].values
    assert status.shape == (len(status), HOURS + 1)
    lon = kept.result["lon"].values
    if make is _stranding:
        stranded = kept.status_categories.index("stranded")
        # kept at the frame they stranded in, NaN after it
        before = status[:, -2] == stranded
        assert before.sum() > 10 and np.isnan(lon[before, -1]).all()
        last = (status[:, -1] == stranded) & ~before
        assert last.any() and np.isfinite(lon[last, -1]).all()
    else:
        # the last released elements are not in the water at the start
        assert np.isnan(lon[-1, 0]) and np.isfinite(lon[-1, -1])
        assert np.isfinite(lon[0]).all()
    assert kept.counters["run.d2h_bytes"] == copied.counters["run.d2h_bytes"]


def test_the_counters_say_where_the_frames_were(monkeypatch):
    kept = _run(_stranding(n=100))
    assert kept.counters["run.frames_kept_on_device"] == HOURS + 1
    assert kept.counters["run.results_assembled_on_device"] == 1
    _per_interval(monkeypatch)
    copied = _run(_stranding(n=100))
    assert "run.frames_kept_on_device" not in copied.counters
    assert "run.results_assembled_on_device" not in copied.counters


@pytest.mark.parametrize("budget", [None, 0], ids=["kept", "per_interval"])
def test_a_run_that_raises_keeps_the_frames_it_had(budget, monkeypatch):
    if budget is not None:
        monkeypatch.setattr(base, "_frame_budget", lambda device: budget)
    o = _stranding(n=100)
    calls = []

    def failing():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("stopped")
    o._sample_memory = failing
    with pytest.raises(RuntimeError, match="stopped"):
        _run(o)
    full = _run(_stranding(n=100))
    assert o.result["lon"].values.shape == (100, 3)
    np.testing.assert_array_equal(o.result.coords["time"],
                                  full.result.coords["time"][:3])
    # the first two frames are whole: the third carries no first-dead
    # fill from a later frame
    for name in ("lon", "lat", "status"):
        assert (o.result[name].values[:, :2].tobytes()
                == full.result[name].values[:, :2].tobytes()), name


def test_a_flushing_outfile_keeps_the_host_frames(tmp_path):
    """``export:buffer_length`` > 0 writes host frames during the loop: the
    run copies each to the host and writes the file the kept path's
    result writes at the end."""
    flushing = _stranding(n=200)
    flushing.set_config("export:buffer_length", 2)
    _run(flushing, outfile=str(tmp_path / "flushed.nc"))
    assert "run.frames_kept_on_device" not in flushing.counters
    at_end = _stranding(n=200)
    at_end.set_config("export:buffer_length", 0)
    _run(at_end, outfile=str(tmp_path / "at_end.nc"))
    assert at_end.counters["run.frames_kept_on_device"] == HOURS + 1
    _assert_byte_equal(flushing.result, at_end.result)
    a = read_result(str(tmp_path / "flushed.nc"))
    b = read_result(str(tmp_path / "at_end.nc"))
    np.testing.assert_array_equal(a.coords["time"], b.coords["time"])
    for name in ("lon", "lat", "z", "status"):
        np.testing.assert_array_equal(np.asarray(a[name]),
                                      np.asarray(b[name]))


def test_the_invalid_frames_are_those_valid_mask_leaves_out():
    import torch
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    rng = np.random.default_rng(5)
    status = rng.integers(-1, 4, (3000, 9)).astype(np.int32)
    status[:100] = np.sort(status[:100], axis=1)    # released, then dead
    got = base._invalid_frames(torch.from_numpy(status))
    np.testing.assert_array_equal(got.numpy(), ~valid_mask(status, 0))
