"""Sharded trajectory output in the port: ``ShardWriter`` and the port's
own ``tools/concat_shards.py`` rebuild the JAX package's single-process
file byte for byte, on the frames of
``tests/test_sharded_output.py::_synthetic_run`` (staggered release,
deactivation mid-run, two elements swapping shards)."""

import numpy as np
import pytest

from opendrift_tpu.models import OceanDrift as JOceanDrift
from opendrift_tpu.export.io_netcdf import write_result as jwrite_result
from opendrift_tpu_torch.export.io_netcdf import ShardWriter, read_result
from opendrift_tpu_torch.models import OceanDrift
from opendrift_tpu_torch.tools.concat_shards import concat_shards, main

from test_sharded_output import _synthetic_run

SLOTS = {0: [[0, 2, 4], [1, 3, 5]], 3: [[0, 3, 4], [1, 2, 5]]}


def _shards(tmp_path, frames, frame_times, result, n):
    paths = []
    for pid in range(2):
        path = str(tmp_path / f"out.nc.p{pid:03d}.nc")
        paths.append(path)
        w = ShardWriter(path, 3, n, pid, 2)
        local = []
        cur = SLOTS[0][pid]
        for t, f in enumerate(frames):
            cur = SLOTS.get(t, [cur, cur])[pid]
            local.append({k: v[cur] for k, v in f.items()})
        w.append(local, frame_times)
        w.finalize(result)
    return paths


@pytest.mark.parametrize("assembled_by", ["jax", "torch"])
def test_shard_concat_equals_the_jax_single_process_file(tmp_path,
                                                         assembled_by):
    """The attributes come from the run's result (the JAX package's or the
    port's); the JAX package's writer makes the plain file from the same
    result, and the merged shards equal it byte for byte."""
    from datetime import timedelta
    T, n = 6, 6
    frames, frame_times = _synthetic_run(T, n)
    o = JOceanDrift(loglevel=40) if assembled_by == "jax" \
        else OceanDrift(loglevel=40, device="cpu")
    o.time_step = timedelta(seconds=600)
    o.time_step_output = timedelta(seconds=600)
    result = o._assemble_result(frames, frame_times)
    plain = str(tmp_path / "plain.nc")
    jwrite_result(result, plain)

    paths = _shards(tmp_path, frames, frame_times, result, n)
    merged = str(tmp_path / "merged.nc")
    concat_shards(paths, merged)
    with open(merged, "rb") as a, open(plain, "rb") as b:
        assert a.read() == b.read()
    ds = read_result(merged)
    lon, st = ds["lon"].values, ds["status"].values
    assert np.isnan(lon[5]).all()
    assert np.isnan(lon[1, :2]).all() and np.isfinite(lon[1, 2:]).all()
    assert np.isfinite(lon[2, :4]).all() and np.isnan(lon[2, 4:]).all()
    assert st[2, 3] == 2


def test_concat_shards_command_line(tmp_path, monkeypatch, capsys):
    """``python -m opendrift_tpu_torch.tools.concat_shards OUT PREFIX``
    globs the shards of a prefix."""
    from datetime import timedelta
    frames, frame_times = _synthetic_run(6, 6)
    o = OceanDrift(loglevel=40, device="cpu")
    o.time_step = o.time_step_output = timedelta(seconds=600)
    result = o._assemble_result(frames, frame_times)
    _shards(tmp_path, frames, frame_times, result, 6)
    out = str(tmp_path / "cli.nc")
    monkeypatch.setattr("sys.argv", ["concat_shards", out,
                                     str(tmp_path / "out.nc")])
    main()
    assert "6 trajectories x 6 steps from 2 shard(s)" in capsys.readouterr().out
    np.testing.assert_array_equal(read_result(out)["status"].values,
                                  result["status"].values)
