"""Runs over several processes in the port
(``opendrift_tpu_torch/parallel/multihost.py``): the helpers' single-process
no-ops, the per-process band read against the full-grid packing (and the
JAX package's), and the two-process gloo dry run
(``opendrift_tpu_torch/tools/multihost_dryrun.py``): 2 processes x 4 CPU
tiles reproduce 1 process x 8 tiles bit for bit in particle sharding and
domain decomposition, and the concatenated sharded output is the plain
file byte for byte."""

import json
import os
import subprocess
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_helpers_single_process_noops():
    from opendrift_tpu_torch.parallel import multihost, mesh
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.is_primary() and not multihost.is_multihost()
    multihost.sync()
    assert multihost.initialize() is None          # no coordinator: no-op
    assert multihost.process_count() == 1
    m = multihost.global_mesh(["cpu"] * 4)
    assert isinstance(m, mesh.Mesh) and m.n_tiles == 4 and m.tiles == [0, 1,
                                                                       2, 3]
    assert multihost.gather([{"a": 1}, {"a": 2}]) == [{"a": 1}, {"a": 2}]
    x = torch.arange(6.0)
    assert multihost.all_gather_last(x) is x
    counts = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(multihost.all_counts(counts), counts)
    tree = {"a": np.arange(8.0, dtype=np.float32)}
    assert multihost.ensure_global(tree, m) is tree
    parts = multihost.put_sharded(tree, m)
    np.testing.assert_array_equal(
        torch.cat([p["a"] for p in parts]).numpy(), tree["a"])
    reps = multihost.put_replicated({"t": torch.ones(2)}, m)
    assert len(reps) == 4 and reps[0] is reps[3]   # one device, one copy
    called = multihost.make_global(lambda g: np.full(2, g), m)
    assert [int(c[0]) for c in called] == [0, 1, 2, 3]
    # messages between tiles of one process are copies
    got = multihost.exchange(m, {(0, 1, 0): torch.ones(3)},
                             {(0, 1, 0): ((3,), torch.float32)})
    assert torch.equal(got[(0, 1, 0)], torch.ones(3))
    frame, offsets = multihost.local_rows(
        [{"x": torch.zeros(2)}, {"x": torch.ones(2)}], mesh.Mesh(["cpu"] * 2))
    np.testing.assert_array_equal(frame["x"], [0, 0, 1, 1])
    np.testing.assert_array_equal(offsets, [0, 1, 2, 3])


def test_default_mesh_is_the_visible_cards_or_one_tile():
    from opendrift_tpu_torch.parallel.mesh import particle_mesh
    assert particle_mesh(None, "cpu").n_tiles == 1
    assert particle_mesh(["cpu", "cpu"]).devices == [torch.device("cpu")] * 2


def _reader(pkg):
    rng = np.random.default_rng(7)
    ny, nx, nz = 37, 11, 4          # not divisible by the tiles
    t0 = datetime(2021, 3, 1)
    data = {
        "x_sea_water_velocity": rng.normal(
            0, 0.3, (2, nz, ny, nx)).astype(np.float32),
        "y_sea_water_velocity": rng.normal(
            0, 0.3, (2, nz, ny, nx)).astype(np.float32),
        "sea_floor_depth_below_sea_level": np.full((ny, nx), 50.0,
                                                   np.float32)}
    if pkg == "jax":
        from opendrift_tpu.fields import ArrayReader
    else:
        from opendrift_tpu_torch.fields import ArrayReader
    r = ArrayReader(data, x=np.linspace(2, 4, nx), y=np.linspace(59, 60, ny),
                    times=[t0, t0 + timedelta(hours=12)],
                    depths=[0.0, 5.0, 10.0, 20.0])
    r._run_epoch = t0
    return r, t0, ny, nx


@pytest.mark.parametrize("pair_hint", [None, "xy"])
def test_per_process_row_reads_match_full_grid_packing(pair_hint):
    """grid.packed_rows re-assembles to the full-grid packed table
    device_state builds, the neighbour-shift columns at band edges and
    the tile padding rows included, and equals the JAX package's bands."""
    r, t0, ny, nx = _reader("torch")
    jr, _, _, _ = _reader("jax")
    for reader in (r, jr):
        reader.pair_hint = pair_hint
    ds = r.device_state(t0, t0 + timedelta(hours=12))
    jr.device_state(t0, t0 + timedelta(hours=12))
    plan = r._pack_plan
    assert plan["pair_mode"] == jr._pack_plan["pair_mode"]
    full = np.asarray(ds["packed"]).reshape(plan["M"] * plan["Z"], ny, nx,
                                            plan["Cf"])
    rows = -(-ny // 8)
    bands = [r.packed_rows(t * rows, (t + 1) * rows) for t in range(8)]
    joined = np.concatenate(bands, axis=1)[:, :ny]
    np.testing.assert_array_equal(joined, full)
    tail = bands[-1][:, (ny - 7 * rows):]
    np.testing.assert_array_equal(tail, np.broadcast_to(full[:, -1:],
                                                        tail.shape))
    for t in (0, 3, 7):
        np.testing.assert_array_equal(
            bands[t], jr.packed_rows(t * rows, (t + 1) * rows))


def test_two_process_dryrun_matches_single_process():
    """2 processes x 4 CPU tiles over gloo == 1 process x 8 tiles, in
    particle sharding, Y-band and 2x4 decomposition, with elements
    migrating across the process boundary; sharded output merged by the
    port's concat_shards == the plain file, byte for byte."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OPENDRIFT_COORDINATOR", "OPENDRIFT_NUM_PROCESSES",
                        "OPENDRIFT_PROCESS_ID")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "opendrift_tpu_torch.tools.multihost_dryrun",
         "--device", "cpu", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIHOST DRYRUN OK" in r.stdout
    report = json.loads([line for line in r.stdout.splitlines()
                         if line.startswith("{")][-1])
    assert report["processes"] == 2 and report["tiles_per_process"] == 4
    assert report["backend"] == "gloo"
    for mode in ("particle", "domain", "domain2d"):
        assert report["modes"][mode]["bit_equal"]
        assert report["modes"][mode]["shards_bit_equal"]
