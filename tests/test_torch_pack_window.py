"""A structured reader's window assembled from its frames
(opendrift_tpu_torch/ops/pack.py, fields/grid.py ``device_state``) on the
CPU: the tables equal the numpy packing the port built on the host before
(the numpy oracle below, byte for byte), the frames go up once each, the
storages built on the host stay there, and a run through the window
equals the same run on host-packed tables bit for bit.  The kernel itself
is held against the plain version on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import json
import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch.fields import ArrayReader
from opendrift_tpu_torch.fields import grid as tgrid
from opendrift_tpu_torch.interop import device_state_from_numpy, \
    host_nbytes, pack_windows
from opendrift_tpu_torch.ops import interp as tinterp
from opendrift_tpu_torch.ops import pack
from opendrift_tpu_torch.ops.pack import WindowTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = datetime(2022, 3, 1)
UV = tgrid.UV
K = tinterp.PackedSampler.PAIR_FACTOR


class MemberReader(ArrayReader):
    """An ArrayReader with two ensemble members: member m reads the data
    scaled by 1 + m."""
    ensemble_size = 2

    def _read_frame(self, std, ti, zslice, yslice, xslice, member=0):
        return (1.0 + member) * np.asarray(
            super()._read_frame(std, ti, zslice, yslice, xslice))


def _data(nt=5, nz=6, ny=13, nx=11, seed=0):
    r = np.random.default_rng(seed)
    u = (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32)
    u[:, 4:, :2, :3] = np.nan                     # cells the fill fills
    v = (0.3 * r.standard_normal((nt, nz, ny, nx))).astype(np.float32)
    land = np.zeros((ny, nx), np.float32)
    land[:, -2:] = 1.0
    return {"x_sea_water_velocity": u, "y_sea_water_velocity": v,
            "x_wind": (5 + r.standard_normal((nt, ny, nx))).astype(
                np.float32),
            "sea_floor_depth_below_sea_level": r.uniform(
                30.0, 80.0, (ny, nx)).astype(np.float32),
            "land_binary_mask": land}


def _reader(case="members", nt=5, **kw):
    data = _data(nt=nt, **kw)
    nz, ny, nx = data["x_sea_water_velocity"].shape[1:]
    x = np.linspace(3.0, 5.0, nx)
    y = np.linspace(59.0, 60.5, ny)
    if case == "flipped":
        x, y = x[::-1], y[::-1]
    depths = np.array([0.0, 2.0, 5.0, 10.0, 20.0, 40.0][:nz], np.float32)
    times = [T0 + timedelta(hours=i) for i in range(nt)]
    cls = MemberReader if case == "members" else ArrayReader
    r = cls(data, x, y, times, depths=depths)
    r.set_run_epoch(T0)
    r.pair_hint = "xy"
    r.truncate_depth = 7.0 if case == "truncated" else None
    r.prepare(interval_seconds=3600.0, variables=list(data))
    return r


def _numpy_tables(r):
    """The tables of the reader's last ``device_state`` as the port packed
    them on the host before windows were assembled (numpy, per member:
    every base column, then the shifted copies, concatenated)."""
    plan = r._pack_plan
    Z, C, F = plan["Z"], plan["C"], len(plan["tidx"])
    ny, nx, mode = plan["ny"], plan["nx"], plan["pair_mode"]
    blocks = []
    for m in range(plan["M"]):
        packed = np.empty((Z, ny, nx, C), dtype=np.float32)
        for v in r._group3:
            c0 = plan["col_of"][v][0]
            for fi, ti in enumerate(plan["tidx"]):
                packed[:, :, :, c0 + fi] = r._load_frame(v, ti, m)[:Z]
        for v in r._group2:
            c0 = plan["col_of"][v][0]
            for fi, ti in enumerate(plan["tidx"]):
                packed[:, :, :, c0 + fi] = r._load_frame(v, ti, m)[None]
        for v in r._static_packed + r._static_near:
            packed[:, :, :, plan["col_of"][v][0]] = r._load_frame(v, 0, m)
        if mode != "none":
            def sx(a):
                return np.concatenate([a[:, :, 1:], a[:, :, -1:]], axis=2)

            def sy(a):
                return np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
            variants = [packed, sx(packed)]
            if mode in ("xy", "xyz"):
                variants += [sy(packed), sx(sy(packed))]
            packed = np.concatenate(variants, axis=3)
            if mode == "xyz":
                packed = np.concatenate(
                    [packed, np.concatenate([packed[1:], packed[-1:]])],
                    axis=3)
        blocks.append(packed.reshape(Z * ny * nx, -1))
    full = np.concatenate(blocks)
    dtype = np.dtype("float16" if getattr(r, "packed_dtype", None)
                     == "float16" else "float32")
    with np.errstate(over="ignore"):          # beyond float16: inf
        out = {"packed": full.astype(dtype)}
        if mode in ("xy", "xyz"):
            sub = [c for v in UV for c in range(plan["col_of"][v][0],
                                                plan["col_of"][v][0] + F)]
            idx = np.concatenate([np.asarray(sub) + b * C
                                  for b in range(K[mode])])
            out["packed_uv"] = np.ascontiguousarray(full[:, idx],
                                                    dtype=dtype)
    return out


def _assert_bytes_equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("case", ["members", "flipped", "truncated"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("mode", ["none", "x", "xy", "xyz"])
def test_window_tables_equal_the_numpy_packing(mode, dtype, case,
                                               monkeypatch):
    """Every pair mode, both storage types, two members, flipped axes and
    a truncated depth, with a 2D variable, a static and a nearest column:
    the tables assembled for the device (the plain version on CPU
    tensors) and on the host equal the numpy packing byte for byte."""
    monkeypatch.setattr(tgrid, "choose_pair_mode", lambda *a: mode)
    r = _reader(case)
    r.packed_dtype = dtype
    host = r.device_state(T0 + timedelta(hours=1), T0 + timedelta(hours=2))
    want = _numpy_tables(r)
    assert r._sampler.pair_mode == mode
    assert set(k for k in host if k.startswith("packed")) == set(want)
    assert all(isinstance(host[k], WindowTable) for k in want)
    assert r._pack_plan["M"] == (2 if case == "members" else 1)
    assert r._pack_plan["Z"] == (4 if case == "truncated" else 6)
    dev = device_state_from_numpy(host, "cpu")
    for k in want:
        assert host[k].shape == want[k].shape
        assert host[k].dtype == want[k].dtype
        _assert_bytes_equal(dev[k], want[k])
        _assert_bytes_equal(host[k], want[k])


def test_float16_rounds_to_nearest_even():
    """Values halfway between float16 neighbours, and beyond its range,
    round as numpy's astype does."""
    r = _reader("plain")
    r.packed_dtype = "float16"
    ties = np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(
        1, 8, 2, dtype=np.float32)
    frame = r._load_frame("x_sea_water_velocity", 0)
    frame[0, 0, :4] = ties
    frame[0, 1, :2] = [70000.0, -1e-8]
    host = r.device_state(T0, T0 + timedelta(hours=1))
    got = device_state_from_numpy(host, "cpu")["packed"]
    _assert_bytes_equal(got, _numpy_tables(r)["packed"])
    assert torch.isinf(got).any()


def _forecast(reader, hours=25, n=300, host_tables=False, monkeypatch=None):
    from opendrift_tpu_torch.models import OceanDrift
    if host_tables:
        # the tables packed on the host and copied whole, as before
        device_state = tgrid.StructuredGridReader.device_state

        def on_host(self, *a):
            return {k: (np.asarray(v) if isinstance(v, WindowTable) else v)
                    for k, v in device_state(self, *a).items()}
        monkeypatch.setattr(tgrid.StructuredGridReader, "device_state",
                            on_host)
    o = OceanDrift(loglevel=50, device="cpu", seed=3)
    o.add_reader(reader)
    o.set_config("drift:vertical_mixing", True)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(1)
    o.seed_elements(lon=r.uniform(3.6, 4.4, n), lat=r.uniform(59.5, 60.0, n),
                    z=-r.uniform(0.0, 20.0, n), time=T0)
    uploads = []
    build = o.env.build_device_states

    def recording(*a, **kw):
        states = build(*a, **kw)
        uploads.append(o.counters.get("readers.frames_uploaded", 0))
        return states
    o.env.build_device_states = recording
    o.run(duration=timedelta(hours=hours), time_step=900,
          time_step_output=3600)
    return o, np.diff([0] + uploads)


def _ocean(nt):
    data = _data(nt=nt, nz=4, ny=16, nx=14)
    del data["x_wind"]
    x, y = np.linspace(3.0, 5.0, 14), np.linspace(59.0, 60.5, 16)
    return ArrayReader(data, x, y,
                       [T0 + timedelta(hours=i) for i in range(nt)],
                       depths=np.array([0.0, 5.0, 10.0, 20.0], np.float32))


def test_each_frame_goes_up_once_over_a_forecast():
    """25 hourly windows of 3 frames: u and v go up at F + 25 - 1 = 27
    frame indices, the two statics once, the final repack uploads
    nothing."""
    o, per_window = _forecast(_ocean(27))
    assert o.counters["readers.frames_uploaded"] == 2 * (3 + 25 - 1) + 2
    assert o.counters["readers.windows_assembled_on_device"] == 26
    assert list(per_window) == [2 * 3 + 2] + [2] * 24 + [0]


def test_a_forecast_equals_the_host_packed_one(monkeypatch):
    """The same forecast with the tables packed on the host and copied
    whole: the same result bit for bit."""
    a, _ = _forecast(_ocean(8), hours=6)
    b, _ = _forecast(_ocean(8), hours=6, host_tables=True,
                     monkeypatch=monkeypatch)
    assert "readers.frames_uploaded" not in b.counters
    for var in ("lon", "lat", "z", "status"):
        x, y = np.asarray(a.result[var].values), np.asarray(
            b.result[var].values)
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("storage", ["dd_keep_host", "dd_defer_pack",
                                     "float16x2", "u16", "u8"])
def test_host_built_storages_stay_on_the_host(storage, monkeypatch):
    """A decomposed run's tables and the compensated and split storages are
    built on the host as before and hand no window to the device."""
    r = _reader("plain")
    if storage.startswith("dd_"):
        setattr(r, "_" + storage, True)
    elif storage == "float16x2":
        r.packed_dtype = storage
    else:
        monkeypatch.setenv("OPENDRIFT_SPLIT_TABLE", storage)
    host = r.device_state(T0, T0 + timedelta(hours=1))
    assert not pack_windows(host)
    if storage == "dd_defer_pack":
        assert host["packed_deferred"] and "packed" not in host
        return
    want = _numpy_tables(r)
    kind = {"dd_keep_host": np.ndarray, "float16x2": tinterp.CompensatedTable,
            "u16": tinterp.SplitTable, "u8": tinterp.SplitTable}[storage]
    assert isinstance(host["packed"], kind)
    if storage == "dd_keep_host":
        assert "packed_uv" not in host
        _assert_bytes_equal(host["packed"], want["packed"])
    else:
        assert isinstance(host["packed_uv"], np.ndarray)
        _assert_bytes_equal(host["packed_uv"], want["packed_uv"])
    if storage == "float16x2":
        _assert_bytes_equal(
            host["packed"].data,
            tinterp.CompensatedTable.from_array(want["packed"]).data)


@pytest.mark.parametrize("mode", ["none", "x", "xy", "xyz"])
def test_band_reads_equal_the_full_table(mode, monkeypatch):
    """A per-process band (``packed_rows``, padded past the grid's edge)
    equals the rows of the full table."""
    monkeypatch.setattr(tgrid, "choose_pair_mode", lambda *a: mode)
    r = _reader("members")
    r._dd_keep_host = True
    full = r.device_state(T0, T0 + timedelta(hours=1))["packed"]
    plan = r._pack_plan
    grid = full.reshape(plan["M"] * plan["Z"], plan["ny"], plan["nx"], -1)
    np.testing.assert_array_equal(r.packed_rows(3, 8), grid[:, 3:8])
    edge = r.packed_rows(plan["ny"] - 2, plan["ny"] + 3)
    np.testing.assert_array_equal(edge[:, :2], grid[:, -2:])
    np.testing.assert_array_equal(edge[:, 2:], np.repeat(
        grid[:, -1:], 3, axis=1))


def test_frames_read_again_go_up_again():
    """A frame the reader's cache read again (a new host array), or
    smoothed anew, goes up again; a window holds only its own frames."""
    r = _reader("plain")
    r.packed_dtype = "float32"
    window = (T0, T0 + timedelta(hours=1))
    first = r.device_state(*window)
    [w] = pack_windows(first)
    assert len(w.frames) == 2 * 3 + 3 + 2 and w.sent is None
    # the window's tables count nothing of their own: their frames are
    # counted as they go up
    assert host_nbytes(first, "cpu") == first["depths"].nbytes
    plain = device_state_from_numpy(first, "cpu")["packed"]
    assert w.sent == (len(w.frames), sum(a.nbytes for _, _, a in w.frames))
    again = r.device_state(*window)
    device_state_from_numpy(again, "cpu")
    assert pack_windows(again)[0].sent == (0, 0)
    r.set_convolution_kernel(3)
    smoothed = r.device_state(*window)
    got = device_state_from_numpy(smoothed, "cpu")["packed"]
    assert pack_windows(smoothed)[0].sent[0] == len(w.frames)
    assert not torch.equal(got, plain)
    _assert_bytes_equal(got, _numpy_tables(r)["packed"])
    later = r.device_state(T0 + timedelta(hours=2), T0 + timedelta(hours=3))
    device_state_from_numpy(later, "cpu")
    assert {key for key in r._resident._held[torch.device("cpu")]} == {
        key for key, _, _ in pack_windows(later)[0].frames}


def test_each_table_is_handed_out_once():
    """The window assembles its tables once a device and keeps none of
    them after handing them out."""
    r = _reader("plain")
    host = r.device_state(T0, T0 + timedelta(hours=1))
    [w] = pack_windows(host)
    a = host["packed"].to("cpu")
    assert w._made
    b = host["packed_uv"].to("cpu")
    assert not w._made
    assert a.shape == host["packed"].shape and b.shape == \
        host["packed_uv"].shape


def test_pack_window_checks_its_arguments():
    frames = [torch.zeros((4, 5, 6)), torch.zeros((5, 6))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pack.pack_window([f.to("meta") for f in frames], [[[0, 1]]], 4, 5,
                         6, 2, torch.float32)
    out = pack.pack_window(frames, [[[0, 1]], [[1]]], 4, 5, 6, 2,
                           torch.float16)
    assert [tuple(t.shape) for t in out] == [(120, 4), (120, 2)]
    assert all(t.dtype == torch.float16 for t in out)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("broken", [False, True])
def test_the_smoke_phase_holds_the_kernel_to_its_plain_version(
        broken, monkeypatch, capsys):
    """chip_smoke.py's ``check_pack_window`` on the CPU: the tool's cases
    pass, one line a case, and tables one bit off their plain version stop
    the phase."""
    smoke = _smoke()
    if broken:
        real = pack.pack_window

        def one_bit_off(*args):
            out = real(*args)
            out[-1].view(torch.int32)[-1, -1] ^= 1
            return out
        monkeypatch.setattr(pack, "pack_window", one_bit_off)
        with pytest.raises(AssertionError, match="arome differs"):
            smoke.check_pack_window("cpu", cases=["arome"], timed=False)
        return
    assert smoke.check_pack_window("cpu", cases=["arome", "odd_columns"],
                                   timed=False) is None
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["kernel"], x["case"], x["equal"]) for x in lines] == [
        ("pack_window", "arome", True), ("pack_window", "odd_columns", True)]
