"""The port's spans and counters (``opendrift_tpu_torch/timer.py``) on the
CPU: the categories a run records at each layer boundary of ``run()``,
their nesting and coverage, the prefetch thread's own spans, the run id,
the profiler's view of them, the byte and window counters, and the
benchmark's per-layer metrics that read them (``drift_bench/metrics/``)
on hand-built records."""

import gc
import os
import sys
import threading
import weakref
from datetime import datetime, timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from drift_bench import cells
from drift_bench.run import Record
from opendrift_tpu_torch.models import OceanDrift
from opendrift_tpu_torch.fields.netcdf import NetCDFReader
from opendrift_tpu_torch.interop import pack_windows
from opendrift_tpu_torch.timer import Timeable
from opendrift_tpu_torch.tools import synthetic_nc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = datetime(2024, 3, 1)
INTERVALS = 4
PREPARE = ("preparing main loop:initial state",
           "preparing main loop:readers", "preparing main loop:to device",
           "preparing main loop:advance")
LOOP = ("main loop:readers", "main loop:advance", "main loop:to host",
        "main loop:export")
READERS = ("main loop:readers:join wait", "main loop:readers:pack",
           "main loop:readers:copy")
POST = ("postprocessing:assemble", "postprocessing:export")
EVERY = (("preparing main loop", "main loop", "postprocessing",
          "prefetch:pack") + PREPARE + LOOP + READERS + POST)


def _bytes(x):
    """Bytes of the host arrays in a packed reader state (frame times stay
    on the host)."""
    if isinstance(x, dict):
        return sum(_bytes(v) for k, v in x.items() if k != "times")
    if isinstance(x, (tuple, list)):
        return sum(_bytes(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.nbytes
    if hasattr(x, "data") and isinstance(x.data, np.ndarray):
        scale = getattr(x, "scale", None)
        return x.data.nbytes + (scale.nbytes if scale is not None else 0)
    return 0


def _h2d_bytes(packed):
    """Bytes a run's packed windows copy to the device: host arrays whole,
    and of each reader's window (``ops/pack.py``) the frames the reader's
    previous window did not hold."""
    held, total = {}, 0
    for states in packed:
        for i, state in enumerate(states):
            total += _bytes(state)
            for window in pack_windows(state):
                have = held.get(i, {})
                total += sum(a.nbytes for key, owner, a in window.frames
                             if have.get(key) is not owner)
                held[i] = {key: owner for key, owner, _ in window.frames}
    return total


def _simulation(path, n=8000):
    o = OceanDrift(loglevel=50, device="cpu", seed=5)
    o.add_reader(NetCDFReader(path))
    o.set_config("drift:vertical_mixing", True)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(2)
    o.seed_elements(lon=r.uniform(13.9, 14.1, n),
                    lat=r.uniform(67.95, 68.05, n),
                    z=-r.uniform(0.0, 20.0, n), time=T0)
    return o


def _run(o, outfile=None):
    """Run ``o``, the garbage collector off: a full collection (~0.1 s
    with the test process's modules loaded) that lands between a parent's
    stamp and its child's would read as the parent's own time, and these
    tests check where the spans are, not how the collector falls."""
    gc.disable()
    try:
        o.run(duration=timedelta(hours=INTERVALS), time_step=900,
              time_step_output=3600, outfile=outfile)
    finally:
        gc.enable()
    return o


@pytest.fixture(scope="module")
def forcing(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "norkyst.nc")
    synthetic_nc.write_norkyst(path, nx=90, ny=90, nz=8, nt=INTERVALS + 3)
    return path


@pytest.fixture(scope="module")
def exported(forcing, tmp_path_factory):
    """A run with an outfile, with the host states it packed and the
    frames it assembled."""
    o = _simulation(forcing)
    packed, frames = [], []
    pack, assemble = o.env._pack_host_states, o._assemble_result

    def packing(a, b):
        states = pack(a, b)
        packed.append(states)
        return states

    def assembling(f, times, trim=True):
        frames.extend(f)
        return assemble(f, times, trim=trim)
    o.env._pack_host_states = packing
    o._assemble_result = assembling
    _run(o, str(tmp_path_factory.mktemp("out") / "out.nc"))
    return o, packed, frames


def _by(o, category):
    return [s for s in o.spans if s.category == category]


def test_a_run_records_every_category(exported):
    o = exported[0]
    assert set(EVERY) <= {s.category for s in o.spans}
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in o.spans)
    assert len(_by(o, "main loop:advance")) == INTERVALS + 1
    assert len(_by(o, "main loop:to host")) == INTERVALS + 1
    assert len(_by(o, "main loop:readers")) == INTERVALS + 1
    # the timers keep their keys, and sum their spans
    for key in ("total time", "preparing main loop", "main loop",
                "main loop:readers", "postprocessing"):
        assert o.timers[key] > 0.0
    for cat in EVERY:
        if cat != "prefetch:pack":
            assert o.timers[cat] == pytest.approx(
                sum(s.seconds for s in _by(o, cat)), rel=1e-9)
    report = o.performance()
    assert "    initial state" in report and "readers.h2d_bytes" in report


@pytest.mark.parametrize("parent", ["preparing main loop", "main loop",
                                    "postprocessing"])
def test_children_cover_their_parent(exported, parent):
    o = exported[0]
    index = {id(s): i for i, s in enumerate(o.spans)}
    (top,) = _by(o, parent)
    children = [s for s in o.spans if s.parent == index[id(top)]]
    assert children and all(s.category.startswith(parent + ":")
                            for s in children)
    covered = sum(s.seconds for s in children)
    assert 0.95 * top.seconds <= covered <= top.seconds


def test_readers_are_join_wait_pack_and_copy(exported):
    o = exported[0]
    index = {id(s): i for i, s in enumerate(o.spans)}
    for span in _by(o, "main loop:readers"):
        kids = {s.category for s in o.spans if s.parent == index[id(span)]}
        assert kids <= set(READERS) and "main loop:readers:copy" in kids
    parts = sum(o.timers[c] for c in READERS)
    assert parts == pytest.approx(o.timers["main loop:readers"], rel=0.05)
    assert parts <= o.timers["main loop:readers"]


def test_prefetch_spans_are_the_worker_threads(exported):
    o = exported[0]
    env = o.env
    prefetched = _by(o, "prefetch:pack")
    assert len(prefetched) == INTERVALS - 1
    assert {s.thread for s in prefetched} == {"opendrift-prefetch"}
    assert all(s.parent is None for s in prefetched)
    assert "prefetch:pack" not in o.timers
    loop_packed = _by(o, "main loop:readers:pack")
    assert {s.thread for s in o.spans if s not in prefetched} == \
        {threading.main_thread().name}
    # the environment's counters come from the same stamps
    assert env.prefetched_pack_seconds == pytest.approx(
        sum(s.seconds for s in prefetched), rel=1e-12)
    assert env.pack_seconds == pytest.approx(
        sum(s.seconds for s in prefetched + loop_packed), rel=1e-12)
    assert env.join_wait_seconds == pytest.approx(
        o.timers["main loop:readers:join wait"], rel=1e-12)
    assert o.counters["readers.windows_prefetched"] == INTERVALS - 1
    assert o.counters["readers.windows_packed_on_loop"] == 2


def test_spans_share_the_run_id(exported):
    o = exported[0]
    assert o.run_id == 1
    assert {s.run for s in o.spans} == {1}


def test_counters_add_up(exported):
    o, packed, frames = exported
    # every window packed once, on either thread, each copied once
    assert len(packed) == INTERVALS + 1
    assert o.counters["readers.h2d_bytes"] == _h2d_bytes(packed)
    assert len(frames) == INTERVALS + 1
    assert o.counters["run.d2h_bytes"] == sum(
        v.nbytes for f in frames for v in f.values())


def test_the_environment_does_not_keep_its_simulation(forcing):
    """The environment records into its simulation's recorder without a
    reference back: a caller that keeps ``o.env`` (the benchmark keeps it
    to read the packing counters) does not keep the simulation and its
    device state alive."""
    o = _run(_simulation(forcing, n=500))
    env, state = o.env, weakref.ref(o.state)
    sim = weakref.ref(o)
    del o
    assert sim() is None and state() is None
    assert env.recorder.spans and env.pack_seconds > 0.0


def test_spans_a_run_are_bounded(forcing):
    """Without an outfile (as a forecast whose result stays in memory):
    six spans an output interval, the final snapshot's and the stages'."""
    o = _run(_simulation(forcing, n=500))
    assert len(o.spans) <= 6 * (INTERVALS + 2) + 1
    assert "main loop:export" not in o.timers


def test_record_function_only_under_a_profiler(forcing, monkeypatch):
    """No profiler: no ``record_function`` is entered.  Under a CPU
    profiler every span is a host event of the trace, in the same order,
    starting within 5 ms of its in-memory stamp.  The profiled run packs
    every window on the loop's thread: a worker that took the interpreter
    lock between the two stamps would delay one by the lock's switch
    interval."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _run(_simulation(forcing, n=500))
    assert entered == []

    o = _simulation(forcing, n=500)
    monkeypatch.setattr(o.env, "prefetch_device_states", lambda a, b: None)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(o)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    loop = [s for s in o.spans if s.category != "total time"]
    assert set(EVERY) - {"prefetch:pack", "main loop:export",
                         "main loop:readers:join wait",
                         "postprocessing:export"} <= \
        {s.category for s in loop}
    assert sorted(entered) == sorted(s.category for s in loop)
    offsets = []
    for category in {s.category for s in loop}:
        mine = sorted(s.start_ns for s in loop if s.category == category)
        theirs = sorted(events[category])
        assert len(theirs) == len(mine), category
        offsets += [t - m for t, m in zip(theirs, mine)]
    offsets = np.abs(np.array(offsets, np.int64))
    assert offsets.max() < 5_000_000, offsets


def test_spans_from_many_threads():
    """Threads recording at once, the interpreter switching often: no span
    or second is lost, and each parent is an open span of the same
    thread."""
    t = Timeable()
    n_threads, n_spans = 12, 200

    def work():
        for _ in range(n_spans):
            with t.timed("outer"):
                with t.timed("outer:inner", total=False):
                    pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"w{i}")
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = t.spans
    assert len(spans) == 2 * n_threads * n_spans
    for s in spans:
        if s.category == "outer":
            assert s.parent is None
        else:
            parent = spans[s.parent]
            assert parent.category == "outer" and parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert set(t.timers) == {"outer"}
    assert t.timers["outer"] == pytest.approx(
        sum(s.seconds for s in spans if s.category == "outer"), rel=1e-9)


def test_a_span_ends_on_another_thread():
    """``timer_start`` on one thread, ``timer_end`` on another (a
    simulation built on one thread and run on another): the span closes,
    sums, and leaves its thread's stack."""
    t = Timeable()
    t.timer_start("total time")
    worker = threading.Thread(target=t.timer_end, args=("total time",))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    (span,) = t.spans
    assert span.end_ns is not None and t.timers["total time"] > 0.0
    with t.timed("next"):
        pass
    assert t.spans[1].parent is None


# ------------------------------------------------ the per-layer metrics --
S = 1_000_000_000


class FakeTrace:
    """What the metrics read of ``drift_bench/trace.py``'s ``Trace``."""

    def __init__(self, gaps, host, window_s=10.0, busy_s=2.0):
        self.gaps = gaps
        self._host = host
        self.window_s = window_s
        self.busy_s = busy_s


def _record(forecasts=(), trace=None):
    record = Record(SimpleNamespace(
        config={}, traffic={"output_step_s": 3600.0, "time_step_s": 900.0}))
    record.forecasts = list(forecasts)
    record.trace = trace
    return record


def _hand_built():
    gaps = [(1 * S, 3 * S), (5 * S, 6 * S), (8 * S, 9 * S)]
    host = [("bench.run", 0, 10 * S),
            ("main loop:readers", S // 2, 2 * S),
            ("main loop:readers", 5 * S // 2, 11 * S // 2),
            ("main loop:readers:pack", 26 * S // 10, 27 * S // 10),
            ("preparing main loop", 75 * S // 10, 85 * S // 10),
            ("postprocessing", 86 * S // 10, 95 * S // 10),
            ("main loop:advance", 6 * S, 7 * S),
            ("cudaLaunchKernel", 61 * S // 10, 61 * S // 10 + 5),
            ("cudaLaunchKernel", 62 * S // 10, 62 * S // 10 + 5),
            ("cudaLaunchKernelExC", 63 * S // 10, 63 * S // 10 + 5),
            ("cuLaunchKernel", 65 * S // 10, 65 * S // 10 + 5),
            ("cudaLaunchKernel", 72 * S // 10, 72 * S // 10 + 5),
            ("aten::add", 64 * S // 10, 64 * S // 10 + 5)]
    forecasts = [
        {"steps": 4, "timers": {"main loop": 10.0, "main loop:to host": 2.0,
                                "main loop:readers:copy": 0.6,
                                "preparing main loop:initial state": 1.5}},
        {"steps": 4, "timers": {"main loop": 6.0, "main loop:to host": 2.0,
                                "main loop:readers:copy": 0.2,
                                "preparing main loop:initial state": 0.5}}]
    return _record(forecasts, FakeTrace(gaps, host))


@pytest.mark.parametrize("name,expected", [
    # readers [0.5, 2] and [2.5, 5.5] s over the gaps: 1 + 0.5 + 0.5 s
    ("device.idle_in_readers_share", 20.0),
    # prepare [7.5, 8.5] and post [8.6, 9.5] over the gap [8, 9]
    ("run.idle_outside_loop_share", 9.0),
    ("run.initial_state_s", 1.0),
    # 0.8 s over one window a forecast (4 steps of 900 s, hourly output)
    ("readers.copy_s_per_window", 0.4),
    ("run.device_wait_share", 25.0),
    # four launches inside the advance span over 8 steps
    ("run.launches_per_step", 0.5),
])
def test_metric_reads_a_hand_built_record(name, expected):
    metric = cells.load_module(ROOT, "metrics", name)
    assert metric.read(_hand_built()) == pytest.approx(expected, rel=1e-12)
    assert metric.read(_record()) is None
    # a program without these spans and timers (the parent's) reads
    # nothing either
    old = _record([{"steps": 4, "timers": {"main loop": 10.0,
                                           "preparing main loop": 1.0}}],
                  FakeTrace([(S, 2 * S)], [("bench.run", 0, 3 * S),
                                           ("cudaLaunchKernel", S, S + 5)]))
    assert metric.read(old) is None
