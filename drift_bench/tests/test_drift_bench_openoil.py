"""The oil cell of the benchmark: it resolves by name, its wave writer's
file reads back through the program's reader, its three per-layer metrics
read nothing from an empty record and the right values from a synthetic
one, and a tiny forecast of it passes the check on the CPU."""

import numpy as np
import pytest

from drift_bench import cells, roofline, run, trace
from drift_bench.forcing import mywave
from drift_bench.tests.tiny import ROOT

CELL = "openoil_norkyst800.spill_2m"
METRICS = ("visser_mixing_oil_roofline", "oil.weathering_launches_per_step",
           "oil.mixing_launches_per_step")
S = 1_000_000_000


def tiny_oil_cell(elements=1000, hours=3, sample=500):
    cell = cells.load_cell(ROOT, CELL)
    cell.config["ocean_grid"].update(nx=70, ny=70, dx_m=3000.0)
    cell.config["wind_grid"].update(nx=40, ny=40, dx_m=8000.0)
    cell.config["wave_grid"].update(nx=30, ny=30, dx_m=12000.0)
    cell.traffic.update(elements=elements, duration_h=hours)
    cell.traffic["release"]["over_h"] = 1.0
    cell.config["check"]["sample_per_forecast"] = sample
    return cell


def test_the_oil_cell_resolves():
    cell = cells.load_cell(ROOT, CELL)
    assert cell.config["model"] == "OpenOil"
    assert cell.traffic["release"]["over_h"] == 6
    assert [f["role"] for f in cell.config["forcing"]] == [
        "ocean", "wind", "wave"]
    names = {m["name"] for m in cell.per_layer}
    assert set(METRICS) <= names
    assert {m["name"] for m in cell.end_to_end} == {
        "particle_steps_per_s", "setup_s"}
    # the OceanDrift cell reports none of the oil's metrics
    other = cells.load_cell(ROOT, "oceandrift_norkyst800.forecast_2m")
    assert not set(METRICS) & {m["name"] for m in other.per_layer}


def test_the_wave_file_reads_back(tmp_path):
    from opendrift_tpu_torch.fields import NetCDFReader
    path = str(tmp_path / "mywave.nc")
    record = mywave.write(path, np.random.default_rng(5), nx=30, ny=20,
                          nt=4)
    reader = NetCDFReader(path, name="mywave")
    for std in record["vars"]:
        assert std in reader.variables
    np.testing.assert_allclose(reader.x, record["x"])
    np.testing.assert_allclose(reader.y, record["y"])
    for std, var in record["vars"].items():
        for ti in (0, 3):
            np.testing.assert_array_equal(reader._load_frame(std, ti),
                                          var["values"][ti])
    hs = record["vars"]["sea_surface_wave_significant_height"]["values"]
    assert hs.min() > 0


class _Fake:
    def __init__(self, kernels, host):
        self.kernels = kernels
        self._host = host

    kernel_time = trace.Trace.kernel_time


def _record(trace_=None, steps=(96, 96)):
    record = run.Record(cells.load_cell(ROOT, CELL))
    record.forecasts = [{"steps": s, "timers": {}} for s in steps]
    record.trace = trace_
    return record


def test_the_oil_metrics_read_nothing_from_an_empty_record():
    cell = cells.load_cell(ROOT, CELL)
    for name in METRICS:
        metric = cell.metric(name)
        assert metric.read(run.Record(cell)) is None
        # a trace of a program without the spans and the kernel (the
        # parent's, or another model's) reads nothing either
        old = _Fake({"visser_mixing_kernel(float const*)": (1.0, 5)},
                    [("main loop:advance", 0, S),
                     ("cudaLaunchKernel", S // 2, S // 2 + 5)])
        assert metric.read(_record(old)) is None


def test_the_oil_metrics_read_a_synthetic_record():
    weather = "main loop:advance:weathering"
    mixing = "main loop:advance:oil mixing"
    host = [("main loop:advance", 0, 10 * S),
            (weather, 1 * S, 2 * S), (mixing, 3 * S, 4 * S),
            (weather, 5 * S, 6 * S), (mixing, 7 * S, 8 * S)]
    # 12 launches in the weathering spans, 4 in the mixing ones, 2 outside
    for t in np.linspace(1.1, 1.9, 6).tolist() + np.linspace(
            5.1, 5.9, 6).tolist():
        host.append(("cudaLaunchKernel", int(t * S), int(t * S) + 5))
    for t in (3.2, 3.4, 7.2, 7.4):
        host.append(("cuLaunchKernel", int(t * S), int(t * S) + 5))
    for t in (2.5, 9.0):
        host.append(("cudaLaunchKernel", int(t * S), int(t * S) + 5))
    fake = _Fake({"void visser_mixing_oil_kernel(float const*)": (0.5, 4),
                  "visser_mixing_kernel(float const*)": (3.0, 9)}, host)
    cell = cells.load_cell(ROOT, CELL)
    record = _record(fake, steps=(2, 2))
    assert cell.metric("oil.weathering_launches_per_step").read(record) \
        == pytest.approx(3.0)
    assert cell.metric("oil.mixing_launches_per_step").read(record) \
        == pytest.approx(1.0)
    # K3 on 2M elements, 15 substeps of Large (1994): 128 operations an
    # element a substep, 60 bytes an element
    least = max(2e6 * 15 * 128 / 67e12, 2e6 * 60 / 3.35e12)
    assert roofline.least_seconds(*roofline.visser_mixing_oil(
        2_000_000, 15, "windspeed_Large1994")) == pytest.approx(least)
    assert cell.metric("visser_mixing_oil_roofline").read(record) \
        == pytest.approx(100.0 * 4 * least / 0.5)


def test_a_tiny_oil_forecast_is_correct():
    cell = tiny_oil_cell()
    code, result, rows = run.execute(cell, 2 ** 31 + 99, 0.0, True, "cpu")
    assert code == 0 and result["correct"] is True, rows
    assert result["attempted"] == 1 and result["failed"] == 0
    assert {"busy_s", "window_s"} <= set(result["device"])
    # on the CPU the trace holds no launch: the oil's metrics are left out
    assert not set(METRICS) & set(result["metrics"])

