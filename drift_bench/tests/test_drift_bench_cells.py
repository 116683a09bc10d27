"""The harness finds its cells, configurations, traffic mixes and metrics
by name, and a cell or a configuration added as new files only runs."""

import json
import os
import shutil

import pytest

from drift_bench import cells, run
from drift_bench.tests.tiny import CELL, ROOT, shrink


def test_every_cell_resolves():
    bench = cells.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = cells.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "particle_steps_per_s"} <= names
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric(m["name"]).read)


def test_metric_reads_nothing_from_an_empty_record():
    cell = cells.load_cell(ROOT, "oceandrift_norkyst800.forecast_2m")
    record = run.Record(cell)
    for m in cell.per_layer:
        assert cell.metric(m["name"]).read(record) is None


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell(ROOT, "no_such.cell")


def test_a_cell_added_as_files_runs(tmp_path):
    """A copy of the benchmark's data with a new traffic mix, a new
    metric, a new cell's limits and the cell in BENCHMARK.json, nothing
    else changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "drift_bench"), root / "drift_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = cells.load_benchmark(ROOT)
    traffic = json.loads((root / "drift_bench" / "traffic"
                          / "forecast_2m.json").read_text())
    traffic.update(name="deeper_release")
    traffic["release"]["depth_m"] = [5.0, 40.0]
    (root / "drift_bench" / "traffic" / "deeper_release.json").write_text(
        json.dumps(traffic))
    (root / "drift_bench" / "metrics" / "run.forecast_s.py").write_text(
        "def read(record):\n"
        "    return sum(f['seconds'] for f in record.forecasts) or None\n")
    bench["workloads"].append({
        "name": "oceandrift_norkyst800.deeper_release",
        "config": "oceandrift_norkyst800", "traffic": "deeper_release",
        "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "run.forecast_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "run loop",
        "moves": "particle_steps_per_s"})
    (root / "drift_bench" / "limits"
     / "oceandrift_norkyst800.deeper_release.json").write_text(
        json.dumps(cells.load_cell(ROOT, CELL).limits))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = shrink(cells.load_cell(str(root),
                                  "oceandrift_norkyst800.deeper_release"),
                  elements=500, hours=2, sample=128)
    assert cell.traffic["release"]["depth_m"] == [5.0, 40.0]
    code, result, rows = run.execute(cell, 77, 0.0, True, "cpu")
    assert code == 0
    assert result["metrics"]["run.forecast_s"]["value"] > 0
    assert result["attempted"] == 1 and result["failed"] == 0


def test_a_configuration_added_as_files_runs(tmp_path):
    """A copy of the benchmark's data with a new configuration (another
    diffusivity, named reader classes), its own plain reference and a
    cell of it, found by name with no edit to the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "drift_bench"), root / "drift_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = root / "drift_bench"
    bench = cells.load_benchmark(ROOT)
    config = json.loads((data / "configs"
                         / "oceandrift_norkyst800.json").read_text())
    config.update(name="oceandrift_calm", reference="oceandrift_calm")
    config["config"]["drift:horizontal_diffusivity"] = 1.0
    (data / "configs" / "oceandrift_calm.json").write_text(
        json.dumps(config))
    # its reference: a file of its own, here the OceanDrift one with a
    # mark that it ran
    reference = (data / "reference" / "oceandrift.py").read_text()
    (data / "reference" / "oceandrift_calm.py").write_text(
        reference + "\n\n_simulate = simulate\n\n\n"
        "def simulate(config, traffic, grids, checked):\n"
        "    open(__file__ + '.ran', 'w').close()\n"
        "    return _simulate(config, traffic, grids, checked)\n")
    bench["configs"].append({
        "name": "oceandrift_calm", "source": "a test configuration",
        "file": "drift_bench/configs/oceandrift_calm.json", "reduced": [],
        "why": "a test configuration"})
    bench["workloads"].append({
        "name": "oceandrift_calm.forecast_2m", "config": "oceandrift_calm",
        "traffic": "forecast_2m", "chips": 1, "why": "a test cell"})
    (data / "limits" / "oceandrift_calm.forecast_2m.json").write_text(
        json.dumps(cells.load_cell(ROOT, CELL).limits))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = shrink(cells.load_cell(str(root), "oceandrift_calm.forecast_2m"),
                  elements=500, hours=2, sample=128)
    assert cell.config["config"]["drift:horizontal_diffusivity"] == 1.0
    code, result, rows = run.execute(cell, 78, 0.0, False, "cpu")
    assert code == 0 and result["correct"] is True, rows
    assert (data / "reference" / "oceandrift_calm.py.ran").exists()
