"""A tiny cell end to end on the CPU through the harness's internals:
the contract's keys, the comparison's numbers beside their limits, and
no result without a card."""

import json

import pytest
import torch

from drift_bench import run
from drift_bench.tests.tiny import tiny_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_untraced_run_reports_the_end_to_end_metrics():
    cell = tiny_cell()
    code, result, rows = run.execute(cell, 2 ** 31 + 9, 1.0, False, "cpu")
    assert code == 0 and KEYS <= set(result)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["metrics"]["particle_steps_per_s"]["value"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] is True
    # the comparison's numbers come last, each beside its limit
    assert list(result)[-1] == "check"
    assert [r[0] for r in rows] == list(result["check"])
    for name, value, limit in rows:
        assert value <= limit
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics():
    cell = tiny_cell(elements=1000, hours=3)
    code, result, _ = run.execute(cell, 5, 0.0, True, "cpu")
    assert code == 0 and KEYS <= set(result)
    metrics = result["metrics"]
    # on the CPU the trace holds no device activity: the device metrics
    # read nothing and are left out, the program's timers are read
    assert "device.idle_share" not in metrics
    assert 0.0 < metrics["run.readers_share"]["value"] < 100.0
    assert metrics["readers.pack_s_per_window"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    code = run.main(["--workload", "oceandrift_norkyst800.forecast_2m",
                     "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code == 2
    assert out.out == ""
    assert "CUDA" in out.err


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell(elements=5000, hours=3)
    code, result, rows = run.execute(cell, 123, 0.0, True, "cuda")
    assert code == 0 and result["correct"] is True, rows
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "device.idle_share" in result["metrics"]
