"""OpenOil's spans and counters on the CPU (``models/openoil/openoil.py``):
the weathering and the oil's mixing cycle are spans under ``main
loop:advance`` that read nothing of a tensor back to the host, and the
counters say which path each step's mixing took."""

import shutil
import tempfile
from datetime import timedelta

import numpy as np
import pytest
import torch

from drift_bench import forecast as fc
from test_torch_openoil_reference import small_cell

SPANS = ("main loop:advance:weathering", "main loop:advance:oil mixing")
# the host reads of a tensor's values
READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
         "__int__")


def _one_step(monkeypatch, config=None, reads=None):
    """A one-step forecast of the benchmark's oil configuration on small
    grids (``config``: keys set on top), with every host read of a tensor
    inside one of :data:`SPANS` appended to ``reads``."""
    cell = small_cell(elements=300, hours=1, over_h=0.0)
    cell.config["config"].update(config or {})
    tmp = tempfile.mkdtemp(prefix="oil_spans_")
    try:
        files = fc.write_forcing(cell, tmp, 3)
        from opendrift_tpu_torch import fields, models
        o = models.OpenOil(loglevel=50, device="cpu", seed=4)
        o.add_reader([fields.NetCDFReader(files[s["name"]][0],
                                          name=s["name"])
                      for s in cell.config["forcing"]])
        for key, value in cell.config["config"].items():
            o.set_config(key, value)
        lon, lat, z = fc.seed_positions(cell.traffic, 3, 0)
        o.seed_elements(lon=lon, lat=lat, z=z, time=fc.START,
                        **cell.config["seed_kw"])
        if reads is not None:
            rec = o.recorder

            def inside():
                stack = getattr(rec._local, "stack", None) or []
                return [rec.spans[i].category for i in stack
                        if rec.spans[i].category in SPANS]
            for name in READS:
                real = getattr(torch.Tensor, name)

                def wrapped(self, *a, _real=real, _name=name, **kw):
                    where = inside()
                    if where:
                        reads.append((_name, where))
                    return _real(self, *a, **kw)
                monkeypatch.setattr(torch.Tensor, name, wrapped)
        o.run(duration=timedelta(seconds=900), time_step=900,
              time_step_output=900)
        monkeypatch.undo()
        return o
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_the_spans_nest_under_advance_and_read_nothing_back(monkeypatch):
    reads = []
    o = _one_step(monkeypatch, reads=reads)
    assert reads == []
    spans = o.spans
    for category in SPANS:
        mine = [s for s in spans if s.category == category]
        assert len(mine) == 1, category
        parent = spans[mine[0].parent]
        assert parent.category == "main loop:advance"
        assert parent.start_ns <= mine[0].start_ns <= mine[0].end_ns \
            <= parent.end_ns
        assert o.timers[category] > 0
    text = o.performance()
    assert "weathering" in text and "oil mixing" in text


def test_the_reads_are_seen_where_there_are_some(monkeypatch):
    """The wrapped reads are caught inside a span: a host read added to
    the weathering is found."""
    from opendrift_tpu_torch.models.openoil.openoil import OpenOil
    real = OpenOil.oil_weathering

    def reading(self, ctx):
        real(self, ctx)
        ctx.state.data["density"].max().item()
    monkeypatch.setattr(OpenOil, "oil_weathering", reading)
    reads = []
    _one_step(monkeypatch, reads=reads)
    assert reads == [("item", ["main loop:advance:weathering"])]


@pytest.mark.parametrize("config,path", [
    ({}, "oil.mixing_fast_path_steps"),
    ({"vertical_mixing:use_pallas": False}, "oil.mixing_generic_steps")])
def test_the_counters_name_the_mixing_path(monkeypatch, config, path):
    o = _one_step(monkeypatch, config)
    other = {"oil.mixing_fast_path_steps", "oil.mixing_generic_steps"} \
        - {path}
    assert o.counters.get(path) == 1
    assert all(o.counters.get(k, 0) == 0 for k in other)
    assert np.isfinite(o.result["lon"].values[:, -1]).all()
