"""The benchmark's data: cells, configurations, traffic mixes, metrics.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* the configuration's ``file`` (``drift_bench/configs/<config>.json``):
  the model class, its configuration keys, the forcing files with their
  writers and reader classes, the plain reference that checks it;
* ``drift_bench/forcing/<writer>.py``: ``write(path, rng, **grid)``, one
  forcing file and the record of the arrays it wrote;
* ``drift_bench/reference/<reference>.py``: ``prepare(config, forcing)``
  and ``simulate(config, traffic, prepared, checked)``, the plain
  reference of a configuration, which reads its own keys;
* ``drift_bench/traffic/<mix>.json``: the elements, the release, the
  forecast's length, time step and output step, the exported variables;
* ``drift_bench/metrics/<metric>.py``: ``read(record)``, the metric from
  one run's record (the program's timers and counters, the trace), or
  None where the run has nothing to read;
* ``drift_bench/limits/<cell>.json``: the limit of each number the check
  compares in that cell, with the readings it was set from.

So a cell, a configuration, a traffic mix or a metric is added as files,
with no edit to the harness.
"""

import importlib.util
import json
import os

PACKAGE = "drift_bench"


def load_benchmark(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(root, kind, name):
    """The module ``drift_bench/<kind>/<name>.py`` under ``root``, loaded
    from its path (a name may hold dots) as a module of the package's
    ``kind``, so that its relative imports find the package's own."""
    path = os.path.join(root, PACKAGE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with what it names, read under
    ``root``."""

    def __init__(self, root, bench, name):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.root = root
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.traffic = _json(os.path.join(
            root, PACKAGE, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = _json(os.path.join(root, PACKAGE, "limits",
                                         f"{name}.json"))

        def reported(metric):
            return name in metric.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if reported(m)]
        self.per_layer = [m for m in bench["per_layer"] if reported(m)]

    def metric(self, name):
        return load_module(self.root, "metrics", name)

    def writer(self, name):
        return load_module(self.root, "forcing", name)

    def reference(self):
        return load_module(self.root, "reference", self.config["reference"])


def load_cell(root, name):
    return Cell(root, load_benchmark(root), name)
