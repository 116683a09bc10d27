"""oil.mixing_launches_per_step: kernel launches a calculation step of
OpenOil's mixing cycle: the CUDA launch calls that start inside a ``main
loop:advance:oil mixing`` span (``models/openoil/openoil.py``
``vertical_mixing``: the entrainment probability, the droplet spectrum
and its mean, the candidate diameters, K3), over the window's forecasts'
steps, counted as ``oil.weathering_launches_per_step`` counts."""

import os

from drift_bench import cells

CATEGORY = "main loop:advance:oil mixing"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read(record):
    counted = cells.load_module(ROOT, "metrics",
                                "oil.weathering_launches_per_step")
    return counted.launches_per_step(record, CATEGORY)
