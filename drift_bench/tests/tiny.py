"""A tiny cell of the benchmark for the CPU tests: the repository's
configuration and traffic files on coarse grids with few elements."""

import os

from drift_bench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "oceandrift_norkyst800.forecast_2m"


def shrink(cell, elements=2000, hours=4, sample=512):
    """``cell`` over the same area on 3 km and 8 km grids, ``elements``
    elements for ``hours`` hours, ``sample`` of them checked."""
    cell.config["ocean_grid"].update(nx=70, ny=70, dx_m=3000.0)
    cell.config["wind_grid"].update(nx=40, ny=40, dx_m=8000.0)
    cell.traffic.update(elements=elements, duration_h=hours)
    cell.config["check"]["sample_per_forecast"] = sample
    return cell


def tiny_cell(root=ROOT, name=CELL, **kw):
    return shrink(cells.load_cell(root, name), **kw)
