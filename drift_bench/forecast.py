"""One forecast as a user makes it, through the program's public entry
points, and the inputs it is made from.

The inputs come from the run's ``--seed`` alone: the forcing files (made
once a run, in set-up) and each forecast's seeded positions (made from the
seed and the forecast's index).  The program receives only these; the
plain reference receives the same.
"""

import math
import os
from datetime import datetime, timedelta

import numpy as np

START = datetime(2024, 3, 1)        # the forcing files' first frame
EARTH_RADIUS = 6371000.0


def rng(seed, *stream):
    """A numpy generator for one purpose of the run's ``--seed`` (any
    whole number, negative too)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def model_seed(seed, index):
    """The program's own seed for forecast ``index`` of the run."""
    return int(rng(seed, 2, index).integers(0, 1 << 31))


def frames(config, traffic, grid):
    """Frames a forcing file needs to cover the forecast, one spare."""
    step = float(config[grid]["frame_s"])
    return int(math.ceil(traffic["duration_h"] * 3600.0 / step)) + 2


def write_forcing(cell, directory, seed):
    """Write the configuration's forcing files into ``directory``, each by
    its writer (``forcing/<writer>.py``); returns {name: (path, the
    writer's record of what it wrote)}."""
    config, traffic = cell.config, cell.traffic
    out = {}
    for k, spec in enumerate(config["forcing"]):
        writer = cell.writer(spec["writer"])
        grid = config[spec["grid"]]
        path = os.path.join(directory, f"{spec['name']}.nc")
        params = {key: grid[key] for key in ("nx", "ny") if key in grid}
        params.update(dx=float(grid["dx_m"]), step_s=float(grid["frame_s"]),
                      centre=tuple(grid["centre"]),
                      nt=frames(config, traffic, spec["grid"]))
        if "nz" in grid:
            params["nz"] = int(grid["nz"])
        record = writer.write(path, rng(seed, 0, k), **params)
        # on the disk now, so that writing back the pages does not fall
        # into the measured window
        with open(path, "rb+") as f:
            os.fsync(f.fileno())
        out[spec["name"]] = (path, record)
    return out


def seed_positions(traffic, seed, index):
    """Forecast ``index``'s release: float32 (lon, lat, z), uniform over a
    disc of ``radius_m`` around the release point and a depth range.  The
    same sizes for every seed."""
    rel = traffic["release"]
    n = int(traffic["elements"])
    r = rng(seed, 1, index)
    dist = rel["radius_m"] * np.sqrt(r.random(n))
    az = r.random(n) * 2.0 * np.pi
    lat0 = math.radians(rel["lat"])
    lat = rel["lat"] + np.degrees(dist * np.cos(az) / EARTH_RADIUS)
    lon = rel["lon"] + np.degrees(dist * np.sin(az)
                                  / (EARTH_RADIUS * math.cos(lat0)))
    top, bottom = rel["depth_m"]
    z = -(top + (bottom - top) * r.random(n))
    return (lon.astype(np.float32), lat.astype(np.float32),
            z.astype(np.float32))


def span(name, enabled):
    """A ``torch.profiler`` span around a call into the program, or
    nothing when the run is not traced."""
    import contextlib
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def release_time(traffic):
    """The ``time`` the elements are seeded with: the forecast's start, or
    the span [start, start + ``release.over_h``] that the program spreads
    them over."""
    over = float(traffic["release"].get("over_h", 0.0))
    return [START, START + timedelta(hours=over)] if over > 0 else START


def forecast(config, traffic, files, positions, seed, device,
             duration_h=None, readers_kw=None, spans=False):
    """Make one forecast: construct the configuration's ``model``, add the
    forcing files as readers of each one's ``reader`` class
    (``readers_kw``: attributes to set on each), configure, seed (with the
    configuration's ``seed_kw``), run.  Returns the finished simulation
    (its result on the host in ``o.result``)."""
    from opendrift_tpu_torch import fields, models
    with span("bench.construct", spans):
        o = getattr(models, config["model"])(loglevel=50, device=device,
                                             seed=seed)
    with span("bench.readers", spans):
        readers = []
        for spec in config["forcing"]:
            reader = getattr(fields, spec["reader"])(
                files[spec["name"]][0], name=spec["name"])
            for key, value in (readers_kw or {}).items():
                setattr(reader, key, value)
            readers.append(reader)
        o.add_reader(readers)
    with span("bench.config", spans):
        for key, value in config["config"].items():
            o.set_config(key, value)
    lon, lat, z = positions
    with span("bench.seed", spans):
        o.seed_elements(lon=lon, lat=lat, z=z, time=release_time(traffic),
                        **config.get("seed_kw", {}))
    with span("bench.run", spans):
        o.run(duration=timedelta(hours=duration_h or traffic["duration_h"]),
              time_step=timedelta(seconds=traffic["time_step_s"]),
              time_step_output=timedelta(seconds=traffic["output_step_s"]),
              export_variables=traffic["export_variables"])
    return o


def steps(traffic, duration_h=None):
    """Calculation steps of one forecast."""
    return int(round((duration_h or traffic["duration_h"]) * 3600.0
                     / traffic["time_step_s"]))
