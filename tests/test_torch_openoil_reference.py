"""The port's OpenOil against the benchmark's plain reference
(``drift_bench/reference/openoil.py``), on the CPU, at a small size: the
benchmark's NorKyst800, AROME and MyWave writers on coarse grids, 2,000
elements released over the first hour, a 3 h forecast, every element
compared at every output frame.

Tolerances, with their reasons (the reference is float32 storage with
float64 sampling and moves, the program float32 throughout).  Each
compared quantity is held at its 99th percentile over the (element,
frame) pairs that both sides hold, and at most ``OUTLIER_SHARE`` of the
pairs may lie beyond a wider bound: the walk's draws are equal on both
sides, but an element whose depth differs by float32 rounding can reach
the surface one substep earlier on one side, be entrained there, and
part from its twin (windage stops below 0.1 m; the weathering of a slick
and a droplet differ).  Measured here: one element of 2,000 parts.

* status: equal for every element and frame (no element strands or
  leaves the files in 3 h from this release; the release is the same
  float32 comparison on both sides);
* lon, lat: ``XY_M`` (p99), ``XY_OUTLIER_M``: float32 positions (0.3 m
  an ulp here) moved by a second-order geodesic on one side and
  Vincenty's on the other, from velocities that differ by float32
  rounding of the sampled fields (measured p99 0.85 m);
* z: ``Z_M`` (p99), ``Z_OUTLIER_M``: the walk's inputs (wind, rise
  velocity, entrainment probability, droplet sizes) differ by float32
  rounding, which can move an element across a 1 m level of the
  diffusivity (``round(|z|)``) (measured p99 2e-4 m);
* the oil's columns: relative ``RTOL`` (p99), ``ROUTLIER``: float32 exp,
  log and powers of the two implementations round differently, and the
  evaporation compounds that over the steps (measured p99 at most 1e-5);
  the diameter is held where both sides have entrained the element.

Two faults fail the comparison: the readers' fields packed in float16,
and evaporation switched off in the program only.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from drift_bench import cells
from drift_bench import forecast as fc
from drift_bench.reference import draws, torch_draws
from drift_bench.reference import openoil as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "openoil_norkyst800.spill_2m"
COLUMNS = ("mass_oil", "mass_evaporated", "mass_dispersed",
           "water_fraction", "viscosity", "density", "diameter")
XY_M, XY_OUTLIER_M = 3.0, 50.0
Z_M, Z_OUTLIER_M = 0.01, 0.1
RTOL, ROUTLIER = 1e-4, 1e-2
OUTLIER_SHARE = 0.005


def small_cell(elements=2000, hours=3, over_h=1.0):
    """The cell on 3 km, 8 km and 12 km grids over the same area."""
    cell = cells.load_cell(ROOT, CELL)
    cell.config["ocean_grid"].update(nx=70, ny=70, dx_m=3000.0)
    cell.config["wind_grid"].update(nx=40, ny=40, dx_m=8000.0)
    cell.config["wave_grid"].update(nx=30, ny=30, dx_m=12000.0)
    cell.traffic.update(elements=elements, duration_h=hours)
    cell.traffic["release"]["over_h"] = over_h
    cell.traffic["export_variables"] = list(
        cell.traffic["export_variables"]) + ["diameter"]
    return cell


def both_sides(cell, seed, readers_kw=None, program_config=None):
    """The program's forecast and the reference's, every element, as
    {variable: (E, T)} each (status as names)."""
    tmp = tempfile.mkdtemp(prefix="openoil_reference_")
    try:
        files = fc.write_forcing(cell, tmp, seed)
        positions = fc.seed_positions(cell.traffic, seed, 0)
        mseed = fc.model_seed(seed, 0)
        config = dict(cell.config)
        config["config"] = {**cell.config["config"],
                            **(program_config or {})}
        o = fc.forecast(config, cell.traffic, files, positions, mseed,
                        "cpu", readers_kw=readers_kw)
        names = np.asarray(o.status_categories, dtype=object)
        program = {k: np.asarray(o.result[k].values, np.float64)
                   for k in ("lon", "lat", "z") + COLUMNS}
        program["status"] = names[np.asarray(o.result["status"].values)]
        program["counters"] = dict(o.counters)
        program["model"] = o
        n = int(cell.traffic["elements"])
        grids = ref.prepare(cell.config, {k: v[1] for k, v in files.items()})
        reference = ref.simulate(cell.config, cell.traffic, grids,
                                 (positions, mseed, np.arange(n)))
        return program, reference
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gaps(program, reference):
    """Per compared quantity, the gaps over the (element, frame) pairs
    that both sides hold: metres for positions, metres for z, relative
    for the oil's columns; and the share of pairs whose status differs."""
    p, r = program, reference
    held = np.isfinite(p["lon"]) & (r["status"] == "active")
    out = {"status": float(np.mean(p["status"] != r["status"]))}
    dy = (p["lat"] - r["lat"]) * 111320.0
    dx = (p["lon"] - r["lon"]) * 111320.0 * np.cos(np.radians(r["lat"]))
    out["xy"] = np.hypot(dx, dy)[held]
    out["z"] = np.abs(p["z"] - r["z"])[held]
    for k in COLUMNS:
        use = held & np.isfinite(p[k])
        if k == "diameter":
            use &= (p[k] > 0) & (r[k] > 0)
        scale = np.maximum(np.abs(r[k][use]), 1e-30)
        out[k] = np.abs(p[k][use] - r[k][use]) / scale
    return out


def within(g):
    """Whether the gaps are within the tolerances, and the failures."""
    bad = []
    if g["status"] > 0:
        bad.append(("status", g["status"]))
    for k, p99, outlier in (("xy", XY_M, XY_OUTLIER_M),
                            ("z", Z_M, Z_OUTLIER_M),
                            *((c, RTOL, ROUTLIER) for c in COLUMNS)):
        v = g[k]
        if not v.size:
            bad.append((k, "no pairs"))
        elif np.quantile(v, 0.99) > p99 \
                or np.mean(v > outlier) > OUTLIER_SHARE:
            bad.append((k, float(np.quantile(v, 0.99)),
                        float(np.mean(v > outlier))))
    return not bad, bad


@pytest.fixture(scope="module")
def program_and_reference():
    return both_sides(small_cell(), 2 ** 31 + 17)


def test_the_port_matches_the_plain_reference(program_and_reference):
    program, reference = program_and_reference
    ok, bad = within(gaps(program, reference))
    assert ok, bad
    # the forecast exercised what it compares: a release over time,
    # surface and entrained oil, evaporation, water uptake, dispersion
    status = reference["status"]
    assert (status[:, 0] == "sedimented").any() \
        and (status[:, 0] == "active").any()
    assert (status[:, -1] == "active").all()
    z = program["z"][:, -1]
    assert (z < 0).any() and (z == 0).any()
    for k in ("mass_evaporated", "mass_dispersed", "water_fraction"):
        assert np.nanmax(program[k][:, -1]) > 0, k
    # every step took the oil kernel's path
    counters = program["counters"]
    assert counters.get("oil.mixing_fast_path_steps") == 12
    assert counters.get("oil.mixing_generic_steps", 0) == 0


def test_the_reference_draws_are_the_programs():
    from opendrift_tpu_torch import rng
    from opendrift_tpu_torch.ops import mixing
    seed = 2 ** 31 + 12345
    key, fkey = rng.PRNGKey(seed), draws.prng_key(seed)
    key, fkey = rng.fold_in(key, 7), draws.fold_in(fkey, 7)
    n = 3001
    np.testing.assert_array_equal(torch_draws.normal(fkey, n, "cpu"),
                                  rng.normal(key, (n,)))
    np.testing.assert_array_equal(torch_draws.bits(fkey, n, "cpu"),
                                  rng.bits(key, (n,)))
    ids = torch.arange(1, n + 1, dtype=torch.int64)
    s = rng.bits(key)
    base, pbase = torch_draws.walk_base(ids, s), mixing._element_base(ids, s)
    np.testing.assert_array_equal(base, pbase)
    for i in (0, 7, 14):
        word = torch_draws.substep_bits(base, i)
        np.testing.assert_array_equal(word, mixing._substep_bits(pbase, i))
        np.testing.assert_array_equal(torch_draws.unit(word),
                                      mixing._unit(word))
        np.testing.assert_array_equal(torch_draws.splitmix32(word),
                                      mixing.splitmix32(word))


FAULTS = {
    "float16_readers": dict(readers_kw={"packed_dtype": "float16"}),
    "no_evaporation_in_the_program": dict(
        program_config={"processes:evaporation": False}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_fails_the_comparison(fault):
    program, reference = both_sides(small_cell(), 2 ** 31 + 17,
                                    **FAULTS[fault])
    ok, bad = within(gaps(program, reference))
    assert not ok
