#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``opendrift_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing its own line:

1. device: the card's name and power limit, and the build of the CUDA
   kernels (one ``nvcc`` per source of ``opendrift_tpu_torch/csrc``, both
   started together); then the forcing files of the file paths (4a),
   written into a temporary directory removed at the end;
2. kernels: each hand-written kernel (the windspeed, profile and oil
   mixing kernels, and the two row-gather kernels) against its plain
   PyTorch version on the card, at the main path's shapes (2M elements,
   15 substeps; 2M row indices), with its time (``ms``: one wrapper call
   at a time between CUDA events; ``device_ms``: calls queued back to back
   behind a spin on the card), the plain version's time, its bound and,
   for the gathers, the one library call that computes the same function
   (``index_select``, which is also their plain version).
   The mixing kernels must equal their plain versions by value, edge cases
   included (a NaN seafloor, mixed layers thinner than 1 m and outside the
   reciprocal's range, frozen elements; for the profile kernel every block
   at the first and last level, 1 m2/s diffusivities, 2 and 201 levels,
   NaN depths), also at ragged sizes (N = 1, 2, 255, 257, 2,000,001); the
   profile kernel's bound also in whole 32-byte sectors
   (``bound_sector_ms``); the reciprocal quotient of the windspeed and oil
   kernels against the division for every mixed-layer depth of its range;
   for the three mixing kernels the substep loop's SASS instructions by
   pipe and the issue bound they set (``opendrift_tpu_torch/tools/sass.py``;
   "not available" without a ``cuobjdump``); the row gathers bit for bit
   on rows of 10 to 4096 bytes, each case naming the route it took (bulk
   copies or the ``cp.async`` ring); the Philox kernel of
   ``general:rng='rbg'`` (``philox_bits``) equal to the bit to its plain
   version at 2M words, at the main path's (2, 2M) draw, at a (2, 2M)
   shard of a longer axis, with a key whose counter carries across both
   64-bit halves and at ragged shapes, timed at (2M,) and (2, 2M) beside
   the threefry ``rng.bits`` of the same shapes;
3. main path: ``OceanDrift(device="cuda")`` on a synthetic 3D z-level
   ``ArrayReader``, 2M elements, RK4 + Visser mixing (windspeed_Large1994,
   through the windspeed kernel) after one untimed interval that takes the
   process's one-time costs (its rate is printed as the cold one), then a
   shorter run with the 'constant'
   diffusivity (through the profile kernel); each run is checked to have
   gone through its kernel, and one interval of the first is profiled
   (kernels by device time, the device's busy share);
3a. rbg path: the first run again with ``general:rng='rbg'``, 2M elements,
   three intervals: its diffusion normals through ``philox_bits`` (the
   launches a step are printed), its mixing seed the rbg scalar draw;
   checked as the first run, with the windspeed kernel once a step; its
   steps-alone rate beside the first run's threefry rate;
4. coast path: a default ``OceanDrift(device="cuda")`` run with no
   landmask setting, so that the bundled coastline raster is added as the
   automatic landmask, on the same ocean moved to Lofoten (12-16 E, 67-69
   N) with a mean eastward current and NaN currents on the raster's land
   cells (every window goes through the host's native NaN fill, whose
   route must be 'native'), 2M elements seeded by ``seed_from_wkt`` west of
   the Lofoten wall, RK4, Visser mixing through the windspeed kernel,
   three intervals after one untimed.  Checked: the windspeed kernel once
   a step, 5-95% stranded, no active element on land by the landmask's
   own sample at any output, no NaN where an element is valid; the fill's
   seconds on one window's frames, native against scipy, and the mask
   samples a step are printed;
4a. file paths: default ``OceanDrift(device="cuda")`` runs from NetCDF-3
   files the script writes itself (``opendrift_tpu_torch/tools/
   synthetic_nc.py``), 2M elements seeded as in the coast path, RK4, three
   intervals after one untimed: ``netcdf_path`` on a NorKyst800-like
   ocean (polar stereographic, 260 x 300 cells of 800 m, 16 z-levels,
   int16-packed with fills on land: the reader's own landmask) and an
   AROME-like wind (Lambert conformal, grid-relative, so the convergence
   rotation runs), Visser mixing through the windspeed kernel; and
   ``roms_path`` on a Nordic-4km-like ROMS file (a 200 x 160 curvilinear
   C-grid, 32 sigma levels), 'environment' mixing on its AKs profiles
   through the profile kernel.  Checked: the int16 decode's route is
   'native', the path's kernel once a step and no other, no NaN where an
   element is valid; printed: reader build and run seconds, the steps-alone
   rate and reader share, the stranded share, the seconds of a window's
   decode (native against numpy) and fill, and the milliseconds of one
   grid-index call (projection or index map) with the calls a step;
4b. mesh path: a default ``OceanDrift(device="cuda")`` run on a SCHISM
   native-output file and a GRIB2 wind the script writes
   (``opendrift_tpu_torch/tools/synthetic_mesh.py``,
   ``synthetic_grib.py``): a mesh over Lofoten and Vestfjorden in UTM 33N
   of about 60,000 nodes and 119,000 triangles whose coast is the bundled
   raster's, 20 levels with time-varying ``zcor``, 9 hourly frames,
   sampled natively on the card (triangle lookup and walk, then a column
   gather of each variable's node values); an ECMWF-like 0.1-degree 10 m
   wind, 16-bit simple packing.  2M elements seeded as in the coast path
   over the top 30 m, RK4, Visser mixing through the windspeed kernel,
   three intervals after one untimed.  Checked: the windspeed kernel once
   a step and no other, 0.5-50% stranded on the mesh's coast and the rest
   active, no active element outside the mesh at any output, no NaN where
   an element is valid, the peak memory below one whole-node-row
   sample's; printed: the reader build and its parts (the regridder, the
   lookup raster, the neighbours), one window's GRIB decode, the
   milliseconds of one triangle lookup and one column gather with their
   calls a step, and a profiled interval;
4c. zoo paths: ``plast_path``, a microplastics user's PlastDrift run on
   the main path's ocean and wind, 2M elements seeded over the top 5 m
   rising at 0.01 m/s, RK4, PlastDrift's defaults (Sundby1983, the
   fetch-tabulated Stokes drift and Hs from the wind), 'randomwalk' mixing
   through the windspeed kernel, three intervals after one untimed
   (checked: the kernel once a step and no other, nothing valid is NaN,
   every z <= 0, more elements in the top 1 m at the end than at the
   seed), then one interval of the default 'analytical' model (no mixing
   kernel launched); ``leeway_path``, Leeway of the default object class
   with capsizing on the same forcing, 2M elements (checked: nothing valid
   is NaN, the cloud moved downwind; printed: the capsized and left/right
   shares);
4d. chemistry: ``chemical_path``, a chemical-fate user's ChemicalDrift
   run (Phenanthrene, degradation and volatilization on) on the oil path's
   ocean and wind with suspended matter served by the ocean reader, 2M
   elements seeded over the top 10 m, dt = 1800 s with 30 mixing substeps
   a step through the generic loop, three intervals after one untimed
   (checked: no mixing kernel launched, each element's mass plus its
   degraded and volatilized mass equals its seeded mass to 1e-4, every
   specie in [0, 5), sedimented elements frozen at the seafloor, nothing
   valid is NaN; printed: the species occupation, a profiled interval and
   the seconds of one density map of the 2M result);
   ``radionuclide_path``, RadionuclideDrift (137Cs) on the same forcing,
   one interval after one untimed; ``euler_field``, the Eulerian solver on
   a 1000 x 1000 grid of 100 m cells, 100 steps, on the card and on the
   CPU (the fields agree to 1e-5 of their maximum, the mass is kept to
   1e-4; printed: device ms a stencil step); ``ftle_path``,
   ``calculate_ftle`` on the double gyre at 2M seeds forward and
   backward, then at 20,000 seeds on the card and on the CPU;
5. oil path: ``OpenOil(device="cuda")`` on the same ocean extended with
   waves, temperature, salinity and a coast (a reader-served landmask),
   2M elements of GENERIC MEDIUM CRUDE seeded at the surface, RK4,
   evaporation, emulsification, dispersion and wave entrainment through
   the oil kernel; then one interval with the default 'environment'
   diffusivity model.  Checked: the oil kernel launched once a step and
   the windspeed kernel not at all, the mass budget closes, some oil is
   submerged, evaporated and stranded, no NaN where an element is valid;
   one interval is profiled;
5a. satellite-seeded oil: ``geotiff_oil_path``, a spill responder's
   OpenOil run seeded by ``seed_from_geotiff_thickness`` from a
   categorical slick-thickness GeoTIFF the script writes
   (``opendrift_tpu_torch/tools/synthetic_tiff.py``: 1000 x 1000 LZW
   pixels of about 50 m, the slick where the oil path releases), 2M
   elements, three intervals through the oil kernel after one untimed
   (checked: the oil kernel once a step and no other, the oil path's
   checks, each category's count and the seeded mass against the JAX
   package's formula, one host memory sample an output interval; printed:
   the TIFF read's and the seeding's seconds, the rates, the peak memory);
   one interval with ``general:profile_dir`` set (checked: a
   ``torch.profiler`` trace naming the oil kernel ten times); then
   ``seed_from_gml`` of a KSAT-style GML of three slicks at 2M elements
   and one interval (checked: every point inside a slick, the count
   within 5% of 2M, the oil kernel once a step);
6. sampler path: ``OceanDrift(device="cuda")`` on the same ocean with a 3D
   ``ocean_vertical_diffusivity`` and the coast, 2M elements, RK4 on one
   corner block a step (``drift:advection_single_fetch``), 'block'
   coastline bisection, 'environment' diffusivity through the profile
   kernel on reader-served profiles, the next window packed on the
   prefetch thread.  Checked: the profile kernel launched once a step and
   the windspeed kernel never, one corner-block gather a step, stranding,
   no NaN where an element is valid; one interval is profiled and
   ``get_profiles`` is timed;
   then the OceanDrift main path with and without the prefetch thread;
7. tiers and storages: one interval each on the 'x' tier (by the
   OPENDRIFT_XY_PAIR override, and by the budget) and the 'none' tier (the
   same field on grids refined until the table leaves the budget) and
   with ``packed_dtype`` 'float16x2' and 'float16', each held against the
   float32 'xyz' run of the same seed;
8. gather A/B: ``tools.gather_ab.run_ab`` on the tool's default table, on
   one that fits shared memory and on the sampler path's real tables and
   row indices (the run that counts the gather kernels' launches);
9. generic loop: one interval of OpenOil with ``TSprofiles`` and one of
   OceanDrift with ``use_pallas=False``;
10. card against CPU: the same small OceanDrift, OpenOil, sampler-path,
   coast-path, file-path and mesh-path configurations (the files on
   coarser grids; ROMS and SCHISM with ``sampling="native"`` and
   ``"regrid"``) on ``cuda`` and on ``cpu`` from one seed, held to the
   slice tolerance (the coast, file and mesh paths with every status
   equal); ``zoo_card_against_cpu``: each of the eleven zoo classes under
   its golden's constant fallbacks (``opendrift_tpu_torch/tools/
   zoo_setups.py``) at 4,096 elements, and the chemistry slice's five
   (the radionuclide and chemical goldens', a metals ChemicalDrift,
   OpenHNS, ModelTemplate; every status equal, species equal but for 1%),
   then ShipDrift's peak memory in a 2M-element step and OpenBerg's
   2M-element step time; ``geotiff_card_against_cpu``: the GeoTIFF-seeded
   OpenOil configuration at 4,096 elements (every status equal);
   ``rbg_card_against_cpu``: the first small run under 'rbg' with
   horizontal diffusion (every status equal, the slice tolerance);
   ``parity_goldens`` (phase 14): every scenario of
   ``opendrift_tpu_torch/tools/parity_compare.py`` with bundled data (21
   of 27: the reference OpenDrift's goldens of the double gyre, the
   constant-wind, stranding and mixing runs, OpenOil's two budgets, the
   zoo and chemistry models and the Eulerian field) on the card, each
   within the bounds of the JAX package's golden tests, in at most
   ``PARITY_BUDGET_S``; the six that read the reference's forcing files
   are listed as "no data";
11. scripts: ``python -m opendrift_tpu_torch.scripts.readerinfo`` on the
   NetCDF path's ocean file, and the GUI's ``GuiController`` running
   OceanDrift on that file at 100,000 elements on the card (checked: both
   end cleanly, the result holds every element, no matplotlib loaded);
12. the parallel layer on one card, four tiles on ``cuda:0``
   (``set_mesh(["cuda:0"] * 4)``): ``dd_path``, the main path's run with
   ``parallel:domain_decomposition`` in 4 Y bands (one untimed interval,
   three timed, then one with 'constant' diffusivity through the profile
   kernel in every tile) and in 2 x 2 tiles (one timed interval); checked:
   the windspeed kernel 4 x 30 times in the timed run, every element ID
   exactly once in every frame, nothing valid NaN, the final lon/lat/z
   spread and moments against the plain main path's run (the JAX package's
   statistical bounds, tests/test_engine_dd.py); printed: the halo in rows
   and columns, the slots and peak occupancy of a tile, halo and
   migration ms (CUDA events), leavers a step, the rates, peak memory;
   ``dd_against_plain``: 2M elements with no mixing or diffusion, tiled
   ("auto", "2x2") against the plain run at atol 2e-5 on lon/lat, every
   status equal; ``sharded_path``: particle sharding over the four tiles
   at 2M, mixing and diffusion on, bit-equal to the plain run;
   ``dd_card_against_cpu``: 4,096 elements in four tiles on the card and
   on the CPU (every status equal, the slice tolerance);
   ``multiprocess_dd``: ``opendrift_tpu_torch/tools/multihost_dryrun.py``
   on the card, 2 processes x 2 tiles over gloo (NCCL refuses two ranks on
   one card), bit-equal to one process of 4 tiles in both modes, the
   merged sharded output equal to the plain file byte for byte;
13. entry points (``entry_points``), the scripts outside the model API on
   a Nordic-4km-like ROMS file the script writes (``write_roms``: 200 x
   160 cells, 32 sigma levels): ``python -m opendrift_tpu_torch.bench``
   in-process at its own sizes (A and B: 2M elements x 30 timed steps;
   D: 10M x 20; C: 500k elements, 10 outer steps of 500 s at 50 s
   substeps, four trials of three intervals), each rate with its trials
   and peak memory (checked: no workload failed, so every active element
   of every workload, D's included, is finite; the windspeed kernel once
   a step of C and no other kernel); the five rungs of
   ``tools/ladder_bench.py`` at 1M (the windspeed kernel once a step in
   vertical_mixing, the oil kernel once a step in openoil, none in the
   others); ``tools/scaling_bench.py`` dp and tiles at d = 1 with 2M
   elements; bench A, B and C at 4,096 elements on the card and on the
   CPU (every status equal, the slice tolerance); 24 of the 28 examples
   of ``opendrift_tpu_torch/examples/`` in-process with no argument, so
   on their default device, the card (each one's seconds, kernel launches
   and last printed line; the four long ones, ``LONG_EXAMPLES``,
   run in tests/test_torch_cuda.py's gpu tests).

Then the seconds of each phase, one JSON line with every kernel's numbers,
the card's name and power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime, timedelta

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_KERNEL = 2_000_000
NTIMES = 15
PROFILE_LEVELS = 26
# Operations one substep does per element, counted from
# csrc/visser_mixing.cu (each add, multiply, divide, square root, compare,
# select, min/max and integer hash operation as one; loop invariants not
# counted).  48 are shared: the SplitMix32 draw (14), the nearest level
# (4), the gradient (6), the Visser update (8) and the reflections,
# buoyancy and sticks (16); each windspeed model adds three diffusivity
# evaluations.  The profile kernel's level lookup costs 8 in place of the
# level and gradient's 10.
OPS_PER_SUBSTEP = {"windspeed_Sundby1983": 48 + 3 * 4,
                   "windspeed_Large1994": 48 + 3 * 13,
                   "stepfunction": 48 + 3 * 3,
                   "profile": 48 - 10 + 8}
# The oil kernel adds to the windspeed kernel's substep: two further hashed
# draws (add, 8 hash operations, shift, convert, multiply: 12 each), the
# Tkalich rise velocity from the carried diameter (10: three multiplies,
# abs, multiply, divide, square root, multiply, compare, select) and the
# entrainment (7: two compares, and, negate, multiply, two selects).
OIL_EXTRA_OPS = 2 * 12 + 10 + 7

# kernel against its plain version on the card: both evaluate the same
# float32 expressions in the same order with no contracted multiply-adds
# (the kernels' reciprocal quotient is the correctly rounded division), so
# the mixing kernels must equal them by value: no tolerance
RAGGED_SIZES = (1, 2, 255, 257, 2_000_001)
# whole slice, card against CPU: transcendental functions differ by an
# ulp or so between the two, which moves a few elements across a
# nearest-level boundary of the mixing; the same bounds as
# tests/test_torch_oceandrift.py holds the port to against the JAX package
SLICE_MEDIAN_ATOL = {"lon": 1e-6, "lat": 1e-6, "z": 1e-4}
SLICE_OUTLIER_ATOL = {"lon": 1e-4, "lat": 1e-4, "z": 0.1}
SLICE_OUTLIER_SHARE = 0.02
# the oil slice, card against CPU: the weathering's exp/log/pow differ by
# an ulp or two between the two, the candidate droplet diameters come from
# a mean over all elements (another summation order) and from normals
# within 4 ulp, and an entrainment test u < p can flip where p differs in
# its last bit, which sends an element to another depth and, through the
# depth-dependent current, another place; a flipped element may also
# strand on one side only, so up to OIL_STATUS_SHARE of the elements may
# differ in status (and in which values are NaN).  Masses are relative to
# one element's seeded mass.
OIL_MEDIAN_ATOL = {"lon": 1e-6, "lat": 1e-6, "z": 1e-4, "mass_oil": 1e-5,
                   "mass_evaporated": 1e-5, "mass_dispersed": 1e-5,
                   "water_fraction": 1e-5}
OIL_OUTLIER_ATOL = {"lon": 1e-3, "lat": 1e-3, "z": 0.1, "mass_oil": 1e-3,
                    "mass_evaporated": 1e-3, "mass_dispersed": 1e-3,
                    "water_fraction": 1e-3}
OIL_OUTLIER_SHARE = 0.05
OIL_STATUS_SHARE = 0.01
MASS_BUDGET_RTOL = 1e-3
# The row tiers against 'xyz': the same rows blended in another order (z
# before or after x/y), so the slice tolerance.  'float16x2' against
# float32: the fields are off by 2^-21 of a column's scale, a current of
# 0.5 m/s by 2.4e-7 m/s, 2 mm over the interval's 9000 s or 4e-8 degrees:
# under the float32 noise the slice tolerance already allows, so the slice
# tolerance.  'float16' against float32: the fields are off by up to 2^-11
# (5e-4: the 1e-3 of float16's spacing, rounded to nearest), a current of
# 0.5 m/s by 2.4e-4 m/s, 2.2 m over 9000 s: 4e-5 degrees of longitude at 59 N;
# a diffusivity off by 5e-4 moves each of 150 mixing kicks of up to 2.7 m
# by up to 7e-4 m, a random sum of about 1e-2 m, and the float16 seafloor
# (300 m) is off by up to 0.15 m for an element resting on it.  Outliers:
# elements that crossed a nearest-level boundary of the mixing or a coast
# cell on one side only.
STORAGE_BOUNDS = {         # storage: ({var: median atol}, {var: outlier atol})
    "float16x2": (SLICE_MEDIAN_ATOL, SLICE_OUTLIER_ATOL),
    "float16": ({"lon": 1e-4, "lat": 1e-4, "z": 0.05},
                {"lon": 1e-3, "lat": 1e-3, "z": 1.0})}
STORAGE_OUTLIER_SHARE = 0.02
STORAGE_STATUS_SHARE = 1e-3


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def agree(a, b, median_atol, outlier_atol, outlier_share, nan_share=0.0):
    """(max |a - b|, ok): the median difference within ``median_atol``,
    at most ``outlier_share`` of the elements beyond ``outlier_atol``, and
    NaN where and only where the other is NaN (but for ``nan_share`` of
    the values)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if np.mean(np.isnan(a) != np.isnan(b)) > nan_share:
        return float("inf"), False
    d = np.abs(a - b)[~np.isnan(a) & ~np.isnan(b)]
    if d.size == 0:
        return 0.0, True
    ok = (np.median(d) <= median_atol
          and np.mean(d > outlier_atol) <= outlier_share)
    return float(d.max()), bool(ok)


def power_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------- phase 2 ----

def must_equal(report, name, case, got, want, **fields):
    """Report a mixing kernel's comparison with its plain version (through
    ``report``, which takes what :func:`log` takes) and raise unless every
    output is equal by value, NaN where and only where the other is NaN.
    Returns the largest difference (0.0)."""
    from opendrift_tpu_torch.tools.kernel_check import max_abs_err, same
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    equal = all(same(g, w) for g, w in zip(got, want))
    report("kernel_check", kernel=name, **case, max_abs_err=err, equal=equal,
           elements=int(got[0].shape[0]), **fields)
    if not equal:
        raise AssertionError(f"{name} {case} differs from its plain "
                             f"version: {err}")
    return err


def check_oil_kernel(device, n=N_KERNEL, ntimes=NTIMES, timed=True,
                     report=log):
    """The oil mixing kernel against its plain version on ``device``, for
    the three windspeed models x keep_diam x mixing_at_surface: both
    outputs equal by value (+0 and -0 count as equal; NaN where the other
    is NaN).  Returns its row of the result line (Large1994, the main
    path's options), or the largest error when not ``timed``."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.tools.kernel_check import (
        OIL_NAMES, cuda_ms, device_ms, oil_kernel_inputs)
    t, seed = oil_kernel_inputs(n, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def oil(model, at_surface, keep_diam, plain):
        kw = dict(ntimes=ntimes, dt_mix=60.0, model=model, bg=1.2e-5,
                  mixing_at_surface=at_surface, keep_diam=keep_diam)
        args = [t[k] for k in OIL_NAMES]
        if plain:
            return mixing.visser_mixing_oil_plain(*args, t["elem"], seed,
                                                  **kw)
        return mixing.visser_mixing_oil(*args, seed, elem=t["elem"], **kw)

    worst = 0.0
    for model in mixing.WINDSPEED_MODELS:
        for keep_diam in (False, True):
            for at_surface in (False, True):
                kz, kd = oil(model, at_surface, keep_diam, False)
                pz, pd = oil(model, at_surface, keep_diam, True)
                sync()
                worst = max(worst, must_equal(
                    report, "visser_mixing_oil",
                    dict(model=model, mixing_at_surface=at_surface,
                         keep_diam=keep_diam), (kz, kd), (pz, pd),
                    entrained_share=float((kd != t["diam"]).float().mean()),
                    submerged_share=float((kz < 0).float().mean())))
    if not timed:
        return worst
    model = "windspeed_Large1994"
    # 12 float arrays and the IDs read once, z and the diameter written once
    nbytes = n * (13 + 2) * 4
    nops = n * ntimes * (OPS_PER_SUBSTEP[model] + OIL_EXTRA_OPS)
    ms = cuda_ms(lambda: oil(model, False, False, False))
    queued_ms = device_ms(lambda: oil(model, False, False, False))
    plain_ms = cuda_ms(lambda: oil(model, False, False, True), warmup=1,
                       reps=3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    row = {"name": "visser_mixing_oil", "route": "cuda",
           "source": "opendrift_tpu_torch/csrc/visser_mixing.cu",
           "replaces": "opendrift_tpu/ops/pallas_mixing.py:472",
           "launches": 0, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "device_ms": queued_ms, "bytes": nbytes,
           "ops": nops}
    log("kernel_time", **row)
    return row


def check_kernels(device, n=N_KERNEL, ntimes=NTIMES, timed=True, report=log):
    """The windspeed and profile kernels against their plain versions on
    ``device``, equal by value; returns the kernel rows of the result line
    (the main-path configuration's times: windspeed_Large1994, no mixing
    at the surface), or the largest errors when not ``timed``."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.tools.kernel_check import (
        cuda_ms, device_ms, kernel_inputs)
    t, seed, h = kernel_inputs(n, device)
    rows = {}
    errs = {"visser_mixing": 0.0, "visser_mixing_profile": 0.0}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def windspeed(model, at_surface, plain):
        fn = mixing.visser_mixing_plain if plain else mixing.visser_mixing
        kw = dict(ntimes=ntimes, dt_mix=60.0, model=model, bg=1.2e-5,
                  mixing_at_surface=at_surface)
        args = (t["z"], t["moving"], t["w"], t["wind"], t["mld"], t["zmin"])
        if plain:
            return fn(*args, t["elem"], seed, **kw)
        return fn(*args, seed, elem=t["elem"], **kw)

    def profile(at_surface, plain):
        kw = dict(ntimes=ntimes, dt_mix=60.0, h=h,
                  mixing_at_surface=at_surface)
        args = (t["z"], t["moving"], t["w"], t["Kprof"], t["gradK"],
                t["zmin"])
        if plain:
            return mixing.visser_mixing_profile_plain(
                *args, t["elem"], seed, **kw)
        return mixing.visser_mixing_profile(*args, seed, elem=t["elem"], **kw)

    for at_surface in (False, True):
        for model in mixing.WINDSPEED_MODELS:
            k = windspeed(model, at_surface, False)
            p = windspeed(model, at_surface, True)
            sync()
            errs["visser_mixing"] = max(errs["visser_mixing"], must_equal(
                report, "visser_mixing",
                dict(model=model, mixing_at_surface=at_surface), (k,), (p,)))
        k = profile(at_surface, False)
        p = profile(at_surface, True)
        sync()
        errs["visser_mixing_profile"] = max(
            errs["visser_mixing_profile"], must_equal(
                report, "visser_mixing_profile", dict(mixing_at_surface=at_surface),
                (k,), (p,)))
    if not timed:
        return errs

    model = "windspeed_Large1994"
    # bytes: 7 arrays of 4 B read once, z written once
    b1 = n * 8 * 4
    o1 = n * ntimes * OPS_PER_SUBSTEP[model]
    # the profile kernel reads 5 arrays of 4 B (z, moving, w, zmin, elem)
    # and writes z, plus K and gradK at each (level, element) this run's
    # data visits (bound_ms, 4 B a pair), or in whole 32-byte
    # sectors (bound_sector_ms)
    L = t["Kprof"].shape[0]
    visited = torch.zeros(t["Kprof"].shape, dtype=torch.bool, device=device)
    for i in range(ntimes):
        # substep i reads the level nearest the plain version's depth after
        # i substeps (a NaN depth reads level 0, as the card converts it)
        z = t["z"] if i == 0 else mixing.visser_mixing_profile_plain(
            t["z"], t["moving"], t["w"], t["Kprof"], t["gradK"], t["zmin"],
            t["elem"], seed, ntimes=i, dt_mix=60.0, h=h,
            mixing_at_surface=False)
        zi = torch.round(-z / h).nan_to_num(0.0).clamp(0, L - 1)
        visited.scatter_(0, zi.to(torch.int64)[None], True)
    pb = mixing.profile_bound_bytes(visited)
    b2 = pb["total"]
    o2 = n * ntimes * OPS_PER_SUBSTEP["profile"]
    report("profile_bound", levels=L, h=h, **pb)
    for name, run, nbytes, nops, line in (
            ("visser_mixing", lambda p: windspeed(model, False, p), b1, o1,
             313),
            ("visser_mixing_profile", lambda p: profile(False, p), b2, o2,
             394)):
        ms = cuda_ms(lambda: run(False))
        queued_ms = device_ms(lambda: run(False))
        plain_ms = cuda_ms(lambda: run(True), warmup=1, reps=3)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "opendrift_tpu_torch/csrc/visser_mixing.cu",
            "replaces": f"opendrift_tpu/ops/pallas_mixing.py:{line}",
            "launches": 0, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "device_ms": queued_ms, "bytes": nbytes,
            "ops": nops}
        if name == "visser_mixing_profile":
            t_sectors = pb["sector_total"] / HBM_BYTES_PER_S * 1e3
            rows[name].update(bound_sector_ms=max(t_sectors, t_ops),
                              sector_bytes=pb["sector_total"])
        log("kernel_time", **rows[name])
    return rows


def check_profile_edges(device, n=200_003, ntimes=NTIMES, report=log):
    """The profile kernel against its plain version on its edge cases
    (``kernel_check.PROFILE_EDGE_CASES``: every block of the kernel at the
    first and the last level, diffusivities that move elements 10 levels a
    substep, 2 and 201 levels, NaN depths and seafloors), with and without
    mixing at the surface, equal by value.  Returns the largest error
    (0.0)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.tools.kernel_check import (
        PROFILE_EDGE_CASES, profile_edge_inputs)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    worst = 0.0
    for case in PROFILE_EDGE_CASES:
        t, seed, h = profile_edge_inputs(case, n, device)
        stats = {"levels": int(t["Kprof"].shape[0]), "h": h}
        for at_surface in (False, True):
            kw = dict(ntimes=ntimes, dt_mix=60.0, h=h,
                      mixing_at_surface=at_surface)
            args = (t["z"], t["moving"], t["w"], t["Kprof"], t["gradK"],
                    t["zmin"])
            got = mixing.visser_mixing_profile(*args, seed, elem=t["elem"],
                                               **kw)
            want = mixing.visser_mixing_profile_plain(*args, t["elem"], seed,
                                                      **kw)
            sync()
            worst = max(worst, must_equal(
                report, "visser_mixing_profile",
                dict(case=case, mixing_at_surface=at_surface), (got,),
                (want,), nan_share=float(torch.isnan(want).float().mean()),
                **stats))
    return worst


def check_ragged_sizes(device, sizes=RAGGED_SIZES):
    """The three mixing kernels against their plain versions at sizes that
    leave a ragged last block (and at one element)."""
    for n in sizes:
        cases = []
        errs = check_kernels(device, n=n, timed=False,
                             report=lambda phase, **f: cases.append(f))
        errs["visser_mixing_oil"] = check_oil_kernel(
            device, n=n, timed=False,
            report=lambda phase, **f: cases.append(f))
        log("kernel_check_ragged", elements=n, cases=len(cases),
            equal=all(c["equal"] for c in cases), max_abs_err=errs)


def quotient_sweep():
    """The windspeed and oil kernels' reciprocal quotient against the
    float32 division on the card, bit for bit, for every float32
    mixed-layer depth of the range that takes the reciprocal and every
    numerator the walk can divide by it (some 1e13 quotients)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    lo, hi = mixing.RECIPROCAL_MLD_RANGE
    t = time.perf_counter()
    compared, differing, where = mixing.reciprocal_quotient_sweep(lo, hi)
    torch.cuda.synchronize()
    log("quotient_sweep", mld_range=[lo, hi], quotients=compared,
        differing=differing, first_differing=where,
        seconds=time.perf_counter() - t)
    if differing or compared == 0:
        raise AssertionError(
            f"the reciprocal quotient differs from the division for "
            f"{differing} of {compared} quotients, first at (mld, "
            f"numerator) = {where}")


def sass_phase(rows, n=N_KERNEL, ntimes=NTIMES):
    """The compiled substep loops of the windspeed, oil and profile kernels
    (Large1994, the main path's options): SASS instructions a substep by
    pipe, and the issue bound they set at the SM clock read under load,
    beside the rows' ``bound_ms`` (bytes and operations at the data sheet's
    rates).  Without a ``cuobjdump`` the line says "not available"."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.tools import kernel_check, sass
    z = torch.zeros(n, device="cuda")
    mhz = kernel_check.sm_clock_mhz(lambda: mixing.visser_mixing(
        z, 1.0, 0.0, 8.0, 40.0, -60.0, 7, ntimes=ntimes, dt_mix=60.0,
        model="windspeed_Large1994", bg=1.2e-5, mixing_at_surface=False))
    report = sass.mixing_report(mixing.build_library(), n, ntimes, mhz)
    if isinstance(report, str):
        log("sass", sass=report, sm_clock_mhz_under_load=mhz)
        return
    for name, loops in report.items():
        # the first loop issues least: the path of every mixed-layer depth
        # in the reciprocal's range; the other divides
        fields = {"kernel": name, "sm_clock_mhz_under_load": mhz,
                  "ms": rows[name]["ms"],
                  "device_ms": rows[name]["device_ms"],
                  "bound_ms": rows[name]["bound_ms"]}
        # the profile kernel has no dividing path
        labels = ("substep", "substep_dividing") \
            if name != "visser_mixing_profile" else ("substep", "substep_2")
        for label, loop in zip(labels, loops):
            fields[label] = loop["per_substep"]
            fields[label + "_issue_bound_ms"] = loop.get("issue_bound_ms")
            fields[label + "_issue_bound_by"] = loop.get("issue_bound_by")
        if not loops:
            fields["sass"] = "no substep loop found"
        log("sass", **fields)


def gather_row(name, line, ms, queued_ms, plain_ms, bound, err):
    """A row-gather kernel's row of the result line.  Its bound is bytes:
    the indices and each distinct row (in whole 32-byte sectors) read once,
    the output written once; a gather does no arithmetic.  The plain
    version and the library call are one and the same ``index_select``."""
    return {"name": name, "route": "cuda",
            "source": "opendrift_tpu_torch/csrc/row_gather.cu",
            "replaces": f"tools/gather_ab.py:{line}", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["total"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": plain_ms,
            "device_ms": queued_ms, "bytes": bound["total"], "ops": 0}


def check_gather_kernels(device, n=2_000_000, timed=True):
    """Both row-gather kernels against ``gather_rows_plain`` on ``device``,
    bit for bit: (a) the A/B tool's default table (the shared-memory
    kernel must refuse it), (b) a table that fits shared memory, (c) a
    float16 table, 10-byte rows and row widths that are no multiple of 16
    bytes (88: 8-byte copies, 92: 4-byte copies), (d) the ragged tail and
    out-of-range indices, int64 and int32, (e) rows of 16 and 4096 bytes
    and a table that starts 8 bytes into its allocation.  Each line names
    the route ``gather_rows_async`` took (bulk for whole 16-byte units of
    48 bytes or more at 16-byte aligned addresses, ring otherwise).
    Returns the two rows of
    the result line: the asynchronous-copy kernel at (a), the
    shared-memory kernel at (b)."""
    import torch
    from opendrift_tpu_torch.ops import gather
    from opendrift_tpu_torch.tools import gather_ab
    from opendrift_tpu_torch.tools.kernel_check import cuda_ms, device_ms
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    r = np.random.default_rng(0)
    small = max(n // 1000, 8)
    cases = [("default", 125 * small, 24, n, np.float32, np.int32),
             ("fits_smem", small, 24, n, np.float32, np.int32),
             ("float16", small, 48, n // 4, np.float16, np.int64),
             ("rows_10B", small, 5, n // 4, np.float16, np.int32),
             ("rows_88B", 125 * small, 22, n // 4, np.float32, np.int64),
             ("rows_92B", 125 * small, 23, n // 4, np.float32, np.int32),
             ("ragged", 40 * small, 88, n + 3, np.float32, np.int64),
             ("ragged_int32", 125 * small, 24, n + 5, np.float32, np.int32),
             ("rows_16B", 125 * small, 4, n + 1, np.float32, np.int64),
             ("rows_4096B", small, 1024, n // 64 + 7, np.float32, np.int32),
             ("offset_8B", 125 * small, 24, n // 4, np.float32, np.int64)]
    rows = {}
    for label, R, C, N, dtype, itype in cases:
        table = r.normal(size=(R, C)).astype(dtype)
        table[0, 0] = np.nan
        table[1, 0] = -0.0
        lo, hi = (-3, R + 3) if label.startswith("ragged") else (0, R - 1)
        if label == "offset_8B":
            # the same rows in a view that starts 8 bytes into its storage
            base = torch.empty(R * C + 2, dtype=torch.float32, device=device)
            base[2:] = torch.as_tensor(table.reshape(-1), device=device)
            packed = base[2:].view(R, C)
        else:
            packed = torch.as_tensor(table, device=device)
        idx = torch.as_tensor(r.integers(lo, hi, N).astype(itype),
                              device=device)
        want = gather.gather_rows_plain(packed, idx)
        got = gather.gather_rows_async(packed, idx)
        sync()
        route = gather.gather_route(C * table.itemsize, packed.data_ptr(),
                                    got.data_ptr())
        equal = {"gather_rows_async": gather_ab.bit_equal(got, want)}
        fits = R * C * table.itemsize <= gather.SMEM_TABLE_MAX_BYTES
        if fits:
            got = gather.gather_rows_smem(packed, idx)
            sync()
            equal["gather_rows_smem"] = gather_ab.bit_equal(got, want)
        else:
            try:
                gather.gather_rows_smem(packed, idx)
            except ValueError as e:
                refused = str(e)
            else:
                raise AssertionError("gather_rows_smem took a table beyond "
                                     "shared memory")
        log("kernel_check", kernel="row_gather", case=label, table=[R, C],
            dtype=np.dtype(dtype).name, indices=N,
            index_dtype=np.dtype(itype).name, copy_route=route,
            table_offset=packed.data_ptr() % 16, bit_equal=equal,
            smem=("launched" if fits else f"refused: {refused}"))
        if not all(equal.values()):
            raise AssertionError(f"row gather {label}: {equal}")
        if not timed:
            continue
        bound = gather.gather_bound_bytes(packed, idx)
        plain_ms = cuda_ms(lambda: gather.gather_rows_plain(packed, idx))
        for name, fn, line in (
                ("gather_rows_async", gather.gather_rows_async, 94),
                ("gather_rows_smem", gather.gather_rows_smem, 133)):
            if name == "gather_rows_smem" and not fits:
                continue
            ms = cuda_ms(lambda: fn(packed, idx))
            queued_ms = device_ms(lambda: fn(packed, idx))
            row = gather_row(name, line, ms, queued_ms, plain_ms, bound, 0.0)
            log("kernel_time", case=label, copy_route=route if name ==
                "gather_rows_async" else None, **row)
            if (name, label) in (("gather_rows_async", "default"),
                                 ("gather_rows_smem", "fits_smem")):
                rows[name] = row
    return rows


# ------------------------------------------------------------- phase 3 ----

def forcing(seed=0, nx=200, ny=200, nz=16, nt=5, lon0=3.0, lat0=59.0,
            dlon=0.02, dlat=0.01):
    """A synthetic z-level ocean: time-varying 3D currents decaying with
    depth, 2D winds and a static seafloor depth, on a ``dlon`` x ``dlat``
    degree lat/lon grid from (``lon0``, ``lat0``), by default off western
    Norway, frames every 3 hours."""
    r = np.random.default_rng(seed)
    x = np.linspace(lon0, lon0 + dlon * (nx - 1), nx)
    y = np.linspace(lat0, lat0 + dlat * (ny - 1), ny)
    depths = np.concatenate([[0.0, 2.0, 5.0, 10.0, 15.0, 20.0, 30.0, 40.0],
                             np.linspace(50.0, 400.0, nz - 8)])[:nz]
    t0 = datetime(2024, 3, 1)
    times = [t0 + timedelta(hours=3 * i) for i in range(nt)]
    X, Y = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                       np.linspace(0, 2 * np.pi, ny))
    decay = np.exp(-depths / 60.0)[None, :, None, None]
    phase = np.arange(nt)[:, None, None, None] * 0.4
    u = 0.3 * np.sin(Y + phase) * decay + 0.05 * r.standard_normal(
        (nt, nz, ny, nx))
    v = 0.3 * np.cos(X - phase) * decay + 0.05 * r.standard_normal(
        (nt, nz, ny, nx))
    xw = 8.0 + 3.0 * np.sin(X + np.arange(nt)[:, None, None])
    yw = 3.0 * np.cos(Y)[None].repeat(nt, 0)
    h = 30.0 + 300.0 * (0.5 + 0.5 * np.sin(X / 2) * np.cos(Y / 3))
    current = {"x_sea_water_velocity": u.astype(np.float32),
               "y_sea_water_velocity": v.astype(np.float32),
               "sea_floor_depth_below_sea_level": h.astype(np.float32)}
    wind = {"x_wind": xw.astype(np.float32), "y_wind": yw.astype(np.float32)}
    return current, wind, x, y, depths, times


def simulation(device, n, model, hdiff, seed=0, forcing_kw=None):
    """An OceanDrift run of ``n`` elements over the synthetic ocean, set
    up as a user would: RK4, Visser mixing with ``model``, dt = 900 s with
    60 s mixing substeps, elements seeded over the top 20 m."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader
    current, wind, x, y, depths, times = forcing(**(forcing_kw or {}))
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                             name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", model)
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", hdiff)
    if model == "constant":
        o.set_config("environment:fallback:ocean_vertical_diffusivity", 1e-3)
    r = np.random.default_rng(seed + 1)
    lon0 = float(x[len(x) // 4])
    lon1 = float(x[3 * len(x) // 4])
    lat0 = float(y[len(y) // 4])
    lat1 = float(y[3 * len(y) // 4])
    o.seed_elements(lon=r.uniform(lon0, lon1, n), lat=r.uniform(lat0, lat1, n),
                    z=-r.uniform(0.0, 20.0, n), time=times[0])
    return o


def run_main_path(n, intervals, model, rng="threefry"):
    """One user-level run on the card with ``general:rng`` = ``rng``;
    returns (simulation, seconds)."""
    import torch
    o = simulation("cuda", n, model, hdiff=10.0)
    o.set_config("general:rng", rng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=900 * 10 * intervals), time_step=900,
          time_step_output=9000,
          export_variables=["lon", "lat", "z", "status"])
    torch.cuda.synchronize()
    return o, time.perf_counter() - t


def check_result(o, n, frames):
    lon = np.asarray(o.result["lon"].values)
    z = np.asarray(o.result["z"].values)
    status = np.asarray(o.result["status"].values)
    assert lon.shape == (n, frames), lon.shape
    active = status[:, -1] == 0
    assert active.mean() > 0.99, f"only {active.mean()} active"
    for var in ("lon", "lat", "z"):
        vals = np.asarray(o.result[var].values)[active, -1]
        assert np.isfinite(vals).all(), f"non-finite {var}"
    assert (z[active, -1] <= 0.0).all(), "elements above the surface"
    return float(active.mean())


def profile_interval(o, top=10, phase="profile", dt=900.0):
    """Where one output interval (K = 10 steps of ``dt`` seconds) of a path
    spends its time on the card: the kernels by device time, and the
    device's busy share of the interval's wall time (torch.profiler).  Not
    part of the run whose launches are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    advance, _, state, key = o.prepare_run(dt, 10, total_steps=10)
    dev_states = o.env.build_device_states()
    advance(state, dev_states, np.float32(0.0), key)     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        advance(state, dev_states, np.float32(0.0), key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) * 1e-6
    events.sort(key=lambda e: -e.device_time_total)
    log(phase, interval_wall_s=wall, device_busy_s=busy,
        device_busy_share=busy / wall, kernels=[
            {"name": e.key[:80], "calls": e.count,
             "device_ms": e.device_time_total * 1e-3}
            for e in events[:top]])


def main_path():
    import torch
    from opendrift_tpu_torch.ops import mixing
    n = 2_000_000
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile)
    launches = {}
    # one untimed interval first: the first run() of a process loads each
    # of PyTorch's CUDA kernels at its first use, and the timed run below
    # should not carry that
    o, secs = run_main_path(n, intervals=1, model="windspeed_Large1994")
    cold = n * 10 / (o.timers["main loop"]
                     - o.timers.get("main loop:readers", 0.0))
    del o
    # the windspeed kernel's path: 3 output intervals of K = 10 steps
    for k in kernels:
        k.launches = 0
    o, secs = run_main_path(n, intervals=3, model="windspeed_Large1994")
    launches["visser_mixing"] = mixing.visser_mixing.launches
    active = check_result(o, n, 4)
    sampler = o.env.readers["ocean"]._sampler.pair_mode
    wind_tier = o.env.readers["wind"]._sampler.pair_mode
    assert sampler == "xyz" and wind_tier == "xy", (sampler, wind_tier)
    steps = 30
    readers_s = o.timers.get("main loop:readers", 0.0)
    loop_s = o.timers["main loop"]
    stats = {"elements": n, "steps": steps, "run_s": secs,
             "main_loop_s": loop_s, "readers_s": readers_s,
             "particle_steps_per_s": n * steps / secs,
             "particle_steps_per_s_steps_only":
                 n * steps / (loop_s - readers_s),
             "particle_steps_per_s_steps_only_cold": cold}
    log("main_path", model="windspeed_Large1994", ocean_tier=sampler,
        wind_tier=wind_tier, active_share=active,
        launches=launches["visser_mixing"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **stats)
    # the final positions' spread, for the tiled run of the same setting
    stats["final"] = final_moments(o)
    if launches["visser_mixing"] == 0:
        raise AssertionError("the main path never launched visser_mixing")
    profile_interval(o)
    del o
    # the profile kernel's path: one interval with 'constant' diffusivity
    for k in kernels:
        k.launches = 0
    o, secs = run_main_path(n, intervals=1, model="constant")
    launches["visser_mixing_profile"] = mixing.visser_mixing_profile.launches
    check_result(o, n, 2)
    log("main_path", model="constant", elements=n, steps=10, run_s=secs,
        launches=launches["visser_mixing_profile"],
        windspeed_launches=mixing.visser_mixing.launches)
    if launches["visser_mixing_profile"] == 0:
        raise AssertionError(
            "the constant-diffusivity path never launched "
            "visser_mixing_profile")
    return launches, stats


def final_moments(o):
    """The final lon/lat spread in metres and the final z mean and spread
    of the active elements, as tests/test_engine_dd.py judges a tiled
    run's statistics."""
    lon = np.asarray(o.result["lon"].values)[:, -1]
    lat = np.asarray(o.result["lat"].values)[:, -1]
    z = np.asarray(o.result["z"].values)[:, -1]
    ok = np.asarray(o.result["status"].values)[:, -1] == 0
    coslat = np.cos(np.radians(np.nanmean(lat[ok])))
    return {"lon_spread_m": float(np.std(lon[ok]) * 111320.0 * coslat),
            "lat_spread_m": float(np.std(lat[ok]) * 111320.0),
            "z_mean": float(np.mean(z[ok])), "z_std": float(np.std(z[ok]))}


# ------------------------------------------------------------ phase 3a ----

# the rbg path's draws: the diffusion normals of a 2M-element step are one
# (2, 2M) draw; a shard of a particle-sharded run draws a (2, n) block of a
# longer axis at an offset inside a Philox block; the carrying key wraps
# both 64-bit halves of the counter
PHILOX_N = 2_000_000
PHILOX_SHARD = (1_000_003, 4_000_006)           # (offset, n_global)
PHILOX_CARRY_KEY = (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFD, 0xFFFFFFFF)
# a counter's 10 rounds: two multiply-highs, two multiplies, four xors and
# two key additions each, for its four words
PHILOX_OPS_PER_WORD = 10 * 10 / 4
PHILOX_REPLACES = ("none: XLA's RngBitGenerator under jax.random.key(seed, "
                   "impl='rbg'), opendrift_tpu/models/base.py:1161")


def philox_cases(n=PHILOX_N):
    """(label, key words, lead, last, offset, n_global) of each check."""
    from opendrift_tpu_torch import rng
    key = tuple(rng.fold_in(rng.rbg_key(7), 3))
    offset, n_global = PHILOX_SHARD
    return [("words", key, 1, n, 0, n),
            ("main_path", key, 2, n, 0, n),
            ("shard", key, 2, n, offset, n_global),
            ("carry", PHILOX_CARRY_KEY, 2, n, 0, n),
            # the last shard of a padded sharded run: rows run past
            # n_global into the next row's words
            ("padded_shard", key, 2, 13, 91, 100),
            ("ragged_1", key, 1, 1, 0, 1),
            ("ragged_3x5", key, 3, 5, 2, 11)]


def check_philox(device, n=PHILOX_N, timed=True):
    """``philox_bits`` against ``philox_bits_plain`` on ``device``, equal
    to the bit in every case of :func:`philox_cases`; with ``timed`` its
    kernel row at the main path's (2, 2M) draw, and the threefry
    ``rng.bits`` of the same shapes beside it."""
    import torch
    from opendrift_tpu_torch import rng
    from opendrift_tpu_torch.ops import philox
    from opendrift_tpu_torch.tools.kernel_check import cuda_ms, device_ms
    times = {}
    for label, key, lead, last, offset, n_global in philox_cases(n):
        got = philox.philox_bits(key, lead, last, offset, n_global, device)
        want = philox.philox_bits_plain(key, lead, last, offset, n_global,
                                        device)
        equal = bool(torch.equal(got, want))
        log("kernel_check", kernel="philox_bits", case=label,
            shape=[lead, last], offset=offset, n_global=n_global,
            equal=equal, max_abs_err=float((got - want).abs().max()))
        if not equal:
            raise AssertionError(f"philox_bits {label} differs from its "
                                 "plain version")
        if not timed or label not in ("words", "main_path"):
            continue
        tf_key = rng.fold_in(rng.PRNGKey(7), 3)
        shape = (lead, last) if lead > 1 else (last,)
        times[label] = {
            "ms": cuda_ms(lambda: philox.philox_bits(key, lead, last,
                                                     device=device)),
            "device_ms": device_ms(lambda: philox.philox_bits(
                key, lead, last, device=device)),
            "plain_ms": cuda_ms(lambda: philox.philox_bits_plain(
                key, lead, last, 0, last, device), warmup=1, reps=5),
            "threefry_ms": cuda_ms(lambda: rng.bits(tf_key, shape, device),
                                   warmup=1, reps=5),
            "threefry_device_ms": device_ms(
                lambda: rng.bits(tf_key, shape, device), launches=5,
                reps=3),
            "words": lead * last}
        nbytes = lead * last * 8                 # int64 words written once
        nops = lead * last * PHILOX_OPS_PER_WORD
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        times[label].update(bound_ms=max(t_bytes, t_ops), bytes=nbytes,
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations", ops=nops)
        log("philox_time", case=label, shape=list(shape), **times[label])
    if not timed:
        return None
    main = times["main_path"]
    row = {"name": "philox_bits", "route": "cuda",
           "source": "opendrift_tpu_torch/csrc/philox.cu",
           "replaces": PHILOX_REPLACES, "launches": 0, "max_abs_err": 0.0,
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": None, "device_ms": main["device_ms"],
           "threefry_ms": main["threefry_ms"],
           "threefry_device_ms": main["threefry_device_ms"],
           "shape": [2, n], "words_2m": times["words"],
           "bytes": main["bytes"], "ops": main["ops"]}
    log("kernel_time", **row)
    return row


def rbg_path(threefry_stats, n=2_000_000, intervals=3):
    """The main path's run under ``general:rng='rbg'``: its diffusion
    normals through ``philox_bits``, its mixing seed the rbg scalar draw
    (on the host).  Returns (Philox launches, stats)."""
    import torch
    from opendrift_tpu_torch.ops import mixing, philox
    mixing.visser_mixing.launches = 0
    philox.philox_bits.launches = 0
    o, secs = run_main_path(n, intervals, "windspeed_Large1994", rng="rbg")
    launches = philox.philox_bits.launches
    k1 = mixing.visser_mixing.launches
    active = check_result(o, n, intervals + 1)
    steps = 10 * intervals
    loop_s = o.timers["main loop"]
    readers_s = o.timers.get("main loop:readers", 0.0)
    stats = {"elements": n, "steps": steps, "run_s": secs,
             "main_loop_s": loop_s, "readers_s": readers_s,
             "particle_steps_per_s": n * steps / secs,
             "particle_steps_per_s_steps_only":
                 n * steps / (loop_s - readers_s)}
    log("rbg_path", model="windspeed_Large1994", active_share=active,
        philox_launches=launches, philox_launches_per_step=launches / steps,
        visser_mixing_launches=k1,
        threefry_particle_steps_per_s_steps_only=threefry_stats[
            "particle_steps_per_s_steps_only"],
        threefry_particle_steps_per_s=threefry_stats[
            "particle_steps_per_s"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **stats)
    if k1 != steps:
        raise AssertionError(f"the rbg path launched K1 {k1} times, not "
                             f"once a step ({steps})")
    if launches != steps:
        raise AssertionError(f"the rbg path launched philox_bits {launches} "
                             f"times, not once a step ({steps})")
    return launches, stats


# ------------------------------------------------------------- phase 4 ----

OIL_EXPORT = ["lon", "lat", "z", "status", "mass_oil", "mass_evaporated",
              "mass_dispersed", "mass_biodegraded", "water_fraction",
              "viscosity", "density", "diameter"]
COAST_CELLS = 30       # the easternmost columns of the grid are land


def oil_forcing(**kw):
    """The synthetic ocean of :func:`forcing` with what oil reads besides:
    3D temperature and salinity, a coast along the eastern side (a
    reader-served ``land_binary_mask``), and a wave reader (significant
    height, peak period, Stokes drift)."""
    current, wind, x, y, depths, times = forcing(**kw)
    nt, nz, ny, nx = current["x_sea_water_velocity"].shape
    X, Y = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                       np.linspace(0, 2 * np.pi, ny))
    cool = np.exp(-depths / 80.0)[None, :, None, None]
    step = np.arange(nt)[:, None, None, None]
    current["sea_water_temperature"] = (
        4.0 + 6.0 * cool + 0.5 * np.sin(X + 0.3 * step)).astype(np.float32)
    current["sea_water_salinity"] = (
        35.0 - 2.0 * cool + 0.2 * np.cos(Y) + 0.0 * step).astype(np.float32)
    land = np.zeros((ny, nx), np.float32)
    land[:, nx - max(2, COAST_CELLS * nx // 200):] = 1.0
    current["land_binary_mask"] = land
    step = step[:, 0]
    hs = 1.8 + 0.6 * np.sin(X + 0.5 * step)
    wave = {
        "sea_surface_wave_significant_height": hs.astype(np.float32),
        "sea_surface_wave_period_at_variance_spectral_density_maximum":
            (7.0 + np.cos(Y) + 0.0 * step).astype(np.float32),
        "sea_surface_wave_stokes_drift_x_velocity":
            (0.04 * hs).astype(np.float32),
        "sea_surface_wave_stokes_drift_y_velocity":
            (0.01 * np.cos(Y) + 0.0 * step).astype(np.float32)}
    return current, wind, wave, x, y, depths, times


def oil_release_point(x, y):
    """(lon, lat) of the oil path's release: two standard deviations of its
    4 km release radius west of the oil forcing's coast, mid-latitude."""
    nx = len(x)
    coast = nx - max(2, COAST_CELLS * nx // 200)
    cell_m = (x[1] - x[0]) * 111320.0 * np.cos(np.radians(y.mean()))
    return (float(x[coast] - 2.0 * 4000.0 / cell_m * (x[1] - x[0])),
            float(y[len(y) // 2]))


def oil_model(device, model=None, seed=0, forcing_kw=None):
    """OpenOil on the oil forcing's readers, set up as a user would: RK4,
    dt = 900 s with 60 s mixing substeps, evaporation, emulsification and
    dispersion on (the defaults), the default current and wind
    uncertainty, stranding at the reader's coast.  ``model=None`` keeps
    the default 'environment' diffusivity model, which no reader serves
    here.  Returns (simulation, the forcing's x, y and times)."""
    from opendrift_tpu_torch.models import OpenOil
    from opendrift_tpu_torch.fields import ArrayReader
    current, wind, wave, x, y, depths, times = oil_forcing(
        **(forcing_kw or {}))
    o = OpenOil(loglevel=40, device=device, seed=seed)
    o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                             name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.add_reader(ArrayReader(wave, x, y, times, name="wave"))
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("vertical_mixing:timestep", 60.0)
    if model is not None:
        o.set_config("vertical_mixing:diffusivitymodel", model)
    return o, x, y, times


def oil_simulation(device, n, model=None, seed=0, forcing_kw=None):
    """An OpenOil run of ``n`` elements (:func:`oil_model`): GENERIC MEDIUM
    CRUDE, 100 m3 released at the surface within a radius some kilometres
    off the coast (:func:`oil_release_point`)."""
    o, x, y, times = oil_model(device, model, seed, forcing_kw)
    lon, lat = oil_release_point(x, y)
    o.seed_elements(lon=lon, lat=lat, radius=4000.0, number=n,
                    time=times[0], z=0.0, m3_per_hour=100.0,
                    oil_type="GENERIC MEDIUM CRUDE")
    return o


def check_oil_result(o, n, frames, must_have=("evaporated_share",
                                               "submerged_share",
                                               "stranded_share")):
    """The oil run's own checks; returns the numbers it logs.  Each share
    of ``must_have`` must be above 0."""
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    status = np.asarray(o.result["status"].values)
    assert status.shape == (n, frames), status.shape
    valid = valid_mask(status, 0)
    for var in OIL_EXPORT:
        vals = np.asarray(o.result[var].values)
        assert vals.shape == (n, frames), (var, vals.shape)
        if np.issubdtype(vals.dtype, np.floating):
            assert np.isfinite(vals[valid]).all(), f"non-finite {var}"
    final = {k: o.state.data[k].double() for k in (
        "mass_oil", "mass_evaporated", "mass_dispersed", "mass_biodegraded")}
    seeded = float(np.asarray(o.result["mass_oil"].values,
                              np.float64)[:, 0].sum())
    total = float(sum(v.sum() for v in final.values()))
    components = float(o.state.data["mass_components"].double().sum())
    assert abs(total - seeded) <= MASS_BUDGET_RTOL * seeded, (total, seeded)
    assert abs(components - float(final["mass_oil"].sum())) \
        <= MASS_BUDGET_RTOL * seeded, components
    z = o.state.data["z"]
    st = o.state.data["status"]
    stranded = o.status_categories.index("stranded")
    out = {"seeded_kg": seeded, "budget_rel_err": abs(total - seeded) / seeded,
           "evaporated_share": float(final["mass_evaporated"].sum()) / seeded,
           "dispersed_share": float(final["mass_dispersed"].sum()) / seeded,
           "submerged_share": float(((z < 0) & (st == 0)).float().mean()),
           "stranded_share": float((st == stranded).float().mean()),
           "active_share": float((st == 0).float().mean())}
    assert float(z.max()) <= 0.0, "elements above the surface"
    for key in must_have:
        assert out[key] > 0.0, f"no oil {key.split('_')[0]}"
    return out


def run_oil_path(n, intervals, model):
    import torch
    o = oil_simulation("cuda", n, model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=900 * 10 * intervals), time_step=900,
          time_step_output=9000, export_variables=OIL_EXPORT)
    torch.cuda.synchronize()
    return o, time.perf_counter() - t


def oil_path():
    """The OpenOil main path at 2M elements; returns (launches of the oil
    kernel over the windspeed_Large1994 run, that run's numbers)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    n = 2_000_000
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    o, secs = run_oil_path(n, intervals=3, model="windspeed_Large1994")
    launches = mixing.visser_mixing_oil.launches
    steps = 30
    assert launches == steps, f"{launches} oil kernel launches in {steps} steps"
    assert mixing.visser_mixing.launches == 0, "the oil run launched K1"
    checks = check_oil_result(o, n, 4)
    tiers = {name: r._sampler.pair_mode for name, r in o.env.readers.items()}
    readers_s = o.timers.get("main loop:readers", 0.0)
    loop_s = o.timers["main loop"]
    stats = {"elements": n, "steps": steps, "run_s": secs,
             "preparing_s": o.timers.get("preparing main loop", 0.0),
             "main_loop_s": loop_s, "readers_s": readers_s,
             "particle_steps_per_s": n * steps / secs,
             "particle_steps_per_s_steps_only":
                 n * steps / (loop_s - readers_s)}
    log("oil_path", model="windspeed_Large1994", tiers=tiers,
        launches=launches, windspeed_launches=mixing.visser_mixing.launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **checks,
        **stats)
    profile_interval(o, phase="oil_profile")
    del o
    # the default 'environment' model with no diffusivity reader: the step
    # switches to windspeed_Large1994 and goes through the oil kernel
    for k in kernels:
        k.launches = 0
    o, secs = run_oil_path(n, intervals=1, model=None)
    assert o.get_config("vertical_mixing:diffusivitymodel") == "environment"
    assert mixing.visser_mixing_oil.launches == 10
    assert mixing.visser_mixing.launches == 0
    checks = check_oil_result(o, n, 2)
    log("oil_path", model="environment", elements=n, steps=10, run_s=secs,
        launches=mixing.visser_mixing_oil.launches, **checks)
    return launches, stats


# ------------------------------------------ the satellite-seeded oil -----

SLICK_PIXEL_M = 50.0             # the slick raster's pixels, about 50 m
SLICK_SHAPE = (1000, 1000)       # pixels: 50 x 50 km around the release
SLICK_SEMI_AXES_PX = (220.0, 110.0)   # the slick: 22 x 11 km, within 7.3
                                      # km of its centre eastward
SLICK_THICKNESS_UM = (0.04, 0.44, 4.4, 16.0)   # categories 1-4
SLICK_OIL_DENSITY = 1000.0       # kg/m3, as the GeoTIFF seeder takes it
SEEDED_MASS_RTOL = 1e-6
GML_SLICK_RADIUS_M = 6000.0
GML_SLICKS = 3
GML_COUNT_RTOL = 0.05


def write_slick_files(directory, forcing_kw=None):
    """A categorical slick GeoTIFF (uint8 categories 0-4, LZW, 1000 x 1000
    pixels of about 50 m) and a KSAT-style GML of a few slick polygons,
    both centred where :func:`oil_simulation` releases its oil, written by
    ``opendrift_tpu_torch/tools/synthetic_tiff.py``; returns
    {'tif': path, 'gml': path, 'tif_mb': size}."""
    from opendrift_tpu_torch.tools import synthetic_tiff as st
    _, _, _, x, y, _, times = oil_forcing(**(forcing_kw or {}))
    lon_c, lat_c = oil_release_point(x, y)
    dlon, dlat = st.pixel_degrees(SLICK_PIXEL_M, lat_c)
    ny, nx = SLICK_SHAPE
    cat = st.slick_categories(SLICK_SHAPE, semi_axes_px=SLICK_SEMI_AXES_PX)
    tif = os.path.join(directory, "slick_thickness.tif")
    size = st.write_geotiff(tif, cat, lon_c - nx / 2 * dlon,
                            lat_c + ny / 2 * dlat, dlon, dlat,
                            compression="lzw")
    gml = st.write_gml(os.path.join(directory, "slicks.gml"),
                       st.slick_polygons(lon_c, lat_c, GML_SLICK_RADIUS_M,
                                         count=GML_SLICKS), times[0])
    return {"tif": tif, "gml": gml, "tif_mb": size / 1e6}


def slick_expectation(tif, number):
    """The JAX package's formula for a GeoTIFF's seeding: each category's
    element count round(number x area x thickness / sum) and the seeded
    mass sum(area x thickness) x 1000 kg/m3."""
    from opendrift_tpu_torch.utils.geotiff import read_geotiff
    data, (lon0, dlon, lat0, dlat) = read_geotiff(tif)
    rows = lat0 + dlat * (np.arange(data.shape[0]) + 0.5)
    area = (abs(dlon) * 111320.0 * np.cos(np.radians(rows))[:, None]
            * abs(dlat) * 110540.0)
    areas = np.array([(area * (data == c)).sum() for c in (1, 2, 3, 4)])
    weighted = areas * np.array(SLICK_THICKNESS_UM)
    counts = np.round(number * weighted / weighted.sum()).astype(int)
    return counts, float(weighted.sum() * 1e-6 * SLICK_OIL_DENSITY)


def geotiff_simulation(device, n, tif, forcing_kw=None, seed=0):
    """OpenOil (:func:`oil_model`, windspeed_Large1994) seeded from the
    slick GeoTIFF: ``n`` elements of GENERIC MEDIUM CRUDE at the surface,
    as a spill responder seeds from a satellite thickness map.  Returns
    (simulation, seconds of the seeding)."""
    import torch
    o, _, _, times = oil_model(device, "windspeed_Large1994", seed,
                               forcing_kw)
    t = time.perf_counter()
    o.seed_from_geotiff_thickness(tif, number=n, time=times[0],
                                  oil_type="GENERIC MEDIUM CRUDE", z=0.0)
    if device == "cuda":
        torch.cuda.synchronize()
    return o, time.perf_counter() - t


def check_slick_seeding(o, tif, n):
    """Each category's count and the seeded mass against the JAX package's
    formula; returns (elements seeded, the numbers logged)."""
    counts, mass = slick_expectation(tif, n)
    got = [len(s["lon"]) for s in o._seedings]
    assert got == [int(c) for c in counts if c], (got, counts)
    seeded = sum(float(np.sum(s["mass_oil"], dtype=np.float64))
                 for s in o._seedings)
    assert abs(seeded - mass) <= SEEDED_MASS_RTOL * mass, (seeded, mass)
    return sum(got), {"category_counts": got, "slick_mass_kg": mass,
                      "seeded_mass_rel_err": abs(seeded - mass) / mass}


def points_outside_slicks(lon, lat, gml):
    """Check that every seeded position (float32, as the elements hold
    them) lies inside a slick polygon of ``gml`` by ``points_in_ring``, or
    is one float32 step from a position inside (the seeder chose it in
    float64, inside); returns how many needed that step."""
    from xml.etree import ElementTree
    from opendrift_tpu_torch.utils.shapefile import points_in_ring
    rings = []
    for pos in ElementTree.parse(gml).iter(
            "{http://www.opengis.net/gml}posList"):
        c = np.array(pos.text.split(), dtype=float)
        rings.append(np.column_stack([c[0::2], c[1::2]]))

    def inside(x, y):
        hit = np.zeros(len(x), bool)
        for ring in rings:
            hit |= points_in_ring(x, y, ring)
        return hit
    lon = np.asarray(lon, np.float32)
    lat = np.asarray(lat, np.float32)
    out = ~inside(lon, lat)
    x, y = lon[out], lat[out]
    near = np.zeros(len(x), bool)
    for dx in (-np.inf, None, np.inf):
        for dy in (-np.inf, None, np.inf):
            nx = x if dx is None else np.nextafter(x, np.float32(dx))
            ny = y if dy is None else np.nextafter(y, np.float32(dy))
            near |= inside(nx, ny)
    assert near.all(), f"{int((~near).sum())} points outside every slick"
    return int(out.sum())


def run_geotiff(o, intervals, **kw):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=900 * 10 * intervals), time_step=900,
          time_step_output=9000, export_variables=OIL_EXPORT, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def geotiff_oil_path(workdir, n=2_000_000):
    """The GeoTIFF-seeded OpenOil run at 2M elements (three intervals after
    one untimed), its profiled run from ``general:profile_dir`` and the
    GML-seeded run; returns (the oil kernel's launches in the timed run,
    its numbers, the GML run's launches)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.utils.geotiff import read_geotiff
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    t = time.perf_counter()
    files = write_slick_files(workdir)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    read_geotiff(files["tif"])
    read_s = time.perf_counter() - t
    # one untimed interval: the first OpenOil run of this seeding
    o, _ = geotiff_simulation("cuda", n, files["tif"])
    run_geotiff(o, 1)
    del o
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    o, seed_s = geotiff_simulation("cuda", n, files["tif"])
    seeded, seeding = check_slick_seeding(o, files["tif"], n)
    secs = run_geotiff(o, 3)
    launches = mixing.visser_mixing_oil.launches
    steps = 30
    assert launches == steps, f"{launches} oil kernel launches in {steps}"
    assert mixing.visser_mixing.launches == 0, "the run launched K1"
    assert mixing.visser_mixing_profile.launches == 0, "the run launched K2"
    assert len(o.memory_usage) == 3, o.memory_usage
    checks = check_oil_result(o, seeded, 4)
    readers_s = o.timers.get("main loop:readers", 0.0)
    loop_s = o.timers["main loop"]
    stats = {"elements": seeded, "steps": steps, "run_s": secs,
             "preparing_s": o.timers.get("preparing main loop", 0.0),
             "main_loop_s": loop_s, "readers_s": readers_s,
             "particle_steps_per_s": seeded * steps / secs,
             "particle_steps_per_s_steps_only":
                 seeded * steps / (loop_s - readers_s)}
    log("geotiff_oil_path", tif_mb=files["tif_mb"], write_files_s=write_s,
        tiff_read_s=read_s, seeding_s=seed_s, **seeding, launches=launches,
        windspeed_launches=mixing.visser_mixing.launches,
        host_peak_rss_mb=o.memory_usage,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **checks,
        **stats)
    del o
    # the run diagnostics: one untimed interval traced by torch.profiler
    trace_dir = os.path.join(workdir, "trace")
    o, _ = geotiff_simulation("cuda", n, files["tif"])
    o.set_config("general:profile_dir", trace_dir)
    profiled_s = run_geotiff(o, 1)
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1, traces
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    k3 = [e for e in events if "visser_mixing_oil_kernel" in
          str(e.get("name", "")) and str(e.get("cat", "")).lower()
          == "kernel"]
    assert len(k3) == 10, f"{len(k3)} oil kernels in the trace"
    assert len(o.memory_usage) == 1, o.memory_usage
    log("geotiff_profile_dir", run_s=profiled_s, trace_file=traces[0],
        trace_mb=os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6,
        trace_events=len(events), oil_kernel_events=len(k3),
        oil_kernel_name=k3[0]["name"][:120],
        oil_kernel_device_ms=sum(e.get("dur", 0) for e in k3) / 1e3 / 10,
        memory_usage_mb=o.memory_usage)
    del o, events
    # the GML-seeded run: one interval
    for k in kernels:
        k.launches = 0
    o, _, _, times = oil_model("cuda", "windspeed_Large1994")
    t = time.perf_counter()
    o.seed_from_gml(files["gml"], num_elements=n,
                    oil_type="GENERIC MEDIUM CRUDE", z=0.0)
    gml_seed_s = time.perf_counter() - t
    lon, lat = o._seedings[-1]["lon"], o._seedings[-1]["lat"]
    count = len(lon)
    assert abs(count - n) <= GML_COUNT_RTOL * n, count
    edge = points_outside_slicks(lon, lat, files["gml"])
    secs = run_geotiff(o, 1)
    gml_launches = mixing.visser_mixing_oil.launches
    assert gml_launches == 10, gml_launches
    assert mixing.visser_mixing.launches == 0
    checks = check_oil_result(o, count, 2, must_have=("evaporated_share",))
    log("gml_oil_path", elements=count, seeding_s=gml_seed_s,
        outside_by_float32_rounding=edge,
        detection_time=str(o._seedings[-1]["time"][0]), run_s=secs,
        launches=gml_launches, **checks)
    return launches, stats, gml_launches


def geotiff_card_against_cpu(workdir, n=4096, intervals=2):
    """The GeoTIFF-seeded OpenOil configuration, small, on the card and on
    the CPU from one seed: the same seeds, every status equal, the
    positions within the slice tolerance."""
    small = dict(nx=60, ny=60, nz=16, nt=5)
    directory = os.path.join(workdir, "slick_small")
    os.makedirs(directory, exist_ok=True)
    tif = write_slick_files(directory, small)["tif"]
    out, seeds = {}, {}
    for device in ("cuda", "cpu"):
        o, _ = geotiff_simulation(device, n, tif, forcing_kw=small)
        seeds[device] = np.concatenate([s["lon"] for s in o._seedings])
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000, export_variables=OIL_EXPORT)
        out[device] = final_frame(o)
    assert np.array_equal(seeds["cuda"], seeds["cpu"])
    status_diff, errs = hold_against(
        "geotiff card", out["cuda"], out["cpu"], SLICE_MEDIAN_ATOL,
        SLICE_OUTLIER_ATOL, SLICE_OUTLIER_SHARE, 0.0)
    log("geotiff_card_vs_cpu", elements=len(seeds["cpu"]),
        intervals=intervals, status_diff_share=status_diff,
        max_abs_err=errs)
    return errs


# ------------------------------------------------------------- scripts ----

GUI_N = 100_000


def scripts_phase(files):
    """``python -m opendrift_tpu_torch.scripts.readerinfo`` on the NetCDF
    path's ocean file (on the card, as by default), and the GUI's
    controller running OceanDrift on that file at 100,000 elements on
    ``cuda``; neither imports matplotlib."""
    import torch
    from opendrift_tpu_torch.scripts.gui import GuiController
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "opendrift_tpu_torch.scripts.readerinfo",
         files["norkyst"]], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    readerinfo_s = time.perf_counter() - t
    assert out.returncode == 0, out.stderr[-2000:]
    assert "x_sea_water_velocity" in out.stdout, out.stdout[-1000:]
    ctl = GuiController()
    assert ctl.device.type == "cuda"
    ctl.select_model("OceanDrift")
    reader = ctl.add_forcing(files["norkyst"])
    logs = []
    t = time.perf_counter()
    o = ctl.run(lon=12.55, lat=67.9, radius=2000.0, number=GUI_N,
                start_time=reader.times[0], duration_hours=2.0,
                time_step=900, log=logs.append)
    torch.cuda.synchronize()
    gui_s = time.perf_counter() - t
    lon = np.asarray(o.result["lon"].values)
    status = np.asarray(o.result["status"].values)
    assert lon.shape == (GUI_N, 9), lon.shape
    assert np.isfinite(lon[status == 0]).all()
    assert any("finished" in m for m in logs), logs
    assert o.state.data["lon"].device.type == "cuda"
    assert "matplotlib" not in sys.modules
    log("scripts", readerinfo_s=readerinfo_s,
        readerinfo_lines=len(out.stdout.splitlines()),
        gui_elements=GUI_N, gui_run_s=gui_s,
        gui_active_share=float((status[:, -1] == 0).mean()),
        matplotlib_loaded=False)


# ------------------------------------------------- the sampler path -------

UV = ("x_sea_water_velocity", "y_sea_water_velocity")


def refine_x(a, factor, nearest=False):
    """``a`` (..., nx) on a grid ``factor`` times finer in x: linear between
    the nodes (so that a bilinear sample of the fine grid equals one of the
    coarse grid, but for rounding), or the nearest node's value for a mask
    (no ties for an odd factor)."""
    if factor == 1:
        return a
    nx = a.shape[-1]
    pos = np.arange(factor * (nx - 1) + 1, dtype=np.float64) / factor
    if nearest:
        return a[..., np.round(pos).astype(np.int64)]
    i0 = np.minimum(np.floor(pos).astype(np.int64), nx - 2)
    w = (pos - i0).astype(np.float32)
    return a[..., i0] * (np.float32(1.0) - w) + a[..., i0 + 1] * w


def sampler_forcing(refine=1, **kw):
    """The ocean of :func:`oil_forcing` as the sampler path reads it: 3D
    currents, a 3D ``ocean_vertical_diffusivity`` that falls with depth,
    the seafloor and the coast in one reader (11 columns a cell with three
    frames a window: the 200 x 200 x 16 grid takes the 'xyz' tier), and the
    wind.  ``refine``: an odd factor by which the ocean's grid is refined
    in x, the field staying the same."""
    current, wind, _, x, y, depths, times = oil_forcing(**kw)
    nt, nz, ny, nx = current["x_sea_water_velocity"].shape
    X, Y = np.meshgrid(np.linspace(0, 2 * np.pi, nx),
                       np.linspace(0, 2 * np.pi, ny))
    K = (1e-2 * np.exp(-depths / 20.0)[None, :, None, None]
         * (1.0 + 0.5 * np.sin(X + 0.3 * np.arange(nt)[:, None, None, None])
            * np.cos(Y)))
    ocean = {"x_sea_water_velocity": current["x_sea_water_velocity"],
             "y_sea_water_velocity": current["y_sea_water_velocity"],
             "ocean_vertical_diffusivity": K.astype(np.float32),
             "sea_floor_depth_below_sea_level":
                 current["sea_floor_depth_below_sea_level"],
             "land_binary_mask": current["land_binary_mask"]}
    ocean = {k: refine_x(v, refine, nearest=k == "land_binary_mask")
             for k, v in ocean.items()}
    x_ocean = np.linspace(x[0], x[-1], refine * (nx - 1) + 1)
    return ocean, wind, x_ocean, x, y, depths, times


def sampler_simulation(device, n, single_fetch=True, packed_dtype=None,
                       refine=1, seed=0, forcing_kw=None):
    """An OceanDrift run of ``n`` elements over :func:`sampler_forcing`, as
    a user of a 3D ocean model with its own diffusivity sets it up: RK4 on
    one corner block a step, the coast's bisection on the same block,
    'environment' mixing on reader-served profiles (26 levels to 50 m, the
    defaults), dt = 900 s with 60 s substeps, elements seeded over the top
    20 m from mid-basin to the coast.  Every seed lies in the ocean, so the
    relocation of land seeds is switched off."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader
    ocean, wind, x_ocean, x, y, depths, times = sampler_forcing(
        refine, **(forcing_kw or {}))
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    reader = ArrayReader(ocean, x_ocean, y, times, depths=depths,
                         name="ocean")
    if packed_dtype is not None:
        reader.packed_dtype = packed_dtype
    o.add_reader(reader)
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:advection_single_fetch", single_fetch)
    o.set_config("general:coastline_bisection", "block")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "environment")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    o.set_config("seed:ocean_only", False)
    nx = len(x)
    coast = nx - max(2, COAST_CELLS * nx // 200)
    r = np.random.default_rng(seed + 1)
    lon1 = float(x[coast] - 0.6 * (x[1] - x[0]))   # the last ocean half-cell
    o.seed_elements(lon=r.uniform(float(x[nx // 2]), lon1, n),
                    lat=r.uniform(float(y[len(y) // 4]),
                                  float(y[3 * len(y) // 4]), n),
                    z=-r.uniform(0.0, 20.0, n), time=times[0])
    return o


def run_sampler(o, intervals):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
          time_step_output=9000,
          export_variables=["lon", "lat", "z", "status"])
    torch.cuda.synchronize()
    return time.perf_counter() - t


def check_sampler_result(o, n, frames):
    """Shapes, no NaN where an element is valid, nothing above the surface;
    returns the stranded and active shares."""
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    status = np.asarray(o.result["status"].values)
    assert status.shape == (n, frames), status.shape
    valid = valid_mask(status, 0)
    for var in ("lon", "lat", "z"):
        vals = np.asarray(o.result[var].values)
        assert np.isfinite(vals[valid]).all(), f"non-finite {var}"
    assert float(np.nanmax(np.asarray(o.result["z"].values))) <= 0.0
    stranded = o.status_categories.index("stranded")
    return {"stranded_share": float((status[:, -1] == stranded).mean()),
            "active_share": float((status[:, -1] == 0).mean())}


def run_stats(o, n, steps, secs):
    readers_s = o.timers.get("main loop:readers", 0.0)
    loop_s = o.timers["main loop"]
    return {"elements": n, "steps": steps, "run_s": secs,
            "preparing_s": o.timers.get("preparing main loop", 0.0),
            "main_loop_s": loop_s, "readers_s": readers_s,
            "reader_share_of_loop": readers_s / loop_s,
            "particle_steps_per_s": n * steps / secs,
            "particle_steps_per_s_steps_only":
                n * steps / (loop_s - readers_s)}


def count_row_gathers(o, steps=4):
    """Row gathers of one short interval of ``o`` by table width, per
    step: the sampler's ``take_rows`` is wrapped for the count and put
    back."""
    from opendrift_tpu_torch.fields import grid
    from opendrift_tpu_torch.ops import interp
    calls = {}
    real = interp.take_rows

    def counted(packed, lin):
        width = int(packed.shape[-1])
        calls[width] = calls.get(width, 0) + 1
        return real(packed, lin)
    advance, _, state, key = o.prepare_run(900.0, steps, total_steps=steps)
    dev_states = o.env.build_device_states()
    interp.take_rows = grid.take_rows = counted
    try:
        advance(state, dev_states, np.float32(0.0), key)
    finally:
        interp.take_rows = grid.take_rows = real
    return {width: count / steps for width, count in sorted(calls.items())}


def time_get_profiles(o):
    """Milliseconds of one ``get_profiles`` call at the run's final
    positions (CUDA events)."""
    from opendrift_tpu_torch.tools.kernel_check import cuda_ms
    dev_states = o.env.build_device_states()
    d = o.state.data
    zlevels = o._profile_zlevels()
    return cuda_ms(lambda: o.env.get_profiles(
        dev_states, o.env.required_profiles, np.float32(0.0), d["lon"],
        d["lat"], zlevels), warmup=1, reps=5), len(zlevels)


def sampler_path(n=2_000_000, intervals=3):
    """The sampler path at full width; returns (the simulation, launches
    of the profile kernel, the run's numbers)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    o = sampler_simulation("cuda", n)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = run_sampler(o, intervals)
    launches = mixing.visser_mixing_profile.launches
    steps = 10 * intervals
    assert launches == steps, f"{launches} K2 launches in {steps} steps"
    assert mixing.visser_mixing.launches == 0, "the sampler path launched K1"
    checks = check_sampler_result(o, n, intervals + 1)
    assert checks["stranded_share"] > 0.0, "nothing stranded"
    tiers = {name: r._sampler.pair_mode for name, r in o.env.readers.items()}
    assert tiers == {"ocean": "xyz", "wind": "xy"}, tiers
    assert o.env.uv_block_plan_index() == 0
    stats = run_stats(o, n, steps, secs)
    env = o.env
    hidden = env.prefetched_pack_seconds - env.join_wait_seconds
    log("sampler_path", tiers=tiers, launches=launches,
        windspeed_launches=mixing.visser_mixing.launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        pack_s=env.pack_seconds,
        prefetched_pack_s=env.prefetched_pack_seconds,
        join_wait_s=env.join_wait_seconds,
        packing_hidden_share=hidden / env.pack_seconds, **checks, **stats)
    # one corner block a step: row gathers per step by table width, against
    # the same configuration with a refetch at every RK stage
    small = 200_000
    single = count_row_gathers(sampler_simulation("cuda", small))
    multi = count_row_gathers(sampler_simulation("cuda", small,
                                                 single_fetch=False))
    levels = PROFILE_LEVELS
    log("row_gathers_per_step", single_fetch=single, multi_fetch=multi,
        profile_levels=levels, widths={"ocean": 88, "ocean_uv": 48,
                                       "wind": 24})
    assert single == {24: 1.0, 88: 1.0 + levels}, single
    assert multi[48] == 3.0 and multi[24] == 1.0 \
        and multi[88] >= 1.0 + levels, multi
    profile_interval(o, phase="sampler_profile")
    ms, levels = time_get_profiles(o)
    step_ms = (stats["main_loop_s"] - stats["readers_s"]) / steps * 1e3
    log("get_profiles", ms=ms, levels=levels, step_ms=step_ms,
        share_of_step=ms / step_ms)
    return o, launches, stats


def prefetch_ab(n=2_000_000, intervals=2):
    """The OceanDrift main path with the next window packed on the worker
    thread and with every window packed by the main thread, in turns (with,
    without, without, with): what the thread does to the whole run and to
    the steps, whose kernel launches share the interpreter with it.  Two
    intervals (one window prefetched), not the main path's three, to keep
    the script's time as the coast path joined it."""
    import torch
    rows = []
    for threaded in (True, False, False, True):
        o = simulation("cuda", n, "windspeed_Large1994", hdiff=10.0)
        if not threaded:
            o.env.prefetch_device_states = lambda start, end: None
        torch.cuda.synchronize()
        t = time.perf_counter()
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000,
              export_variables=["lon", "lat", "z", "status"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        rows.append(dict(prefetch_thread=threaded,
                         pack_s=o.env.pack_seconds,
                         prefetched_pack_s=o.env.prefetched_pack_seconds,
                         join_wait_s=o.env.join_wait_seconds,
                         **run_stats(o, n, 10 * intervals, secs)))
        del o
    log("prefetch_ab", runs=rows)
    return rows


# ------------------------------------------------- the coast path ---------

# Lofoten and Vestfjorden, 12-16 E x 67-69 N: the bundled coastline raster
# covers it (about a third of it land).  The seeds fill a sea polygon west of the
# Lofoten wall, COAST_OCEAN_SHARE or more of it ocean by the raster, and a
# mean eastward current carries them onto the wall within the run.
COAST_WKT = ("POLYGON ((12.30 67.80, 12.85 67.80, 12.85 68.00, "
             "12.30 68.00, 12.30 67.80))")
COAST_OCEAN_SHARE = 0.9
COAST_MEAN_U = 0.3                 # m/s, eastward
COAST_STRANDED = (0.05, 0.95)      # the stranded share the path must reach


def coast_forcing(nx=200, ny=200, **kw):
    """The ocean of :func:`forcing` moved to Lofoten: the same 4 x 2
    degrees at any ``nx`` x ``ny`` (0.02 x 0.01 degrees at 200 x 200), a
    mean eastward current of COAST_MEAN_U on top of its own, and the
    currents NaN on every cell the bundled raster marks as land, so that
    each window's frames go through the host NaN fill."""
    from opendrift_tpu_torch.fields import GlobalLandmask
    current, wind, x, y, depths, times = forcing(
        nx=nx, ny=ny, lon0=12.0, lat0=67.0, dlon=0.02 * 199 / (nx - 1),
        dlat=0.01 * 199 / (ny - 1), **kw)
    X, Y = np.meshgrid(x, y)
    land = GlobalLandmask().contains(X, Y)
    for v, mean in zip(UV, (COAST_MEAN_U, 0.0)):
        a = current[v] + np.float32(mean)
        a[:, :, land] = np.nan
        current[v] = a
    return current, wind, x, y, depths, times


def coast_ocean_share():
    """The share of COAST_WKT's area that the bundled raster calls ocean
    (on a 0.002-degree lattice)."""
    from opendrift_tpu_torch.fields import GlobalLandmask
    from opendrift_tpu_torch.utils.shapefile import points_in_ring
    ring = np.array([[float(v) for v in pair.split()] for pair in
                     COAST_WKT.split("((")[1].rstrip(")").split(",")])
    X, Y = np.meshgrid(np.arange(ring[:, 0].min(), ring[:, 0].max(), 0.002),
                       np.arange(ring[:, 1].min(), ring[:, 1].max(), 0.002))
    inside = points_in_ring(X, Y, ring)
    return float(1.0 - GlobalLandmask().contains(X[inside], Y[inside])
                 .mean())


def coast_simulation(device, n, seed=0, forcing_kw=None):
    """A default OceanDrift run of ``n`` elements on the Lofoten ocean, set
    up as a user would, with no landmask setting: the automatic landmask
    (the bundled raster) strands them.  RK4, Visser mixing with
    windspeed_Large1994, horizontal diffusivity 10 m2/s, dt = 900 s with
    60 s substeps, seeded by ``seed_from_wkt`` over the top 20 m."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader
    current, wind, x, y, depths, times = coast_forcing(**(forcing_kw or {}))
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                             name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(seed + 1)
    o.seed_from_wkt(COAST_WKT, time=times[0], number=n,
                    z=-r.uniform(0.0, 20.0, n))
    return o


def check_coast_result(o, n, frames):
    """The coast path's own checks: no NaN where an element is valid, the
    stranded share within COAST_STRANDED, and at every output no active
    element on land by the landmask's own ``sample`` on the run's device.
    Returns the shares."""
    import torch
    shares = check_sampler_result(o, n, frames)
    lo, hi = COAST_STRANDED
    if not lo <= shares["stranded_share"] <= hi:
        raise AssertionError(f"{shares['stranded_share']} of the elements "
                             f"stranded, outside [{lo}, {hi}]")
    lm = o.env.readers["global_landmask"]
    state = lm.device_state()
    status = np.asarray(o.result["status"].values)
    on_land = 0
    for k in range(frames):
        act = status[:, k] == 0
        lon, lat = (torch.as_tensor(np.asarray(o.result[v].values)[act, k],
                                    device=o.device) for v in ("lon", "lat"))
        vals, covers = lm.sample(state, ["land_binary_mask"], 0.0, lon, lat,
                                 None)
        on_land += int(((vals["land_binary_mask"] > 0.5) | ~covers).sum())
    if on_land:
        raise AssertionError(f"{on_land} active elements on land")
    return shares


def fill_seconds(reader):
    """Seconds of the host scrub and NaN fill (``_scrub_frame``) of one
    window's frames of ``reader``, every variable it packs, through the
    native fill and through the scipy fallback, in turns (native, scipy,
    scipy, native)."""
    from opendrift_tpu_torch.utils import native
    tidx = reader._frame_indices(None, None)
    frames = [(v, ti) for v in reader._group3 + reader._group2
              for ti in tidx] + [(v, 0) for v in reader._groups]
    raw = [(v, np.asarray(reader._read_frame(v, ti, slice(None), reader._iy,
                                             reader._ix), np.float32))
           for v, ti in frames]
    real = native.get_lib
    out = {"native": [], "scipy": []}
    for route in ("native", "scipy", "scipy", "native"):
        if route == "scipy":
            native.get_lib = lambda: None
        try:
            t = time.perf_counter()
            for v, a in raw:
                reader._scrub_frame(v, a)
            out[route].append(time.perf_counter() - t)
        finally:
            native.get_lib = real
    return {"frames": len(raw), "native_s": out["native"],
            "scipy_s": out["scipy"]}


def coast_path(n=2_000_000, intervals=3):
    """The coast path at full width: one untimed interval, then the timed
    run; returns (launches of the windspeed kernel, the run's numbers)."""
    import torch
    from opendrift_tpu_torch.fields import GlobalLandmask
    from opendrift_tpu_torch.ops import interp, mixing
    route = interp.fill_route()
    log("fill_route", route=route)
    if route != "native":
        raise AssertionError(f"the host NaN fill took the {route!r} route")
    share = coast_ocean_share()
    if share < COAST_OCEAN_SHARE:
        raise AssertionError(f"the seed polygon is {share} ocean")
    o = coast_simulation("cuda", n)
    run_sampler(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    o = coast_simulation("cuda", n)
    for k in kernels:
        k.launches = 0
    samples = []
    real = GlobalLandmask.sample

    def counted(self, *args, **kw):
        samples.append(1)
        return real(self, *args, **kw)
    torch.cuda.reset_peak_memory_stats()
    GlobalLandmask.sample = counted
    try:
        secs = run_sampler(o, intervals)
    finally:
        GlobalLandmask.sample = real
    launches = mixing.visser_mixing.launches
    steps = 10 * intervals
    assert launches == steps, f"{launches} K1 launches in {steps} steps"
    assert mixing.visser_mixing_oil.launches == 0
    assert mixing.visser_mixing_profile.launches == 0
    assert [r.name for r, _ in o.env._plan][-1] == "global_landmask"
    checks = check_coast_result(o, n, intervals + 1)
    # one mask sample in each pre-update (every step and the final
    # snapshot), three more on a step where something strands
    fetches = steps + 1
    stats = run_stats(o, n, steps, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    log("coast_path", fill_route=route, seed_polygon_ocean_share=share,
        launches=launches, landmask_samples=len(samples),
        landmask_samples_per_step=len(samples) / fetches,
        bisection_steps=(len(samples) - fetches) / 3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        fill=fill_seconds(o.env.readers["ocean"]), **checks, **stats)
    profile_interval(o, phase="coast_profile")
    return launches, stats


def coast_card_against_cpu(n=4096, intervals=2):
    """The coast path's configuration, small, on the card and on the CPU
    from one seed: every status equal at every output, lon/lat/z within
    the slice tolerance."""
    out = {}
    small = dict(nx=60, ny=60)
    for device in ("cuda", "cpu"):
        o = coast_simulation(device, n, forcing_kw=small)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000)
        out[device] = o.result
    status = [np.asarray(out[d]["status"].values) for d in ("cuda", "cpu")]
    if not np.array_equal(*status):
        raise AssertionError(f"card and CPU disagree on "
                             f"{int((status[0] != status[1]).sum())} "
                             f"statuses")
    errs = {}
    for var in ("lon", "lat", "z"):
        err, ok = agree(out["cuda"][var].values, out["cpu"][var].values,
                        SLICE_MEDIAN_ATOL[var], SLICE_OUTLIER_ATOL[var],
                        SLICE_OUTLIER_SHARE)
        errs[var] = err
        if not ok:
            raise AssertionError(f"card and CPU disagree on {var}: {err}")
    stranded = float((status[1][:, -1]
                      == o.status_categories.index("stranded")).mean())
    log("coast_card_vs_cpu", elements=n, intervals=intervals,
        stranded_share=stranded, max_abs_err=errs)
    return errs


# ------------------------------------------ the NetCDF and ROMS paths -----

# The files of these paths, written when the script starts (write_files):
# a NorKyst800-like ocean (polar stereographic, 260 x 300 cells of 800 m
# over Lofoten and Vestfjorden, the 16 NorKyst depths, int16-packed u, v,
# temperature and salinity with fills on the raster's land cells), an
# AROME-like wind (Lambert conformal, 160 x 140 cells of 2.5 km) and a
# Nordic-4km-like ROMS file (a 200 x 160 curvilinear C-grid, 32 sigma
# levels, AKs on the w levels).  Hourly frames for NorKyst and AROME and
# 3-hourly for ROMS, 0 to 8 h and 0 to 12 h: the timed run spans 7.5 h.
NORKYST_SHAPE = dict(nx=260, ny=300, nz=16, nt=9)
AROME_SHAPE = dict(nx=160, ny=140, nt=9)
ROMS_SHAPE = dict(nxi=200, neta=160, ns=32, nt=5)


def write_files(directory, small=False):
    """The three forcing files, at the products' widths or (``small``, for
    the card-against-CPU phases) over the same areas on coarser grids;
    returns {name: path}."""
    from opendrift_tpu_torch.tools import synthetic_nc as nc
    import os
    norkyst, arome, roms = NORKYST_SHAPE, AROME_SHAPE, ROMS_SHAPE
    if small:
        norkyst = dict(nx=60, ny=70, nz=8, nt=9, dx=3000.0)
        arome = dict(nx=40, ny=40, nt=9, dx=8000.0)
        roms = dict(nxi=50, neta=40, ns=8, nt=5, dx=16000.0)
    return {"norkyst": nc.write_norkyst(os.path.join(directory, "norkyst.nc"),
                                        **norkyst),
            "arome": nc.write_arome(os.path.join(directory, "arome.nc"),
                                    **arome),
            "roms": nc.write_roms(os.path.join(directory, "roms.nc"), **roms)}


def netcdf_simulation(device, n, files, seed=0):
    """A default OceanDrift run of ``n`` elements on the NorKyst-like ocean
    and the AROME-like wind, read from the files as a user would, with no
    landmask setting (the ocean file's fill cells give its landmask): RK4,
    Visser mixing with windspeed_Large1994 on the file's wind, horizontal
    diffusivity 10 m2/s, dt = 900 s with 60 s substeps, seeded by
    ``seed_from_wkt`` west of the Lofoten wall over the top 20 m.  Returns
    (simulation, seconds to build the readers)."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields import NetCDFReader
    t = time.perf_counter()
    ocean = NetCDFReader(files["norkyst"], name="norkyst")
    wind = NetCDFReader(files["arome"], name="arome")
    build_s = time.perf_counter() - t
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    o.add_reader([ocean, wind])
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(seed + 1)
    o.seed_from_wkt(COAST_WKT, time=ocean.times[0], number=n,
                    z=-r.uniform(0.0, 20.0, n))
    return o, build_s


def roms_simulation(device, n, files, sampling="native", seed=0):
    """A default OceanDrift run of ``n`` elements on the Nordic-like ROMS
    file (its mask_rho the landmask): RK4, 'environment' mixing on the
    file's AKs profiles, horizontal diffusivity 10 m2/s, dt = 900 s with
    60 s substeps, seeded as :func:`netcdf_simulation`.  Returns
    (simulation, seconds to build the reader)."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields import ROMSReader
    t = time.perf_counter()
    reader = ROMSReader(files["roms"], sampling=sampling, name="nordic")
    build_s = time.perf_counter() - t
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    o.add_reader(reader)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "environment")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(seed + 1)
    o.seed_from_wkt(COAST_WKT, time=reader.times[0], number=n,
                    z=-r.uniform(0.0, 20.0, n))
    return o, build_s


def decode_seconds(reader):
    """Seconds of the CF decode (``cf_unpack``) of one window's int16
    frames of ``reader``'s packed variables, through the native
    ``decode_i16`` and through the numpy fallback, in turns (native,
    numpy, numpy, native)."""
    from opendrift_tpu_torch.utils import native, ncio
    tidx = reader._frame_indices(None, None)
    raw = []
    for v in reader._group3 + reader._group2:
        vname = reader._sources[v][0]
        for ti in tidx:
            var = reader._files[reader._file_of_frame[ti]].variables[vname]
            if var.dtype == np.int16:
                raw.append((var, var[reader._index_in_file[ti]]))
    real = native.get_lib
    out = {"native": [], "numpy": []}
    for route in ("native", "numpy", "numpy", "native"):
        if route == "numpy":
            native.get_lib = lambda: None
        try:
            t = time.perf_counter()
            for var, a in raw:
                ncio.cf_unpack(var, a)
            out[route].append(time.perf_counter() - t)
        finally:
            native.get_lib = real
    return {"frames": len(raw), "values": int(sum(a.size for _, a in raw)),
            "native_s": out["native"], "numpy_s": out["numpy"]}


def grid_index_ms(reader, o):
    """Milliseconds of one ``_grid_indices`` call (the projection or the
    curvilinear index map, then the division into cells) at the run's
    element positions on the card, by CUDA events (median)."""
    import torch
    lon, lat = o.state.data["lon"], o.state.data["lat"]
    reader._grid_indices(lon, lat)
    times = []
    for _ in range(NTIMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        reader._grid_indices(lon, lat)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def file_path(name, simulation, kernel, files, n=2_000_000, intervals=3,
              fill=True):
    """A file-forcing path at full width: one untimed interval, then the
    timed run.  ``kernel`` is the mixing kernel the path must launch once a
    step (and no other); ``fill``: time the host NaN fill of a window too.
    Returns (its launches, the run's numbers)."""
    import torch
    from opendrift_tpu_torch.fields.grid import StructuredGridReader
    from opendrift_tpu_torch.ops import mixing
    from opendrift_tpu_torch.utils import native
    route = native.decode_route()
    log(f"{name}_decode_route", route=route)
    if route != "native":
        raise AssertionError(f"the int16 decode took the {route!r} route")
    parts = {}
    t = time.perf_counter()
    o, _ = simulation("cuda", n, files)
    run_sampler(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    parts["untimed_s"] = time.perf_counter() - t
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    t = time.perf_counter()
    o, build_s = simulation("cuda", n, files)
    parts["setup_s"] = time.perf_counter() - t
    for k in kernels:
        k.launches = 0
    calls = []
    real = StructuredGridReader._grid_indices

    def counted(self, *args, **kw):
        calls.append(type(self).__name__)
        return real(self, *args, **kw)
    torch.cuda.reset_peak_memory_stats()
    StructuredGridReader._grid_indices = counted
    try:
        secs = run_sampler(o, intervals)
    finally:
        StructuredGridReader._grid_indices = real
    launches = kernel.launches
    steps = 10 * intervals
    assert launches == steps, f"{launches} launches of {kernel.__name__} " \
        f"in {steps} steps"
    for k in kernels:
        if k is not kernel:
            assert k.launches == 0, f"{name} launched {k.__name__}"
    checks = check_sampler_result(o, n, intervals + 1)
    stats = run_stats(o, n, steps, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    stats["reader_build_s"] = build_s
    readers = [r for r, _ in o.env._plan]
    step_ms = (stats["main_loop_s"] - stats["readers_s"]) / steps * 1e3
    index = {r.name: {"ms": grid_index_ms(r, o),
                      "calls_per_step": calls.count(type(r).__name__)
                      / len(readers) / (steps + 1)}
             for r in readers if isinstance(r, StructuredGridReader)}
    t = time.perf_counter()
    host = {"decode": decode_seconds(readers[0])}
    if fill:
        host["fill"] = fill_seconds(readers[0])
    parts["host_timing_s"] = time.perf_counter() - t
    log(name, decode_route=route, launches=launches,
        tiers={r.name: r._sampler.pair_mode for r in readers},
        grid_index=index, step_ms=step_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_parts=parts, **host, **checks, **stats)
    profile_interval(o, phase=f"{name}_profile")
    return launches, stats


def file_card_against_cpu(name, simulation, files, n=4096, intervals=2,
                          **kw):
    """A file path's configuration, small, on the card and on the CPU from
    one seed: every status equal at every output, lon/lat/z within the
    slice tolerance."""
    out = {}
    for device in ("cuda", "cpu"):
        o, _ = simulation(device, n, files, **kw)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000)
        out[device] = o.result
    status = [np.asarray(out[d]["status"].values) for d in ("cuda", "cpu")]
    if not np.array_equal(*status):
        raise AssertionError(f"{name}: card and CPU disagree on "
                             f"{int((status[0] != status[1]).sum())} "
                             f"statuses")
    errs = {}
    for var in ("lon", "lat", "z"):
        err, ok = agree(out["cuda"][var].values, out["cpu"][var].values,
                        SLICE_MEDIAN_ATOL[var], SLICE_OUTLIER_ATOL[var],
                        SLICE_OUTLIER_SHARE)
        errs[var] = err
        if not ok:
            raise AssertionError(f"{name}: card and CPU disagree on {var}: "
                                 f"{err}")
    stranded = float((status[1][:, -1]
                      == o.status_categories.index("stranded")).mean())
    log(f"{name}_card_vs_cpu", elements=n, intervals=intervals,
        stranded_share=stranded, max_abs_err=errs, **kw)
    return errs


def netcdf_path(files):
    from opendrift_tpu_torch.ops import mixing
    return file_path("netcdf_path", netcdf_simulation, mixing.visser_mixing,
                     files)


def roms_path(files):
    from opendrift_tpu_torch.ops import mixing
    # ROMS frames arrive coast-filled by grey dilation (fields/roms.py), so
    # the host NaN fill has nothing left to do there and is not timed
    return file_path("roms_path", roms_simulation,
                     mixing.visser_mixing_profile, files, fill=False)


def netcdf_card_against_cpu(files):
    return file_card_against_cpu("netcdf", netcdf_simulation, files)


def roms_card_against_cpu(files):
    for sampling in ("native", "regrid"):
        file_card_against_cpu("roms", roms_simulation, files,
                              sampling=sampling)


# ------------------------------------------------------- mesh path -------
# A SCHISM user's configuration: the port's own writers give a regional
# mesh over Lofoten and Vestfjorden in UTM 33N (about 60,000 nodes and
# 119,000 triangles, its coast that of the bundled raster, 20 levels) and
# an ECMWF-HRES-like GRIB2 wind at 0.1 degrees, both with 9 hourly frames:
# the timed run spans 7.5 h, and an element beyond a reader's last frame
# (and its one step of slack) would leave the run for missing data.
MESH_SMALL = dict(spacing_m=3000.0, nlev=8)
WIND_SMALL = dict(res=0.25)
MESH_STRANDED = (0.005, 0.5)     # the stranded share the path must reach


def write_mesh_files(directory, small=False):
    """The SCHISM and GRIB files of the mesh path, at the models' widths
    or (``small``) on coarser grids over the same areas; returns {name:
    path}."""
    from opendrift_tpu_torch.tools import synthetic_grib, synthetic_mesh
    return {"schism": synthetic_mesh.write_schism_lofoten(
                os.path.join(directory, "schism.nc"),
                **(MESH_SMALL if small else {})),
            "ecmwf": synthetic_grib.write_ecmwf_wind(
                os.path.join(directory, "ecmwf.grib2"),
                **(WIND_SMALL if small else {}))}


def mesh_simulation(device, n, files, sampling="native", seed=0):
    """A default OceanDrift run of ``n`` elements on the SCHISM file (the
    mesh's coverage its landmask; 3D currents z-sliced onto the default
    depths) and the GRIB wind, read as a user would: RK4, Visser mixing
    with windspeed_Large1994 on the GRIB wind, horizontal diffusivity 10
    m2/s, dt = 900 s with 60 s substeps, seeded by ``seed_from_wkt`` west
    of the Lofoten wall over the top 30 m.  Returns (simulation, seconds
    to build the readers)."""
    from opendrift_tpu_torch.models.oceandrift import OceanDrift
    from opendrift_tpu_torch.fields.grib import GribReader
    from opendrift_tpu_torch.fields.unstructured import SCHISMReader
    from opendrift_tpu_torch.tools.synthetic_mesh import UTM33
    t = time.perf_counter()
    ocean = SCHISMReader(files["schism"], proj4=UTM33, use_3d=True,
                         sampling=sampling, name="schism")
    wind = GribReader(files["ecmwf"], name="ecmwf")
    build_s = time.perf_counter() - t
    o = OceanDrift(loglevel=40, device=device, seed=seed)
    o.add_reader([ocean, wind])
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    o.set_config("vertical_mixing:timestep", 60.0)
    o.set_config("drift:horizontal_diffusivity", 10.0)
    r = np.random.default_rng(seed + 1)
    o.seed_from_wkt(COAST_WKT, time=ocean.times[0], number=n,
                    z=-r.uniform(0.0, 30.0, n))
    return o, build_s


def mesh_build_parts(reader):
    """Seconds of the host tables of ``reader``'s build, each built again
    from the reader's nodes: the regridder (made in native mode too, as in
    the JAX package), the lookup raster and the neighbour table."""
    from opendrift_tpu_torch.fields import mesh
    from opendrift_tpu_torch.fields.regrid import DelaunayRegridder
    ms = reader._mesh
    out = {}
    t = time.perf_counter()
    DelaunayRegridder(reader._node_lon, reader._node_lat)
    out["regridder_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh.locate_grid(reader._node_lon, reader._node_lat, ms.triangles,
                     ms.lx0, ms.ldx, ms.nx, ms.ly0, ms.ldy, ms.ny)
    out["lookup_raster_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh.tri_neighbors(ms.triangles)
    out["neighbours_s"] = time.perf_counter() - t
    out.update(nodes=ms.n_nodes, triangles=len(ms.triangles),
               lookup=[ms.ny, ms.nx])
    return out


def grib_decode_seconds(reader):
    """Seconds of one window's GRIB decode of ``reader``: every frame of
    every variable of the window, each decoding its whole message as
    ``_read_frame`` does."""
    tidx = reader._frame_indices(None, None)
    t = time.perf_counter()
    for v in reader._group2:
        for ti in tidx:
            reader._read_frame(v, ti, None, slice(None), slice(None))
    return {"frames": len(tidx) * len(reader._group2),
            "seconds": time.perf_counter() - t}


def mesh_layer_ms(reader, o):
    """Milliseconds of one ``locate_device``, of one column gather
    (``blend_columns``: 3 node values an element, blended) and of one
    z-resolved variable's sample from the node rows (4 column gathers: 2
    frames x 2 levels) at the run's element positions on the card, by CUDA
    events (median)."""
    import torch
    from opendrift_tpu_torch.interop import device_state_from_numpy
    from opendrift_tpu_torch.tools.kernel_check import cuda_ms
    d = o.state.data
    lon, lat, z = d["lon"], d["lat"], d["z"]
    ms = reader._mesh
    dev_state = device_state_from_numpy(reader.device_state(), o.device)
    locate = cuda_ms(lambda: ms.locate_device(lon, lat))
    _, w, nidx, _, _ = ms.locate_device(lon, lat)
    rows = dev_state["node_rows"]
    column = cuda_ms(lambda: ms.blend_columns(rows, w, nidx, 0))
    variable = cuda_ms(lambda: reader._mesh_values(
        dev_state, np.float32(0.0), w, nidx, ["x_sea_water_velocity"],
        torch.clamp_min(-z, 0.0)))
    return {"locate_ms": locate, "column_gather_ms": column,
            "variable_3d_ms": variable, "elements": int(lon.numel())}


def check_mesh_result(o, n, frames, reader):
    """The mesh path's own checks: no NaN where an element is valid, the
    stranded share within MESH_STRANDED, and at every output no active
    element outside the mesh by the reader's own ``locate_device`` on the
    run's device; every element active or stranded at the end (none left
    for missing data).  Returns the shares."""
    import torch
    shares = check_sampler_result(o, n, frames)
    lo, hi = MESH_STRANDED
    if not lo <= shares["stranded_share"] <= hi:
        raise AssertionError(f"{shares['stranded_share']} of the elements "
                             f"stranded, outside [{lo}, {hi}]")
    if shares["active_share"] + shares["stranded_share"] < 0.99:
        raise AssertionError(f"only {shares['active_share']} of the "
                             "elements active and not stranded at the end")
    status = np.asarray(o.result["status"].values)
    outside = 0
    for k in range(frames):
        act = status[:, k] == 0
        lon, lat = (torch.as_tensor(np.asarray(o.result[v].values)[act, k],
                                    device=o.device) for v in ("lon", "lat"))
        inside = reader._mesh.locate_device(lon, lat)[3]
        outside += int((~inside).sum())
    if outside:
        raise AssertionError(f"{outside} active elements outside the mesh")
    return shares


def mesh_path(files, n=2_000_000, intervals=3):
    """The mesh path at full width: one untimed interval, then the timed
    run, which must launch the windspeed kernel once a step and no other
    mixing kernel.  Returns (its launches, the run's numbers)."""
    import torch
    from opendrift_tpu_torch.fields import mesh
    from opendrift_tpu_torch.ops import mixing
    parts = {}
    t = time.perf_counter()
    o, _ = mesh_simulation("cuda", n, files)
    run_sampler(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    parts["untimed_s"] = time.perf_counter() - t
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    t = time.perf_counter()
    o, build_s = mesh_simulation("cuda", n, files)
    parts["setup_s"] = time.perf_counter() - t
    ocean, wind = o.env.readers["schism"], o.env.readers["ecmwf"]
    if "matplotlib" in sys.modules:
        raise AssertionError("matplotlib was imported")
    calls = {"locate": 0, "column_gather": 0}
    real = (mesh.MeshSampler.locate_device, mesh.MeshSampler.blend_columns)

    def locate(self, *a, **kw):
        calls["locate"] += 1
        return real[0](self, *a, **kw)

    def columns(*a, **kw):
        calls["column_gather"] += 1
        return real[1](*a, **kw)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mesh.MeshSampler.locate_device = locate
    mesh.MeshSampler.blend_columns = staticmethod(columns)
    try:
        secs = run_sampler(o, intervals)
    finally:
        mesh.MeshSampler.locate_device = real[0]
        mesh.MeshSampler.blend_columns = staticmethod(real[1])
    peak = torch.cuda.max_memory_allocated()
    launches = mixing.visser_mixing.launches
    steps = 10 * intervals
    assert launches == steps, f"{launches} launches of visser_mixing " \
        f"in {steps} steps"
    for k in kernels[1:]:
        assert k.launches == 0, f"mesh_path launched {k.__name__}"
    checks = check_mesh_result(o, n, intervals + 1, ocean)
    stats = run_stats(o, n, steps, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    stats["reader_build_s"] = build_s
    step_ms = (stats["main_loop_s"] - stats["readers_s"]) / steps * 1e3
    columns = sum(ocean._mesh_Z * ocean._mesh_F if kind == "t3" else
                  ocean._mesh_F if kind == "t" else 1
                  for _, kind in ocean._mesh_cols.values())
    # one sample of the window's whole node rows: three gathered (N, C)
    # rows and the blended one, float32
    whole_rows_bytes = 4 * 4 * n * columns
    if peak >= whole_rows_bytes:
        raise AssertionError(f"peak {peak} B not below one whole-row "
                             f"sample's {whole_rows_bytes} B")
    t = time.perf_counter()
    host = {"build_parts": mesh_build_parts(ocean),
            "grib_decode": grib_decode_seconds(wind)}
    parts["host_timing_s"] = time.perf_counter() - t
    layer = mesh_layer_ms(ocean, o)
    layer.update({f"{k}_calls_per_step": v / steps
                  for k, v in calls.items()})
    log("mesh_path", launches=launches, sampling=ocean._sampling,
        depths=len(ocean.depths), node_columns=columns, step_ms=step_ms,
        peak_mem_gb=peak / 1e9, whole_row_sample_gb=whole_rows_bytes / 1e9,
        mesh_layer=layer, phase_parts=parts, wind_tier=
        wind._sampler.pair_mode, **host, **checks, **stats)
    profile_interval(o, phase="mesh_path_profile")
    return launches, stats


def mesh_card_against_cpu(files):
    for sampling in ("native", "regrid"):
        file_card_against_cpu("mesh", mesh_simulation, files,
                              sampling=sampling)


# -------------------------------------------- tiers and storages ----------

# ----------------------------------------------------- the model zoo -----

PLAST_SEED_DEPTH = 5.0      # m: PlastDrift elements seeded over the top 5 m
ZOO_N = 4096
ZOO_CLASSES = ("windblow_euler", "seaice_euler", "leeway_stat",
               "plast_stat", "sediment_stat", "pelagicegg_stat",
               "larvalfish_stat", "larvalfish_extended", "openberg_det",
               "shipdrift_stat", "sealice_stat")


def zoo_simulation(cls, device, n, seed=0, forcing_kw=None):
    """A zoo model of ``n`` elements on the main path's synthetic ocean
    and wind, seeded as the main path seeds, no landmask."""
    from opendrift_tpu_torch.fields import ArrayReader
    current, wind, x, y, depths, times = forcing(**(forcing_kw or {}))
    o = cls(loglevel=40, device=device, seed=seed)
    o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                             name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("environment:fallback:land_binary_mask", 0)
    r = np.random.default_rng(seed + 1)
    lon = r.uniform(float(x[len(x) // 4]), float(x[3 * len(x) // 4]), n)
    lat = r.uniform(float(y[len(y) // 4]), float(y[3 * len(y) // 4]), n)
    return o, lon, lat, times[0], r


def plast_simulation(device, n, mixingmodel="randomwalk", seed=0,
                     forcing_kw=None):
    """A microplastics user's PlastDrift run: RK4, dt = 900 s, PlastDrift's
    own defaults (windspeed_Sundby1983, the fetch-tabulated Stokes drift
    and Hs from the wind, as no wave reader serves them), with
    ``mixingmodel`` ('randomwalk' through the windspeed kernel, 60 s
    substeps), elements seeded over the top 5 m with the default rising
    terminal velocity of 0.01 m/s."""
    from opendrift_tpu_torch.models import PlastDrift
    o, lon, lat, t0, r = zoo_simulation(PlastDrift, device, n, seed,
                                        forcing_kw)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("vertical_mixing:mixingmodel", mixingmodel)
    o.set_config("vertical_mixing:timestep", 60.0)
    o.seed_elements(lon=lon, lat=lat, z=-r.uniform(0.0, PLAST_SEED_DEPTH, n),
                    time=t0)
    return o


def leeway_simulation(device, n, seed=0, forcing_kw=None):
    """A search-and-rescue Leeway run of the default object class on the
    same forcing, dt = 900 s, capsizing on."""
    from opendrift_tpu_torch.models import Leeway
    o, lon, lat, t0, _ = zoo_simulation(Leeway, device, n, seed, forcing_kw)
    o.set_config("processes:capsizing", True)
    o.seed_elements(lon=lon, lat=lat, time=t0)
    return o


def top_share(z, depth=1.0):
    return float(np.mean(np.asarray(z) > -depth))


def plast_path(n=2_000_000, intervals=3):
    """PlastDrift at full width: one untimed interval, then the timed run
    with 'randomwalk' through the windspeed kernel; then one interval of
    the default 'analytical' model, which launches no mixing kernel.
    Returns (launches of the windspeed kernel, the run's numbers)."""
    import torch
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    from opendrift_tpu_torch.ops import mixing
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    o = plast_simulation("cuda", n)
    run_sampler(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    o = plast_simulation("cuda", n)
    seed_top = top_share(o._seedings[0]["z"])
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = run_sampler(o, intervals)
    launches = mixing.visser_mixing.launches
    steps = 10 * intervals
    assert launches == steps, f"{launches} K1 launches in {steps} steps"
    assert mixing.visser_mixing_profile.launches == 0
    assert mixing.visser_mixing_oil.launches == 0
    checks = check_sampler_result(o, n, intervals + 1)
    z = np.asarray(o.result["z"].values)
    valid = valid_mask(np.asarray(o.result["status"].values), 0)
    end_top = top_share(z[valid[:, -1], -1])
    if not end_top > seed_top:
        raise AssertionError(f"rising plastics: {end_top} in the top 1 m at "
                             f"the end, {seed_top} at the seed")
    stats = run_stats(o, n, steps, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    log("plast_path", mixingmodel="randomwalk",
        diffusivitymodel=o.get_config("vertical_mixing:diffusivitymodel"),
        tabularised_stokes=o.get_config("drift:use_tabularised_stokes_drift"),
        launches=launches, top_1m_share_seed=seed_top,
        top_1m_share_end=end_top,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        **checks, **stats)
    del o
    o = plast_simulation("cuda", n, mixingmodel="analytical")
    for k in kernels:
        k.launches = 0
    secs = run_sampler(o, 1)
    counts = [k.launches for k in kernels]
    if any(counts):
        raise AssertionError(f"'analytical' PlastDrift launched {counts}")
    checks = check_sampler_result(o, n, 2)
    z = np.asarray(o.result["z"].values)[:, -1]
    log("plast_path", mixingmodel="analytical", launches=counts,
        z_mean=float(z.mean()), top_1m_share_end=top_share(z), **checks,
        **run_stats(o, n, 10, secs))
    return launches, stats


def leeway_path(n=2_000_000, intervals=3):
    """Leeway at full width: one untimed interval, then the timed run.
    Checked: no NaN where an element is valid, and the cloud moved
    downwind (its mean displacement along the mean wind is positive)."""
    import torch
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    o = leeway_simulation("cuda", n)
    run_sampler(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    o = leeway_simulation("cuda", n)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
          time_step_output=9000,
          export_variables=["lon", "lat", "status", "capsized",
                            "orientation"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    status = np.asarray(o.result["status"].values)
    valid = valid_mask(status, 0)
    lon = np.asarray(o.result["lon"].values, np.float64)
    lat = np.asarray(o.result["lat"].values, np.float64)
    for name, vals in (("lon", lon), ("lat", lat)):
        if not np.isfinite(vals[valid]).all():
            raise AssertionError(f"Leeway: non-finite {name}")
    _, wind, *_ = forcing()
    wx, wy = float(wind["x_wind"].mean()), float(wind["y_wind"].mean())
    east = (lon[:, -1] - lon[:, 0]) * np.cos(np.deg2rad(lat[:, 0])) * 111e3
    north = (lat[:, -1] - lat[:, 0]) * 111e3
    downwind = (east * wx + north * wy) / np.hypot(wx, wy)
    if not downwind.mean() > 0:
        raise AssertionError(f"Leeway moved {downwind.mean()} m downwind")
    capsized = np.asarray(o.result["capsized"].values)[:, -1]
    orientation = np.asarray(o.result["orientation"].values)[:, -1]
    stats = run_stats(o, n, 10 * intervals, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    log("leeway_path", object_type=o.get_config("seed:object_type"),
        downwind_m_mean=float(downwind.mean()),
        downwind_share=float((downwind > 0).mean()),
        capsized_share=float(capsized.mean()),
        left_share=float((orientation == 1).mean()),
        right_share=float((orientation == 0).mean()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **stats)
    return stats


# ------------------------------------------------------------ phase 4d ----

CHEM_SEED_DEPTH = 10.0      # m: chemical elements seeded over the top 10 m
CHEM_DT = 1800.0            # s, as the chemical_stat golden
CHEM_EXPORT = ["lon", "lat", "z", "status", "moving", "specie", "mass",
               "mass_degraded", "mass_volatilized"]
CHEM_MASS_RTOL = 1e-4       # per element: mass + degraded + volatilized
SPECIATION_SHARE = 0.01     # species of card and CPU runs may differ
SEAFLOOR_ATOL = 1e-3        # m: sedimented elements sit at the seafloor
CHEM_ZOO = ("radionuclide_stat", "chemical_stat", "chemical_metals",
            "hns_butyl", "model_template")


def mixing_kernels():
    from opendrift_tpu_torch.ops import mixing
    return (mixing.visser_mixing, mixing.visser_mixing_profile,
            mixing.visser_mixing_oil)


def chemistry_forcing(**kw):
    """The oil path's ocean (currents, 3D temperature and salinity, the
    coast along the eastern side) and wind, with suspended particulate
    matter served as a further variable of the ocean reader: 1-20 g/m3,
    highest at the surface next to the coast, falling with depth and with
    distance from the coast."""
    current, wind, _, x, y, depths, times = oil_forcing(**kw)
    nt, nz, ny, nx = current["x_sea_water_velocity"].shape
    coast = nx - max(2, COAST_CELLS * nx // 200)
    off = np.clip(coast - np.arange(nx), 0, None)       # cells off the coast
    spm = 1.0 + 19.0 * np.exp(-depths / 15.0)[:, None, None] \
        * np.exp(-off / (0.25 * nx))[None, None, :]
    current["spm"] = np.ascontiguousarray(np.broadcast_to(
        spm[None], (nt, nz, ny, nx))).astype(np.float32)
    return current, wind, x, y, depths, times


def chemistry_simulation(cls, device, n, seed=0, forcing_kw=None):
    """A ``cls`` run of ``n`` elements on :func:`chemistry_forcing`, 60 s
    mixing substeps, seeded over the top 10 m in the middle of the grid;
    returns the simulation and the seeding's keyword arguments."""
    from opendrift_tpu_torch.fields import ArrayReader
    current, wind, x, y, depths, times = chemistry_forcing(
        **(forcing_kw or {}))
    o = cls(loglevel=40, device=device, seed=seed)
    o.add_reader(ArrayReader(current, x, y, times, depths=depths,
                             name="ocean"))
    o.add_reader(ArrayReader(wind, x, y, times, name="wind"))
    o.set_config("vertical_mixing:timestep", 60.0)
    r = np.random.default_rng(seed + 1)
    lon = r.uniform(float(x[len(x) // 4]), float(x[3 * len(x) // 4]), n)
    lat = r.uniform(float(y[len(y) // 4]), float(y[3 * len(y) // 4]), n)
    return o, dict(lon=lon, lat=lat, z=-r.uniform(0.0, CHEM_SEED_DEPTH, n),
                   number=n, time=times[0])


def chemical_simulation(device, n, seed=0, forcing_kw=None):
    """A chemical-fate user's ChemicalDrift run: the 'organics' setup with
    the Phenanthrene preset, degradation and volatilization on, dt =
    1800 s (the chemical_stat golden's), 30 mixing substeps a step through
    OceanDrift's generic loop (the model overrides the substep hooks)."""
    from opendrift_tpu_torch.models import ChemicalDrift
    o, seed_kw = chemistry_simulation(ChemicalDrift, device, n, seed,
                                      forcing_kw)
    o.init_chemical_compound("Phenanthrene")
    o.set_config("chemical:transformations:degradation", True)
    o.set_config("chemical:transformations:volatilization", True)
    np.random.seed(seed)        # the SPM diameters come from numpy's global
    o.seed_elements(**seed_kw)
    return o


def radionuclide_simulation(device, n, seed=0, forcing_kw=None):
    """RadionuclideDrift with its defaults (137Cs, 'LMM + Rev', the
    suspended-matter concentration ``conc3`` from the fallback) on the
    same forcing, released at the seafloor (``seed:seafloor``), as from
    waste dumped on the seabed: sorption to the sediment runs."""
    from opendrift_tpu_torch.models import RadionuclideDrift
    o, seed_kw = chemistry_simulation(RadionuclideDrift, device, n, seed,
                                      forcing_kw)
    o.set_config("seed:seafloor", True)
    o.seed_elements(**seed_kw)
    return o


def run_chemistry(o, intervals, dt=CHEM_DT):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=dt * 10 * intervals), time_step=dt,
          time_step_output=dt * 10, export_variables=CHEM_EXPORT)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def occupation(o):
    """Elements of each specie among the valid ones at the last output."""
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    valid = valid_mask(np.asarray(o.result["status"].values), 0)[:, -1]
    sp = np.asarray(o.result["specie"].values)[valid, -1]
    return {name: int((sp == i).sum())
            for i, name in enumerate(o.name_species)}


def check_chemistry_result(o, n, frames, mass=True):
    """Nothing valid is NaN, every specie lies in [0, S), elements of a
    sediment specie are frozen at the seafloor, and (``mass``) each
    element's mass closes: mass + degraded + volatilized equals what was
    seeded.  Returns the numbers it logs."""
    from opendrift_tpu_torch.export.io_netcdf import valid_mask
    res = o.result
    status = np.asarray(res["status"].values)
    assert status.shape == (n, frames), status.shape
    valid = valid_mask(status, 0)
    names = [v for v in CHEM_EXPORT if v in res and v != "status"]
    if not mass:
        names = [v for v in names if not v.startswith("mass")]
    for var in names:
        vals = np.asarray(res[var].values)
        if not np.isfinite(vals[valid]).all():
            raise AssertionError(f"{type(o).__name__}: non-finite {var}")
    sp = np.asarray(res["specie"].values)
    S = o.nspecies
    if not ((sp[valid] >= 0) & (sp[valid] < S)).all():
        raise AssertionError(f"a specie outside [0, {S})")
    last = status[:, -1] == 0
    sed = np.zeros(n, bool)
    for i, name in enumerate(o.name_species):
        if name.startswith("Sediment"):
            sed |= last & (sp[:, -1] == i)
    moving = np.asarray(res["moving"].values)[:, -1]
    if (moving[sed] != 0).any():
        raise AssertionError("a sedimented element is moving")
    lon = np.asarray(res["lon"].values)[sed, -1]
    lat = np.asarray(res["lat"].values)[sed, -1]
    z = np.asarray(res["z"].values)[sed, -1]
    seafloor_err = 0.0
    if sed.any():
        when = np.datetime64(res.coords["time"][-1], "us").astype(datetime)
        depth = o.env.readers["ocean"].sample_at(
            lon, lat, when, ["sea_floor_depth_below_sea_level"],
            device=o.device)["sea_floor_depth_below_sea_level"]
        seafloor_err = float(np.abs(z + depth).max())
        if seafloor_err > SEAFLOOR_ATOL:
            raise AssertionError(f"sedimented elements {seafloor_err} m "
                                 "off the seafloor")
    out = {"sedimented": int(sed.sum()), "seafloor_max_err_m": seafloor_err,
           "active_share": float(last.mean()),
           "stranded_share": float((status[:, -1] == o.status_categories
                                    .index("stranded")).mean())}
    if mass:
        total = sum(np.asarray(res[v].values, np.float64)
                    for v in ("mass", "mass_degraded", "mass_volatilized"))
        rel = np.abs(total - total[:, :1]) / total[:, :1]
        err = float(rel[valid].max())
        if err > CHEM_MASS_RTOL:
            raise AssertionError(f"an element's mass budget is off by {err}")
        out["mass_budget_max_rel_err"] = err
        out["mass_degraded_share"] = float(
            np.nansum(res["mass_degraded"].values[:, -1])
            / np.nansum(total[:, 0]))
        out["mass_volatilized_share"] = float(
            np.nansum(res["mass_volatilized"].values[:, -1])
            / np.nansum(total[:, 0]))
    return out


def no_mixing_kernel(name):
    launched = {k.__name__: k.launches for k in mixing_kernels()}
    if any(launched.values()):
        raise AssertionError(f"{name} launched mixing kernels {launched}")
    return launched


def chemical_path(workdir, n=2_000_000, intervals=3):
    """ChemicalDrift at full width: one untimed interval, then the timed
    run of ``intervals`` intervals of 10 steps, which must launch no mixing
    kernel; then a profiled interval and one density map of the result.
    Returns the run's numbers."""
    import torch
    o = chemical_simulation("cuda", n)
    run_chemistry(o, 1)
    first = n * 10 / (o.timers["main loop"]
                      - o.timers.get("main loop:readers", 0.0))
    del o
    o = chemical_simulation("cuda", n)
    for k in mixing_kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = run_chemistry(o, intervals)
    launched = no_mixing_kernel("chemical_path")
    peak = torch.cuda.max_memory_allocated() / 1e9
    checks = check_chemistry_result(o, n, intervals + 1)
    stats = run_stats(o, n, 10 * intervals, secs)
    stats["particle_steps_per_s_steps_only_untimed_interval"] = first
    path = os.path.join(workdir, "chemical_density.nc")
    t = time.perf_counter()
    o.write_netcdf_chemical_density_map(path, pixelsize_m=1000.0,
                                        zlevels=(-20.0, -10.0, -5.0))
    density_s = time.perf_counter() - t
    log("chemical_path", compound=o.get_config("chemical:compound"),
        substeps=int(CHEM_DT / 60.0), launches=launched,
        occupation_seed=dict(zip(o.name_species, np.bincount(
            o._seedings[0]["specie"], minlength=o.nspecies).tolist())),
        occupation_end=occupation(o), peak_mem_gb=peak,
        density_map_s=density_s,
        density_map_mb=os.path.getsize(path) / 1e6, **checks, **stats)
    os.remove(path)
    profile_interval(o, phase="chemical_profile", dt=CHEM_DT)
    return stats


def radionuclide_path(n=2_000_000):
    """RadionuclideDrift (137Cs) at full width: one untimed interval, then
    one timed, which must launch no mixing kernel."""
    import torch
    o = radionuclide_simulation("cuda", n)
    run_chemistry(o, 1)
    del o
    o = radionuclide_simulation("cuda", n)
    for k in mixing_kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = run_chemistry(o, 1)
    launched = no_mixing_kernel("radionuclide_path")
    checks = check_chemistry_result(o, n, 2, mass=False)
    log("radionuclide_path", isotope=o.get_config("radionuclide:isotope"),
        launches=launched, occupation_end=occupation(o),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **checks,
        **run_stats(o, n, 10, secs))


EULER_SIZE = 1000           # cells a side, of 100 m
EULER_STEPS = 100
EULER_RTOL = 1e-5           # of the field's maximum, card against CPU
EULER_MASS_RTOL = 1e-4


def euler_simulation(device, size=EULER_SIZE):
    """``ExplSimulation`` on a size x size grid of 100 m cells off western
    Norway, D = 5 m2/s, a constant current of (0.3, 0.1) m/s, a Gaussian
    source (sigma 1 km) a third of the way in."""
    from opendrift_tpu_torch.models import eulerdrift
    s = eulerdrift.ExplSimulation.new(lon0=4.0, lat0=60.0, res=100.0,
                                      shape=(size, size), D=5.0,
                                      device=device)
    s.readers.append(eulerdrift.ConstantReader.new_xy(x=0.3, y=0.1))
    lon, lat = s.grid.crs.inv(np, s.grid.x[size // 3], s.grid.y[size // 3])
    s.grid.source_gaussian_blob(float(lon), float(lat), A=1.0, N=61,
                                sigma=1000.0)
    return s


def euler_field(size=EULER_SIZE, steps=EULER_STEPS, dt=60.0):
    """The Eulerian solver on the card and on the CPU at the same size:
    the fields agree to ``EULER_RTOL`` of the maximum, and each keeps its
    mass; the device seconds of one stencil step are timed with CUDA
    events on the card's field."""
    import torch
    from opendrift_tpu_torch.models import eulerdrift
    fields, masses, walls = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for device in ("cuda", "cpu"):
        s = euler_simulation(device, size)
        m0 = s.grid.total_mass()
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.integrate(dt=dt, max_steps=steps)
        torch.cuda.synchronize()
        walls[device] = time.perf_counter() - t
        masses[device] = abs(s.grid.total_mass() - m0) / m0
        fields[device] = s.grid.field.cpu().numpy()
        if device == "cuda":
            peak = torch.cuda.max_memory_allocated() / 1e9
            c = s.grid.field
            u = torch.full_like(c, 0.3)
            v = torch.full_like(c, 0.1)
            eulerdrift._step_kernel(c, u, v, s.D, s.grid.res, dt)   # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                c = eulerdrift._step_kernel(c, u, v, s.D, s.grid.res, dt)
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / steps
        del s
    err = float(np.abs(fields["cuda"].astype(np.float64)
                       - fields["cpu"]).max())
    scale = float(np.abs(fields["cpu"]).max())
    if not np.isfinite(fields["cuda"]).all() or err > EULER_RTOL * scale:
        raise AssertionError(f"euler field: card against CPU {err} "
                             f"(max {scale})")
    if max(masses.values()) > EULER_MASS_RTOL:
        raise AssertionError(f"euler field: mass changed by {masses}")
    log("euler_field", shape=[size, size], res_m=100.0, steps=steps,
        max_abs_err=err, field_max=scale, rel_err=err / scale,
        mass_rel_change=masses, integrate_s=walls,
        device_ms_per_step=step_ms,
        cells_per_s=size * size / (step_ms * 1e-3), peak_mem_gb=peak)


FTLE_DELTA = 0.001          # 2000 x 1000 seeds over the 2 x 1 gyre
FTLE_SMALL_DELTA = 0.01     # 200 x 100 seeds, card against CPU
FTLE_ATOL = 1e-3            # 1/s, card against CPU where both are finite
FTLE_SHARE = 0.01           # of the cells beyond 1e-4


def ftle_fields(device, delta):
    """``calculate_ftle`` of OceanDrift (RK4) on the double gyre, forward
    (RLCS) and backward (ALCS), 8 s in steps of 0.2 s: an LCS user's
    job."""
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import DoubleGyre
    o = OceanDrift(loglevel=40, device=device)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_advection", False)
    dg = DoubleGyre(epsilon=0.25, omega=0.628, A=0.1)
    o.add_reader(dg)
    return o.calculate_ftle(reader=dg, delta=delta,
                            domain=[0.0, 2.0, 0.0, 1.0],
                            time=dg.initial_time, time_step=0.2,
                            duration=timedelta(seconds=8))


def ftle_path():
    """FTLE at about 2M seeds on the card (forward and backward runs), then
    the same at 20,000 seeds on the card and on the CPU, held together."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    big = ftle_fields("cuda", FTLE_DELTA)
    secs = time.perf_counter() - t
    shape = big["RLCS"][0].shape
    out = {}
    for name in ("RLCS", "ALCS"):
        f = big[name][0]
        finite = float(np.isfinite(f).mean())
        if finite < 0.99 or not np.nanmax(f) > 3 * np.nanmedian(np.abs(f)):
            raise AssertionError(f"{name} at {shape}: finite share {finite},"
                                 f" max {np.nanmax(f)}")
        out[name] = {"finite_share": finite, "max": float(np.nanmax(f)),
                     "median": float(np.nanmedian(f))}
    log("ftle_path", seeds=int(np.prod(shape)), shape=list(shape),
        run_s=secs, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        **out)
    del big
    card = ftle_fields("cuda", FTLE_SMALL_DELTA)
    cpu = ftle_fields("cpu", FTLE_SMALL_DELTA)
    errs = {}
    for name in ("RLCS", "ALCS"):
        a, b = card[name][0], cpu[name][0]
        ok = np.isfinite(a) & np.isfinite(b)
        d = np.abs(a[ok] - b[ok])
        errs[name] = {"max_abs_err": float(d.max()),
                      "share_beyond_1e-4": float((d > 1e-4).mean()),
                      "finite_equal": bool(np.array_equal(np.isfinite(a),
                                                          np.isfinite(b)))}
        if d.max() > FTLE_ATOL or (d > 1e-4).mean() > FTLE_SHARE:
            raise AssertionError(f"ftle {name}: card against CPU {errs}")
    log("ftle_card_vs_cpu", seeds=int(np.prod(card["RLCS"][0].shape)),
        **errs)


def zoo_run(name, device, n, seed=0, steps=10, intervals=2):
    """Configuration ``name`` of ``opendrift_tpu_torch/tools/
    zoo_setups.py`` at ``n`` elements, ``intervals`` output intervals of
    ``steps`` steps."""
    from opendrift_tpu_torch.tools import zoo_setups
    cfg = zoo_setups.config(name, n, seed)
    o, _ = zoo_setups.setup(name, cfg, device)
    dt = cfg["time_step"]
    o.run(duration=timedelta(seconds=dt * steps * intervals), time_step=dt,
          time_step_output=dt * steps)
    return o


def zoo_card_against_cpu(n=ZOO_N):
    """Each class of the zoo on the card and on the CPU from one seed,
    under the constant fallbacks of its golden (or its JAX test's): lon/lat/z
    within the slice tolerance, statuses equal but for the share where an
    ulp may decide (the chemistry slice's configurations: every status
    equal, species equal but for ``SPECIATION_SHARE``); then ShipDrift's
    peak memory and OpenBerg's step time at 2M elements."""
    import torch
    out = {}
    for name in ZOO_CLASSES + CHEM_ZOO:
        card, cpu = zoo_run(name, "cuda", n), zoo_run(name, "cpu", n)
        got, want = final_frame(card), final_frame(cpu)
        chem = name in CHEM_ZOO
        status_diff, errs = hold_against(
            f"zoo {name}", got, want, SLICE_MEDIAN_ATOL, SLICE_OUTLIER_ATOL,
            SLICE_OUTLIER_SHARE, 0.0 if chem else STORAGE_STATUS_SHARE)
        extra = {}
        if "specie" in card.result:
            extra["specie_diff_share"] = float(np.mean(
                card.result["specie"].values != cpu.result["specie"].values))
            if extra["specie_diff_share"] > SPECIATION_SHARE:
                raise AssertionError(f"zoo {name}: species differ {extra}")
        out[name] = errs
        log("zoo_card_vs_cpu", config=name, elements=n,
            status_diff_share=status_diff, max_abs_err=errs,
            active_share=float((got["status"] == 0).mean()), **extra)
    big = 2_000_000
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    o = zoo_run("shipdrift_stat", "cuda", big, steps=1, intervals=1)
    log("zoo_shipdrift_memory", elements=big,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_above_start_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
        step_s=(o.timers["main loop"]
                - o.timers.get("main loop:readers", 0.0)))
    del o
    # the second of two runs: the first loads PyTorch's kernels
    for _ in range(2):
        o = zoo_run("openberg_det", "cuda", big, steps=4, intervals=1)
        torch.cuda.synchronize()
        step = (o.timers["main loop"]
                - o.timers.get("main loop:readers", 0.0)) / 4
        del o
    log("zoo_openberg_step", elements=big, substeps=20, step_s=step,
        particle_steps_per_s=big / step)
    return out


def final_frame(o):
    return {v: np.asarray(o.result[v].values)[:, -1]
            for v in ("lon", "lat", "z", "status")}


def hold_against(name, got, want, median, outlier, share, status_share):
    status_diff = float(np.mean(got["status"] != want["status"]))
    if status_diff > status_share:
        raise AssertionError(f"{name}: {status_diff} of the elements differ "
                             "in status from the float32 'xyz' run")
    errs = {}
    for var in ("lon", "lat", "z"):
        err, ok = agree(got[var], want[var], median[var], outlier[var],
                        share, nan_share=status_share)
        errs[var] = err
        if not ok:
            raise AssertionError(f"{name} disagrees with the float32 'xyz' "
                                 f"run on {var}: {err}")
    return status_diff, errs


def tiers_and_storages(n=2_000_000):
    """One interval of 10 steps on each further row tier and storage, held
    against the float32 'xyz' run of the same seed.

    'x' twice.  Once on the same grid, chosen with OPENDRIFT_XY_PAIR=0
    (the JAX package's override), on one corner block a step like the
    'xyz' run it is held against.  Once as the budget chooses it: the ocean
    refined 3 times in x (119,600 cells a level, 84 MB of base rows: only
    x 2 stays under the 256 MB budget); 'none' from 5 times (199,200 cells,
    140 MB: over the budget even x 2).  A corner block clamps a stage
    position at its cell's edge, and a finer cell clamps sooner, so the
    refined grids are run with a refetch at every RK stage ('none' has no
    x-paired rows and can do nothing else) and held against the 'xyz' run
    that does the same."""
    import os
    runs = {}
    cases = [("xyz", dict(), None),
             ("xyz_multi", dict(single_fetch=False), None),
             ("x_same_grid", dict(), "xyz"),
             ("x", dict(refine=3, single_fetch=False), "xyz_multi"),
             ("none", dict(refine=5, single_fetch=False), "xyz_multi"),
             ("float16x2", dict(packed_dtype="float16x2"), "xyz"),
             ("float16", dict(packed_dtype="float16"), "xyz")]
    for name, kw, base in cases:
        if name == "x_same_grid":
            os.environ["OPENDRIFT_XY_PAIR"] = "0"
        try:
            o = sampler_simulation("cuda", n, **kw)
            secs = run_sampler(o, 1)
            table = o.env.build_device_states()[0]["packed"]
        finally:
            os.environ.pop("OPENDRIFT_XY_PAIR", None)
        check_sampler_result(o, n, 2)
        tier = o.env.readers["ocean"]._sampler.pair_mode
        data = getattr(table, "data", table)
        runs[name] = final_frame(o)
        line = dict(case=name, tier=tier, storage=type(table).__name__,
                    dtype=str(data.dtype), rows=int(data.shape[0]),
                    table_bytes=int(data.numel() * data.element_size()),
                    single_fetch=kw.get("single_fetch", True),
                    held_against=base, **run_stats(o, n, 10, secs))
        want_tier = {"x_same_grid": "x", "x": "x", "none": "none"}.get(
            name, "xyz")
        assert tier == want_tier, (name, tier)
        assert (o.env.uv_block_plan_index() is not None) == (tier != "none")
        del o, table, data
        if base is None:
            log("tier_storage", **line)
            continue
        median, outlier = STORAGE_BOUNDS.get(
            name, (SLICE_MEDIAN_ATOL, SLICE_OUTLIER_ATOL))
        status_diff, errs = hold_against(
            name, runs[name], runs[base], median, outlier,
            STORAGE_OUTLIER_SHARE, STORAGE_STATUS_SHARE)
        log("tier_storage", status_diff_share=status_diff, max_abs_err=errs,
            median_atol=median, outlier_atol=outlier, **line)
    return runs


# ------------------------------------------------- gather A/B -------------

def real_tables(o):
    """(label, table, row indices) of the sampler path's last window at the
    elements' final positions: the ocean reader's table and its u/v
    companion at the trilinear cell, the wind reader's at the bilinear
    cell: what ``take_rows`` is given in the step."""
    import torch
    from opendrift_tpu_torch.ops import interp
    steps = o.steps_calculation
    start = o.start_time + timedelta(seconds=900 * (steps - 10))
    states = o.env.build_device_states(start,
                                       start + timedelta(seconds=9000))
    d = o.state.data
    out = []
    for (reader, _), state in zip(o.env._plan, states):
        s = reader._sampler
        xi, yi = reader._grid_indices(d["lon"], d["lat"])
        x0, y0, _, _ = interp._xy_cell(xi, yi, s.X, s.Y)
        z0, _ = interp._z_bracket(torch.clamp_min(-d["z"], 0.0),
                                  state["depths"], s.Z, x0)
        lin = s._lin(z0, y0, x0, 0).contiguous()
        out.append((reader.name, state["packed"], lin))
        if "packed_uv" in state:
            out.append((reader.name + "_uv", state["packed_uv"], lin))
    return out


def gather_ab_phase(o):
    """The gather kernels' main path: the A/B entry point on the tool's
    default inputs, on a table that fits shared memory, and on the real
    tables.  Returns the launches of (async, smem) over it."""
    from opendrift_tpu_torch.ops import gather
    from opendrift_tpu_torch.tools import gather_ab
    tables = real_tables(o)
    gather.gather_rows_async.launches = 0
    gather.gather_rows_smem.launches = 0
    jobs = [("tool_default", *gather_ab.default_inputs(
                250_000, 24, 2_000_000, "cuda")),
            ("fits_smem", *gather_ab.default_inputs(
                2_000, 24, 2_000_000, "cuda"))]
    jobs += [(label, table, lin, None) for label, table, lin in tables]
    for label, table, idx, fx in jobs:
        res = gather_ab.run_ab(table, idx, fx, out=lambda line: None)
        log("gather_ab", table=label, shape=list(table.shape),
            dtype=str(table.dtype), index_dtype=str(idx.dtype),
            indices=int(idx.shape[0]), results=res)
    return (gather.gather_rows_async.launches,
            gather.gather_rows_smem.launches)


# ------------------------------------------------- generic loop -----------

def generic_loop_phase(n=2_000_000):
    """The per-substep mixing loop on the card: one interval of OpenOil
    with T/S profiles (``surface_wave_mixing``, the rise velocity at the
    profiles' T and S) and one of OceanDrift with
    ``vertical_mixing:use_pallas=False``; neither may launch a mixing
    kernel."""
    from opendrift_tpu_torch.ops import mixing
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile,
               mixing.visser_mixing_oil)
    for k in kernels:
        k.launches = 0
    o = oil_simulation("cuda", n, "windspeed_Large1994")
    o.set_config("vertical_mixing:TSprofiles", True)
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=9000), time_step=900,
          time_step_output=9000, export_variables=OIL_EXPORT)
    secs = time.perf_counter() - t
    checks = check_oil_result(o, n, 2)
    log("generic_loop", model="OpenOil", TSprofiles=True,
        **run_stats(o, n, 10, secs), **checks)
    del o
    o = simulation("cuda", n, "windspeed_Large1994", hdiff=10.0)
    o.set_config("vertical_mixing:use_pallas", False)
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=9000), time_step=900,
          time_step_output=9000,
          export_variables=["lon", "lat", "z", "status"])
    secs = time.perf_counter() - t
    active = check_result(o, n, 2)
    log("generic_loop", model="OceanDrift", use_pallas=False,
        active_share=active, **run_stats(o, n, 10, secs))
    launched = {k.__name__: k.launches for k in kernels}
    assert not any(launched.values()), launched


# ------------------------------------------------------------- phase 5 ----

def oil_card_against_cpu(n=4096, intervals=2):
    """The same small OpenOil run on the card and on the CPU, from one
    seed."""
    out = {}
    small = dict(nx=60, ny=60, nz=16, nt=5)
    for device in ("cuda", "cpu"):
        o = oil_simulation(device, n, "windspeed_Large1994",
                           forcing_kw=small)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000, export_variables=OIL_EXPORT)
        out[device] = o.result
    status_diff = float(np.mean(np.asarray(out["cuda"]["status"].values)
                                != np.asarray(out["cpu"]["status"].values)))
    if status_diff > OIL_STATUS_SHARE:
        raise AssertionError(f"card and CPU disagree on the status of "
                             f"{status_diff} of the elements")
    unit = float(np.nanmax(np.asarray(out["cpu"]["mass_oil"].values)[:, 0]))
    errs = {}
    for var in OIL_MEDIAN_ATOL:
        scale = unit if var.startswith("mass_") else 1.0
        err, ok = agree(np.asarray(out["cuda"][var].values) / scale,
                        np.asarray(out["cpu"][var].values) / scale,
                        OIL_MEDIAN_ATOL[var], OIL_OUTLIER_ATOL[var],
                        OIL_OUTLIER_SHARE, nan_share=OIL_STATUS_SHARE)
        errs[var] = err
        if not ok:
            raise AssertionError(f"card and CPU disagree on {var}: {err}")
    log("oil_card_vs_cpu", elements=n, intervals=intervals,
        status_diff_share=status_diff, max_abs_err=errs)
    return errs


def card_against_cpu(n=4096, intervals=2, rng="threefry", hdiff=0.0):
    """The same small run on the card and on the CPU, from one seed, with
    ``general:rng`` = ``rng`` (every status equal under 'rbg')."""
    out = {}
    small = dict(nx=60, ny=60, nz=16, nt=5)
    for device in ("cuda", "cpu"):
        o = simulation(device, n, "windspeed_Large1994", hdiff=hdiff,
                       forcing_kw=small)
        o.set_config("general:rng", rng)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000)
        out[device] = o.result
    errs = {}
    for var in ("lon", "lat", "z"):
        err, ok = agree(out["cuda"][var].values, out["cpu"][var].values,
                        SLICE_MEDIAN_ATOL[var], SLICE_OUTLIER_ATOL[var],
                        SLICE_OUTLIER_SHARE)
        errs[var] = err
        if not ok:
            raise AssertionError(f"card and CPU disagree on {var}: {err}")
    status_equal = bool(np.array_equal(out["cuda"]["status"].values,
                                       out["cpu"]["status"].values))
    if rng == "rbg" and not status_equal:
        raise AssertionError("rbg: card and CPU statuses differ")
    log("card_vs_cpu", elements=n, intervals=intervals, rng=rng,
        hdiff=hdiff, status_equal=status_equal, max_abs_err=errs)
    return errs


def rbg_card_against_cpu(n=4096, intervals=2):
    """The rbg path's small run, horizontal diffusion on."""
    return card_against_cpu(n, intervals, rng="rbg", hdiff=10.0)


# ------------------------------------------------------------- phase 14 ---

PARITY_BUDGET_S = 120.0


def parity_goldens(device="cuda"):
    """Every scenario of ``opendrift_tpu_torch/tools/parity_compare.py``
    with bundled data on ``device``, each within the bounds of the JAX
    package's golden tests; the six that read the reference's forcing files
    are listed as "no data" (absent from the repository)."""
    from opendrift_tpu_torch.tools import parity_compare as parity
    t = time.perf_counter()
    status = {}
    for name in parity.SCENARIOS:
        rec = parity.check(name, device)
        status[name] = rec["status"]
        log("parity_golden", scenario=name, status=rec["status"],
            seconds=rec.get("seconds"),
            beyond=[r for r in rec.get("rows", []) if not r["ok"]])
        if rec["status"] == "fail":
            raise AssertionError(f"{name} on {device} is beyond its bound: "
                                 f"{rec['rows']}")
    secs = time.perf_counter() - t
    passed = sorted(k for k, v in status.items() if v == "pass")
    no_data = sorted(k for k, v in status.items() if v == "no data")
    log("parity_goldens", passed=len(passed), no_data=no_data,
        seconds=secs, budget_s=PARITY_BUDGET_S)
    if secs > PARITY_BUDGET_S:
        raise AssertionError(f"the parity goldens took {secs:.1f} s, over "
                             f"their {PARITY_BUDGET_S} s")
    return passed


def sampler_card_against_cpu(n=4096, intervals=2):
    """The sampler path's configuration, small, on the card and on the
    CPU from one seed (a status may differ where an ulp decides a
    stranding)."""
    out = {}
    small = dict(nx=60, ny=60, nz=16, nt=5)
    for device in ("cuda", "cpu"):
        o = sampler_simulation(device, n, forcing_kw=small)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000)
        out[device] = final_frame(o)
    status_diff, errs = hold_against(
        "card", out["cuda"], out["cpu"], SLICE_MEDIAN_ATOL,
        SLICE_OUTLIER_ATOL, SLICE_OUTLIER_SHARE, STORAGE_STATUS_SHARE)
    log("sampler_card_vs_cpu", elements=n, intervals=intervals,
        status_diff_share=status_diff, max_abs_err=errs)
    return errs


# ---------------------------------------------------------------- main ----

# ------------------------------------------------------------ phase 12 ----

DD_TILES = ["cuda:0"] * 4


def dd_simulation(device, n, tile_grid="auto", model="windspeed_Large1994",
                  hdiff=10.0, forcing_kw=None, mixing=True, tiles=None):
    """The main path's run (:func:`simulation`) with
    ``parallel:domain_decomposition`` over four tiles of ``device``."""
    o = simulation(device, n, model, hdiff=hdiff, forcing_kw=forcing_kw)
    o.set_config("drift:vertical_mixing", mixing)
    o.set_config("parallel:domain_decomposition", True)
    o.set_config("parallel:tile_grid", tile_grid)
    o.set_mesh(tiles or ([f"{device}:0"] * 4 if device == "cuda"
                         else [device] * 4))
    return o


def run_intervals(o, intervals, export=("lon", "lat", "z", "status")):
    """One ``run`` of ``intervals`` output intervals of K = 10 steps;
    returns the seconds (host clock, synchronised)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
          time_step_output=9000, export_variables=list(export))
    torch.cuda.synchronize()
    return time.perf_counter() - t


def check_tiled(o, n, frames, name):
    """Every element ID exactly once in every frame, nothing valid NaN."""
    dd = o._dd
    assert dd is not None and dd.n_tiles == 4, f"{name}: not tiled"
    bad = [c for c in dd.id_checks if c != (0, 0)]
    if len(dd.id_checks) != frames or bad:
        raise AssertionError(f"{name}: element IDs not held once a frame: "
                             f"{len(dd.id_checks)} frames, {bad[:3]}")
    status = np.asarray(o.result["status"].values)
    assert status.shape == (n, frames), status.shape
    valid = status >= 0
    for var in ("lon", "lat", "z"):
        v = np.asarray(o.result[var].values)
        if np.isnan(v[valid & (status == 0)]).any():
            raise AssertionError(f"{name}: NaN {var} of an active element")


def dd_run_stats(o, n, steps, secs):
    dd = o._dd
    st = dd.stats()
    loop = o.timers["main loop"]
    readers = o.timers.get("main loop:readers", 0.0)
    return {"elements": n, "steps": steps, "run_s": secs,
            "main_loop_s": loop, "readers_s": readers,
            "particle_steps_per_s": n * steps / secs,
            "particle_steps_per_s_steps_only": n * steps / (loop - readers),
            "tiles": dd.n_tiles, "tile_grid": [dd.n_ty, dd.n_tx],
            "rows": dd.rows, "cols": dd.cols, "halo_rows": dd.halo,
            "halo_cols": dd.halo_x, "slots_per_tile": dd.cap,
            "peak_occupancy": st["peak_occupancy"],
            "halo_ms_per_window": st["halo_ms_per_window"],
            "migrate_ms_per_step": st["migrate_ms_per_step"],
            "leavers_per_step": st["leavers_per_step"],
            "in_transit": dd.last_in_transit}


def dd_path(plain_final, n=2_000_000):
    """The main path's 2M-element run over four tiles on the card: 4 Y
    bands (one untimed interval, three timed, one 'constant'), then 2 x 2
    tiles (one timed interval).  Returns the windspeed and profile
    kernels' launches and the 4-band timed run's numbers."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    kernels = (mixing.visser_mixing, mixing.visser_mixing_profile)
    o = dd_simulation("cuda", n)
    run_intervals(o, 1)                          # untimed: one-time costs
    check_tiled(o, n, 2, "dd_path untimed")
    del o
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    o = dd_simulation("cuda", n)
    secs = run_intervals(o, 3)
    launches = mixing.visser_mixing.launches
    check_tiled(o, n, 4, "dd_path")
    stats = dd_run_stats(o, n, 30, secs)
    final = final_moments(o)
    log("dd_path", model="windspeed_Large1994", launches=launches,
        profile_launches=mixing.visser_mixing_profile.launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        final=final, plain_final=plain_final, **stats)
    if launches != 4 * 30:
        raise AssertionError(f"dd_path: {launches} windspeed launches, "
                             "not 4 tiles x 30 steps")
    # tests/test_engine_dd.py's statistical bounds against the plain run
    for var in ("lon_spread_m", "lat_spread_m"):
        rel = abs(final[var] - plain_final[var]) / plain_final[var]
        if rel >= 0.35:
            raise AssertionError(f"dd_path: {var} {final[var]} against "
                                 f"{plain_final[var]} plain")
    for var in ("z_mean", "z_std"):
        if abs(final[var] - plain_final[var]) >= 2.0:
            raise AssertionError(f"dd_path: {var} {final[var]} against "
                                 f"{plain_final[var]} plain")
    del o
    for k in kernels:
        k.launches = 0
    o = dd_simulation("cuda", n, model="constant")
    run_intervals(o, 1)
    profile_launches = mixing.visser_mixing_profile.launches
    check_tiled(o, n, 2, "dd_path constant")
    log("dd_path", model="constant", launches=profile_launches,
        windspeed_launches=mixing.visser_mixing.launches,
        **dd_run_stats(o, n, 10, o.timers["main loop"]))
    if profile_launches != 4 * 10:
        raise AssertionError(f"dd_path: {profile_launches} profile "
                             "launches, not 4 tiles x 10 steps")
    del o
    o = dd_simulation("cuda", n, tile_grid="2x2")
    secs = run_intervals(o, 1)
    check_tiled(o, n, 2, "dd_path 2x2")
    log("dd_path", model="windspeed_Large1994",
        **dd_run_stats(o, n, 10, secs))
    return launches, profile_launches, stats


def dd_against_plain(n=2_000_000):
    """Deterministic 2M-element runs (no mixing, no diffusion) tiled in 4
    Y bands and in 2 x 2 tiles against the plain run on the card, at the
    JAX package's own tolerance (tests/test_engine_dd.py)."""
    res = {}
    for grid in (None, "auto", "2x2"):
        if grid is None:
            o = simulation("cuda", n, "windspeed_Large1994", hdiff=0.0)
            o.set_config("drift:vertical_mixing", False)
        else:
            o = dd_simulation("cuda", n, grid, hdiff=0.0, mixing=False)
        secs = run_intervals(o, 1)
        if grid is not None:
            check_tiled(o, n, 2, f"dd_against_plain {grid}")
        res[grid] = ({v: np.asarray(o.result[v].values)
                      for v in ("lon", "lat", "status")}, secs)
        del o
    plain = res[None][0]
    for grid in ("auto", "2x2"):
        got, secs = res[grid]
        err = {v: float(np.nanmax(np.abs(got[v] - plain[v])))
               for v in ("lon", "lat")}
        same_status = bool(np.array_equal(got["status"], plain["status"]))
        log("dd_against_plain", tile_grid=grid, elements=n, steps=10,
            max_abs_err=err, status_equal=same_status, run_s=secs,
            plain_run_s=res[None][1])
        if not same_status or max(err.values()) > 2e-5:
            raise AssertionError(f"dd_against_plain {grid}: {err}, "
                                 f"status equal {same_status}")


def sharded_path(n=2_000_000, intervals=2):
    """Particle sharding over four tiles of the card at 2M elements, mixing
    and diffusion on: bit-equal to the plain run of the same seed."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    out = {}
    for sharded in (True, False):
        o = simulation("cuda", n, "windspeed_Large1994", hdiff=10.0)
        if sharded:
            o.set_mesh(DD_TILES)
        mixing.visser_mixing.launches = 0
        torch.cuda.reset_peak_memory_stats()
        secs = run_intervals(o, intervals)
        loop = o.timers["main loop"]
        readers = o.timers.get("main loop:readers", 0.0)
        assert (o._sharding is not None) == sharded
        out[sharded] = (
            {v: np.asarray(o.result[v].values)
             for v in ("lon", "lat", "z", "status")},
            {"run_s": secs, "particle_steps_per_s": n * 10 * intervals / secs,
             "particle_steps_per_s_steps_only":
                 n * 10 * intervals / (loop - readers),
             "launches": mixing.visser_mixing.launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del o
    equal = {v: bool(np.array_equal(out[True][0][v], out[False][0][v],
                                    equal_nan=True))
             for v in out[True][0]}
    log("sharded_path", elements=n, steps=10 * intervals, tiles=4,
        bit_equal=equal, sharded=out[True][1], plain=out[False][1])
    if not all(equal.values()):
        raise AssertionError(f"sharded_path: not bit-equal: {equal}")
    if out[True][1]["launches"] != 4 * 10 * intervals:
        raise AssertionError("sharded_path: the windspeed kernel did not "
                             "run once a tile and step")
    return out[True][1]


def dd_card_against_cpu(n=4096, intervals=2):
    """The tiled run with mixing and diffusion, small, on four tiles of the
    card and on four CPU tiles: every status equal, the slice tolerance."""
    small = dict(nx=60, ny=60, nz=16, nt=5)
    out = {}
    for device in ("cuda", "cpu"):
        o = dd_simulation(device, n, forcing_kw=small)
        o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
              time_step_output=9000)
        check_tiled(o, n, intervals + 1, f"dd_card_against_cpu {device}")
        out[device] = o.result
    same_status = bool(np.array_equal(out["cuda"]["status"].values,
                                      out["cpu"]["status"].values))
    errs = {}
    for var in ("lon", "lat", "z"):
        err, ok = agree(out["cuda"][var].values, out["cpu"][var].values,
                        SLICE_MEDIAN_ATOL[var], SLICE_OUTLIER_ATOL[var],
                        SLICE_OUTLIER_SHARE)
        errs[var] = err
        if not ok:
            raise AssertionError(f"dd card and CPU disagree on {var}: {err}")
    log("dd_card_vs_cpu", elements=n, intervals=intervals, tiles=4,
        status_equal=same_status, max_abs_err=errs)
    if not same_status:
        raise AssertionError("dd card and CPU differ in status")


def multiprocess_dd(workdir, n=4096):
    """The port's multi-process dry run on the card: 2 processes x 2 tiles
    of cuda:0 over gloo against one process of 4 tiles, both modes, and
    the sharded output; each child has a timeout, and any failure fails
    the phase."""
    outdir = os.path.join(workdir, "dryrun")
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "opendrift_tpu_torch.tools.multihost_dryrun",
         "--device", "cuda", "--processes", "2", "--tiles", "2",
         "--number", str(n), "--timeout", "240", "--outdir", outdir],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0 or "MULTIHOST DRYRUN OK" not in r.stdout:
        raise AssertionError("multiprocess_dd failed:\n" + r.stdout[-4000:]
                             + r.stderr[-4000:])
    report = json.loads([line for line in r.stdout.splitlines()
                         if line.startswith("{")][-1])
    log("multiprocess_dd", seconds=time.perf_counter() - t,
        why_gloo="NCCL refuses two ranks on one card; gloo stages the "
        "card's tensors through host copies", **report)


# ------------------------------------------------------------ phase 13 ----

ENTRY_LADDER_N = 1_000_000     # the ladder's default size
ENTRY_SCALING_N = 2_000_000    # scaling_bench elements a device
ENTRY_SMALL_N = 4096           # bench A, B, C card against CPU


def counted(fn, *args):
    """``fn(*args)``'s result and each mixing kernel's launches in it."""
    kernels = mixing_kernels()
    for k in kernels:
        k.launches = 0
    out = fn(*args)
    return out, {k.__name__: k.launches for k in kernels}


def entry_bench(nordic):
    """``python -m opendrift_tpu_torch.bench`` in-process on the card at
    its own sizes (A, B: 2M x 30 steps; D: 10M x 20; C: 500k, 10 outer
    steps of 500 s at 50 s substeps), on the file ``nordic``.  Checked:
    no workload failed (each one's active elements finite, D's
    included), the windspeed kernel once a step of C and no other
    kernel.  Returns the windspeed kernel's launches."""
    from opendrift_tpu_torch import bench
    from opendrift_tpu_torch.tools import json_lines
    (rc, lines), launches = counted(json_lines, bench.main,
                                    ["--nordic", nordic])
    (line,) = lines
    log("entry_bench", rc=rc, launches=launches, **line)
    if rc != 0 or line["failed_workloads"]:
        raise AssertionError(f"bench workloads failed (rc {rc}): "
                             f"{line['failed_workloads']}")
    ten_m = next(m for m in line["extra_metrics"] if m["id"] == "10m")
    if not ten_m["active_share"] > 0.5:
        raise AssertionError(f"10M run: active share {ten_m}")
    steps_c = bench.MIX_OUTER * (1 + bench.MIX_TRIALS * bench.MIX_REPS)
    want = {"visser_mixing": steps_c, "visser_mixing_profile": 0,
            "visser_mixing_oil": 0}
    if launches != want:
        raise AssertionError(f"bench launches {launches}, want {want}")
    return launches["visser_mixing"]


def entry_ladder(nordic, device="cuda", n=ENTRY_LADDER_N):
    """The five rungs of ``tools/ladder_bench.py`` at ``n`` elements, each
    a JSON line.  On the card: the windspeed kernel once a step in
    vertical_mixing, the oil kernel once a step in openoil, no kernel in
    the others.  Returns each rung's launches."""
    import torch
    from opendrift_tpu_torch.tools import ladder_bench
    steps = 30                  # _measure's: 1 untimed + 2 timed intervals
    out = {}
    for name in ladder_bench.RUNGS:
        rec, launches = counted(ladder_bench.run_rung, name, n,
                                torch.device(device), nordic)
        log("entry_ladder", launches=launches, **rec)
        want = {"visser_mixing": steps if name == "vertical_mixing" else 0,
                "visser_mixing_profile": 0,
                "visser_mixing_oil": steps if name == "openoil" else 0}
        if device == "cuda" and launches != want:
            raise AssertionError(f"rung {name}: launches {launches}, "
                                 f"want {want}")
        out[name] = launches
    return out


def entry_scaling(device="cuda", n=ENTRY_SCALING_N):
    """``tools/scaling_bench.py`` dp and tiles at d = 1 (the one card),
    ``n`` elements a device."""
    from opendrift_tpu_torch.tools import json_lines, scaling_bench
    _, lines = json_lines(scaling_bench.main,
                          ["--mode", "both", "--per-device", str(n),
                           "--devices", "1", "--device", device])
    for ln in lines:
        log("entry_scaling", **ln)
    if lines[-1]["devices"] != 1 or len(lines) != 3:
        raise AssertionError(f"scaling_bench: {lines}")
    return lines


def entry_card_against_cpu(nordic, n=ENTRY_SMALL_N, intervals=2):
    """Bench workloads A, B and C at ``n`` elements on the card and on the
    CPU from one seed: every status equal, lon/lat/z to the slice
    tolerance (B's z is NaN in both: it seeds ``z=None``)."""
    from opendrift_tpu_torch import bench
    cases = {
        "A": (lambda d: bench._build_grid_sim(False, n, nordic, d),
              900.0, bench.K, bench.K * intervals, ("lon", "lat", "z")),
        "B": (lambda d: bench._build_grid_sim(True, n, nordic, d),
              900.0, bench.K, bench.K * intervals, ("lon", "lat", "z")),
        "C": (lambda d: bench._mixing_sim(n, d), bench.MIX_DT,
              bench.MIX_OUTER, None, ("lon", "lat", "z"))}
    errs = {}
    for name, (build, dt, K, total, variables) in cases.items():
        finals = {}
        for device in ("cuda", "cpu"):
            state = bench.final_state(build(device), intervals, dt, K,
                                      total)
            finals[device] = {k: v.cpu().numpy()
                              for k, v in state.data.items()}
        got, want = finals["cuda"], finals["cpu"]
        if not np.array_equal(got["status"], want["status"]):
            raise AssertionError(f"bench {name}: statuses differ, card "
                                 "against CPU")
        errs[name] = {}
        for var in variables:
            err, ok = agree(got[var], want[var], SLICE_MEDIAN_ATOL[var],
                            SLICE_OUTLIER_ATOL[var], SLICE_OUTLIER_SHARE)
            errs[name][var] = err
            if not ok:
                raise AssertionError(f"bench {name}: card and CPU disagree "
                                     f"on {var}: {err}")
        errs[name]["active_share"] = float(np.mean(got["status"] == 0))
    log("entry_card_vs_cpu", elements=n, intervals=intervals,
        max_abs_err=errs)
    return errs


# long on the card: a 3D ROMS window packed every step on the host (basic,
# coastline_options, rungekutta_norkyst) or a 12-day run (larvalfish), 59 to
# 314 s each on an H100 (PERF.md §6); tests/test_torch_cuda.py's
# test_example_runs_on_its_default_device runs them on the card
LONG_EXAMPLES = ("example_basic", "example_coastline_options",
                 "example_larvalfish", "example_rungekutta_norkyst")


def entry_examples():
    """Every example of ``opendrift_tpu_torch/examples/`` but
    ``LONG_EXAMPLES`` in-process as a user runs it, with no argument, so on
    its default device, the card.  Logged for each: its seconds, the mixing
    kernels' launches in it and its last printed line; an example that
    raises fails the phase.  Returns each mixing kernel's launches over
    the examples run."""
    import importlib
    import pkgutil
    from opendrift_tpu_torch import examples
    names = sorted(m.name for m in pkgutil.iter_modules(examples.__path__)
                   if m.name.startswith("example_"))
    if len(names) != 28 or not set(LONG_EXAMPLES) <= set(names):
        raise AssertionError(f"{len(names)} examples, want 28: {names}")
    names = [n for n in names if n not in LONG_EXAMPLES]
    total = {}
    for name in names:
        module = importlib.import_module(f"opendrift_tpu_torch.examples."
                                         f"{name}")
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, launches = counted(module.main, [])
        printed = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        log("entry_examples", example=name,
            seconds=time.perf_counter() - t, launches=launches,
            last_line=printed[-1][:200] if printed else None)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    log("entry_examples", examples=len(names), left_out=LONG_EXAMPLES,
        launches=total)
    return total


def entry_points(workdir):
    """Phase 13: the scripts outside the model API on the card, on a
    Nordic-4km-like ROMS file written into ``workdir``.  Returns the
    windspeed and oil kernels' launches by path."""
    from opendrift_tpu_torch.tools import synthetic_nc
    nordic = synthetic_nc.write_roms(os.path.join(workdir, "nordic_like.nc"))
    paths = {"visser_mixing": {}, "visser_mixing_oil": {}}
    paths["visser_mixing"]["bench_mixing"] = entry_bench(nordic)
    ladder = entry_ladder(nordic)
    paths["visser_mixing"]["ladder_vertical_mixing"] = \
        ladder["vertical_mixing"]["visser_mixing"]
    paths["visser_mixing_oil"]["ladder_openoil"] = \
        ladder["openoil"]["visser_mixing_oil"]
    entry_scaling()
    entry_card_against_cpu(nordic)
    gallery = entry_examples()
    for name, count in gallery.items():
        paths.setdefault(name, {})["examples"] = count
    return paths


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from opendrift_tpu_torch.ops import gather, mixing, philox

    kind = torch.cuda.get_device_name(0)
    power = power_line()
    t = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        for built in [pool.submit(mixing.load_library),
                      pool.submit(gather.load_library),
                      pool.submit(philox.load_library)]:
            built.result()

    def ptxas(report):
        return [line.strip() for line in (report or "").splitlines()
                if "registers" in line or "spill" in line]
    log("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=power, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        build_s=time.perf_counter() - t, nvcc_flags=mixing.NVCC_FLAGS,
        gather_nvcc_flags=gather.NVCC_FLAGS, ptxas=ptxas(mixing.build_log),
        gather_ptxas=ptxas(gather.build_log),
        philox_nvcc_flags=philox.NVCC_FLAGS,
        philox_ptxas=ptxas(philox.build_log))

    seconds = {"build": time.perf_counter() - t}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(kind, power, t, seconds, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_phases(kind, power, t, seconds, workdir):
    """Every phase after the build, in order; the forcing files go into
    ``workdir``."""
    import torch

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t

    files = timed("write_files", write_files, workdir)
    files.update(timed("write_mesh_files", write_mesh_files, workdir))
    os.mkdir(os.path.join(workdir, "small"))
    small_files = write_files(os.path.join(workdir, "small"), small=True)
    small_files.update(write_mesh_files(os.path.join(workdir, "small"),
                                        small=True))
    log("files", **{k: {"path": os.path.basename(v),
                        "mb": os.path.getsize(v) / 1e6}
                    for k, v in files.items()})
    rows = timed("check_kernels", check_kernels, "cuda")
    rows["visser_mixing_oil"] = timed("check_oil_kernel", check_oil_kernel,
                                      "cuda")
    timed("check_ragged_sizes", check_ragged_sizes, "cuda")
    timed("check_profile_edges", check_profile_edges, "cuda")
    timed("quotient_sweep", quotient_sweep)
    timed("sass_phase", sass_phase, rows)
    rows.update(timed("check_gather_kernels", check_gather_kernels, "cuda"))
    rows["philox_bits"] = timed("check_philox", check_philox, "cuda")
    launches, stats = timed("main_path", main_path)
    launches["philox_bits"], _ = timed("rbg_path", rbg_path, stats)
    coast_launches, coast_stats = timed("coast_path", coast_path)
    netcdf_launches, netcdf_stats = timed("netcdf_path", netcdf_path, files)
    roms_launches, roms_stats = timed("roms_path", roms_path, files)
    mesh_launches, mesh_stats = timed("mesh_path", mesh_path, files)
    launches["visser_mixing_oil"], oil_stats = timed("oil_path", oil_path)
    geotiff_launches, geotiff_stats, gml_launches = timed(
        "geotiff_oil_path", geotiff_oil_path, workdir)
    plast_launches, plast_stats = timed("plast_path", plast_path)
    timed("leeway_path", leeway_path)
    timed("chemical_path", chemical_path, workdir)
    timed("radionuclide_path", radionuclide_path)
    timed("euler_field", euler_field)
    timed("ftle_path", ftle_path)
    for path, name, count, st in (
            ("main", "visser_mixing", launches["visser_mixing"], stats),
            ("oil", "visser_mixing_oil", launches["visser_mixing_oil"],
             oil_stats),
            ("geotiff", "visser_mixing_oil", geotiff_launches,
             geotiff_stats),
            ("coast", "visser_mixing", coast_launches, coast_stats),
            ("netcdf", "visser_mixing", netcdf_launches, netcdf_stats),
            ("roms", "visser_mixing_profile", roms_launches, roms_stats),
            ("mesh", "visser_mixing", mesh_launches, mesh_stats),
            ("plast", "visser_mixing", plast_launches, plast_stats)):
        mixing_s = rows[name]["ms"] * 1e-3 * count
        log("mixing_share", path=path, kernel=name, mixing_s=mixing_s,
            share_of_steps=mixing_s / (st["main_loop_s"] - st["readers_s"]))
    # the profile kernel's count is the sampler path's: reader-served
    # profiles, once a step (its 'constant' run above is logged there)
    o, launches["visser_mixing_profile"], sampler_stats = timed(
        "sampler_path", sampler_path)
    mixing_s = rows["visser_mixing_profile"]["ms"] * 1e-3 \
        * launches["visser_mixing_profile"]
    log("mixing_share", kernel="visser_mixing_profile", mixing_s=mixing_s,
        share_of_steps=mixing_s / (sampler_stats["main_loop_s"]
                                   - sampler_stats["readers_s"]))
    launches["gather_rows_async"], launches["gather_rows_smem"] = timed(
        "gather_ab_phase", gather_ab_phase, o)
    del o
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")
        rows[name]["launches"] = count
    # every path that launches each kernel, with its count in that path
    rows["visser_mixing"]["paths"] = {
        "main": launches["visser_mixing"], "coast": coast_launches,
        "netcdf": netcdf_launches, "mesh": mesh_launches,
        "plast": plast_launches}
    rows["visser_mixing_profile"]["paths"] = {
        "sampler": launches["visser_mixing_profile"], "roms": roms_launches}
    rows["visser_mixing_oil"]["paths"] = {
        "oil": launches["visser_mixing_oil"], "geotiff": geotiff_launches,
        "gml": gml_launches}
    for name in ("gather_rows_async", "gather_rows_smem"):
        rows[name]["paths"] = {"gather_ab": launches[name]}
    rows["philox_bits"]["paths"] = {"rbg_main": launches["philox_bits"]}
    for name, fn in (("prefetch_ab", prefetch_ab),
                     ("tiers_and_storages", tiers_and_storages),
                     ("generic_loop", generic_loop_phase),
                     ("card_against_cpu", card_against_cpu),
                     ("oil_card_against_cpu", oil_card_against_cpu),
                     ("sampler_card_against_cpu", sampler_card_against_cpu),
                     ("coast_card_against_cpu", coast_card_against_cpu),
                     ("zoo_card_against_cpu", zoo_card_against_cpu),
                     ("rbg_card_against_cpu", rbg_card_against_cpu),
                     ("parity_goldens", parity_goldens)):
        timed(name, fn)
    timed("netcdf_card_against_cpu", netcdf_card_against_cpu, small_files)
    timed("roms_card_against_cpu", roms_card_against_cpu, small_files)
    timed("mesh_card_against_cpu", mesh_card_against_cpu, small_files)
    timed("geotiff_card_against_cpu", geotiff_card_against_cpu, workdir)
    timed("scripts", scripts_phase, files)
    dd_launches, dd_profile_launches, dd_stats = timed(
        "dd_path", dd_path, stats["final"])
    rows["visser_mixing"]["paths"]["dd"] = dd_launches
    rows["visser_mixing_profile"]["paths"]["dd_constant"] = \
        dd_profile_launches
    mixing_s = rows["visser_mixing"]["ms"] * 1e-3 * dd_launches
    log("mixing_share", path="dd", kernel="visser_mixing",
        mixing_s=mixing_s, share_of_steps=mixing_s / (
            dd_stats["main_loop_s"] - dd_stats["readers_s"]))
    timed("dd_against_plain", dd_against_plain)
    rows["visser_mixing"]["paths"]["sharded"] = timed(
        "sharded_path", sharded_path)["launches"]
    timed("dd_card_against_cpu", dd_card_against_cpu)
    timed("multiprocess_dd", multiprocess_dd, workdir)
    for name, by_path in timed("entry_points", entry_points,
                               workdir).items():
        rows[name]["paths"].update(by_path)
    log("phase_seconds", total=time.perf_counter() - t, **seconds)

    kernels = [{k: v for k, v in row.items()
                if k not in ("bytes", "ops")}
               for row in rows.values()]
    print(json.dumps({"kernels": kernels}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
