#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``opendrift_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing its own line:

1. device: the card's name and power limit, and the build of the CUDA
   kernels (one ``nvcc`` per source of ``opendrift_tpu_torch/csrc``, both
   started together);
2. kernels: each hand-written kernel (the windspeed, profile and oil
   mixing kernels, and the two row-gather kernels) against its plain
   PyTorch version on the card, at the main path's shapes (2M elements,
   15 substeps; 2M row indices), with its time, the plain version's time,
   its bound and, for the gathers, the one library call that computes the
   same function (``index_select``, which is also their plain version);
3. main path: ``OceanDrift(device="cuda")`` on a synthetic 3D z-level
   ``ArrayReader``, 2M elements, RK4 + Visser mixing (windspeed_Large1994,
   through the windspeed kernel), then a shorter run with the 'constant'
   diffusivity (through the profile kernel); each run is checked to have
   gone through its kernel, and one interval of the first is profiled
   (kernels by device time, the device's busy share);
4. oil path: ``OpenOil(device="cuda")`` on the same ocean extended with
   waves, temperature, salinity and a coast (a reader-served landmask),
   2M elements of GENERIC MEDIUM CRUDE seeded at the surface, RK4,
   evaporation, emulsification, dispersion and wave entrainment through
   the oil kernel; then one interval with the default 'environment'
   diffusivity model.  Checked: the oil kernel launched once a step and
   the windspeed kernel not at all, the mass budget closes, some oil is
   submerged, evaporated and stranded, no NaN where an element is valid;
   one interval is profiled;
5. sampler path: ``OceanDrift(device="cuda")`` on the same ocean with a 3D
   ``ocean_vertical_diffusivity`` and the coast, 2M elements, RK4 on one
   corner block a step (``drift:advection_single_fetch``), 'block'
   coastline bisection, 'environment' diffusivity through the profile
   kernel on reader-served profiles, the next window packed on the
   prefetch thread.  Checked: the profile kernel launched once a step and
   the windspeed kernel never, one corner-block gather a step, stranding,
   no NaN where an element is valid; one interval is profiled and
   ``get_profiles`` is timed;
   then the OceanDrift main path with and without the prefetch thread;
6. tiers and storages: one interval each on the 'x' tier (by the
   OPENDRIFT_XY_PAIR override, and by the budget) and the 'none' tier (the
   same field on grids refined until the table leaves the budget) and
   with ``packed_dtype`` 'float16x2' and 'float16', each held against the
   float32 'xyz' run of the same seed;
7. gather A/B: ``tools.gather_ab.run_ab`` on the tool's default table, on
   one that fits shared memory and on the sampler path's real tables and
   row indices (the run that counts the gather kernels' launches);
8. generic loop: one interval of OpenOil with ``TSprofiles`` and one of
   OceanDrift with ``use_pallas=False``;
9. card against CPU: the same small OceanDrift, OpenOil and sampler-path
   configurations on ``cuda`` and on ``cpu`` from one seed, held to the
   slice tolerance.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero.
"""

import json
import subprocess
import sys
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
# float32 expressions in the same order with no contracted multiply-adds,
# so they are expected to agree to the bit; the bound allows a rare
# nearest-level flip (round(|z|)) from a one-ulp difference
KERNEL_MEDIAN_ATOL = 1e-6        # m
KERNEL_OUTLIER_ATOL = 1e-4       # m
KERNEL_OUTLIER_SHARE = 1e-4
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


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def power_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------- phase 2 ----

def kernel_inputs(n, device, seed=0, profiles=True):
    """Per-element mixing inputs at the main path's ranges: depths over
    the top 30 m (5% exactly at the surface), a few frozen elements, small
    terminal velocities, winds to 20 m/s, mixed layers of 10-60 m,
    seafloors from 5 m (so reflections happen), IDs above 2^24."""
    import torch
    r = np.random.default_rng(seed)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < 0.05] = 0.0
    arrays = {
        "z": z, "moving": (r.random(n) > 0.02).astype(np.float64),
        "w": r.normal(0.0, 1e-4, n), "wind": r.uniform(0.0, 20.0, n),
        "mld": r.uniform(10.0, 60.0, n), "zmin": -r.uniform(5.0, 100.0, n)}
    t = {k: torch.as_tensor(v.astype(np.float32), device=device)
         for k, v in arrays.items()}
    t["z"] = torch.maximum(t["z"], t["zmin"])
    t["elem"] = torch.as_tensor(
        r.integers(1 << 24, (1 << 31) - 1, n, dtype=np.int64).astype(
            np.int32), device=device)
    seed_u32 = int(r.integers(0, 1 << 32))
    if not profiles:
        return t, seed_u32, None
    # a 'constant'-like profile pair plus a depth-varying one: K falls
    # with depth, gradK its -d/d(level) over spacing h
    L = PROFILE_LEVELS
    h = 2.0
    decay = np.exp(-np.arange(L) * h / 20.0)
    kprof = (1e-2 * decay[:, None] * r.uniform(0.5, 1.5, n)[None]).astype(
        np.float32)
    gradk = -np.gradient(kprof, axis=0) / h
    t["Kprof"] = torch.as_tensor(kprof, device=device)
    t["gradK"] = torch.as_tensor(gradk.astype(np.float32), device=device)
    return t, seed_u32, h


def oil_kernel_inputs(n, device, seed=1):
    """The further per-element inputs of the oil kernel, beside those of
    :func:`kernel_inputs`: 30% of the elements exactly at the surface,
    entrainment probabilities over (0, 0.3) so that entrainment happens,
    diameters of 10 um to 2 mm with the schema's default 0 for a third,
    intrusion depths to 6 m, and the Tkalich factors of oils of 800 to
    990 kg/m3 in water of 1e-6 to 1.8e-6 m2/s."""
    import torch
    r = np.random.default_rng(seed)
    t, seed_u32, _ = kernel_inputs(n, device, profiles=False)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < 0.3] = 0.0
    diam = r.uniform(1e-5, 2e-3, n)
    diam[r.random(n) < 0.33] = 0.0
    rhopr = r.uniform(0.8, 0.99, n)
    nu_w = r.uniform(1e-6, 1.8e-6, n)
    arrays = {"z": z, "diam": diam, "p_ent": r.uniform(0.0, 0.3, n),
              "d_cand": r.uniform(1e-6, 3e-3, n), "zb": r.uniform(0.0, 6.0, n),
              "kw": 2.0 * 9.81 * (1.0 - rhopr) / (9.0 * nu_w),
              "kw2": np.sqrt(16.0 * 9.81 * (1.0 - rhopr) / 3.0),
              "nu_w": nu_w}
    for k, v in arrays.items():
        t[k] = torch.as_tensor(v.astype(np.float32), device=device)
    t["z"] = torch.maximum(t["z"], t["zmin"])
    return t, seed_u32


def check_oil_kernel(device, n=N_KERNEL, ntimes=NTIMES, timed=True):
    """The oil mixing kernel against its plain version on ``device``, for
    the three windspeed models x keep_diam x mixing_at_surface: both
    outputs equal by value (``torch.equal``; +0 and -0 count as equal).
    Returns its row of the result line (Large1994, the main path's
    options), or the largest error when not ``timed``."""
    import torch
    from opendrift_tpu_torch.ops import mixing
    t, seed = oil_kernel_inputs(n, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    names = ("z", "diam", "moving", "wind", "mld", "zmin", "p_ent", "d_cand",
             "zb", "kw", "kw2", "nu_w")

    def oil(model, at_surface, keep_diam, plain):
        kw = dict(ntimes=ntimes, dt_mix=60.0, model=model, bg=1.2e-5,
                  mixing_at_surface=at_surface, keep_diam=keep_diam)
        args = [t[k] for k in names]
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
                err = float((kz - pz).abs().max())
                err_d = float((kd - pd).abs().max())
                equal = bool(torch.equal(kz, pz) and torch.equal(kd, pd))
                log("kernel_check", kernel="visser_mixing_oil", model=model,
                    mixing_at_surface=at_surface, keep_diam=keep_diam,
                    max_abs_err=err, max_abs_err_diameter=err_d, equal=equal,
                    entrained_share=float((kd != t["diam"]).float().mean()),
                    submerged_share=float((kz < 0).float().mean()))
                if not equal:
                    raise AssertionError(
                        f"visser_mixing_oil {model} differs from its plain "
                        f"version: z {err}, diameter {err_d}")
                worst = max(worst, err, err_d)
    if not timed:
        return worst
    model = "windspeed_Large1994"
    # 12 float arrays and the IDs read once, z and the diameter written once
    nbytes = n * (13 + 2) * 4
    nops = n * ntimes * (OPS_PER_SUBSTEP[model] + OIL_EXTRA_OPS)
    ms = cuda_ms(lambda: oil(model, False, False, False))
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
           "library_ms": None, "bytes": nbytes, "ops": nops}
    log("kernel_time", **row)
    return row


def check_kernels(device, n=N_KERNEL, ntimes=NTIMES, timed=True):
    """Every kernel against its plain version on ``device``; returns the
    kernel rows of the result line (the main-path configuration's times:
    windspeed_Large1994, no mixing at the surface)."""
    import torch
    from opendrift_tpu_torch.ops import mixing
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

    def profile(at_surface, plain, substeps=ntimes):
        kw = dict(ntimes=substeps, dt_mix=60.0, h=h,
                  mixing_at_surface=at_surface)
        args = (t["z"], t["moving"], t["w"], t["Kprof"], t["gradK"],
                t["zmin"])
        if plain:
            return mixing.visser_mixing_profile_plain(
                *args, t["elem"], seed, **kw)
        return mixing.visser_mixing_profile(*args, seed, elem=t["elem"], **kw)

    def profile_levels_visited():
        """How many (level, element) pairs of Kprof/gradK the profile
        kernel reads on this data: substep i reads the level nearest the
        depth after i substeps, the plain version's output at ntimes=i."""
        L = t["Kprof"].shape[0]
        visited = torch.zeros(t["Kprof"].shape, dtype=torch.bool,
                              device=device)
        for i in range(ntimes):
            z = t["z"] if i == 0 else profile(False, True, substeps=i)
            zi = torch.clip(torch.round(-z / h).to(torch.int64), 0, L - 1)
            visited.scatter_(0, zi[None], True)
        return int(visited.sum())

    for at_surface in (False, True):
        for model in mixing.WINDSPEED_MODELS:
            k = windspeed(model, at_surface, False)
            p = windspeed(model, at_surface, True)
            sync()
            err, ok = agree(k.cpu(), p.cpu(), KERNEL_MEDIAN_ATOL,
                            KERNEL_OUTLIER_ATOL, KERNEL_OUTLIER_SHARE)
            log("kernel_check", kernel="visser_mixing", model=model,
                mixing_at_surface=at_surface, max_abs_err=err,
                bit_equal=bool(torch.equal(k, p)))
            if not ok:
                raise AssertionError(f"visser_mixing {model} disagrees "
                                     f"with its plain version: {err}")
            errs["visser_mixing"] = max(errs["visser_mixing"], err)
        k = profile(at_surface, False)
        p = profile(at_surface, True)
        sync()
        err, ok = agree(k.cpu(), p.cpu(), KERNEL_MEDIAN_ATOL,
                        KERNEL_OUTLIER_ATOL, KERNEL_OUTLIER_SHARE)
        log("kernel_check", kernel="visser_mixing_profile",
            mixing_at_surface=at_surface, max_abs_err=err,
            bit_equal=bool(torch.equal(k, p)))
        if not ok:
            raise AssertionError(f"visser_mixing_profile disagrees with "
                                 f"its plain version: {err}")
        errs["visser_mixing_profile"] = max(errs["visser_mixing_profile"],
                                            err)
    if not timed:
        return errs

    model = "windspeed_Large1994"
    # bytes: 7 arrays of 4 B read once, z written once
    b1 = n * 8 * 4
    o1 = n * ntimes * OPS_PER_SUBSTEP[model]
    # the profile kernel reads 5 arrays of 4 B (z, moving, w, zmin, elem)
    # and writes z, plus K and gradK at each (level, element) this run's
    # data visits
    b2 = n * 6 * 4 + profile_levels_visited() * 2 * 4
    o2 = n * ntimes * OPS_PER_SUBSTEP["profile"]
    for name, run, nbytes, nops, line in (
            ("visser_mixing", lambda p: windspeed(model, False, p), b1, o1,
             313),
            ("visser_mixing_profile", lambda p: profile(False, p), b2, o2,
             394)):
        ms = cuda_ms(lambda: run(False))
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
            "library_ms": None, "bytes": nbytes, "ops": nops}
        log("kernel_time", **rows[name])
    return rows


def gather_row(name, line, ms, plain_ms, bound, err):
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
            "bytes": bound["total"], "ops": 0}


def check_gather_kernels(device, n=2_000_000, timed=True):
    """Both row-gather kernels against ``gather_rows_plain`` on ``device``,
    bit for bit: (a) the A/B tool's default table (the shared-memory
    kernel must refuse it), (b) a table that fits shared memory, (c) a
    float16 table, 10-byte rows and row widths that are no multiple of 16
    bytes (88: 8-byte copies, 92: 4-byte copies), (d) the ragged tail and
    out-of-range indices.  Returns the two
    rows of the result line: the cp.async kernel at (a), the shared-memory
    kernel at (b)."""
    import torch
    from opendrift_tpu_torch.ops import gather
    from opendrift_tpu_torch.tools import gather_ab
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    r = np.random.default_rng(0)
    small = max(n // 1000, 8)
    cases = [("default", 125 * small, 24, n, np.float32, np.int32),
             ("fits_smem", small, 24, n, np.float32, np.int32),
             ("float16", small, 48, n // 4, np.float16, np.int64),
             ("rows_10B", small, 5, n // 4, np.float16, np.int32),
             ("rows_88B", 125 * small, 22, n // 4, np.float32, np.int64),
             ("rows_92B", 125 * small, 23, n // 4, np.float32, np.int32),
             ("ragged", 40 * small, 88, n + 3, np.float32, np.int64)]
    rows = {}
    for label, R, C, N, dtype, itype in cases:
        table = r.normal(size=(R, C)).astype(dtype)
        table[0, 0] = np.nan
        table[1, 0] = -0.0
        lo, hi = (-3, R + 3) if label == "ragged" else (0, R - 1)
        packed = torch.as_tensor(table, device=device)
        idx = torch.as_tensor(r.integers(lo, hi, N).astype(itype),
                              device=device)
        want = gather.gather_rows_plain(packed, idx)
        got = gather.gather_rows_async(packed, idx)
        sync()
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
            index_dtype=np.dtype(itype).name, bit_equal=equal,
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
            row = gather_row(name, line, ms, plain_ms, bound, 0.0)
            log("kernel_time", case=label, **row)
            if (name, label) in (("gather_rows_async", "default"),
                                 ("gather_rows_smem", "fits_smem")):
                rows[name] = row
    return rows


# ------------------------------------------------------------- phase 3 ----

def forcing(seed=0, nx=200, ny=200, nz=16, nt=5):
    """A synthetic z-level ocean: time-varying 3D currents decaying with
    depth, 2D winds and a static seafloor depth, on a 0.02 x 0.01 degree
    lat/lon grid off western Norway, frames every 3 hours."""
    r = np.random.default_rng(seed)
    x = np.linspace(3.0, 3.0 + 0.02 * (nx - 1), nx)
    y = np.linspace(59.0, 59.0 + 0.01 * (ny - 1), ny)
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


def run_main_path(n, intervals, model):
    """One user-level run on the card; returns (simulation, seconds)."""
    import torch
    o = simulation("cuda", n, model, hdiff=10.0)
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


def profile_interval(o, top=10, phase="profile"):
    """Where one output interval (K = 10 steps) of the main path spends
    its time on the card: the kernels by device time, and the device's
    busy share of the interval's wall time (torch.profiler).  Not part of
    the run whose launches are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    advance, _, state, key = o.prepare_run(900.0, 10, total_steps=10)
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
                 n * steps / (loop_s - readers_s)}
    log("main_path", model="windspeed_Large1994", ocean_tier=sampler,
        wind_tier=wind_tier, active_share=active,
        launches=launches["visser_mixing"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **stats)
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


def oil_simulation(device, n, model=None, seed=0, forcing_kw=None):
    """An OpenOil run of ``n`` elements set up as a user would: GENERIC
    MEDIUM CRUDE, 100 m3 released at the surface within a radius some
    kilometres off the coast, RK4, dt = 900 s with 60 s mixing substeps,
    evaporation, emulsification and dispersion on (the defaults), the
    default current and wind uncertainty, stranding at the reader's
    coast.  ``model=None`` keeps the default 'environment' diffusivity
    model, which no reader serves here."""
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
    nx = len(x)
    coast = nx - max(2, COAST_CELLS * nx // 200)
    cell_m = (x[1] - x[0]) * 111320.0 * np.cos(np.radians(y.mean()))
    # two standard deviations of the release radius west of the coast
    centre = float(x[coast] - 2.0 * 4000.0 / cell_m * (x[1] - x[0]))
    o.seed_elements(lon=centre, lat=float(y[len(y) // 2]), radius=4000.0,
                    number=n, time=times[0], z=0.0, m3_per_hour=100.0,
                    oil_type="GENERIC MEDIUM CRUDE")
    return o


def check_oil_result(o, n, frames):
    """The oil run's own checks; returns the numbers it logs."""
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
    for key in ("evaporated_share", "submerged_share", "stranded_share"):
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


def prefetch_ab(n=2_000_000, intervals=3):
    """The OceanDrift main path with the next window packed on the worker
    thread and with every window packed by the main thread, in turns (with,
    without, without, with): what the thread does to the whole run and to
    the steps, whose kernel launches share the interpreter with it."""
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


# -------------------------------------------- tiers and storages ----------

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


def card_against_cpu(n=4096, intervals=2):
    """The same small run on the card and on the CPU, from one seed."""
    out = {}
    small = dict(nx=60, ny=60, nz=16, nt=5)
    for device in ("cuda", "cpu"):
        o = simulation(device, n, "windspeed_Large1994", hdiff=0.0,
                       forcing_kw=small)
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
    log("card_vs_cpu", elements=n, intervals=intervals, max_abs_err=errs)
    return errs


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

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from opendrift_tpu_torch.ops import gather, mixing

    kind = torch.cuda.get_device_name(0)
    power = power_line()
    t = time.perf_counter()
    # one nvcc per source, both started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        for built in [pool.submit(mixing.load_library),
                      pool.submit(gather.load_library)]:
            built.result()

    def ptxas(report):
        return [line.strip() for line in (report or "").splitlines()
                if "registers" in line or "spill" in line]
    log("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=power, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        build_s=time.perf_counter() - t, nvcc_flags=mixing.NVCC_FLAGS,
        gather_nvcc_flags=gather.NVCC_FLAGS, ptxas=ptxas(mixing.build_log),
        gather_ptxas=ptxas(gather.build_log))

    rows = check_kernels("cuda")
    rows["visser_mixing_oil"] = check_oil_kernel("cuda")
    rows.update(check_gather_kernels("cuda"))
    launches, stats = main_path()
    launches["visser_mixing_oil"], oil_stats = oil_path()
    for name, st in (("visser_mixing", stats),
                     ("visser_mixing_oil", oil_stats)):
        mixing_s = rows[name]["ms"] * 1e-3 * launches[name]
        log("mixing_share", kernel=name, mixing_s=mixing_s,
            share_of_steps=mixing_s / (st["main_loop_s"] - st["readers_s"]))
    # the profile kernel's count is the sampler path's: reader-served
    # profiles, once a step (its 'constant' run above is logged there)
    o, launches["visser_mixing_profile"], sampler_stats = sampler_path()
    mixing_s = rows["visser_mixing_profile"]["ms"] * 1e-3 \
        * launches["visser_mixing_profile"]
    log("mixing_share", kernel="visser_mixing_profile", mixing_s=mixing_s,
        share_of_steps=mixing_s / (sampler_stats["main_loop_s"]
                                   - sampler_stats["readers_s"]))
    launches["gather_rows_async"], launches["gather_rows_smem"] = \
        gather_ab_phase(o)
    del o
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")
        rows[name]["launches"] = count
    prefetch_ab()
    tiers_and_storages()
    generic_loop_phase()
    card_against_cpu()
    oil_card_against_cpu()
    sampler_card_against_cpu()

    kernels = [{k: v for k, v in row.items() if k not in ("bytes", "ops")}
               for row in rows.values()]
    print(json.dumps({"kernels": kernels}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
