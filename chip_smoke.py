#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``opendrift_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing its own line:

1. device: the card's name and power limit, and the build of the CUDA
   kernels (``nvcc`` from ``opendrift_tpu_torch/csrc``);
2. kernels: each hand-written kernel (the windspeed, profile and oil
   mixing kernels) against its plain PyTorch version on the card, at the
   main path's shapes (2M elements, 15 substeps), with its time, the plain
   version's time and its bound;
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
5. card against CPU: the same small OceanDrift and OpenOil configurations
   on ``cuda`` and on ``cpu`` from one seed, held to the slice tolerance.

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


# ---------------------------------------------------------------- main ----

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from opendrift_tpu_torch.ops import mixing

    kind = torch.cuda.get_device_name(0)
    power = power_line()
    t = time.perf_counter()
    mixing.load_library()
    log("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=power, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        build_s=time.perf_counter() - t, nvcc_flags=mixing.NVCC_FLAGS,
        ptxas=[line.strip() for line in (mixing.build_log or "").splitlines()
               if "registers" in line or "spill" in line])

    rows = check_kernels("cuda")
    rows["visser_mixing_oil"] = check_oil_kernel("cuda")
    launches, stats = main_path()
    launches["visser_mixing_oil"], oil_stats = oil_path()
    for name, count in launches.items():
        rows[name]["launches"] = count
    for name, st in (("visser_mixing", stats),
                     ("visser_mixing_oil", oil_stats)):
        mixing_s = rows[name]["ms"] * 1e-3 * launches[name]
        log("mixing_share", kernel=name, mixing_s=mixing_s,
            share_of_steps=mixing_s / (st["main_loop_s"] - st["readers_s"]))
    card_against_cpu()
    oil_card_against_cpu()

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
