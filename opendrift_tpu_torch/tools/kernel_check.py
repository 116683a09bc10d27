"""The inputs the mixing kernels are checked and timed on, the comparison
they are held to, and the timers.

``chip_smoke.py``, the card-only tests (``tests/test_torch_cuda.py``) and
the A/B script of the kernel source (``mixing_ab.py`` at the root of the
repository) share them, so that a kernel is held to the same elements
wherever it is checked: the main path's ranges plus, for a small share of
the elements, a NaN seafloor, mixed layers thinner than 1 m and outside the
range of the reciprocal quotient, entrainment probabilities of 0 and 1.
"""

import subprocess

import numpy as np
import torch

PROFILE_LEVELS = 26
OIL_NAMES = ("z", "diam", "moving", "wind", "mld", "zmin", "p_ent", "d_cand",
             "zb", "kw", "kw2", "nu_w")
# the share of the elements given each edge case
EDGE_SHARE = 2e-3
# mixed-layer depths outside the range in which the Large1994 quotient goes
# through the reciprocal (csrc/visser_mixing.cu): those take the division
MLD_OUTSIDE = (0.0, 1e-40, 1e-7, 1e7, float("inf"), float("nan"))


def _edge_cases(arrays, n, seed):
    """A small share of the elements with a NaN seafloor, a mixed layer
    thinner than 1 m, and a mixed-layer depth that is zero, subnormal,
    tiny, huge, infinite or NaN."""
    r = np.random.default_rng(seed + 1000)
    pick = r.random(n)
    arrays["zmin"][pick < EDGE_SHARE] = np.nan
    thin = (pick >= EDGE_SHARE) & (pick < 2 * EDGE_SHARE)
    arrays["mld"][thin] = r.uniform(0.05, 1.0, int(thin.sum()))
    odd = (pick >= 2 * EDGE_SHARE) & (pick < 3 * EDGE_SHARE)
    arrays["mld"][odd] = r.choice(MLD_OUTSIDE, int(odd.sum()))


def kernel_inputs(n, device, seed=0, profiles=True, surface_share=0.05):
    """Per-element mixing inputs at the main path's ranges: depths over
    the top 30 m (5% exactly at the surface), a few frozen elements, small
    terminal velocities, winds to 20 m/s, mixed layers of 10-60 m,
    seafloors from 5 m (so reflections happen), IDs above 2^24; and the
    edge cases of :func:`_edge_cases`."""
    r = np.random.default_rng(seed)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < surface_share] = 0.0
    arrays = {
        "z": z, "moving": (r.random(n) > 0.02).astype(np.float64),
        "w": r.normal(0.0, 1e-4, n), "wind": r.uniform(0.0, 20.0, n),
        "mld": r.uniform(10.0, 60.0, n), "zmin": -r.uniform(5.0, 100.0, n)}
    elem = r.integers(1 << 24, (1 << 31) - 1, n, dtype=np.int64)
    seed_u32 = int(r.integers(0, 1 << 32))
    h = 2.0
    if profiles:
        # a 'constant'-like profile pair plus a depth-varying one: K falls
        # with depth, gradK its -d/d(level) over spacing h
        decay = np.exp(-np.arange(PROFILE_LEVELS) * h / 20.0)
        kprof = (1e-2 * decay[:, None] * r.uniform(0.5, 1.5, n)[None]).astype(
            np.float32)
        gradk = -np.gradient(kprof, axis=0) / h
    _edge_cases(arrays, n, seed)
    with np.errstate(over="ignore", under="ignore"):
        t = {k: torch.as_tensor(v.astype(np.float32), device=device)
             for k, v in arrays.items()}
    # where the seafloor is NaN the depth stays as drawn
    t["z"] = torch.where(t["z"] < t["zmin"], t["zmin"], t["z"])
    t["elem"] = torch.as_tensor(elem.astype(np.int32), device=device)
    if not profiles:
        return t, seed_u32, None
    t["Kprof"] = torch.as_tensor(kprof, device=device)
    t["gradK"] = torch.as_tensor(gradk.astype(np.float32), device=device)
    return t, seed_u32, h


# The profile kernel's edge cases (profile_edge_inputs): every block of the
# kernel has elements at the first and the last level; diffusivities of
# 1 m2/s that carry elements some 19 m (10 levels) a substep; 2 and 201
# levels (the smallest profile and the most the configuration allows); NaN
# depths beside NaN seafloors.
PROFILE_EDGE_CASES = ("level_extremes", "large_diffusivity", "levels_2",
                      "levels_201", "nan_depths")
PROFILE_DEPTH = 50.0       # drift:profile_depth's default (m)


def profile_edge_inputs(case, n, device, seed=5, block=256):
    """The inputs of :func:`kernel_inputs` with profiles of the edge
    ``case`` (one of ``PROFILE_EDGE_CASES``) over ``PROFILE_DEPTH`` m:
    returns (inputs, seed, level spacing h).  ``level_extremes`` puts the
    first two elements of every ``block`` (the kernel's block of elements)
    at the first and the last level."""
    levels = {"levels_2": 2, "levels_201": 201}.get(case, PROFILE_LEVELS)
    h = PROFILE_DEPTH / (levels - 1)
    t, seed_u32, _ = kernel_inputs(n, device, seed, profiles=False)
    r = np.random.default_rng(seed + 7)
    scale = 1.0 if case == "large_diffusivity" else 1e-2
    decay = np.exp(-np.arange(levels) * h / 20.0)
    kprof = scale * decay[:, None] * r.uniform(0.5, 1.5, n)[None]
    gradk = -np.gradient(kprof, axis=0) / h
    z, zmin = t["z"].cpu().numpy(), t["zmin"].cpu().numpy()
    if case == "level_extremes":
        z[0::block] = 0.0
        z[1::block] = -(levels - 1) * h
        zmin[1::block] = np.minimum(zmin[1::block], -100.0)
    if case == "nan_depths":
        pick = r.random(n)
        z[pick < 0.01] = np.nan
        zmin[(pick >= 0.01) & (pick < 0.02)] = np.nan
    t["z"] = torch.as_tensor(z, device=device)
    t["zmin"] = torch.as_tensor(zmin, device=device)
    t["Kprof"] = torch.as_tensor(kprof.astype(np.float32), device=device)
    t["gradK"] = torch.as_tensor(gradk.astype(np.float32), device=device)
    return t, seed_u32, h


def oil_kernel_inputs(n, device, seed=1, surface_share=0.3):
    """The further per-element inputs of the oil kernel, beside those of
    :func:`kernel_inputs`: 30% of the elements exactly at the surface,
    entrainment probabilities over (0, 0.3) so that entrainment happens
    (and 0 or 1 for a small share: never, and at every visit of the
    surface), diameters of 10 um to 2 mm with the schema's default 0 for a
    third, intrusion depths to 6 m, and the Tkalich factors of oils of 800
    to 990 kg/m3 in water of 1e-6 to 1.8e-6 m2/s."""
    r = np.random.default_rng(seed)
    t, seed_u32, _ = kernel_inputs(n, device, profiles=False)
    z = -r.uniform(0.0, 30.0, n)
    z[r.random(n) < surface_share] = 0.0
    diam = r.uniform(1e-5, 2e-3, n)
    diam[r.random(n) < 0.33] = 0.0
    rhopr = r.uniform(0.8, 0.99, n)
    nu_w = r.uniform(1e-6, 1.8e-6, n)
    p_ent = r.uniform(0.0, 0.3, n)
    arrays = {"z": z, "diam": diam, "p_ent": p_ent,
              "d_cand": r.uniform(1e-6, 3e-3, n), "zb": r.uniform(0.0, 6.0, n),
              "kw": 2.0 * 9.81 * (1.0 - rhopr) / (9.0 * nu_w),
              "kw2": np.sqrt(16.0 * 9.81 * (1.0 - rhopr) / 3.0),
              "nu_w": nu_w}
    pick = np.random.default_rng(seed + 1000).random(n)
    p_ent[pick < 5 * EDGE_SHARE] = 0.0
    p_ent[pick > 1.0 - 5 * EDGE_SHARE] = 1.0
    for k, v in arrays.items():
        t[k] = torch.as_tensor(v.astype(np.float32), device=device)
    t["z"] = torch.where(t["z"] < t["zmin"], t["zmin"], t["z"])
    return t, seed_u32


def same(a, b):
    """Equal by value (+0 and -0 count as equal), NaN where and only where
    the other is NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_err(a, b):
    """The largest difference where both are numbers (0.0 if nowhere)."""
    d = (a - b).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
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


def device_ms(fn, launches=20, reps=5, sleep_cycles=40_000_000):
    """Median milliseconds one ``fn()`` keeps the card busy: ``launches``
    calls are queued behind a spin of ``sleep_cycles`` clocks on the card,
    so that the host is ahead and the kernels run back to back, and timed
    as one stretch by CUDA events.  :func:`cuda_ms` times one call at a
    time and so includes the gap between two launches, and all the host
    needs for a call where that is longer than the kernel."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def sm_clock_mhz(fn, launches=400):
    """The SM clock ``nvidia-smi`` reports while ``fn`` keeps the card
    busy (MHz), or None where it cannot be read."""
    query = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    while query.poll() is None:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    out = query.stdout.read().strip().splitlines()
    try:
        return float(out[0])
    except (IndexError, ValueError):
        return None
