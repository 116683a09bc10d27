#!/usr/bin/env python3
"""A/B of versions of the mixing kernels' source on one CUDA card.

    python3 mixing_ab.py [--variant LABEL=SOURCE.cu[:FLAG,FLAG...]] ...
        [--n N] [--ntimes T] [--surface-share S] [--skip-timing]
        [--out FILE.json] [--listing-dir DIR]

A developer's tool, not part of the package: it answers "is this version of
``opendrift_tpu_torch/csrc/visser_mixing.cu`` faster than that one, and
still equal to the plain versions".  Every variant is a version of that
file with the same C interface: another file (say the parent commit's,
unpacked with ``git archive``, or a copy with one line changed) or the same
file with further ``nvcc`` flags.  The label ``current`` (always there,
first) is the package's own source.  Each variant is built with the
package's flags, launched directly (no wrapper), held against the plain
versions of ``ops/mixing.py`` on the check inputs of
``tools/kernel_check.py`` (the windspeed kernel for 3 models x
``mixing_at_surface``, the oil kernel also x ``keep_diam``, the profile
kernel x ``mixing_at_surface`` on those inputs and on its edge cases;
equal by value, NaN where the other is NaN), then timed in turns there and
back (v1, v2, ..., v2, v1) at N elements and T substeps for every model,
the oil kernel with and without ``keep_diam``, and the profile kernel:
queued back to back (``device_ms``) and one launch at a time
(``cuda_ms``).  With a ``cuobjdump`` the substep loop's SASS counts and
issue bound of each variant follow (``tools/sass.py``).  One JSON line a
result.  The exit code is 1 if ``current`` differs from a plain version
(what another variant does is in its line only), 0 otherwise.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from opendrift_tpu_torch.ops import cuda_build, mixing
from opendrift_tpu_torch.tools import sass
from opendrift_tpu_torch.tools.kernel_check import (
    OIL_NAMES, PROFILE_EDGE_CASES, cuda_ms, device_ms, kernel_inputs,
    oil_kernel_inputs, profile_edge_inputs, same, sm_clock_mhz)

LAUNCHERS = ("visser_mixing_launch", "visser_mixing_oil_launch",
             "visser_mixing_profile_launch")
PROFILE_NAMES = ("z", "moving", "w", "Kprof", "gradK", "zmin", "elem")


class Variant:
    """One built version of the kernels' source, launched directly."""

    def __init__(self, label, source=None, flags=()):
        self.label = label
        if source is None:
            self.path = mixing.build_library()
            report = mixing.build_log
        else:
            self.path, report = cuda_build.build(
                source, [*mixing.NVCC_FLAGS, *flags])
        self.ptxas = [line.strip() for line in (report or "").splitlines()
                      if "registers" in line or "spill" in line]
        self.lib = ctypes.CDLL(self.path)
        own = mixing.load_library()
        for name in LAUNCHERS:
            getattr(self.lib, name).argtypes = getattr(own, name).argtypes
            getattr(self.lib, name).restype = ctypes.c_int

    def windspeed(self, t, seed, model, at_surface, ntimes, dt_mix=60.0,
                  bg=1.2e-5):
        out = torch.empty_like(t["z"])
        rc = self.lib.visser_mixing_launch(
            *(t[k].data_ptr() for k in ("z", "moving", "w", "wind", "mld",
                                        "zmin", "elem")), seed, ntimes,
            dt_mix, mixing.WINDSPEED_MODELS.index(model), bg,
            int(at_surface), t["z"].shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(rc, f"{self.label}: visser_mixing")
        return out

    def oil(self, t, seed, model, at_surface, keep_diam, ntimes, dt_mix=60.0,
            bg=1.2e-5):
        z_out = torch.empty_like(t["z"])
        diam_out = torch.empty_like(t["z"])
        rc = self.lib.visser_mixing_oil_launch(
            *(t[k].data_ptr() for k in OIL_NAMES), t["elem"].data_ptr(), seed,
            ntimes, dt_mix, mixing.WINDSPEED_MODELS.index(model), bg,
            int(at_surface), int(keep_diam), t["z"].shape[0],
            z_out.data_ptr(), diam_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(rc, f"{self.label}: visser_mixing_oil")
        return z_out, diam_out

    def profile(self, t, seed, h, at_surface, ntimes, dt_mix=60.0):
        out = torch.empty_like(t["z"])
        rc = self.lib.visser_mixing_profile_launch(
            *(t[k].data_ptr() for k in PROFILE_NAMES), seed, ntimes, dt_mix,
            h, t["Kprof"].shape[0], int(at_surface), t["z"].shape[0],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(rc, f"{self.label}: visser_mixing_profile")
        return out


def profile_cases(t, seed, h, n_edge):
    """(case, inputs, seed, h) the profile kernel is checked on: the check
    inputs and each edge case at ``n_edge`` elements."""
    cases = [("check", t, seed, h)]
    for case in PROFILE_EDGE_CASES:
        cases.append((case, *profile_edge_inputs(case, n_edge, "cuda")))
    return cases


def check_variant(v, t, seed, to, oil_seed, ntimes, profiles):
    """{case: equal} of a variant against the plain versions; ``profiles``
    from :func:`profile_cases`."""
    equal = {}
    for case, tp, sp, h in profiles:
        for at_surface in (False, True):
            want = mixing.visser_mixing_profile_plain(
                *(tp[k] for k in PROFILE_NAMES), sp, ntimes=ntimes,
                dt_mix=60.0, h=h, mixing_at_surface=at_surface)
            got = v.profile(tp, sp, h, at_surface, ntimes)
            equal[f"K2 {case} surface={at_surface}"] = same(got, want)
    kw = dict(ntimes=ntimes, dt_mix=60.0, bg=1.2e-5)
    for model in mixing.WINDSPEED_MODELS:
        for at_surface in (False, True):
            want = mixing.visser_mixing_plain(
                *(t[k] for k in ("z", "moving", "w", "wind", "mld", "zmin",
                                 "elem")), seed, model=model,
                mixing_at_surface=at_surface, **kw)
            got = v.windspeed(t, seed, model, at_surface, ntimes)
            equal[f"K1 {model} surface={at_surface}"] = same(got, want)
            for keep in (False, True):
                want = mixing.visser_mixing_oil_plain(
                    *(to[k] for k in OIL_NAMES), to["elem"], oil_seed,
                    model=model, mixing_at_surface=at_surface,
                    keep_diam=keep, **kw)
                got = v.oil(to, oil_seed, model, at_surface, keep, ntimes)
                equal[f"K3 {model} surface={at_surface} keep={keep}"] = \
                    same(got[0], want[0]) and same(got[1], want[1])
    torch.cuda.synchronize()
    return equal


def run(variants, n, ntimes, surface_share=0.3, out=print, timed=True,
        listing_dir=None, n_edge=200_003):
    """Check, time (unless not ``timed``) and count every variant; returns
    whether the first variant equals the plain versions."""
    t, seed, h = kernel_inputs(n, "cuda")
    to, oil_seed = oil_kernel_inputs(n, "cuda", surface_share=surface_share)
    profiles = profile_cases(t, seed, h, n_edge)
    ok = True
    for v in variants:
        equal = check_variant(v, t, seed, to, oil_seed, ntimes, profiles)
        bad = [k for k, e in equal.items() if not e]
        if v is variants[0]:
            ok = not bad
        out(json.dumps({"variant": v.label, "library": v.path,
                        "ptxas": v.ptxas, "cases": len(equal),
                        "differs": bad}))
    mhz = sm_clock_mhz(lambda: variants[0].oil(
        to, oil_seed, "windspeed_Large1994", False, False, ntimes))
    out(json.dumps({"sm_clock_mhz_under_load": mhz,
                    "surface_share_oil": surface_share}))
    there_and_back = [*variants, *reversed(variants)]
    for model in mixing.WINDSPEED_MODELS if timed else ():
        runs = {"K1": lambda v: v.windspeed(t, seed, model, False, ntimes),
                "K3": lambda v: v.oil(to, oil_seed, model, False, False,
                                      ntimes),
                "K3_keep_diam": lambda v: v.oil(to, oil_seed, model, False,
                                                True, ntimes)}
        times = {"model": model, "n": n, "ntimes": ntimes}
        for v in there_and_back:
            for name, fn in runs.items():
                times.setdefault(name + "_device_ms", {}).setdefault(
                    v.label, []).append(device_ms(lambda: fn(v)))
                times.setdefault(name + "_ms", {}).setdefault(
                    v.label, []).append(cuda_ms(lambda: fn(v)))
        out(json.dumps(times))
    if timed:
        times = {"kernel": "K2", "n": n, "ntimes": ntimes,
                 "levels": t["Kprof"].shape[0]}
        for v in there_and_back:
            def run_k2():
                return v.profile(t, seed, h, False, ntimes)
            times.setdefault("K2_device_ms", {}).setdefault(
                v.label, []).append(device_ms(run_k2))
            times.setdefault("K2_ms", {}).setdefault(v.label, []).append(
                cuda_ms(run_k2))
        out(json.dumps(times))
    for v in variants:
        listing = listing_dir and os.path.join(listing_dir,
                                               f"{v.label}.sass")
        out(json.dumps({"variant": v.label, "sass": sass.mixing_report(
            v.path, n, ntimes, mhz, listing)}))
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=SOURCE.cu[:FLAG,FLAG...]")
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--ntimes", type=int, default=15)
    ap.add_argument("--surface-share", type=float, default=0.3)
    ap.add_argument("--skip-timing", action="store_true",
                    help="build, check and count only")
    ap.add_argument("--out", default=None)
    ap.add_argument("--listing-dir", default=None,
                    help="write each variant's SASS listing there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mixing_ab: no CUDA device", file=sys.stderr)
        return 1
    lines = []

    def out(line):
        print(line, flush=True)
        lines.append(line)
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    out(json.dumps({"card": name.stdout.strip(),
                    "torch": torch.__version__}))
    variants = [Variant("current")]
    for text in args.variant:
        label, _, rest = text.partition("=")
        source, _, flags = rest.partition(":")
        variants.append(Variant(label, os.path.abspath(source),
                                [f for f in flags.split(",") if f]))
    if args.listing_dir:
        os.makedirs(args.listing_dir, exist_ok=True)
    ok = run(variants, args.n, args.ntimes, args.surface_share, out,
             timed=not args.skip_timing, listing_dir=args.listing_dir)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
