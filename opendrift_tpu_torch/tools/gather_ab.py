"""A/B harness for the packed-row gather.

The sampling hot path of every gridded workload is a row gather,
``packed (R, C)[idx (N,)]``.  This tool, the counterpart of the JAX
package's ``tools/gather_ab.py``, measures the framework's gather against
the two hand-written kernels of ``ops/gather.py`` on the attached device:

  A. index_select        the run path (``take_rows``)
  D. index_select_blend  two gathers + a bilinear x blend, the sampler's
                         shape
  B. gather_rows_async   a ring of cp.async row copies per warp
  C. gather_rows_smem    the table resident in shared memory (only while
                         the table fits)

Usage: python -m opendrift_tpu_torch.tools.gather_ab [R] [C] [N]
           [--device cpu] [--tables FILE.pt]
           [--variant LABEL=SOURCE.cu[:FLAG,FLAG...]] ...
The default device is ``cuda``.  ``--tables`` adds the (label, table,
indices) triples of a file written with ``torch.save`` (say the sampler
path's real tables, ``chip_smoke.real_tables``) to the default inputs.
``--variant`` compares versions of ``csrc/row_gather.cu`` instead (the
parent commit's, unpacked with ``git archive``, or an edited copy, with
further ``nvcc`` flags where given): each is built with the package's
flags and its
``gather_rows_async`` launched directly beside the package's own
(``current``, first), held bit for bit against A, and timed in turns
there and back on every input, queued back to back (``device_ms``) and
one launch at a time (``ms``), one JSON line an input; the exit code is 1
if ``current`` differs from A.  B and C are each checked bit-equal to A
before they are timed; a kernel that fails to build, to launch or to agree
ends the program with a traceback.  Times are medians of 20 launches after
3 warm-up launches, by CUDA events on the card and by the host clock on
the CPU (where B and C take their plain version, so the lines compare
nothing but say that the path runs).  Each line gives rows/s, the GB/s of
a gather that reads a row for every index, ``N * (index bytes + 2 * row
bytes)``, and on the card the share of the bound: the least time at
3.35 TB/s for the indices, each distinct row once and the output.
"""

import argparse
import ctypes
import json
import os
import time

import numpy as np
import torch

from ..ops import cuda_build, gather
from .kernel_check import cuda_ms, device_ms

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def median_ms(fn, device, warmup=3, reps=20):
    """Median milliseconds of ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def bit_equal(a, b):
    """Equal bit for bit (NaN payloads and signed zeros included)."""
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return a.shape == b.shape and a.dtype == b.dtype \
        and bool(torch.equal(a.view(as_int), b.view(as_int)))


def run_ab(packed, idx, fx=None, label="", out=print, warmup=3, reps=20):
    """Time the four variants on ``packed`` (R, C) and ``idx`` (N,), both
    on one device; ``fx`` (N,) float32 are the blend weights of variant D
    (uniform from a seed when None; D is skipped for an integer table).
    Prints one line per variant through ``out`` and returns
    ``{variant: {...numbers...} or None}``."""
    device = packed.device
    rows, cols = packed.shape
    n = idx.shape[0]
    rb = cols * packed.element_size()
    bound = gather.gather_bound_bytes(packed, idx)
    bound_ms = bound["total"] / HBM_BYTES_PER_S * 1e3
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    out(f"{label}device: {device} ({clock})  table ({rows}, {cols}) "
        f"{str(packed.dtype).replace('torch.', '')} ({rows * rb / 1e6:.1f} "
        f"MB, {rb} B rows), N={n / 1e6:.3f}M {idx.dtype} indices, "
        f"{bound['distinct_rows']} distinct rows, bound on an H100 "
        f"{bound_ms:.4f} ms")
    results = {}

    def line(key, name, ms, gathers=1, equal=None):
        res = {"ms": ms, "rows_per_s": gathers * n / (ms * 1e-3),
               "gb_per_s": gathers * bound["traffic"] / (ms * 1e-3) / 1e9,
               "bound_ms": gathers * bound_ms,
               "bound_share": (gathers * bound_ms / ms
                               if device.type == "cuda" else None),
               "bit_equal": equal}
        share = f"{100 * res['bound_share']:5.1f}% of the bound" \
            if res["bound_share"] is not None else "no bound on the cpu"
        note = "" if equal is None else "  bit-equal to A"
        note += f" ({gathers} gathers)" if gathers > 1 else ""
        out(f"{label}{key} {name:<19}: {ms:9.4f} ms "
            f"{res['rows_per_s'] / 1e6:9.1f} M rows/s "
            f"{res['gb_per_s']:8.1f} GB/s  {share}{note}")
        results[key] = res

    ref = gather.gather_rows_plain(packed, idx)
    line("A", "index_select",
         median_ms(lambda: gather.gather_rows_plain(packed, idx), device,
                   warmup, reps))
    if packed.is_floating_point():
        if fx is None:
            fx = torch.as_tensor(
                np.random.default_rng(0).uniform(0, 1, n).astype(np.float32),
                device=device)
        w = fx[:, None]

        def blend():
            g0 = gather.gather_rows_plain(packed, idx)
            g1 = gather.gather_rows_plain(packed, idx + 1)
            return g0 * (1.0 - w) + g1 * w
        line("D", "index_select_blend", median_ms(blend, device, warmup, reps),
             gathers=2)
    else:
        results["D"] = None

    got = gather.gather_rows_async(packed, idx)
    if not bit_equal(got, ref):
        raise AssertionError("gather_rows_async differs from index_select")
    line("B", "gather_rows_async",
         median_ms(lambda: gather.gather_rows_async(packed, idx), device,
                   warmup, reps), equal=True)

    if rows * rb > gather.SMEM_TABLE_MAX_BYTES:
        out(f"{label}C gather_rows_smem   : table of {rows * rb} bytes "
            f"exceeds a block's {gather.SMEM_TABLE_MAX_BYTES} bytes of "
            "shared memory, skipped")
        results["C"] = None
    else:
        got = gather.gather_rows_smem(packed, idx)
        if not bit_equal(got, ref):
            raise AssertionError("gather_rows_smem differs from index_select")
        line("C", "gather_rows_smem",
             median_ms(lambda: gather.gather_rows_smem(packed, idx), device,
                       warmup, reps), equal=True)
    return results


def default_inputs(R, C, N, device):
    """The JAX tool's inputs (gather_ab.py:167-170): seed 0, a normal
    float32 table, int32 indices in [0, R - 1), uniform blend weights."""
    rng = np.random.default_rng(0)
    packed = torch.as_tensor(rng.normal(size=(R, C)).astype(np.float32),
                             device=device)
    idx = torch.as_tensor(rng.integers(0, R - 1, N).astype(np.int32),
                          device=device)
    fx = torch.as_tensor(rng.uniform(0, 1, N).astype(np.float32),
                         device=device)
    return packed, idx, fx


class Variant:
    """One built version of ``csrc/row_gather.cu`` (the package's own where
    ``source`` is None), its ``gather_rows_async`` launched directly."""

    def __init__(self, label, source=None, flags=()):
        self.label = label
        if source is None:
            self.path = gather.build_library()
        else:
            self.path, _ = cuda_build.build(
                os.path.abspath(source), [*gather.NVCC_FLAGS, *flags])
        self.lib = ctypes.CDLL(self.path)
        own = gather.load_library().gather_rows_async_launch
        self.lib.gather_rows_async_launch.argtypes = own.argtypes
        self.lib.gather_rows_async_launch.restype = ctypes.c_int

    def __call__(self, packed, idx):
        rows, row_bytes = gather._checked(packed, idx, self.label)
        out, _ = gather._launch("gather_rows_async_launch", packed, idx,
                                rows, row_bytes, self.label, lib=self.lib)
        return out


def compare_variants(variants, jobs, out=print):
    """Each variant against ``index_select`` bit for bit and timed in turns
    there and back on each (label, table, indices) of ``jobs``; one JSON
    line a job through ``out``.  Returns whether the first variant equals
    ``index_select`` everywhere."""
    ok = True
    for label, packed, idx in jobs:
        want = gather.gather_rows_plain(packed, idx)
        row_bytes = packed.shape[1] * packed.element_size()
        bound = gather.gather_bound_bytes(packed, idx)
        line = {"table": label, "shape": list(packed.shape),
                "dtype": str(packed.dtype), "index_dtype": str(idx.dtype),
                "indices": int(idx.shape[0]),
                "route": gather.gather_route(row_bytes, packed.data_ptr(),
                                             want.data_ptr()),
                "bound_ms": bound["total"] / HBM_BYTES_PER_S * 1e3,
                "bit_equal": {}, "device_ms": {}, "ms": {}}
        for v in variants:
            got = v(packed, idx)
            torch.cuda.synchronize()
            line["bit_equal"][v.label] = bit_equal(got, want)
        ok = ok and line["bit_equal"][variants[0].label]
        for v in [*variants, *reversed(variants)]:
            line["device_ms"].setdefault(v.label, []).append(
                device_ms(lambda: v(packed, idx)))
            line["ms"].setdefault(v.label, []).append(
                cuda_ms(lambda: v(packed, idx)))
        out(json.dumps(line))
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("R", nargs="?", type=int, default=250_000)
    ap.add_argument("C", nargs="?", type=int, default=24)
    ap.add_argument("N", nargs="?", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tables", default=None,
                    help="a torch.save file of (label, table, indices)")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=SOURCE.cu[:FLAG,FLAG...]")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(device)}")
    packed, idx, fx = default_inputs(args.R, args.C, args.N, device)
    jobs = [("tool_default", packed, idx)]
    if args.tables:
        jobs += [(label, table.to(device), lin.to(device))
                 for label, table, lin in torch.load(args.tables,
                                                     weights_only=True)]
    if args.variant:
        if device.type != "cuda":
            raise SystemExit("gather_ab: --variant needs a CUDA device")
        variants = [Variant("current")]
        for text in args.variant:
            label, _, rest = text.partition("=")
            source, _, flags = rest.partition(":")
            variants.append(Variant(label, source,
                                    [f for f in flags.split(",") if f]))
        return 0 if compare_variants(variants, jobs) else 1
    run_ab(packed, idx, fx)
    for label, table, lin in jobs[1:]:
        run_ab(table, lin, label=f"{label}: ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
