"""The window assembly kernel (``ops/pack.py`` ``pack_window``,
``csrc/pack_window.cu``) on the attached device: bit equality with its
plain version and the times of both, one JSON line a case.

Usage: python -m opendrift_tpu_torch.tools.pack_ab [--device cpu]
           [--case NAME ...]

The cases are the benchmark forecast's tables (``norkyst``: 16 levels,
300 x 260 cells, u and v at three frames, the sea floor and the land mask,
the 'xy' pairs with the u/v companion; ``arome``: the wind's 2D 'xy'
table) and variants of them ('xyz', float16, two members, an odd column
count that takes the scalar stores).  A line gives ``equal`` (every table
byte-equal to :func:`~opendrift_tpu_torch.ops.pack.assemble_rows_plain`),
``ms`` (one call at a time between CUDA events), ``device_ms`` (calls
queued back to back), ``plain_ms``, the bytes the tables hold and the
frames' bytes, and ``bound_ms``: those bytes written and read once at
3.35 TB/s, with ``roofline`` the bound over ``device_ms`` in percent.  On
the CPU both versions are the plain one and no time is a device time.
The exit code is 1 if a case is not equal.
"""

import argparse
import json
import sys
import time

import torch

from ..ops import pack
from ..ops.interp import PackedSampler
from .kernel_check import cuda_ms, device_ms

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
# name: (members, planes, rows, columns, time variables, frames, statics,
#        pair mode, dtype, u/v companion)
CASES = {
    "norkyst": (1, 16, 300, 260, 2, 3, 2, "xy", torch.float32, True),
    "norkyst_xyz": (1, 16, 300, 260, 2, 3, 2, "xyz", torch.float32, True),
    "norkyst_f16": (1, 16, 300, 260, 2, 3, 2, "xy", torch.float16, True),
    "norkyst_m2": (2, 16, 300, 260, 2, 3, 2, "xy", torch.float32, True),
    "arome": (1, 1, 140, 160, 2, 3, 0, "xy", torch.float32, False),
    "odd_columns": (1, 5, 37, 29, 2, 3, 1, "x", torch.float16, True),
}


def window_inputs(members, Z, ny, nx, nvars, F, statics, companion, device,
                  seed=0):
    """Random frames of a window on ``device``: per member ``nvars`` 3D
    variables (Z > 1; else 2D) at ``F`` frames and ``statics`` 2D fields,
    and the tables' base columns (``pack_window``'s ``tables``): the full
    table, and with ``companion`` the first two variables' frames."""
    g = torch.Generator().manual_seed(seed)
    shape = (Z, ny, nx) if Z > 1 else (ny, nx)
    srcs, full, uv = [], [], []
    for _ in range(members):
        cols = []
        for _ in range(nvars * F):
            cols.append(len(srcs))
            srcs.append(torch.randn(shape, generator=g))
        for _ in range(statics):
            cols.append(len(srcs))
            srcs.append(torch.rand((ny, nx), generator=g) * 100.0)
        full.append(cols)
        uv.append(cols[:2 * F])
    tables = [full, uv] if companion else [full]
    return [s.to(device) for s in srcs], tables


def case_inputs(name, device):
    """A case's frames and tables on ``device`` and the rest of
    ``pack_window``'s arguments: (srcs, tables, (Z, ny, nx, k, dtype))."""
    M, Z, ny, nx, nvars, F, statics, mode, dtype, companion = CASES[name]
    srcs, tables = window_inputs(M, Z, ny, nx, nvars, F, statics, companion,
                                 device)
    return srcs, tables, (Z, ny, nx, PackedSampler.PAIR_FACTOR[mode], dtype)


def bytes_equal(a, b):
    """Two tables equal bit for bit (2-byte words compared)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


def run_case(name, device):
    srcs, tables, args = case_inputs(name, device)

    def kernel():
        return pack.pack_window(srcs, tables, *args)

    def plain():
        return [pack.assemble_rows_plain(srcs, cols, *args)
                for cols in tables]
    got, want = kernel(), plain()
    equal = all(bytes_equal(a, b) for a, b in zip(got, want))
    table_bytes = sum(t.numel() * t.element_size() for t in got)
    frame_bytes = sum(s.numel() * s.element_size() for s in srcs)
    line = {"case": name, "device": str(device), "equal": equal,
            "shapes": [list(t.shape) for t in got], "dtype": str(args[-1]),
            "table_bytes": table_bytes, "frame_bytes": frame_bytes}
    if device.type == "cuda":
        before = pack.pack_window.launches
        kernel()
        line["launches_a_call"] = pack.pack_window.launches - before
        bound = (table_bytes + frame_bytes) / HBM_BYTES_PER_S * 1e3
        line.update(ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                    plain_ms=cuda_ms(plain), bound_ms=bound,
                    write_bound_ms=table_bytes / HBM_BYTES_PER_S * 1e3)
        line["roofline"] = 100.0 * bound / line["device_ms"]
    else:
        t0 = time.perf_counter()
        plain()
        line["host_plain_s"] = time.perf_counter() - t0
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", action="append", choices=sorted(CASES))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.init()
        print(json.dumps({"card": torch.cuda.get_device_name(device)}))
    ok = True
    for name in args.case or list(CASES):
        line = run_case(name, device)
        ok &= line["equal"]
        print(json.dumps(line), flush=True)
    if device.type == "cuda":
        print(json.dumps({"build_log": pack.build_log}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
