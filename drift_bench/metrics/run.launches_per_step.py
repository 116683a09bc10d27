"""run.launches_per_step: kernel launches a calculation step: the CUDA
launch calls in the trace's host events (runtime and driver API) that
start inside a ``main loop:advance`` span of ``models/base.py`` ``run``
(an interval's steps, and the final snapshot's), over the window's
forecasts' steps."""

import bisect

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
CATEGORY = "main loop:advance"


def read(record):
    t = record.trace
    if t is None:
        return None
    spans = sorted((s, e) for name, s, e in t._host if name == CATEGORY)
    steps = sum(f["steps"] for f in record.forecasts)
    if not spans or not steps:
        return None
    starts = [s for s, _ in spans]
    ends = [e for _, e in spans]
    launches = 0
    for name, s, _ in t._host:
        if name in LAUNCHES:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ends[i]:
                launches += 1
    return launches / steps if launches else None
