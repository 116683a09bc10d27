"""oil.weathering_launches_per_step: kernel launches a calculation step of
OpenOil's weathering: the CUDA launch calls in the trace's host events
(runtime and driver API) that start inside a ``main
loop:advance:weathering`` span (``models/openoil/openoil.py``
``update``: the emulsion's density and viscosity, evaporation,
emulsification, dispersion, biodegradation), over the window's
forecasts' steps, counted as ``run.launches_per_step`` counts."""

import bisect

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
CATEGORY = "main loop:advance:weathering"


def launches_per_step(record, category):
    """Launch calls inside the spans ``category`` over the steps; None
    where the trace holds no such span or no launch in one."""
    t = record.trace
    if t is None:
        return None
    spans = sorted((s, e) for name, s, e in t._host if name == category)
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


def read(record):
    return launches_per_step(record, CATEGORY)
