"""sampler.gather_ms_per_step: device milliseconds a calculation step
spends in the sampler's row gathers (``ops/interp.py`` ``PackedSampler``,
which gathers its packed rows with ``index_select``), from the trace."""

# names of the kernels PyTorch's CUDA ``index_select`` launches (2.x:
# the vectorized gather for rows of whole 16-byte units, else the
# index-select kernels)
KERNELS = ("vectorized_gather_kernel", "indexSelectLargeIndex",
           "indexSelectSmallIndex")


def read(record):
    if record.trace is None:
        return None
    secs, launches = record.trace.kernel_time(KERNELS)
    steps = sum(f["steps"] for f in record.forecasts)
    if not launches or not steps:
        return None
    return 1e3 * secs / steps
