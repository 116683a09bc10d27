"""device.peak_gib: the most device memory the window's forecasts held,
``torch.cuda.max_memory_allocated()`` over the window, reset at its start
(GiB)."""


def read(record):
    if not record.window_peak_bytes:
        return None
    return record.window_peak_bytes / 2.0 ** 30
