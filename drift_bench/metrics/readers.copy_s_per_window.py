"""readers.copy_s_per_window: host seconds a window of the run loop spends
copying the reader layer's tables to the card (``timers["main
loop:readers:copy"]`` of ``models/base.py`` ``run``, the copies of
``fields/environment.py`` ``build_device_states``), over the forecast's
output intervals counted as ``readers.pack_s_per_window`` counts them,
over the window's forecasts."""

KEY = "main loop:readers:copy"


def read(record):
    timed = [f for f in record.forecasts if KEY in f["timers"]]
    if not timed:
        return None
    t = record.traffic
    per_interval = round(t["output_step_s"] / t["time_step_s"])
    windows = sum(-(-f["steps"] // per_interval) for f in timed)
    copied = sum(f["timers"][KEY] for f in timed)
    return copied / windows if windows else None
