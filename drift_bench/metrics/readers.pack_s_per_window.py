"""readers.pack_s_per_window: host seconds of packing (decode, fill,
subset, pack, on either thread) a window of the run loop, one output
interval of the traffic: the environment's ``pack_seconds``
(``fields/environment.py``) over the forecast's output intervals (its
steps over the steps an interval), over the window's forecasts."""


def read(record):
    t = record.traffic
    per_interval = round(t["output_step_s"] / t["time_step_s"])
    windows = sum(-(-f["steps"] // per_interval) for f in record.forecasts)
    packed = sum(f["pack_seconds"] for f in record.forecasts)
    return packed / windows if windows else None
