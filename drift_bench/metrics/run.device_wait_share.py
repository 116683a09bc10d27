"""run.device_wait_share: the share of the run loop's time in which the
host waits for the card: ``timers["main loop:to host"]`` (the output
frames' copies to the host, which wait for the interval's steps to finish)
over ``timers["main loop"]`` of ``models/base.py`` ``run``, summed over
the window's forecasts (%)."""

KEY = "main loop:to host"


def read(record):
    timed = [f for f in record.forecasts if KEY in f["timers"]]
    main = sum(f["timers"].get("main loop", 0.0) for f in timed)
    waited = sum(f["timers"][KEY] for f in timed)
    return 100.0 * waited / main if main > 0 else None
