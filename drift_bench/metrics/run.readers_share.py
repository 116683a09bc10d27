"""run.readers_share: the share of the run loop's time spent in its
reader layer (packing each window on the host, waiting for the prefetch
thread and copying to the card): ``timers["main loop:readers"]`` over
``timers["main loop"]`` of ``models/base.py`` ``run``, summed over the
window's forecasts (%)."""


def read(record):
    main = sum(f["timers"].get("main loop", 0.0) for f in record.forecasts)
    readers = sum(f["timers"].get("main loop:readers", 0.0)
                  for f in record.forecasts)
    return 100.0 * readers / main if main > 0 else None
