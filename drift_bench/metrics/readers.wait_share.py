"""readers.wait_share: the share of the run loop's time in which it waits
for the reader layer's host packing, which its prefetch did not hide:
the packing done on the run loop's own thread (``pack_seconds`` less
``prefetched_pack_seconds``) and the wait to join the prefetch thread
(``join_wait_seconds``, all of ``fields/environment.py``), over
``timers["main loop"]`` of ``models/base.py`` ``run``, summed over the
window's forecasts (%)."""


def read(record):
    main = sum(f["timers"].get("main loop", 0.0) for f in record.forecasts)
    waited = sum(f["join_wait_seconds"] + f["pack_seconds"]
                 - f["prefetched_pack_seconds"] for f in record.forecasts)
    return 100.0 * waited / main if main > 0 else None
