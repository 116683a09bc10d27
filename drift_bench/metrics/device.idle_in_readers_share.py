"""device.idle_in_readers_share: the share of the traced window in which
the card is idle while the run loop is in its reader layer: the time of
the trace's idle gaps that the union of the ``main loop:readers`` spans
(``models/base.py`` ``run``: the join of the prefetch thread, packing on
the loop's thread, the copy to the card) covers, by the overlap of the
intervals, over the window (%)."""

CATEGORIES = ("main loop:readers",)


def union(intervals):
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap_ns(a, b):
    """Nanoseconds that two lists of sorted, disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(record, categories):
    """The share (%) of the traced window's idle card time that falls in
    the host spans named ``categories``; None where the trace holds no
    device activity or no such span."""
    t = record.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    spans = union((s, e) for name, s, e in t._host if name in categories)
    if not spans:
        return None
    return 100.0 * overlap_ns(union(t.gaps), spans) * 1e-9 / t.window_s


def read(record):
    return idle_share_in(record, CATEGORIES)
