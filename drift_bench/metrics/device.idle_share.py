"""device.idle_share: the share of the traced window in which nothing ran
on the card: 1 - the union of its kernels, copies and sets over the
window (%)."""


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
