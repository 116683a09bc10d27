"""run.idle_outside_loop_share: the share of the traced window in which
the card is idle while ``run()`` (``models/base.py``) prepares its main
loop or post-processes (the initial state, the readers' set-up, the
result's assembly: the host work between forecasts inside ``run()``): the
time of the trace's idle gaps that the union of the ``preparing main
loop`` and ``postprocessing`` spans covers, over the window (%)."""

import os

from drift_bench import cells

CATEGORIES = ("preparing main loop", "postprocessing")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read(record):
    shares = cells.load_module(ROOT, "metrics",
                               "device.idle_in_readers_share")
    return shares.idle_share_in(record, CATEGORIES)
