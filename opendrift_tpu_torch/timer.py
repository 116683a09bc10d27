"""Hierarchical wall-clock timers.

Equivalent of the reference's ``Timeable`` mixin (reference:
opendrift/timer.py:4-34); the port's own copy of
``opendrift_tpu/timer.py``.  Categories nest with ``:`` separators, e.g.
``main loop:readers:norkyst``.  CUDA launches are asynchronous, so a timed
section that ends at a device boundary must synchronise before
``timer_end`` for its number to be wall clock; the run loop synchronises
at output boundaries only (when it copies a snapshot to the host).
"""

import time
from collections import OrderedDict


class Timeable:
    """Mixin providing nested named timers and a text report."""

    @property
    def timers(self):
        if not hasattr(self, "_timers"):
            self._timers = OrderedDict()
        return self._timers

    @property
    def _timer_start_times(self):
        if not hasattr(self, "_timer_starts"):
            self._timer_starts = {}
        return self._timer_starts

    def timer_start(self, category):
        if category not in self.timers:
            self.timers[category] = 0.0
        self._timer_start_times[category] = time.perf_counter()

    def timer_end(self, category):
        start = self._timer_start_times.pop(category, None)
        if start is not None:
            self.timers[category] += time.perf_counter() - start

    def performance(self):
        """Return a text report of accumulated timers (indented by nesting)."""
        lines = []
        for cat, secs in self.timers.items():
            parts = cat.split(":")
            indent = "    " * (len(parts) - 1)
            lines.append(f"{secs:10.1f} {indent}{parts[-1]}")
        return "\n".join(lines) + "\n"
