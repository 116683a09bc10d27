"""The traced run's device trace, reduced to what the metrics read.

A ``torch.profiler`` (CPU and CUDA activities) runs around the window's
forecasts.  From its events this module keeps:

* the device's activity: every kernel, copy and set on the card, merged
  into busy intervals (``busy_s``), against the traced window
  (``window_s``);
* the device time and count of each kernel name;
* the longest idle gaps on the card, each labelled by the innermost host
  span or operator running at the gap's middle.
"""

import numpy as np


def start(cuda=True):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _events(prof):
    """(device events, host events) as lists of (name, start_ns, end_ns)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and str(e.device_type()).endswith("CUDA"):
            continue                    # a host span drawn on the card's row
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if str(e.device_type()).endswith("CUDA"):
            dev.append(item)
        else:
            host.append(item)
    return dev, host


class Trace:
    """The reduced trace of one traced window."""

    def __init__(self, prof, window_s):
        dev, host = _events(prof)
        self.window_s = float(window_s)
        self.kernels = {}
        for name, s, e in dev:
            secs, count = self.kernels.get(name, (0.0, 0))
            self.kernels[name] = (secs + (e - s) * 1e-9, count + 1)
        self.busy_s = 0.0
        self.gaps = []
        if dev:
            order = sorted((s, e) for _, s, e in dev)
            merged = [list(order[0])]
            for s, e in order[1:]:
                if s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self.busy_s = sum(e - s for s, e in merged) * 1e-9
            self.gaps = [(merged[i][1], merged[i + 1][0])
                         for i in range(len(merged) - 1)]
        self._host = host

    def kernel_time(self, patterns):
        """(seconds, launches) of the kernels whose name holds any of
        ``patterns``."""
        secs, count = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if any(p in name for p in patterns):
                secs += s
                count += c
        return secs, count

    def top_kernels(self, k=10):
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name, secs] for name, (secs, _) in ranked[:k]]

    def top_gaps(self, k=10):
        """The ``k`` longest idle gaps as [label, seconds]."""
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]
        if not longest:
            return []
        names = [h[0] for h in self._host]
        starts = np.array([h[1] for h in self._host], np.int64)
        ends = np.array([h[2] for h in self._host], np.int64)
        out = []
        for s, e in longest:
            mid = (s + e) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = names[inside[np.argmax(starts[inside])]] if len(inside) \
                else "(no host span)"
            out.append([label, (e - s) * 1e-9])
        return out
