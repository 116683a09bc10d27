"""Hierarchical wall-clock timers, the spans they are built from, and
counters.

Equivalent of the reference's ``Timeable`` mixin (reference:
opendrift/timer.py:4-34); the port's own copy of
``opendrift_tpu/timer.py``.  Categories nest with ``:`` separators, e.g.
``main loop:readers:pack``.  CUDA launches are asynchronous, so a timed
section that ends at a device boundary must synchronise before it ends for
its number to be wall clock; the run loop synchronises at output
boundaries only (when it copies a snapshot to the host, ``main loop:to
host``).

Every timed section is a span (:meth:`Recorder.timed`): its seconds add to
``timers[category]``, and one :class:`Span` record goes to the in-memory
list ``spans`` with its thread, the span it nests in and the id of the
``run()`` it ended in.  Spans are stamped with ``time.time_ns()``, the
clock of ``torch.profiler``'s host events, and while a profiler runs each
span is also a ``record_function`` of the same name, so that it appears in
the profiler's trace.  Nothing is written to disk.  A :class:`Recorder`
holds all of it and refers to nothing else, so the environment records
into its simulation's without keeping the simulation alive.
"""

import contextlib
import threading
import time
from collections import OrderedDict

import torch

_RECORDER_LOCK = threading.Lock()


class Span:
    """One timed section: ``category``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``; ``end_ns`` is None while it is open), the name of
    its ``thread``, the index in ``spans`` of the span it nests in on that
    thread (``parent``, None at the top) and the id of the ``run()`` it
    ended in (``run``: 0 outside any run, None while open)."""

    __slots__ = ("category", "start_ns", "end_ns", "thread", "parent", "run",
                 "_annotation", "_stack")

    def __init__(self, category, thread, parent, stack):
        self.category = category
        self.start_ns = self.end_ns = self.run = None
        self.thread = thread
        self.parent = parent
        self._annotation = None
        self._stack = stack             # its thread's stack of open spans

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.category!r}, {self.start_ns}, {self.end_ns}, "
                f"{self.thread!r}, parent={self.parent}, run={self.run})")


class Recorder:
    """The timers, spans and counters of a simulation.  Spans may open on
    any thread (the prefetch thread records too); counters are kept by the
    thread that takes the windows, the run loop's."""

    def __init__(self):
        self.timers = OrderedDict()
        self.spans = []
        self.counters = OrderedDict()
        self.run_id = 0
        self._started = {}              # category -> index, timer_start's
        self._local = threading.local()     # each thread's open spans
        self._lock = threading.Lock()       # of spans and timers

    def _open(self, category, total):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        span = Span(category, threading.current_thread().name,
                    stack[-1] if stack else None, stack)
        with self._lock:
            index = len(self.spans)
            self.spans.append(span)
            if total and category not in self.timers:
                self.timers[category] = 0.0
        stack.append(index)
        # set while a torch.profiler runs, on every thread (unlike
        # torch._C._autograd._profiler_enabled(), which reads False under
        # profile_all_threads)
        if torch.autograd.profiler._is_profiler_enabled:
            # stamped right before the profiler's own stamp, so the two
            # agree
            span._annotation = torch.profiler.record_function(category)
            span.start_ns = time.time_ns()
            span._annotation.__enter__()
        else:
            span.start_ns = time.time_ns()
        return index

    def _close(self, index, total):
        span = self.spans[index]
        span.end_ns = time.time_ns()
        if span._annotation is not None:
            span._annotation.__exit__(None, None, None)
            span._annotation = None
        span.run = self.run_id
        stack, span._stack = span._stack, None
        if stack and stack[-1] == index:
            stack.pop()
        elif index in stack:
            stack.remove(index)
        if total:
            with self._lock:
                self.timers[span.category] += span.seconds

    @contextlib.contextmanager
    def timed(self, category, total=True):
        """A span of ``category`` around the block; yields its
        :class:`Span`, whose ``seconds`` are set when the block ends.
        ``total=False`` records the span only, outside ``timers`` (a worker
        thread's work, which overlaps the run loop's)."""
        index = self._open(category, total)
        try:
            yield self.spans[index]
        finally:
            self._close(index, total)

    def timer_start(self, category):
        """Open a span of ``category`` that :meth:`timer_end` closes (for
        sections that do not fit one block); a category already open is
        restarted."""
        if category in self._started:
            self._close(self._started.pop(category), False)
        self._started[category] = self._open(category, True)

    def timer_end(self, category):
        index = self._started.pop(category, None)
        if index is not None:
            self._close(index, True)

    def count(self, name, n=1):
        """Add ``n`` to counter ``name``."""
        self.counters[name] = self.counters.get(name, 0) + n


class Timeable:
    """Mixin providing nested named timers, spans, counters and a text
    report, kept by its :class:`Recorder`."""

    @property
    def recorder(self):
        recorder = getattr(self, "_recorder", None)
        if recorder is None:
            with _RECORDER_LOCK:
                recorder = getattr(self, "_recorder", None)
                if recorder is None:
                    recorder = self._recorder = Recorder()
        return recorder

    @property
    def timers(self):
        return self.recorder.timers

    @property
    def spans(self):
        """Every span recorded, in the order they opened."""
        return self.recorder.spans

    @property
    def counters(self):
        """Counts kept beside the spans (bytes copied, windows packed)."""
        return self.recorder.counters

    @property
    def run_id(self):
        """The id the current (or last) ``run()``'s spans carry; 0 before
        the first."""
        return self.recorder.run_id

    def next_run(self):
        """Start a new run id (a count of ``run()`` calls)."""
        self.recorder.run_id += 1

    def timed(self, category, total=True):
        return self.recorder.timed(category, total)

    def timer_start(self, category):
        self.recorder.timer_start(category)

    def timer_end(self, category):
        self.recorder.timer_end(category)

    def count(self, name, n=1):
        self.recorder.count(name, n)

    def performance(self):
        """Return a text report of accumulated timers (indented by nesting,
        each under its parent in the order they first opened) and the
        counters."""
        timers = self.timers
        first = {cat: i for i, cat in enumerate(timers)}

        def tree_order(cat):
            parts = cat.split(":")
            return [first.get(":".join(parts[:i + 1]), first[cat])
                    for i in range(len(parts))]
        lines = []
        for cat in sorted(timers, key=tree_order):
            secs = timers[cat]
            parts = cat.split(":")
            indent = "    " * (len(parts) - 1)
            lines.append(f"{secs:10.1f} {indent}{parts[-1]}")
        for name, n in self.counters.items():
            lines.append(f"{n:>10} {name}")
        return "\n".join(lines) + "\n"
