"""Named spans of the port's stages, on the host's clock and the profiler's.

    from yolov3_tpu_torch.utils import tracing

    with tracing.span("serve/forward"):
        feats = model(x)

    @tracing.span("val/fetch")
    def fetch(...): ...

    tracing.record("batcher/wait", seconds)   # an interval no block can wrap
    tracing.stats("serve/")                   # {name: {count, total_s, p50_ms, p95_ms}}

A span adds its host-clock duration to one process-wide, thread-safe table:
per name the count, the total and the last `KEEP` durations. While a torch
profiler records in the calling thread (`torch.autograd._profiler_enabled()`,
which is per thread), the span is also a `torch.profiler.record_function`
range of the same name, so a trace shows it beside the device's activity;
otherwise no range is entered, and a span costs two clock reads and one
table update under a lock.

The names, their stages and their readers are listed in PERF.md §3: the
train step's `train_step/*`, the serving fast path's `serve/*`,
`MicroBatcher`'s `batcher/*`, `build_pipeline`'s `pipeline/*` and the
validator's `val/*`. `/health` of the HTTP server reports the request
path's (`batcher/`, `pipeline/`, `serve/`).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

KEEP = 1024  # the last durations a name keeps for its percentiles

_lock = threading.Lock()
_table = {}  # name -> [count, total seconds, deque of the last KEEP durations]
_clock = time.perf_counter
_profiling = torch.autograd._profiler_enabled


def record(name, seconds):
    """Add one interval of `seconds` to `name`'s row of the table."""
    with _lock:
        row = _table.get(name)
        if row is None:
            row = _table[name] = [0, 0.0, deque(maxlen=KEEP)]
        row[0] += 1
        row[1] += seconds
        row[2].append(seconds)


class span:
    """A named stage: a context manager, or a decorator of a function whose
    every call is one span."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name).__enter__() if _profiling() else None
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        with _lock:  # record(), inlined: a span's cost is mostly calls
            row = _table.get(self.name)
            if row is None:
                row = _table[self.name] = [0, 0.0, deque(maxlen=KEEP)]
            row[0] += 1
            row[1] += dt
            row[2].append(dt)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped


def stats(prefix=""):
    """{name: {count, total_s, p50_ms, p95_ms}} of the names that start with
    `prefix` (a string or a tuple of strings); the percentiles are over each
    name's last KEEP durations."""
    with _lock:
        rows = [(n, c, t, list(d)) for n, (c, t, d) in _table.items() if n.startswith(prefix)]
    out = {}
    for name, count, total, last in sorted(rows):
        p50, p95 = np.percentile(np.asarray(last) * 1e3, (50, 95))
        out[name] = dict(count=count, total_s=total, p50_ms=float(p50), p95_ms=float(p95))
    return out


def reset():
    """Empty the table."""
    with _lock:
        _table.clear()
