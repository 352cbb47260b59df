"""The port's spans in a traced run (metrics/<name>.py of source program_span).

The port names its stages with `yolov3_tpu_torch/utils/tracing.py`'s
`span`, which is a `record_function` range while a profiler records: the
traced window's `ranges` ({name: [seconds, ...]}, harness/trace.py) hold
them. A program without those spans gives None here, and its metric is left
out of the result line.
"""

from __future__ import annotations


def span_seconds(run, names):
    """Seconds of every range named in `names` over the traced window, or
    None where the run was not traced or one of the names never ran."""
    ranges = run.trace.get("ranges", {}) if run.trace is not None else {}
    if not all(ranges.get(n) for n in names):
        return None
    return sum(sum(ranges[n]) for n in names)


def enqueue_ms(run):
    """Host milliseconds to queue one served batch's work: the fast path's
    `serve/copy_in`, `serve/forward`, `serve/decode` and `serve/nms` spans
    over the traced batches."""
    s = span_seconds(run, ("serve/copy_in", "serve/forward", "serve/decode", "serve/nms"))
    batches = run.counters.get("traced", {}).get("batches", 0)
    return None if s is None or not batches else 1e3 * s / batches
