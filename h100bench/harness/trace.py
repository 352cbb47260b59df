"""The traced window: torch.profiler over a block of the run, reduced to what
the per-layer metrics and the result line read.

`traced(run)` profiles its block (host and device activity) when the run
is traced and leaves `run.trace`:

    busy_s     seconds in which some operation ran on the device (the union
               of the device intervals inside the window)
    window_s   the window's length on the profiler's clock
    kernels    [(name, seconds)] of every device operation in the window
    ranges     {record_function name: [seconds, ...]} of the host's ranges
    breakdown  {"device_ops": the 10 device operations that took most time,
                "idle_gaps": device idle time by what the host was doing,
                the 10 largest}

The profiler stretches the host's side of the window; busy_s and the
kernel times are the device's own.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "h100bench/window"


@contextlib.contextmanager
def traced(run):
    if not run.trace_on or run.device.type != "cuda":
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield prof
            torch.cuda.synchronize(run.device)
    run.trace = summarize(prof.events())


def _union(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events):
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    window = [e for e in cpu if e.name == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    annotations = {e.name for e in cpu if e.is_user_annotation} | {WINDOW}
    dev = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation or e.name in annotations:
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            dev.append((s, t, e.name))
    merged = _union([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in merged)
    by_name = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6

    # device idle gaps, each named by the innermost host operation running at its middle
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if e.name != WINDOW)
    starts = [h[0] for h in host]
    edges = [w0] + [x for pair in merged for x in pair] + [w1]
    gaps = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "host idle or outside any operation"
        for j in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 4000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    ranges = {}
    for e in cpu:
        if e.is_user_annotation and e.name != WINDOW:
            ranges.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
                kernels=[(name, (t - s) / 1e6) for s, t, name in dev], ranges=ranges,
                breakdown=dict(device_ops=[[n, v] for n, v in top], idle_gaps=[[n, v] for n, v in idle]))
