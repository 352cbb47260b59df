"""Streamed serving: independent clients in an open loop, one frame a request.

Each request is one BGR uint8 frame, drawn from seeded pools of the sizes
in `sizes` (equal shares), sent at its scheduled time to the port's
`serve.build_pipeline(model, imgsz, max_batch, batch_wait_ms, fast=True)`
predict (letterbox, BGR to RGB, MicroBatcher, the fast path, boxes scaled
back to the frame), on a pool of `workers` client threads. The arrivals are
Poisson at `rate` requests a second: the gaps are the quantiles of the
exponential distribution at (i + 0.5) / n for the window's n = rate x
seconds requests, in an order drawn from the seed, so every seed offers
the same gaps and sizes in another order. Detections are planted on the
letterboxed pool frames.

End to end: `stream_req_s`, the requests answered within the window a
second, for a cell offered more than the path sustains (its knee); and
`request_p95_ms`, the 95th percentile over all requests of the time from a
request's scheduled send to its boxes in the frame's pixels (a failed
request counts as never answered), for a cell below it. BENCHMARK.json says
which a cell reports. An earlier line on standard error says how late the
generator sent. Counters: the batcher's device calls and
requests in the window. Traced: `trace_seconds` more of the same traffic.
Check: a seeded sample of `sample` requests (a frame of the largest size
among them) against the plain reference's letterbox, float32 forward,
greedy NMS and scale back.

`sweep(run, rates, seconds)` offers each rate in turn and prints what was
completed, the tail and the backlog: the knee of this cell, found once
(tools/sweep_stream.py).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness import compare, plant, program
from harness.core import derived_seed, generator, steady_host
from harness.trace import traced
from harness.weights import make_weights
from reference import detect as ref_detect
from reference.model import Net, decode, forward, strict_f32


def setup_inputs(run):
    """(net, planted weights, {size: frames}) of the run's seed."""
    wl, dev = run.workload, run.device
    net = Net(wl.get("model") or run.config["model"])
    p = make_weights(net, run.seed, dev)
    g = generator(run.seed, "frames", dev)
    pools = {}
    for h, w in wl["sizes"]:
        pools[(h, w)] = torch.randint(0, 256, (wl["pool_per_size"], h, w, 3), generator=g, device=dev,
                                      dtype=torch.uint8).cpu().numpy()
    boxed = np.stack([ref_detect.letterbox(f, wl["imgsz"])[:, :, ::-1] for fs in pools.values() for f in fs])
    used, counts, _ = plant.plant(p, net, boxed, dev, wl["plant_targets"], wl["k_per_scale"], wl["conf_thres"])
    run.note(f"planted: targets {used}; above conf, median / max over the letterboxed frames: "
             + ", ".join(f"{int(c.median())} / {int(c.max())}" for c in counts))
    return net, p, pools


def schedule(seed, purpose, rate, seconds, sizes, pool_per_size):
    """[(due s, size, frame index)] of an open loop at `rate` for `seconds`."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(derived_seed(seed, purpose))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
    kinds = rng.permutation(np.arange(n) % len(sizes))
    frames = rng.integers(0, pool_per_size, n)
    return [(float(t), tuple(sizes[k]), int(f)) for t, k, f in zip(due, kinds, frames)]


def offer(predict, pools, plan, workers, keep=(), grace_s=60.0):
    """Send `plan` in an open loop; returns (latencies s, lateness s, answers
    {i: dets} of the requests in `keep`, failures, wall s). A request not
    answered `grace_s` after the last send counts as failed."""
    n = len(plan)
    lat = np.full(n, np.inf)
    late = np.zeros(n)
    answers, errors = {}, []
    keep = set(keep)
    lock = threading.Lock()

    def one(i, t_due):
        try:
            dets = predict(pools[plan[i][1]][plan[i][2]])
        except Exception as e:  # noqa: BLE001 — a failed request is counted, the loop goes on
            with lock:
                errors.append(f"request {i}: {e!r}")
            return
        lat[i] = time.perf_counter() - t_due
        if i in keep:
            answers[i] = dets

    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="client") as pool:
        futures = []
        t0 = time.perf_counter()
        for i, (due, _, _) in enumerate(plan):
            t_due = t0 + due
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t_due
            futures.append(pool.submit(one, i, t_due))
        t_sent = time.perf_counter()
        for i, f in enumerate(futures):
            try:
                f.result(timeout=max(0.1, grace_s - (time.perf_counter() - t_sent)))
            except TimeoutError:
                errors.append(f"request {i}: no answer {grace_s} s after the last send")
                break
        wall = time.perf_counter() - t0
    return lat, late, answers, errors, wall


def build(run, p, pools):
    from yolov3_tpu_torch.serve import build_pipeline

    wl = run.workload
    model = program.build_model(run.config, p, run.device, wl.get("model"))
    predict = build_pipeline(model, imgsz=wl["imgsz"], conf_thres=wl["conf_thres"], iou_thres=wl["iou_thres"],
                             max_det=wl["max_det"], max_batch=wl["max_batch"], batch_wait_ms=wl["batch_wait_ms"],
                             fast=True)
    predict.batcher.warmup(wl["imgsz"])  # every bucket once, as the serve CLI does before its first request
    for frames in pools.values():  # and the letterbox of every frame size (its host library builds on first use)
        predict(frames[0])
    return model, predict


def drive(run):
    wl, dev = run.workload, run.device
    net, p, pools = setup_inputs(run)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model, predict = build(run, p, pools)
    plan = schedule(run.seed, "arrivals", wl["rate"], run.seconds, wl["sizes"], wl["pool_per_size"])
    rng = np.random.default_rng(derived_seed(run.seed, "sample"))
    largest = max(range(len(plan)), key=lambda i: plan[i][1][0] * plan[i][1][1])
    sample = sorted({largest, *rng.choice(len(plan), min(wl["sample"], len(plan)) - 1, replace=False).tolist()})
    steady_host()
    run.setup_s = time.perf_counter() - run.t_start

    b = predict.batcher
    calls0, req0 = b.calls, b.requests
    lat, late, answers, errors, wall = offer(predict, pools, plan, wl["workers"], keep=sample)
    run.attempted, run.failed = len(plan), len(errors)
    for e in errors[:5]:
        run.note(e)
    run.e2e["request_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    run.e2e["stream_req_s"] = float((np.array([t for t, _, _ in plan]) + lat <= run.seconds).sum()) / run.seconds
    run.counters.update(calls=b.calls - calls0, requests=b.requests - req0)
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    run.note(f"generator: {len(plan)} requests at {wl['rate']} /s over {plan[-1][0]:.3f} s, sent late by "
             f"median {np.median(late) * 1e3:.3f} ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, "
             f"max {late.max() * 1e3:.3f} ms")
    run.note(f"window: {len(plan)} requests in {wall:.3f} s, {run.e2e['stream_req_s']:.1f} answered a second "
             f"within it, {run.counters['calls']} device calls, latency "
             f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p95 {run.e2e['request_p95_ms']:.3f} ms, "
             f"p99 {np.percentile(lat, 99) * 1e3:.3f} ms, {len(errors)} failed")

    with traced(run):
        if run.trace_on:
            tplan = schedule(run.seed, "trace", wl["rate"], wl["trace_seconds"], wl["sizes"], wl["pool_per_size"])
            calls0, req0 = b.calls, b.requests
            offer(predict, pools, tplan, wl["workers"])
            run.counters["traced"] = dict(calls=b.calls - calls0, requests=b.requests - req0)

    del predict, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    frames = [pools[plan[i][1]][plan[i][2]] for i in sample]
    want = reference_dets(p, net, frames, dev, wl)
    got = [answers.get(i, np.zeros((0, 6), np.float32)) for i in sample]
    compare.check_detections(run, got, want)



def reference_dets(p, net, frames, device, wl, precision="f32"):
    """The reference's detections of BGR frames, in the frames' pixels."""
    out = []
    size = wl["imgsz"]
    with torch.no_grad(), strict_f32():
        for f in frames:
            x = torch.from_numpy(np.ascontiguousarray(ref_detect.letterbox(f, size)[:, :, ::-1]))[None]
            x = x.to(device).float() / 255.0
            boxes, scores, cls = ref_detect.best_class(decode(forward(p, net, x, precision=precision), net, "yxa"),
                                                       wl["conf_thres"])
            dets, n = ref_detect.greedy_nms(boxes, scores, cls, wl["iou_thres"], wl["max_det"])
            d = dets[0, :int(n[0])].cpu().numpy()
            d[:, :4] = ref_detect.scale_boxes(size, d[:, :4], f.shape[:2])
            out.append(d)
    return out


def sweep(run, rates, seconds):
    """Offer each rate for `seconds` after one set-up; returns a row per rate."""
    wl = run.workload
    net, p, pools = setup_inputs(run)
    model, predict = build(run, p, pools)
    rows = []
    for rate in rates:
        plan = schedule(run.seed, f"sweep/{rate}", rate, seconds, wl["sizes"], wl["pool_per_size"])
        b = predict.batcher
        calls0 = b.calls
        lat, late, _, errors, wall = offer(predict, pools, plan, wl["workers"])
        done = np.isfinite(lat)
        row = dict(rate=rate, requests=len(plan), completed_per_s=int(done.sum()) / wall,
                   p50_ms=float(np.percentile(lat, 50)) * 1e3, p95_ms=float(np.percentile(lat, 95)) * 1e3,
                   p99_ms=float(np.percentile(lat, 99)) * 1e3, late_p99_ms=float(np.percentile(late, 99)) * 1e3,
                   drain_s=wall - plan[-1][0], occupancy=len(plan) / max(b.calls - calls0, 1), failed=len(errors))
        rows.append(row)
        print(" ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()), flush=True)
        if row["drain_s"] > 10.0:  # far past the knee: the queue grew all through the window
            break
    return rows


def control(run, precision="fp8"):
    """The compared numbers of the reference in `precision` put in the program's place, on a
    seeded sample of the pool's frames (a frame of each size among them)."""
    wl = run.workload
    net, p, pools = setup_inputs(run)
    rng = np.random.default_rng(derived_seed(run.seed, "sample"))
    frames = [fs[i] for fs in pools.values()
              for i in rng.choice(len(fs), max(1, wl["sample"] // len(pools)), replace=False)]
    want = reference_dets(p, net, frames, run.device, wl)
    return compare.check_detections(run, reference_dets(p, net, frames, run.device, wl, precision), want)
