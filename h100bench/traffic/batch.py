"""Batched serving: a closed loop with one batch in flight.

Batches of `batch` seeded uint8 frames (`imgsz` square, NHWC, a pool of
`pool_batches` batches in pinned host memory, cycled, as an offline batch
server stages them) go to the port's
`serve.build_batched_infer(model)` fast path, and the valid rows come back
to the host as `serve.MicroBatcher` fetches them. Detections are planted
(harness/plant.py) on the pool's frames at `plant_targets` cells an image a
head stride.

End to end: the images returned to the host over the window a second, under
the workload's `rate_metric` (`serve_img_s` unless it names another).
Counters: the batches, the port's K1 / K2 launches and its fallbacks, in
the window and in the traced window (`trace_batches` batches after it).
Check: the last answer to every frame of the pool against the plain
reference's float32 forward, decode and greedy NMS of the same frame
(harness/compare.py detection_gaps).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, plant, program
from harness.core import generator, steady_host
from harness.trace import traced
from harness.weights import make_weights
from reference import detect as ref_detect
from reference.model import Net, decode, forward, strict_f32


def frames_pool(run, n, size):
    g = generator(run.seed, "frames", run.device)
    return torch.randint(0, 256, (n, size, size, 3), generator=g, device=run.device, dtype=torch.uint8).cpu().numpy()


def reference_dets(p, net, frames, device, conf, iou, max_det, precision="f32", chunk=16):
    """The reference's detections (n, 6) of each uint8 NHWC frame."""
    out = []
    with torch.no_grad(), strict_f32():
        for i in range(0, len(frames), chunk):
            x = torch.as_tensor(frames[i:i + chunk]).to(device).float() / 255.0
            boxes, scores, cls = ref_detect.best_class(decode(forward(p, net, x, precision=precision), net, "yxa"), conf)
            dets, n = ref_detect.greedy_nms(boxes, scores, cls, iou, max_det)
            out += [d[:k].cpu().numpy() for d, k in zip(dets, n.tolist())]
    return out


def plant_frames(run, net, p, frames):
    wl = run.workload
    used, counts, _ = plant.plant(p, net, frames, run.device, wl["plant_targets"], wl["k_per_scale"],
                                  wl["conf_thres"])
    run.note(f"planted: targets {used} cells an image by level; above conf, median / max over the frames: "
             + ", ".join(f"{int(c.median())} / {int(c.max())}" for c in counts))


def setup_inputs(run):
    wl = run.workload
    net = Net(wl.get("model") or run.config["model"])
    p = make_weights(net, run.seed, run.device)
    frames = frames_pool(run, wl["batch"] * wl["pool_batches"], wl["imgsz"])
    plant_frames(run, net, p, frames)
    return net, p, frames


def drive(run):
    from yolov3_tpu_torch.serve import build_batched_infer

    wl, dev = run.workload, run.device
    B, P = wl["batch"], wl["pool_batches"]
    net, p, frames = setup_inputs(run)
    model = program.build_model(run.config, p, dev, wl.get("model"))
    infer = build_batched_infer(model, wl["conf_thres"], wl["iou_thres"], wl["max_det"],
                                k_per_scale=tuple(wl["k_per_scale"]))
    batches = [torch.from_numpy(frames[i * B:(i + 1) * B]) for i in range(P)]
    if dev.type == "cuda":
        batches = [b.pin_memory() for b in batches]

    def serve(imgs):  # the device call and MicroBatcher's fetch of the valid rows
        dets, n = infer(imgs)
        n = np.asarray(n)
        return dets[:, :int(n.max())].cpu().numpy(), n

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(wl.get("warmup_batches", 2)):
        serve(batches[0])
    steady_host()
    run.setup_s = time.perf_counter() - run.t_start

    before, fb0 = program.kernel_counters(), infer.fallbacks
    answers, served, failed, i = {}, 0, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds or i < P:  # at least one pass over the pool
        try:
            answers[i % P] = serve(batches[i % P])
            served += B
        except RuntimeError as e:
            failed += B
            run.note(f"batch {i} failed: {e}")
        i += 1
    elapsed = time.perf_counter() - t0
    after = program.kernel_counters()
    run.attempted, run.failed = served + failed, failed
    run.e2e[wl.get("rate_metric", "serve_img_s")] = served / elapsed
    run.counters.update(batches=i, fallbacks=infer.fallbacks - fb0,
                        launches={k: after[k] - before[k] for k in after})
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    run.note(f"window: {i} batches of {B} in {elapsed:.3f} s, {run.counters['fallbacks']} fallbacks, "
             f"launches {run.counters['launches']}")

    with traced(run):
        before = program.kernel_counters()
        for j in range(wl["trace_batches"] if run.trace_on else 0):
            serve(batches[j % P])
        after = program.kernel_counters()
    run.counters["traced"] = dict(batches=wl["trace_batches"] if run.trace_on else 0,
                                  launches={k: after[k] - before[k] for k in after})

    # the check, once the program is gone: the last answer to every frame of the pool
    del infer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_dets(p, net, frames, dev, wl["conf_thres"], wl["iou_thres"], wl["max_det"])
    got = []
    for k in range(P):
        dets, n = answers[k]
        got += [dets[j, :int(n[j])] for j in range(B)]
    compare.check_detections(run, got, want)



def control(run, precision="fp8"):
    """The compared numbers of the reference in `precision` put in the program's place."""
    wl = run.workload
    net, p, frames = setup_inputs(run)
    args = (wl["conf_thres"], wl["iou_thres"], wl["max_det"])
    want = reference_dets(p, net, frames, run.device, *args)
    got = reference_dets(p, net, frames, run.device, *args, precision=precision)
    return compare.check_detections(run, got, want)
