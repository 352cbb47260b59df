"""Validation: one `eval.validator.run` call of the port over labelled batches.

The port validates at its val-grade defaults (conf 0.001, iou 0.6,
multi-label NMS, max_det 300, max_nms 30000, float32 forward) over an
in-memory loader that yields batches of `batch` seeded uint8 `imgsz` frames
(pinned host memory, as a loader that pins its batches gives them) from a
pool of `pool_batches` batches, cycled, until `--seconds` have passed since
its first batch. Detections are planted on the pool's frames, and the
labels of a frame are the plain reference's most confident val-grade
detections, `label_counts` of them an image (the same counts for every
seed, in another order; mean near 7, as COCO val2017's 7.4).

End to end: `val_img_s`, the images over the wall time of the run call, the
mAP computation included. The loader's callback hook (`on_val_image_end`)
keeps the last detections of every pool frame. Traced: a second run call
over `trace_batches` batches.

Check: the plain reference's val-grade detections of every pool frame
(float32, TF32 off) against the program's (harness/compare.py, pairs of one
class), and the mAP50 and mAP50-95 that the reference's detections of the
same sequence of frames reach, against the program's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, plant, program
from harness.core import derived_seed, steady_host
from harness.trace import traced
from harness.weights import make_weights
from reference import detect as ref_detect
from reference import val_metrics
from reference.model import Net, decode, forward, head, strict_f32
from traffic.batch import frames_pool


class Frames:
    """`dataset.im_files` of the loader: the pool index of the run's n-th image."""

    def __init__(self, batch, pool_batches):
        self.batch, self.pool_batches = batch, pool_batches

    def __getitem__(self, n):
        return (n // self.batch) % self.pool_batches * self.batch + n % self.batch


class Loader:
    """(imgs, targets, mask, shapes) batches from the pool, cycled, for
    `seconds` from the first one (one pass over the pool at least), or
    `count` batches."""

    def __init__(self, batches, seconds=None, count=None):
        self.batches, self.seconds, self.count = batches, seconds, count
        self.dataset = type("Dataset", (), {})()
        self.dataset.im_files = Frames(len(batches[0][0]), len(batches))
        self.served = 0

    def __iter__(self):
        t0 = time.perf_counter()
        while (self.count is None or self.served < self.count) and (
                self.seconds is None or time.perf_counter() - t0 < self.seconds
                or self.served < len(self.batches)):
            yield self.batches[self.served % len(self.batches)]
            self.served += 1


class Keep:
    """The validator's callbacks: the last detections of every pool frame."""

    def __init__(self):
        self.dets = {}
        self.kept = []  # detections kept, image by image

    def run(self, event, predn=None, path=None, **_):
        if event == "on_val_image_end":
            self.dets[path] = predn.copy()
            self.kept.append(len(predn))


def label_counts(n, mean, cap, seed):
    """n label counts from 1 to cap, mean near `mean`: the exponential's
    quantiles, in an order drawn from the seed."""
    q = (np.arange(n) + 0.5) / n
    counts = np.clip(1 + np.floor(-(mean - 0.5) * np.log1p(-q)), 1, cap).astype(int)
    return np.random.default_rng(derived_seed(seed, "labels")).permutation(counts)


def setup_inputs(run):
    """(net, planted weights, frames, reference val-grade detections of each frame)."""
    wl, dev = run.workload, run.device
    B, P, S = wl["batch"], wl["pool_batches"], wl["imgsz"]
    net = Net(wl.get("model") or run.config["model"])
    p = make_weights(net, run.seed, dev)
    frames = frames_pool(run, B * P, S)
    _, counts, feats = plant.plant(p, net, frames, dev, wl["plant_targets"], wl["k_per_scale"], 0.25)
    run.note("planted: above conf 0.25, median / max over the frames: "
             + ", ".join(f"{int(c.median())} / {int(c.max())}" for c in counts))
    want = reference_dets(p, net, feats, wl)
    return net, p, frames, want


def reference_dets(p, net, feats, wl, chunk=8):
    """The reference's val-grade detections (n, 6) of every frame from the head's float32 inputs."""
    return _val_dets(net, wl, (decode(head(p, net, [f[i:i + chunk] for f in feats]), net)
                               for i in range(0, len(feats[0]), chunk)))


def reference_dets_frames(p, net, frames, device, wl, precision, chunk=8):
    """The reference's val-grade detections of uint8 frames, every convolution in `precision`."""
    return _val_dets(net, wl, (decode(forward(p, net, torch.as_tensor(frames[i:i + chunk]).to(device).float() / 255.0,
                                              precision=precision), net) for i in range(0, len(frames), chunk)))


def _val_dets(net, wl, preds):
    out = []
    with torch.no_grad(), strict_f32():
        for pred in preds:
            boxes, scores, cls = ref_detect.multi_label(pred, wl["conf_thres"], wl["max_nms"])
            dets, n = ref_detect.greedy_nms(boxes, scores, cls, wl["iou_thres"], wl["max_det"])
            out += [d[:k].cpu().numpy() for d, k in zip(dets, n.tolist())]
    return out


def labelled_batches(run, frames, want):
    wl = run.workload
    B, P, S = wl["batch"], wl["pool_batches"], wl["imgsz"]
    counts = label_counts(B * P, wl["labels_mean"], wl["labels_max"], run.seed)
    M = int(counts.max())
    targets, mask = np.zeros((B * P, M, 5), np.float32), np.zeros((B * P, M), bool)
    for i, (d, c) in enumerate(zip(want, counts)):
        top = d[np.argsort(-d[:, 4], kind="stable")[:c]]
        targets[i, :len(top), 0] = top[:, 5]
        targets[i, :len(top), 1:3] = (top[:, 0:2] + top[:, 2:4]) / 2 / S
        targets[i, :len(top), 3:5] = (top[:, 2:4] - top[:, 0:2]) / S
        mask[i, :len(top)] = True
    imgs = torch.from_numpy(frames)
    if run.device.type == "cuda":
        imgs = imgs.pin_memory()
    return [(imgs[k * B:(k + 1) * B], targets[k * B:(k + 1) * B], mask[k * B:(k + 1) * B], [None] * B)
            for k in range(P)]


def drive(run):
    from yolov3_tpu_torch.eval import validator

    wl, dev = run.workload, run.device
    B = wl["batch"]
    net, p, frames, want = setup_inputs(run)
    batches = labelled_batches(run, frames, want)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model = program.build_model(run.config, p, dev, wl.get("model"))
    kw = dict(conf_thres=wl["conf_thres"], iou_thres=wl["iou_thres"], max_det=wl["max_det"],
              max_nms=wl["max_nms"], batch_size=B, imgsz=wl["imgsz"])
    validator.run(model=model, dataloader=Loader(batches, count=1), **kw)  # warm-up: the card's shapes
    steady_host()
    run.setup_s = time.perf_counter() - run.t_start

    keep, loader = Keep(), Loader(batches, seconds=run.seconds)
    before = program.kernel_counters()
    t0 = time.perf_counter()
    results, _, speeds = validator.run(model=model, dataloader=loader, callbacks=keep, **kw)
    elapsed = time.perf_counter() - t0
    after = program.kernel_counters()
    run.attempted, run.failed = loader.served * B, 0
    run.e2e["val_img_s"] = loader.served * B / elapsed
    run.counters.update(batches=loader.served, speeds_ms=list(speeds),
                        launches={k: after[k] - before[k] for k in after})
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    run.note(f"window: {loader.served} batches of {B} in {elapsed:.3f} s; ms an image pre / inference+NMS / "
             f"post {[round(s, 4) for s in speeds]}; P R mAP50 mAP50-95 {[float(v) for v in results[:4]]}; "
             f"launches {run.counters['launches']}")

    with traced(run):
        if run.trace_on:
            tkeep = Keep()
            _, _, tspeeds = validator.run(model=model, dataloader=Loader(batches, count=wl["trace_batches"]),
                                          callbacks=tkeep, **kw)
            kept = [sum(tkeep.kept[b * B:(b + 1) * B]) for b in range(wl["trace_batches"])]
            run.counters["traced"] = dict(batches=wl["trace_batches"], kept_per_batch=kept, speeds_ms=list(tspeeds))

    del model
    got = [keep.dets.get(i, np.zeros((0, 6), np.float32)) for i in range(len(want))]
    check_val(run, results, got, want, batches, loader.served)


def reference_map(want, batches, served):
    """The mAP the reference's detections reach over the served sequence of batches."""
    B = len(batches[0][0])
    S = batches[0][0].shape[1]
    per_frame = []
    for k, (_, targets, mask, _) in enumerate(batches):
        for j in range(B):
            t = targets[j][mask[j]]
            lab = np.concatenate([t[:, :1], ref_detect.xywh2xyxy(torch.from_numpy(t[:, 1:5] * S)).numpy()], 1)
            d = want[k * B + j]
            per_frame.append((val_metrics.process_batch(d, lab), d[:, 4], d[:, 5], lab[:, 0]))
    return val_metrics.mean_ap([per_frame[(b % len(batches)) * B + j] for b in range(served) for j in range(B)])


def check_val(run, results, got, want, batches, served):
    ref = reference_map(want, batches, served)
    gaps = compare.detection_gaps(got, want, run.workload["conf_thres"], same_class=True)
    gaps.update(map50_gap=abs(float(results[2]) - ref[2]), map_gap=abs(float(results[3]) - ref[3]))
    run.note(f"compared {len(want)} frames and {served} batches: program mAP50 {float(results[2])!r} "
             f"mAP50-95 {float(results[3])!r}, reference {ref[2]!r} {ref[3]!r}; {gaps}")
    return compare.check(run, gaps)


def control(run, precision="bf16"):
    """The compared numbers of the reference in `precision` put in the program's place, over
    one pass of the pool."""
    net, p, frames, want = setup_inputs(run)
    batches = labelled_batches(run, frames, want)
    got = reference_dets_frames(p, net, frames, run.device, run.workload, precision)
    return check_val(run, reference_map(got, batches, len(batches)), got, want, batches, len(batches))
