#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolov3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line:
  1. build every CUDA source of yolov3_tpu_torch/csrc/ with nvcc (sm_90a),
     one nvcc process each, all started together, and the host image ops
     (csrc/host_ops.cpp) with the C++ compiler beside them;
  2. the greedy-NMS kernels against the plain version at the serving
     shapes of yolov3 and yolov3-tiny, the fallback and the val-grade shape
     (one per kernel): outputs equal; the time
     of one step's dependent chain, from a run at one candidate a lane;
  3. the candidate-score kernel against its plain version on bf16 head
     outputs of yolov3@640 at batch 32 and at ragged, f16, f32 and unaligned
     shapes; its time per scale and for the three scales beside the bound;
 3b. the conv epilogue kernel (csrc/epilogue.cu) against its plain version at
     yolov3's and yolov5x6's served epilogue shapes (EPILOGUE_SHAPES, two
     with a residual): within one bf16 unit in the last place; its device
     time beside its byte bound, the plain version's time and that of the
     three PyTorch passes it replaced;
  3c. the conv + max-pool kernel (csrc/conv_pool.cu) against its plain version
     at yolov3-tiny's four conv -> max-pool pairs (CONV_POOL_SHAPES, batch 32
     at 640 px): within one bf16 unit in the last place; each pair's device time beside its bound and beside the
     three kernels it replaced (cuDNN's conv, the epilogue, PyTorch's pool);
 4. the conv3x3 + BatchNorm-statistics kernels against the plain version at
     every stride-1 3x3 conv shape of yolov3, yolov3-spp, yolov3-tiny,
     yolov5s and yolov5s-transformer at 640 px and at small f32 and odd
     shapes; each row names the kernel it took and is run twice for equal
     bits; yolov3's, yolov5s's and yolov3-tiny's shapes (batch 8, bf16) are timed beside two
     library yardsticks, cuDNN's conv + var_mean over an
     f32 copy of y and over the bf16 y, by kernel time and by CUDA events;
  5. the serving path: full-width yolov3 (seeded random weights, detections
     planted on the head bias), 64 concurrent 640x640 requests through
     MicroBatcher(max_batch=32), one dense batch that takes the overflow
     fallback, launch counts of K1, K2 and the conv epilogue (once a
     folded Conv a fast path) over that run, a profile of
     the served batch by kernel group, and the fast path's detections
     against the plain score and NMS functions;
  6. the HTTP front end on that model, saved as a port checkpoint:
     serve.make_server on a free port in a thread, 32 requests (npy through
     RemoteModel and PNG bodies) of 4 frame sizes from 8 client threads,
     each answer held to the in-process pipeline, K2 three launches and K1
     one a device call, /health, 400 and 404, requests/s and latency, the
     server shut down; then build_pipeline(fast=False) on 4 frames (K1 once
     a call, no K2) against the plain NMS on the same f32 predictions;
  7. the val path on the same model: eval.validator.run at the val-grade
     defaults (conf 0.001, iou 0.6, multi-label, max_det 300, max_nms 30000)
     over 32 640x640 frames and 8 512x640 rect frames, labelled with the f32
     val path's own detections above conf 0.25; f32 mAP50 >= 0.95, half=True
     beside it, one greedy-NMS launch a batch at K = 30000, detections and
     metrics equal to those through the plain NMS, a profile of one batch;
     then merge-NMS through K1 against the plain NMS on two val frames (one
     inside merge's 3000-candidate gate, one outside), and
     validator.run(save_hybrid=True) through K1 against the plain NMS;
 7b. export and backends (phase_export) on the served model as a port
     checkpoint: export.run to pt2 (f32, dynamic batch), pt2 with nms, pt2
     --half and onnx on the card; MultiBackend of each against the
     in-process model on the val batch of 32 (f32 decode 2e-3 / 1e-3, half
     and nms detections at the NMS bars, K1 once an nms call); validator.run
     through MultiBackend(pt2) and (onnx) (K1 once a batch, mAP50 within
     0.005); benchmarks.run over checkpoint, pt2 and onnx; a pt2 exported
     on the CPU moved to the card; ms per batch of 32 and val img/s of each;
     phase 9 adds detect through a pt2 of its weights (K1 once an image,
     rows equal to detect through the checkpoint in f32);
  8. the train path: the same model in train mode, SGD with the default
     hyper-parameters, 1 + 10 steps on one seeded batch of 8 640x640 images
     with 8 boxes each; finite falling loss, moved parameters, BatchNorm
     statistics and EMA, 33 launches of the conv+statistics kernel a step,
     a profile of a step by kernel group, then a float32 step with the
     kernel against one with its plain version from each of six states of
     the run, and the kernel against its plain version on a bf16 step's own
     inputs (steps_against_plain); then the step with
     remat off, whole-body and remat_until=7 from one state: peak memory,
     ms per step, K3 launches per step, the same loss, grad norm and
     BatchNorm statistics (updated once);
  9. detection from JPEGs on disk: every file of tests/data/jpeg and both
     sample images decoded by the in-tree decoder to the SHA-256 of cv2's
     decode pinned in digests.json (ms per megapixel), and those images and
     twelve synthetic ones (1x1 to 720x1280, gray, BGR, BGRA) encoded by the
     in-tree JPEG encoder to the SHA-256 of cv2.imencode's bytes pinned in
     encode_digests.json (ms per megapixel); then cli.detect.run
     at yolov3@640 (its own planted weights) from a port checkpoint, from
     the same weights as a reference yolov3.pt (equal detections) and with
     --augment, over those files: K1 once an image through its
     shared-memory route, every image's detections equal to the plain NMS,
     annotated JPEGs, labels and crops (JPEG, as the JAX package writes
     them); K1's device time at the detect shape;
     hub.custom on the list of paths (one K1 launch); cli.val.run with both
     weights as an Ensemble over a synthetic PNG dataset (K1 once a batch);
 10. the trainer: a synthetic PNG dataset written to a temporary directory
     (64 train and 32 val images, 480-800 px a side), the train loader
     alone (mosaic at 640 px, batch 16, 8 threads), train.loop.train of
     full-width yolov3 (nc 5) for 2 epochs with scratch-low (33 K3 launches
     a step, one K1 launch a val batch, results.csv, `last` and `best`
     stripped), a resume of a third epoch from the full state the second
     saved (step, optimizer and EMA counters restored; device busy share
     of its train loop under the profiler), and the stripped `best` served
     through build_batched_infer (K2 and K1 launched);
 11. the YOLOv5s family at its published widths (phase_zoo): yolov5s
     (7,235,389 parameters) served in batches of 32 at 640 px (K2 three and
     K1 one launch a batch, equal to the plain path, ms a batch) and trained
     1 + 5 steps at batch 8 (11 K3 launches a step), held as in 8;
     yolov5s-transformer and yolov5s-ghost one served batch of 8 and one
     train step each (K3 10 and 0 launches), held alike.
 12. data parallelism on the one card (phase_parallel, after 7b, on the planted
     model): a float32 train step of a seeded batch of 8 through a process
     group of one over NCCL equal to the ungrouped step in its bits (loss,
     grad norm, BatchNorm statistics; at one rank the statistics and the
     loss are the local ones, the gradient and metrics go through NCCL);
     two ranks (gloo with CUDA tensors, named by this script: NCCL takes a
     card a rank), 4 images each with unequal labels, 1 + 2 float32
     steps against one process on all 8 (loss rtol 1e-4, grad norm 1e-3,
     parameters, running statistics and EMA 1e-4; 33 K3 launches a rank a
     step; the ranks equal in their bits); serving over a mesh of two shards
     of the card (each shard's rows equal to the unsharded call on them, K2
     6 and K1 2 launches a batch of 32; the float32 full path against the
     unsharded batch of 32 at the NMS bars, the bf16 fast path's frames that
     differ from it counted; MicroBatcher(min_bucket=2)); sharded
     validation (mAP50 within 0.005, per-shard rows equal); and
     cli/train.main over two processes for an epoch and a resume of a second
     (rank 0 alone writes checkpoints, the ranks end equal).
 13. a training run that learns (phase_learn, after 10): yolov3-tiny at its
     published width (8,852,366 parameters at nc 80; nc 5 here) from seeded
     random weights, train.loop.train with its default plots on 256
     synthetic 320 px PNGs (RAM cache, no augmentation, batch 32) for
     LEARN_EPOCHS epochs (K3 once a stride-1 3x3 Conv layer a step: 9),
     then validator.run(plots=True) of the untrained model and the trained
     `last` on the train split (K1 once a batch): trained mAP50 > 0.5 and
     > untrained + 0.4 (tests/test_e2e.py's bars); the loop's and the
     loader's img/s, the device busy share of one epoch's loop, which of
     matplotlib / seaborn / pandas the host has, the plots written (the
     mosaics as JPEG) and the logger sinks that were on; then
     on full-width yolov3 at 640: check_bf16's deltas, profile_layers
     (per-layer ms by CUDA events, GFLOPs beside the FLOP counter's) and
     model_memory_bytes at batch 8.
 14. the host greedy NMS (phase_host_nms, after 12, on the planted model):
     yolov3_tpu_torch.native.greedy_nms_batch on the host against K1 on the
     serving batch's top-k candidates (B=32, K=448) and on two val frames'
     candidates at the val grade (K=30000): n equal, rows within the NMS
     bars, the images equal in every bit counted; non_max_suppression on a
     numpy prediction (the host engine) against batched_nms through K1; the
     host loop's ms beside K1's.
 15. the TPU layout options of the JAX package (phase_layout, after 14, on
     the planted model): the serving batch of 32 through the padded head
     (serving_module(pad_lanes=128), decode_topk_nhwc(padded_lanes=128)) and
     through the 5-D eval head (decode_topk_candidates), each into
     nms_from_candidates: K2 three and K1 one launch, the rows equal to the
     plain fast path's at the NMS bars, ms a batch beside the plain layout's;
     yolov3 with s2d_stem=True through 1 + 2 float32 train steps against the
     same steps without it from one seeded state (deterministic cuDNN):
     losses, grad norms and the train state equal in their bits, K3 33
     launches a step; and, on a host with tensorflow, a savedmodel and a
     tflite of the model read back through MultiBackend against the port's
     float32 decode (a host without it prints that they were not run).
 16. yolov3-spp and yolov3-tiny at their published widths (phase_family,
     after 11): 62,998,749 and 8,852,366 parameters; each served as yolov3
     is in 5 (32 requests through MicroBatcher(max_batch=32), K2 once a head
     level (3, 2) and K1 once a device call, K1 once more on the fallback
     batch, the rows against the plain score and NMS versions, K2 against
     its plain version on each level's rows; K2's time per level), validated
     as in 7 on 32 self-labelled 640x640 frames (f32 mAP50 >= 0.95, K1 once a
     batch) and trained as in 8 for 1 + 3 steps (K3 33 and 9 launches a step);
     ms per batch of 32 of both, in turns; then cli.detect.run() with its
     defaults (yolov3-tiny over the sample images: K1 once an image, rows
     equal to the plain NMS) and hub.load("yolov3_spp") on those images (one
     K1 launch).
The first lines also name the optional packages the host has (env:
tensorboard, tensorflow, wandb, clearml, comet_ml, cv2, matplotlib).
With `--kernel-times [ROOT]` it only times K3, K1 and K2 of the package under
ROOT (default: beside this file) at the main paths' shapes and stops: run
once per tree, parent, change, change, parent, to compare two trees on one
card (a tree from before csrc/score.cu times its Triton K2).

Then a JSON line of per-kernel numbers ({"kernels": [...]}), a JSON line of
the other measurements, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failure raises: exit code != 0.
"""

from __future__ import annotations

import copy
import functools
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
NMS_OPS_PER_IOU = 17  # f32 operations of one IoU test + compare in csrc/nms.cu


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=20, warmup=2):
    """Mean milliseconds per fn() call between CUDA events over `iters`
    back-to-back calls (host launch overhead included where it dominates)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters=20, per_call=1):
    """Mean device time per fn() call spent in kernels whose name contains
    `kernel`, or one of them if it is a tuple; fn() launches `per_call` of
    them (torch.profiler's CUDA activity; launch overhead excluded).

    The profiler now and then loses events, mostly the first of a window, so
    a few unmeasured calls run inside the window first and only the last
    per_call * iters events count. If events are still missing after three
    windows, the mean over the events seen is used and said so."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    need = per_call * iters
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3 + iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in names)]
        if len(spans) >= need:
            return sum(spans[-need:]) / iters / 1e3
    check(spans, f"the profiler saw no {kernel} kernel")
    print(f"device_ms: the profiler kept {len(spans)} of {need + 3 * per_call} {kernel} events; "
          "their mean is used", flush=True)
    return sum(spans) / len(spans) * per_call / 1e3


def ranges_device_ms(segments, iters=20):
    """Device time per call of each (label, fn) of `segments`, all in one
    profiler window: the summed time of the kernels launched inside a
    record_function range around `iters` calls of fn, whatever their names.
    The profiler now and then loses events, so a window in which a range's
    kernel count is no multiple of `iters` is taken again, three times at most."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def launched(event):
        return len(event.kernels) + sum(launched(child) for child in event.cpu_children)

    for _, fn in segments:
        fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for label, fn in segments:
                fn()  # an unmeasured call: the first event of a window is the one most often lost
                torch.cuda.synchronize()
                with record_function(f"ranges_device_ms/{label}"):
                    for _ in range(iters):
                        fn()
                torch.cuda.synchronize()
        out, whole = {}, True
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("ranges_device_ms/"):
                n = launched(e)
                whole = whole and n > 0 and n % iters == 0
                out[e.name.split("/", 1)[1]] = e.device_time_total / iters / 1e3
        if whole and len(out) == len(segments):
            return out
    check(len(out) == len(segments), f"the profiler kept {sorted(out)} of {[l for l, _ in segments]}")
    print("ranges_device_ms: kernel events were lost in three windows; the last window's sums are used", flush=True)
    return out


def make_candidates(rng, B, K, device, nc=80):
    """Random prefiltered candidates: score-sorted, a quarter of the slots invalid."""
    xy = rng.uniform(0, 640, size=(B, K, 2)).astype(np.float32)
    wh = rng.uniform(8, 160, size=(B, K, 2)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    scores = rng.uniform(0.25, 1.0, size=(B, K)).astype(np.float32)
    scores[:, K - K // 4:] = -1.0
    scores[:, 1:K // 8:7] = scores[:, 0:K // 8 - 1:7]  # exact ties: lowest index first
    order = np.argsort(-scores, axis=1, kind="stable")
    scores = np.take_along_axis(scores, order, 1)
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    cls = rng.integers(0, nc, size=(B, K)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (boxes + cls[..., None] * 7680.0, boxes, scores, cls)]


# (label, B, K, iou): the serving top-k of yolov3 (256 + 128 + 64) and of yolov3-tiny (256 + 128), the
# full-decode fallback and the val grade
NMS_SHAPES = (("serving", 32, 448, 0.45), ("tiny serving", 32, 384, 0.45), ("fallback", 4, 8192, 0.45),
              ("val", 2, 30000, 0.6))
NMS_KERNEL = "greedy_nms"  # in the name of each of csrc/nms.cu's kernels


def nms_step_chain_ms(device="cuda", B=32):
    """Least time of one NMS step: its dependent chain (warp argmax, broadcast
    of the selected box, one IoU test, compare) with nothing else to do.
    Measured with the warp kernel at one candidate a lane (K = 32, boxes that
    never overlap, so n steps for n valid scores): the difference between a
    run of 32 steps and a run of 16, over 16."""
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms

    x1 = torch.arange(32, device=device, dtype=torch.float32).repeat(B, 1) * 100.0
    boxes = torch.stack([x1, torch.zeros_like(x1), x1 + 50.0, torch.full_like(x1, 50.0)], -1)
    cls = torch.zeros((B, 32), device=device)
    ms = {}
    for n_valid in (32, 16):
        scores = torch.linspace(0.9, 0.3, 32, device=device).repeat(B, 1)
        scores[:, n_valid:] = -1.0
        _, n = greedy_nms(boxes, boxes, scores, cls, 0.45, 300)
        check(bool((n == n_valid).all()), f"the chain run took {n.tolist()} steps, expected {n_valid}")
        ms[n_valid] = device_ms(lambda: greedy_nms(boxes, boxes, scores, cls, 0.45, 300), NMS_KERNEL)
    return (ms[32] - ms[16]) / 16


def phase_nms(rng, shapes=NMS_SHAPES, device="cuda"):
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain

    chain_ms = nms_step_chain_ms(device)
    print(f"K1 greedy_nms step chain (argmax, broadcast, one IoU, compare; measured at one candidate "
          f"a lane): {chain_ms * 1e3:.3f} us", flush=True)
    rows = {}
    for label, B, K, iou in shapes:
        args = make_candidates(rng, B, K, device)
        out_k, n_k = greedy_nms(*args, iou, 300)
        out_p, n_p = greedy_nms_plain(*args, iou, 300)
        torch.cuda.synchronize()
        check(torch.equal(n_k, n_p), f"greedy_nms {label}: n differs from the plain version")
        err = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p), f"greedy_nms {label}: rows differ (max abs err {err})")
        route = greedy_nms.last_route
        ms = device_ms(lambda: greedy_nms(*args, iou, 300), NMS_KERNEL)
        launch_ms = cuda_ms(lambda: greedy_nms(*args, iou, 300))
        plain_ms = cuda_ms(lambda: greedy_nms_plain(*args, iou, 300), iters=3, warmup=1)
        nbytes = B * K * 40 + B * 300 * 24 + B * 4
        ops = int(n_k.sum()) * K * NMS_OPS_PER_IOU
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
        # the steps of one image are sequential: the longest image times one step's chain
        latency_bound_ms = int(n_k.max()) * chain_ms
        rows[label] = dict(B=B, K=K, max_det=300, n_mean=float(n_k.float().mean()), max_abs_err=err,
                           route=route, ms=ms, launch_ms=launch_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, latency_bound_ms=latency_bound_ms)
        print(f"K1 greedy_nms {label}: B={B} K={K} [{route}] equal to plain, n_mean={rows[label]['n_mean']:.1f} "
              f"kernel {ms:.4f} ms device ({launch_ms:.4f} ms with launch), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}), latency bound {latency_bound_ms:.4f} ms "
              f"({int(n_k.max())} steps x the chain), "
              f"{ms / rows[label]['n_mean'] * 1e3 if rows[label]['n_mean'] else float('nan'):.2f} us/step",
              flush=True)
    return rows


HOST_NMS_VAL = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, max_det=300, max_nms=30000)  # the val grade
OPTIONAL_PACKAGES = ("tensorboard", "tensorflow", "wandb", "clearml", "comet_ml", "cv2", "matplotlib")


def host_loop_ms(fn, iters=3):
    """Least wall time of a host call over `iters` runs, in ms."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def phase_host_nms(model, serving_batch, val_imgs, gpu):
    """The host greedy NMS (yolov3_tpu_torch.native, csrc/host_ops.cpp) against
    K1 on the same candidates from the card: the serving batch's top-k
    candidates (B=32, K=448, from the fused bf16 forward and decode_topk_nhwc),
    and two val frames' candidates at the val grade (K=30000, multi-label,
    conf 0.001, iou 0.6: the candidates batched_nms hands K1). n equal per
    image and rows within the NMS bars (box 0.1, conf 1e-3); the images whose
    rows are equal in every bit are counted. Also non_max_suppression on the
    val predictions as a numpy array (engine "auto": the host loop) against
    batched_nms on the card. Times: the host loop's best of three against
    K1's device time and its time with the launch."""
    from yolov3_tpu_torch import native
    from yolov3_tpu_torch.models.detect_head import decode_predictions, decode_topk_nhwc
    from yolov3_tpu_torch.models.detection import cast_for_inference
    from yolov3_tpu_torch.ops.nms import MAX_WH, batched_nms, nms_from_candidates, non_max_suppression
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms

    check(native.available(), "host NMS: the host library did not load")
    reset_kernel_counts()
    rows, timing_launches = {}, [0]

    def compare(label, args, iou, max_det=300):
        out_k, n_k = greedy_nms(*args, iou, max_det)
        torch.cuda.synchronize()
        host = [a.float().cpu().numpy() for a in args]
        out_h, n_h = native.greedy_nms_batch(*host, iou, max_det)
        n_k, out_k = n_k.cpu().numpy(), out_k.cpu().numpy()
        check((n_k == n_h).all(), f"host NMS {label}: n {n_h.tolist()} != K1 {n_k.tolist()}")
        box_err = conf_err = 0.0
        exact = 0
        for b in range(len(n_k)):
            e = check_dets(out_h[b, : n_h[b]], out_k[b, : n_k[b]], f"host NMS {label} image {b}")
            box_err, conf_err = max(box_err, e[0]), max(conf_err, e[1])
            exact += bool(np.array_equal(out_h[b], out_k[b]))
        host_ms = host_loop_ms(lambda: native.greedy_nms_batch(*host, iou, max_det))
        before = greedy_nms.launches
        k1_ms = device_ms(lambda: greedy_nms(*args, iou, max_det), NMS_KERNEL)
        k1_launch_ms = cuda_ms(lambda: greedy_nms(*args, iou, max_det))
        timing_launches[0] += greedy_nms.launches - before
        B, K = args[2].shape
        rows[label] = dict(B=B, K=K, n_sum=int(n_k.sum()), exact_images=exact, box_err=box_err, conf_err=conf_err,
                           host_ms=host_ms, k1_ms=k1_ms, k1_launch_ms=k1_launch_ms)
        print(f"host NMS {label}: B={B} K={K}, n equal ({int(n_k.sum())} rows), {exact} of {B} images equal in "
              f"every bit (box err {box_err:.3g}, conf err {conf_err:.3g}); host loop {host_ms:.3f} ms against K1 "
              f"{k1_ms:.4f} ms device ({k1_launch_ms:.4f} ms with launch) on {gpu}", flush=True)

    with torch.inference_mode():
        serving = cast_for_inference(model.fuse())
        imgs = torch.as_tensor(serving_batch, device=model.device)
        feats = serving(imgs.to(torch.bfloat16) / 255.0, raw=True)
        boxes, scores, cls_ids, ov = decode_topk_nhwc(feats, model.anchors_px, model.spec.strides, with_overflow=True)
        check(not bool(ov.any()), "host NMS: the serving batch overflowed its top-k")
        boxes, scores, cls_ids = boxes.float(), scores.float(), cls_ids.float()
        compare("serving", (boxes + (cls_ids * MAX_WH)[..., None], boxes, torch.where(scores > 0, scores, -1.0),
                            cls_ids), 0.45)
        want_d, want_n = nms_from_candidates(boxes, scores, cls_ids)  # the serving path's own call
        check(int(want_n.sum()) == rows["serving"]["n_sum"], "host NMS: nms_from_candidates disagrees")
        del serving, feats

        x = torch.as_tensor(val_imgs, device=model.device).float() / 255.0
        pred = decode_predictions(model(x), model.anchors_px, model.spec.strides)
        captured = []

        def capture(*args):
            captured.append(args[:4])
            return greedy_nms(*args)

        dets_k, n_k = batched_nms(pred, **HOST_NMS_VAL, nms_fn=capture)
        check(captured[0][2].shape[1] == 30000, f"host NMS: the val candidates are K={captured[0][2].shape[1]}")
        compare("val", captured[0], HOST_NMS_VAL["iou_thres"])
        t0 = time.perf_counter()
        lists = non_max_suppression(pred.cpu().numpy(), **HOST_NMS_VAL)  # numpy: the host engine
        engine_ms = (time.perf_counter() - t0) * 1e3
        n_k = n_k.cpu().numpy()
        check([len(d) for d in lists] == n_k.tolist(), f"host engine n {[len(d) for d in lists]} != K1 {n_k}")
        for b, d in enumerate(lists):
            check_dets(d, dets_k[b, : n_k[b]].cpu().numpy(), f"host engine val image {b}")
    rows["val"]["engine_ms"] = engine_ms
    check(rows["serving"]["n_sum"] > 0 and rows["val"]["n_sum"] > 0, "host NMS: a comparison without detections")
    # K1 once a comparison (serving, nms_from_candidates, the val batched_nms and its candidates), K2 three
    # times for the serving candidates; the timing loops' launches are left out
    rows["launches"] = {**kernel_counts(), "greedy_nms": greedy_nms.launches - timing_launches[0]}
    check(rows["launches"] == {"greedy_nms": 4, "masked_scores": 3, "conv3x3_bn_stats": 0},
          f"host NMS phase launches {rows['launches']}")
    print(f"host NMS: non_max_suppression(numpy, engine auto) at the val grade: {engine_ms:.1f} ms for "
          f"{len(lists)} frames (batched_nms's candidate prep on the CPU and the host loop), rows equal to "
          f"batched_nms through K1 within the NMS bars", flush=True)
    return rows


def optional_packages():
    """Which optional packages this host has (found on its path; none is imported)."""
    import importlib.util

    return {p: importlib.util.find_spec(p) is not None for p in OPTIONAL_PACKAGES}


SCORE_CELLS = (6400, 1600, 400)  # yolov3@640's 80x80, 40x40 and 20x20 grids
# (label, B, M, dtype, storage offset in elements): ragged cell counts, f16 and f32 rows, views whose
# data start off a 16-byte line (every tile then has a head and a tail of 2-byte loads), one cell
SCORE_EXTRA = (("ragged bf16", 3, 401, torch.bfloat16, 0), ("ragged f16", 3, 401, torch.float16, 0),
               ("ragged f32", 3, 401, torch.float32, 0), ("unaligned bf16 view", 3, 401, torch.bfloat16, 1),
               ("unaligned f32 view", 2, 7, torch.float32, 1), ("one cell", 1, 1, torch.bfloat16, 3))
SCORE_KERNEL = "score_kernel"  # in the name of csrc/score.cu's kernel


def score_module():
    """The tree's K2 wrapper: ops.score_cuda, or ops.score_triton in a tree from before it."""
    try:
        from yolov3_tpu_torch.ops import score_cuda as module
    except ImportError:
        from yolov3_tpu_torch.ops import score_triton as module
    return module


def make_heads(rng, shapes, na=3, no=85, device="cuda"):
    """Seeded head outputs (B, M, na*no) in `dtype`, starting `offset` elements into their storage."""
    heads = []
    for B, M, dtype, offset in shapes:
        x = rng.normal(-3.0, 2.0, size=(B * M * na * no + offset,)).astype(np.float32)
        heads.append(torch.from_numpy(x).to(device, dtype)[offset:].view(B, M, na * no))
    return heads


def check_scores(f, na, no, conf, label):
    """K2 against its plain version on one head: class args equal, scores within
    1e-6, valid masks equal away from the threshold. Returns the max score error."""
    from yolov3_tpu_torch.ops.score_cuda import masked_scores, masked_scores_plain

    s_k, a_k = masked_scores(f, na, no, conf)
    s_p, a_p = masked_scores_plain(f, na, no, conf)
    torch.cuda.synchronize()
    check(torch.equal(a_k, a_p), f"masked_scores {label}: class args differ")
    both = (s_k >= 0) & (s_p >= 0)
    e = float((s_k - s_p)[both].abs().max()) if bool(both.any()) else 0.0
    check(e <= 1e-6, f"masked_scores {label}: scores differ by {e} > 1e-6")
    v = f.reshape(f.shape[0], -1, no).float()
    obj = torch.sigmoid(v[..., 4])
    score = obj * torch.sigmoid(v[..., 5:].amax(-1))
    # within 1e-6 of the threshold either side may round across it
    near = ((score - conf).abs() <= 1e-6) | ((obj - conf).abs() <= 1e-6)
    flips = ((s_k >= 0) != (s_p >= 0)) & ~near
    check(not bool(flips.any()), f"masked_scores {label}: valid masks differ")
    check(bool(((s_k == -1.0) | (s_k > conf)).all()), f"masked_scores {label}: a score is neither -1 nor > conf")
    print(f"K2 masked_scores {label} {tuple(f.shape)} {str(f.dtype).split('.')[-1]} "
          f"[{masked_scores.last_route}]: args equal, valid {int((s_k >= 0).sum())}, max score err {e:.3g}",
          flush=True)
    return e


def phase_score(rng, bs=32, conf=0.25, device="cuda"):
    """K2 against its plain version on bf16 head outputs of yolov3@640 at
    batch 32 and at SCORE_EXTRA's shapes; device time per scale and for the
    three scales, beside the byte bound of each."""
    from yolov3_tpu_torch.ops.score_cuda import masked_scores, masked_scores_plain

    na, no = 3, 85
    heads = make_heads(rng, [(bs, m, torch.bfloat16, 0) for m in SCORE_CELLS], na, no, device)
    t0 = time.perf_counter()
    masked_scores(heads[0], na, no, conf)
    torch.cuda.synchronize()
    print(f"K2 masked_scores: first launch {time.perf_counter() - t0:.2f} s", flush=True)
    err = max(check_scores(f, na, no, conf, f"yolov3@640 {int(f.shape[1] ** 0.5)}x{int(f.shape[1] ** 0.5)}")
              for f in heads)
    # a generator of their own: the serving frames drawn from `rng` later stay those of earlier PRs
    extra = make_heads(np.random.default_rng(1), [row[1:] for row in SCORE_EXTRA], na, no, device)
    for (label, *_), f in zip(SCORE_EXTRA, extra):
        err = max(err, check_scores(f, na, no, conf, label))
    check(extra[3].data_ptr() % 16 != 0 and extra[4].data_ptr() % 16 != 0, "the unaligned views are aligned")

    def run(fn):
        return lambda: [fn(f, na, no, conf) for f in heads]

    def nbytes(f):
        return f.numel() * f.element_size() + f.shape[0] * f.shape[1] * na * 8

    scales = []
    for f in heads:
        ms = device_ms(lambda: masked_scores(f, na, no, conf), SCORE_KERNEL)
        bound = nbytes(f) / HBM_BYTES_PER_S * 1e3
        scales.append(dict(cells=f.shape[1], ms=ms, bound_ms=bound, mb=nbytes(f) / 1e6))
    ms = device_ms(run(masked_scores), SCORE_KERNEL, per_call=len(heads))
    launch_ms = cuda_ms(run(masked_scores))
    plain_ms = cuda_ms(run(masked_scores_plain))
    total = sum(nbytes(f) for f in heads)
    bound_ms = total / HBM_BYTES_PER_S * 1e3
    print("K2 masked_scores bs32 per scale: " + "; ".join(
        f"{int(r['cells'] ** 0.5)}x{int(r['cells'] ** 0.5)} {r['ms']:.4f} ms device, bound {r['bound_ms']:.4f} ms "
        f"({r['mb']:.1f} MB)" for r in scales), flush=True)
    print(f"K2 masked_scores bs{bs}, 3 scales: kernel {ms:.4f} ms device ({launch_ms:.4f} ms with "
          f"launches), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({total / 1e6:.1f} MB), "
          f"{bound_ms / ms:.1%} of the bound", flush=True)
    return dict(max_abs_err=err, ms=ms, launch_ms=launch_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", scales=scales)


def plant_detections(model, base, gains, deltas, cls_bump=12.0):
    """Bias the Detect head so it emits real candidates (bench.py:_plant_detections):
    scale i's objectness kernel column times gains[i] and its bias plus
    deltas[i]; every class bias plus cls_bump, so conf = obj * cls_max ~ obj."""
    detect = model.model[-1]
    no = detect.no
    with torch.no_grad():
        for i, conv in enumerate(detect.m):
            w, b = base[i][0].clone(), base[i][1].clone()
            w[4::no] *= float(gains[i])  # output channel a*no + 4 of every anchor a
            b[4::no] += float(deltas[i])
            for a in range(detect.na):
                b[a * no + 5:(a + 1) * no] += cls_bump
            conv.weight.copy_(w)
            conv.bias.copy_(b)


def calibrate(model, probe, targets=(112.0, 28.0, 10.0), conf=0.25):
    """Gains and bias shifts that put about targets[i] cells per image of scale i
    above conf: gains widen the objectness logits' spread to ~2, the shift
    moves the (1 - target/cells) quantile to the conf crossing."""
    detect = model.model[-1]
    with torch.inference_mode():
        feats = model(torch.as_tensor(probe, device=model.device).float() / 255.0, raw=True)
    gains, deltas = [], []
    for i, f in enumerate(feats):
        bs, ny, nx, _ = f.shape
        b0 = detect.m[i].bias.detach().reshape(detect.na, detect.no)[:, 4].float()
        obj = f.reshape(bs, ny * nx, detect.na, detect.no)[..., 4].float()
        spread = obj - b0  # the part the kernel column scales
        g = float(np.clip(2.0 / max(float(spread.std()), 1e-8), 1.0, 1e6))
        planted = (g * spread + b0).reshape(-1)
        q = float(torch.quantile(planted, 1.0 - targets[i] / (ny * nx * detect.na)))
        gains.append(g)
        deltas.append(float(np.log(conf / (1 - conf))) + 0.05 - q)
    return gains, deltas


def settle_bn(model, frames):
    """Every BatchNorm's running statistics from one train-mode forward of
    `frames` (momentum 1), then eval mode. With its seeded init statistics
    (mean 0, var 1) a random yolov5s's eval forward shrinks its activations
    layer by layer until the head's objectness no longer depends on the
    image, and no bias shift plants a given number of detections; a trained
    model's statistics keep them at unit scale, as these do."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(torch.as_tensor(frames, device=model.device).float() / 255.0, raw=True)
    for bn, m in zip(bns, momenta):
        bn.momentum = m
    model.eval()


def plant_under_topk(model, frames, k=(256, 128, 64), targets=(112.0, 28.0, 10.0), conf=0.25):
    """Plant detections (`calibrate`, `plant_detections`) for the served
    frames themselves, halving a scale's target until no frame has more than
    half that scale's top-k above `conf`: a random yolov5's objectness moves
    with each frame as a whole (at 40x40 one frame in 32 had ten times the
    median above conf), and a frame past the top-k takes the full-decode
    fallback. Returns the targets, the cells above conf by scale and frame, and
    the gains and bias shifts planted."""
    detect = model.model[-1]
    base = [(c.weight.detach().clone(), c.bias.detach().clone()) for c in detect.m]
    targets = list(targets)
    for _ in range(10):
        with torch.no_grad():
            for conv, (w, b) in zip(detect.m, base):
                conv.weight.copy_(w)
                conv.bias.copy_(b)
        gains, deltas = calibrate(model, frames, tuple(targets), conf)
        plant_detections(model, base, gains, deltas)
        with torch.inference_mode():
            feats = model(torch.as_tensor(frames, device=model.device).float() / 255.0, raw=True)
        counts = []
        for f in feats:
            p = torch.sigmoid(f.float().reshape(f.shape[0], -1, detect.no))
            counts.append(((p[..., 4:5] * p[..., 5:]).amax(-1) > conf).sum(1).cpu().numpy())
        over = [i for i, c in enumerate(counts) if c.max() > k[min(i, len(k) - 1)] // 2]
        if not over:
            return targets, counts, gains, deltas
        for i in over:
            targets[i] /= 2
    raise RuntimeError(f"chip_smoke: no targets keep every frame under half the top-k {k}: {targets}")


# (label, B, C, H, W, act, residual): yolov3@640 batch 32's largest epilogue (its first stride-2 conv), a darknet
# residual block at 160x160 and one at 20x20; yolov5x6@1280 batch 16's largest (its 6x6 stem) and a C3 bottleneck's
EPILOGUE_SHAPES = (("yolov3 320x320x64", 32, 64, 320, 320, "silu", False),
                   ("yolov3 160x160x128 residual", 32, 128, 160, 160, "silu", True),
                   ("yolov3 20x20x1024 residual", 32, 1024, 20, 20, "silu", True),
                   ("yolov5x6 640x640x80", 16, 80, 640, 640, "silu", False),
                   ("yolov5x6 320x320x160 residual", 16, 160, 320, 320, "silu", True))
EPILOGUE_KERNEL = "conv_epilogue"  # in the name of csrc/epilogue.cu's kernel


def bf16_ulps(a, b):
    """The largest distance between two bf16 / f16 tensors in units in the last place (-0 and +0 equal)."""
    def ordered(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((ordered(a) - ordered(b)).abs().max())


CANCEL_FLOOR = 2.0 ** -6  # below it a bf16 unit in the last place (<= 2^-14) nears f32's rounding of a cancelling sum


def bf16_ulps_apart(a, b, floor=CANCEL_FLOOR):
    """(bf16_ulps over the elements where |b| >= floor, the largest absolute
    difference where |b| < floor). Two float32 sums of the same bf16
    products in another order differ by float32 rounding, about 1e-6 at
    these widths; where the sum cancels to near 0 that is many units in the
    last place of a tiny value: the plain version in float32 on the CPU
    lies 13184 units from float64 at |v| 2.8e-6 of yolov3-tiny's stem, and
    within one wherever |v| >= 2^-6. So a conv computed in another order is
    held to one unit above the floor and to 2^-14 (one unit just under it)
    below."""
    big = b.float().abs() >= floor
    ulps = bf16_ulps(a[big], b[big]) if bool(big.any()) else 0
    below = float((a.float() - b.float()).abs()[~big].max()) if bool((~big).any()) else 0.0
    return ulps, below


def phase_epilogue(shapes=EPILOGUE_SHAPES, device="cuda"):
    """The conv epilogue kernel (csrc/epilogue.cu) against its plain version
    at the served shapes of EPILOGUE_SHAPES (bf16, channels_last): within one
    unit in the last place, and the share of elements that differ at all;
    then each shape's device time beside its byte bound
    ((2 + residual) * numel * 2 + 2 C bytes at 3.35 TB/s), the plain
    version's time and that of the three PyTorch passes it replaced (cuDNN's
    in-place bias add, SiLU, the residual add), both by CUDA events."""
    import torch.nn.functional as F

    from yolov3_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain

    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for label, B, C, H, W, act, residual in shapes:
        y0 = (torch.randn((B, H, W, C), generator=gen, device=device) * 3).to(torch.bfloat16).permute(0, 3, 1, 2)
        bias = torch.randn((C,), generator=gen, device=device).to(torch.bfloat16)
        r = torch.randn((B, H, W, C), generator=gen, device=device).to(torch.bfloat16).permute(0, 3, 1, 2) \
            if residual else None
        want = conv_epilogue_plain(y0, bias, act, r)
        y = y0.clone(memory_format=torch.channels_last)
        t0 = time.perf_counter()
        conv_epilogue(y, bias, act, r)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ulps = bf16_ulps(y, want)
        differ = float((y != want).float().mean())
        check(ulps <= 1, f"conv_epilogue {label}: {ulps} ulps from the plain version")
        del want
        nbytes = (2 + bool(residual)) * y.numel() * 2 + 2 * C
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = device_ms(lambda: conv_epilogue(y, bias, act, r), EPILOGUE_KERNEL)
        plain_ms = cuda_ms(lambda: conv_epilogue_plain(y0, bias, act, r), iters=5)
        b4 = bias.view(1, -1, 1, 1)

        def passes():
            out = F.silu(y.add_(b4))
            return out if r is None else r + out

        passes_ms = cuda_ms(passes, iters=10)
        rows[label] = dict(ulps=ulps, differ=differ, ms=ms, bound_ms=bound_ms, share=bound_ms / ms,
                           plain_ms=plain_ms, passes_ms=passes_ms, gb=nbytes / 1e9)
        print(f"conv_epilogue {label} {(B, C, H, W)} {act}{' + residual' if residual else ''}: first call "
              f"{first_s:.2f} s; within {ulps} ulp of the plain version ({differ:.2e} of elements differ); device "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB), {bound_ms / ms:.1%} of the bound "
              f"= {nbytes / ms / 1e6:.0f} GB/s; plain {plain_ms:.4f} ms; the three PyTorch passes "
              f"{passes_ms:.4f} ms", flush=True)
        del y, y0, r
    return rows


# (label, B, Cin, Cout, H, W, keep): yolov3-tiny@640 batch 32's four conv -> max-pool pairs, layers 0/1 to 6/7 (its
# 8/9, 128 -> 256 channels, is wider than the kernel takes)
CONV_POOL_SHAPES = (("tiny 0/1 640x640 3->16", 32, 3, 16, 640, 640, False),
                    ("tiny 2/3 320x320 16->32", 32, 16, 32, 320, 320, False),
                    ("tiny 4/5 160x160 32->64", 32, 32, 64, 160, 160, False),
                    ("tiny 6/7 80x80 64->128", 32, 64, 128, 80, 80, False))
CONV_POOL_KERNEL = "conv_pool"  # in the name of each of csrc/conv_pool.cu's kernels


def phase_conv_pool(shapes=CONV_POOL_SHAPES, device="cuda"):
    """The conv + max-pool kernel (csrc/conv_pool.cu) against its plain
    version at CONV_POOL_SHAPES (bf16, channels_last, SiLU; cuDNN's float32
    convolutions without TF32): within one unit in the last place where
    |v| >= 2^-6 and 2^-14 below (`bf16_ulps_apart`), and the share of pooled
    elements that differ at all; then each shape's device
    time beside its bound (x, the pooled output, the unpooled one where kept
    and the weight once at 3.35 TB/s, or 2 * 9 * Cin * Cout a pixel at
    989 TFLOP/s, whichever is larger) and beside the three kernels it
    replaced, cuDNN's conv + `conv_epilogue` + `F.max_pool2d` (`library_ms`:
    the device time of each side's kernels, one profiler window), and the
    plain version's time by CUDA events."""
    import torch.nn.functional as F

    from yolov3_tpu_torch.ops.conv_pool_cuda import conv_pool, conv_pool_plain
    from yolov3_tpu_torch.ops.epilogue_cuda import conv_epilogue

    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    try:
        for label, B, cin, cout, H, W, keep in shapes:
            x = torch.rand((B, H, W, cin), generator=gen, device=device).to(torch.bfloat16).permute(0, 3, 1, 2)
            scale = 3.0 / (9 * cin) ** 0.5
            weight = ((torch.rand((cout, 3, 3, cin), generator=gen, device=device) * 2 - 1) * scale).to(
                torch.bfloat16).permute(0, 3, 1, 2)
            bias = torch.randn((cout,), generator=gen, device=device).to(torch.bfloat16)
            want = conv_pool_plain(x, weight, bias, "silu", keep)
            t0 = time.perf_counter()
            pooled, unpooled = conv_pool(x, weight, bias, "silu", keep)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            apart = [bf16_ulps_apart(pooled, want[0]), bf16_ulps_apart(unpooled, want[1]) if keep else (0, 0.0)]
            ulps, below = max(u for u, _ in apart), max(d for _, d in apart)
            differ = float((pooled != want[0]).float().mean())
            check(ulps <= 1 and below <= 2.0 ** -14, f"conv_pool {label}: {ulps} ulps from the plain version where "
                                                     f"|v| >= 2^-6, {below:.3e} apart below")
            check(not keep or torch.equal(pooled, F.max_pool2d(unpooled, 2, 2)),
                  f"conv_pool {label}: the pooled store is not the max of the unpooled one")
            del want, pooled, unpooled
            flops = 2 * 9 * cin * cout * B * H * W
            nbytes = 2 * (x.numel() + B * cout * (H // 2) * (W // 2) + (B * cout * H * W if keep else 0)
                          + weight.numel() + cout)
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e3
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_OPS_PER_S else "operations"

            def fused():
                return conv_pool(x, weight, bias, "silu", keep)

            def library():  # the parent's three kernels: cuDNN's conv, the epilogue in place, PyTorch's pool
                y = conv_epilogue(F.conv2d(x, weight, None, 1, 1), bias, "silu")
                return F.max_pool2d(y, 2, 2), (y if keep else None)

            with torch.no_grad():
                ms = device_ms(fused, CONV_POOL_KERNEL)
                both = ranges_device_ms([("fused", fused), ("library", library)])
                events_ms = cuda_ms(fused, iters=20)
                library_events_ms = cuda_ms(library, iters=20)
                plain_ms = cuda_ms(lambda: conv_pool_plain(x, weight, bias, "silu", keep), iters=3)
            rows[label] = dict(ulps=ulps, below=below, differ=differ, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                               share=bound_ms / ms, library_ms=both["library"], fused_range_ms=both["fused"],
                               events_ms=events_ms, library_events_ms=library_events_ms, plain_ms=plain_ms,
                               gb=nbytes / 1e9, gflop=flops / 1e9)
            print(f"conv_pool {label} B={B} keep={keep}: first call {first_s:.2f} s; within {ulps} ulp of the plain "
                  f"version where |v| >= 2^-6 and {below:.2e} below ({differ:.2e} of pooled elements differ); "
                  f"device {ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.2f} GFLOP), {bound_ms / ms:.1%} of the bound, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; library (cuDNN conv + conv_epilogue + max_pool2d) "
                  f"{both['library']:.4f} ms device, {library_events_ms:.4f} ms by events (the kernel "
                  f"{events_ms:.4f}); plain {plain_ms:.4f} ms", flush=True)
            del x, weight, bias
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    total = {k: sum(r[k] for r in rows.values()) for k in ("ms", "bound_ms", "library_ms")}
    print(f"conv_pool all {len(rows)} pairs: device {total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"({total['bound_ms'] / total['ms']:.1%}), library {total['library_ms']:.4f} ms", flush=True)
    return rows


KERNEL_GROUPS = (  # kernel-name substrings -> the layer it belongs to, first match wins
    ("K1 greedy_nms", ("greedy_nms",)),
    ("K2 masked_scores", (SCORE_KERNEL,)),
    ("conv epilogue", (EPILOGUE_KERNEL,)),
    ("conv + max pool", (CONV_POOL_KERNEL,)),
    ("convolutions (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "sm90", "cudnn", "nhwc", "nvjet")),
    ("sort (top-k)", ("sort", "radix")),
)


def profile_fast_path(infer, imgs, iters=3):
    """Device time of `iters` served batches by layer, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    infer(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            infer(imgs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(spans, "the profiler saw no device activity")
    by_group, by_name, busy, edge = {}, {}, 0.0, -1.0
    for start, end, name in spans:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name.lower() for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + (end - start)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    parts = ", ".join(f"{g} {t / iters / 1e3:.3f} ms" for g, t in sorted(by_group.items(), key=lambda x: -x[1]))
    print(f"profile, per batch of {imgs.shape[0]}: {parts}; device busy {busy / wall_us:.1%} "
          f"of {wall_us / iters / 1e3:.3f} ms wall", flush=True)
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        print(f"profile kernel {t / iters / 1e3:.3f} ms  {name[:110]}", flush=True)


SERVE_TARGETS = {8: 112.0, 16: 28.0, 32: 10.0}  # cells an image above conf 0.25 planted at each head stride
SERVE_MAX_NMS = 8192  # the full-decode fallback's max_nms (serve._paths)


def phase_main_path(rng, model, imgsz=640, n_requests=64, max_batch=32, label="main path", fit_frames=False):
    """The serving path of `model` (any head, nl levels): detections planted
    at SERVE_TARGETS by head stride (calibrated on the first 8 frames; with
    `fit_frames`, on all of them, the targets halved until every frame is
    under half each level's top-k: `plant_under_topk`), `n_requests` concurrent requests through
    MicroBatcher(max_batch), then a dense batch that takes the full-decode
    fallback. Launches over that run: K2 nl times and K1 once a device call,
    and K1 once more for the fallback (K = min(8192, every anchor row)).
    The folded model's convs: the epilogue kernel once a `Conv` a fast path
    (a device call or the dense batch's), but the conv + max-pool kernel
    once instead for a conv of `conv_pool_pairs`. Then ms per batch, its profile and
    `check_fast_path`. `label` starts each line printed."""
    from yolov3_tpu_torch.nn.modules import Conv
    from yolov3_tpu_torch.ops import nms as nms_module
    from yolov3_tpu_torch.ops.conv_pool_cuda import conv_pool
    from yolov3_tpu_torch.ops.epilogue_cuda import conv_epilogue
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores
    from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer

    nl, na = model.spec.nl, model.spec.na
    frames = rng.integers(0, 256, size=(n_requests, imgsz, imgsz, 3), dtype=np.uint8)
    base = [(c.weight.detach().clone(), c.bias.detach().clone()) for c in model.model[-1].m]
    targets = tuple(SERVE_TARGETS[s] for s in model.spec.strides)
    if fit_frames:
        targets, counts, gains, deltas = plant_under_topk(model, frames, targets=targets)
        print(f"{label}: detections planted at targets {[round(t, 2) for t in targets]} cells an image by level; "
              "above conf 0.25 (f32 eval) by level, median / max over the frames: "
              + ", ".join(f"{int(np.median(c))} / {int(c.max())}" for c in counts), flush=True)
    else:
        gains, deltas = calibrate(model, frames[:8], targets=targets)
        plant_detections(model, base, gains, deltas)
    infer = build_batched_infer(model)
    batcher = MicroBatcher(infer, max_batch=max_batch, batch_wait_ms=50.0)
    batcher.warmup(imgsz)
    torch.cuda.synchronize()
    warm_fallbacks = infer.fallbacks  # the warm-up's zero frames may overflow a planted model's top-k

    # --- the main path: every launch from here to the count read is the path's own
    greedy_nms.launches = 0
    masked_scores.launches = 0
    conv_epilogue.launches = 0
    conv_pool.launches = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=n_requests) as pool:
        results = [f.result() for f in [pool.submit(batcher.submit, im) for im in frames]]
    serve_s = time.perf_counter() - t0
    served_fallbacks = infer.fallbacks - warm_fallbacks

    # dense batch: scale 0's objectness far above conf, so its top-k overflows;
    # the fallback's batched_nms resolves greedy_nms in ops.nms, where it is
    # wrapped here to record the candidate count K of each call
    plant_detections(model, base, gains, [deltas[0] + 8.0, *deltas[1:]])
    dense_infer = build_batched_infer(model)
    seen_k = []
    real_nms = nms_module.greedy_nms

    def recording_nms(*args, **kwargs):
        seen_k.append(args[2].shape[1])
        return real_nms(*args, **kwargs)

    nms_module.greedy_nms = recording_nms
    try:
        dense_dets, dense_n = dense_infer(frames[:8])
        torch.cuda.synchronize()
    finally:
        nms_module.greedy_nms = real_nms
        plant_detections(model, base, gains, deltas)
    launches = {"greedy_nms": greedy_nms.launches, "masked_scores": masked_scores.launches,
                "conv_epilogue": conv_epilogue.launches, "conv_pool": conv_pool.launches}
    # --- end of the main path

    print(f"{label}: {n_requests} requests in {serve_s:.3f} s = {n_requests / serve_s:.1f} img/s "
          f"({batcher.calls} device calls, {served_fallbacks} fallbacks), launches {launches}", flush=True)
    check(batcher.requests == n_requests, f"{label}: batcher served {batcher.requests} of {n_requests}")
    counts = []
    for dets, n in results:
        check(dets.shape == (n, 6) and np.isfinite(dets).all(), f"{label}: request result malformed")
        check((dets[:, 4] > 0).all() and (np.diff(dets[:, 4]) <= 0).all(),
              f"{label}: rows not valid-first by score")
        counts.append(n)
    check(max(counts) > 0, f"{label}: no request got a detection")
    check(served_fallbacks == 0, f"{label}: a served batch took the full-decode fallback")
    check(dense_infer.fallbacks == 1, f"{label}: the dense batch did not take the full-decode fallback")
    # every device call and the dense batch's fast path: K2 once a level, K1 once, the epilogue once a Conv but
    # for those of a conv -> max-pool pair, which launch the conv + max-pool kernel instead; the fallback: K1 once more
    calls = batcher.calls + 1
    pairs = len(infer.serving_model.conv_pool_pairs)
    convs = sum(isinstance(m, Conv) for m in infer.serving_model.modules()) - pairs
    want = {"greedy_nms": calls + 1, "masked_scores": nl * calls, "conv_epilogue": convs * calls,
            "conv_pool": pairs * calls}
    check(launches == want, f"{label}: launches {launches} in {batcher.calls} device calls and a fallback batch, "
                            f"expected {want} (K2 {nl}, K1 1, the epilogue {convs} and the conv + max pool {pairs} "
                            "a call, K1 1 more on the fallback)")
    fallback_k = min(SERVE_MAX_NMS, na * sum((imgsz // s) ** 2 for s in model.spec.strides))
    check(seen_k == [fallback_k], f"{label}: fallback NMS ran at K={seen_k}, expected [{fallback_k}]")
    print(f"{label} requests: n per image mean {np.mean(counts):.1f}, max {max(counts)}; dense batch fell back, "
          f"K1 at K={seen_k[0]} [{greedy_nms.last_route}], n mean {float(dense_n.float().mean()):.1f}", flush=True)

    batch = frames[:max_batch]
    imgs = torch.as_tensor(batch, device=model.device)

    def one_batch():
        dets, n = infer(imgs)
        return dets

    batch_ms = cuda_ms(one_batch, iters=10)
    print(f"{label}: {batch_ms:.3f} ms per batch of {max_batch} = "
          f"{max_batch / batch_ms * 1e3:.1f} img/s (device-synchronised, inputs on the card)", flush=True)

    profile_fast_path(infer, imgs)

    fast_path = check_fast_path(infer, model, imgs, f"{label} fast path")
    return launches, dict(img_s=n_requests / serve_s, batch_ms=batch_ms, device_calls=batcher.calls,
                          fallback_k=fallback_k, fast_path=fast_path), batch


def check_fast_path(infer, model, imgs, label="fast path"):
    """The served batch through the kernels against the plain score and NMS
    functions on the same bf16 head outputs: n equal, boxes 0.1 px, conf 1e-3;
    and K2 against masked_scores_plain on each level's rows (`check_scores`)."""
    from yolov3_tpu_torch.models.detect_head import decode_topk_nhwc
    from yolov3_tpu_torch.ops.nms import nms_from_candidates
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain
    from yolov3_tpu_torch.ops.score_cuda import masked_scores_plain

    fallbacks = infer.fallbacks
    dets_k, n_k = infer(imgs)
    check(infer.fallbacks == fallbacks, f"{label}: the compared batch took the full-decode fallback")
    rows_in = []
    with torch.inference_mode():
        feats = infer.serving_model(imgs.to(torch.bfloat16) / 255.0, raw=True)
        boxes, scores, cls_ids, ov = decode_topk_nhwc(
            feats, model.anchors_px, model.spec.strides, with_overflow=True,
            score_fn=functools.partial(_recorded, masked_scores_plain, rows_in))
        dets_p, n_p = nms_from_candidates(boxes, scores, cls_ids, nms_fn=greedy_nms_plain)
    check(len(rows_in) == model.spec.nl, f"{label}: the decode scored {len(rows_in)} row tensors")
    score_err = max(check_scores(*args, f"{label} level {i}") for i, args in enumerate(rows_in))
    n_k, n_p = np.asarray(n_k), n_p.cpu().numpy()
    check(not bool(ov.any()), f"{label}: the compared batch overflowed")
    check((n_k == n_p).all(), f"{label}: n {n_k.tolist()} != plain {n_p.tolist()}")
    check(n_k.sum() > 0, f"{label}: no detection in the compared batch")
    dk, dp = dets_k.cpu().numpy(), dets_p.cpu().numpy()
    valid = np.arange(dk.shape[1])[None, :] < n_k[:, None]  # rows [0, n) of each image
    box_err = float(np.abs(dk[..., :4] - dp[..., :4])[valid].max(initial=0.0))
    conf_err = float(np.abs(dk[..., 4] - dp[..., 4])[valid].max(initial=0.0))
    check(box_err <= 0.1 and conf_err <= 1e-3, f"{label} vs plain: box err {box_err}, conf err {conf_err}")
    print(f"{label} vs plain kernels' versions: n equal (sum {int(n_k.sum())}), "
          f"max box err {box_err:.3g} px, max conf err {conf_err:.3g}", flush=True)
    return dict(n=int(n_k.sum()), box_err=box_err, conf_err=conf_err, score_err=score_err)


# a 390x500 frame letterboxed into 512x640: gain 1.28, 6.4 rows of padding above and below
RECT_META = ((390, 500), ((1.28, 1.28), (0.0, 6.4)))
VAL_BATCHES = ((32, 640, 640, None), (8, 512, 640, RECT_META))  # (B, H, W, shapes meta of each image)


def make_val_batches(rng, model, batches=VAL_BATCHES):
    """Seeded uint8 frames labelled with the f32 val path's own detections
    above conf 0.25, from a pass through the plain NMS: (imgs, targets (B, M, 5)
    [cls, xywh normalised to the frame], mask, shapes) batches, the layout of
    the JAX package's DataLoader."""
    from yolov3_tpu_torch.eval.validator import make_forward
    from yolov3_tpu_torch.ops.boxes import xyxy2xywh
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain

    forward = make_forward(model, nms_fn=greedy_nms_plain)
    out = []
    for B, H, W, meta in batches:
        imgs = rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8)
        dets, n = forward(torch.as_tensor(imgs, device=model.device))
        dets, n = dets.cpu().numpy(), n.cpu().numpy()
        labels = [d[:k][d[:k, 4] > 0.25] for d, k in zip(dets, n)]
        M = max(1, max(len(lb) for lb in labels))
        targets, mask = np.zeros((B, M, 5), np.float32), np.zeros((B, M), bool)
        for i, lb in enumerate(labels):
            targets[i, :len(lb), 0] = lb[:, 5]
            targets[i, :len(lb), 1:] = xyxy2xywh(lb[:, :4]) / np.array([W, H, W, H], np.float32)
            mask[i, :len(lb)] = True
        out.append((imgs, targets, mask, [meta] * B))
    return out


def profile_val_batch(model, imgs, nms_kw):
    """Device time of one val batch by stage: the f32 forward, the decode and
    batched_nms (split into K1, the sort and the rest by kernel name), each in
    a profiler window of its own, so a stage's time is every kernel in its
    window; then the whole validator step (eval.validator.make_forward) for the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from yolov3_tpu_torch.eval.validator import make_forward
    from yolov3_tpu_torch.models.detect_head import decode_predictions
    from yolov3_tpu_torch.ops.nms import batched_nms

    x = torch.as_tensor(imgs, device="cuda")
    with torch.inference_mode():
        feats = model(x.float() / 255.0)
        pred = decode_predictions(feats, model.anchors_px, model.spec.strides)
    step = make_forward(model, **nms_kw)
    stages = (("forward", lambda: model(x.float() / 255.0)),
              ("decode", lambda: decode_predictions(feats, model.anchors_px, model.spec.strides)),
              ("nms", lambda: batched_nms(pred, multi_label=True, **nms_kw)),
              ("step", lambda: step(x)))
    out = {}
    for label, fn in stages:
        for _ in range(3):  # the profiler now and then drops every event of a short window: take it again
            with torch.inference_mode():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
            spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            if spans:
                break
        check(spans, f"the val profile saw no kernel in the {label} window in 3 tries")
        out[f"{label}_ms"] = sum(end - start for start, end, _ in spans) / 1e3
        if label == "nms":
            out["k1_ms"] = sum(end - start for start, end, name in spans if NMS_KERNEL in name) / 1e3
            out["sort_ms"] = sum(end - start for start, end, name in spans
                                 if "sort" in name.lower() or "radix" in name.lower()) / 1e3
        if label == "step":
            busy, edge = 0.0, -1.0
            for start, end, _ in spans:
                busy += max(0.0, end - max(start, edge))
                edge = max(edge, end)
            out.update(step_wall_ms=wall_us / 1e3, device_busy=busy / wall_us)
    print(f"val profile, one batch of {imgs.shape[0]} at {imgs.shape[1]}x{imgs.shape[2]}, device ms: forward (f32) "
          f"{out['forward_ms']:.3f}, decode {out['decode_ms']:.3f}, batched_nms {out['nms_ms']:.3f} = multi-label sort "
          f"{out['sort_ms']:.3f} + K1 {out['k1_ms']:.3f} + candidates and gathers "
          f"{out['nms_ms'] - out['sort_ms'] - out['k1_ms']:.3f}; the whole step {out['step_ms']:.3f} ms of kernels, "
          f"device busy {out['device_busy']:.1%} of {out['step_wall_ms']:.3f} ms wall (profiler on)", flush=True)
    return out


def phase_val(rng, model, batches=VAL_BATCHES, label="val path"):
    """The val path: validator.run at the val-grade defaults on a self-labelled
    set (`batches`, VAL_BATCHES' layout), f32 and half=True; K1 once a batch at
    K = 30000; the same run through the plain NMS gives the same metrics, and
    K1's detections equal the plain NMS's on the same predictions. `label`
    starts each line printed."""
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.detect_head import decode_predictions
    from yolov3_tpu_torch.ops.nms import batched_nms
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain

    t0 = time.perf_counter()
    batches = make_val_batches(rng, model, batches)
    n_imgs = sum(b[0].shape[0] for b in batches)
    n_labels = int(sum(b[2].sum() for b in batches))
    print(f"{label} set: {len(batches)} batches {[b[0].shape[:3] for b in batches]}, {n_labels} labels (the f32 "
          f"val path's detections above conf 0.25, plain NMS) in {time.perf_counter() - t0:.2f} s", flush=True)
    check(n_labels > 0, f"{label}: the self-labelling pass found no detection above conf 0.25")
    validator.run(model=model, dataloader=batches[:1])  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    # --- the val path: every launch from here to the count read is the path's own
    reset_kernel_counts()
    t0 = time.perf_counter()
    results, _, speeds = validator.run(model=model, dataloader=batches)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    route = greedy_nms.last_route
    # --- end of the val path

    t0 = time.perf_counter()
    results_half, _, speeds_half = validator.run(model=model, dataloader=batches, half=True)
    wall_half = time.perf_counter() - t0
    results_plain, _, _ = validator.run(model=model, dataloader=batches, nms_fn=greedy_nms_plain)
    out = {}
    for kind, res, sp, w in (("f32", results, speeds, wall), ("half", results_half, speeds_half, wall_half)):
        mp, mr, map50, map_ = (float(v) for v in res[:4])
        out[kind] = dict(mp=mp, mr=mr, map50=map50, map=map_, ms_per_batch=w / len(batches) * 1e3,
                         img_s=n_imgs / w, ms_per_image=dict(zip(("pre", "inference+nms", "post"), sp)))
        print(f"{label} {kind}: P {mp:.4f} R {mr:.4f} mAP50 {map50:.4f} mAP50-95 {map_:.4f}; "
              f"{w / len(batches) * 1e3:.1f} ms per batch, {n_imgs / w:.1f} img/s (host clock around "
              f"validator.run, {n_imgs} images); ms per image: pre {sp[0]:.3f}, inference+NMS {sp[1]:.3f}, "
              f"post {sp[2]:.3f}", flush=True)
    print(f"{label}: launches {launches} for {len(batches)} batches, K1 route [{route}]; half=True mAP50 "
          f"{out['half']['map50'] - out['f32']['map50']:+.4f}, mAP50-95 {out['half']['map'] - out['f32']['map']:+.4f} "
          f"against f32", flush=True)
    check(launches == {"greedy_nms": len(batches), "masked_scores": 0, "conv3x3_bn_stats": 0},
          f"{label}: launches {launches}, expected K1 once a batch and nothing else")
    check(route == "block per image, candidates in global memory", f"{label}: K1 took [{route}]")
    check(out["f32"]["map50"] >= 0.95, f"{label}: f32 mAP50 {out['f32']['map50']} < 0.95 on the self-labelled set")
    check(np.array_equal(np.array(results[:4]), np.array(results_plain[:4])),
          f"{label}: metrics through K1 {results[:4]} differ from those through the plain NMS {results_plain[:4]}")

    n_dets = 0
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000)  # the val-grade defaults
    for imgs, *_ in batches:  # K1 against the plain NMS on the same predictions
        with torch.inference_mode():
            feats = model(torch.as_tensor(imgs, device=model.device).float() / 255.0)
            pred = decode_predictions(feats, model.anchors_px, model.spec.strides)
            dets_k, n_k = batched_nms(pred, multi_label=True, **kw)
            dets_p, n_p = batched_nms(pred, multi_label=True, nms_fn=greedy_nms_plain, **kw)
        check(torch.equal(n_k, n_p) and torch.equal(dets_k, dets_p),
              f"{label}: detections through K1 differ from the plain NMS's at {tuple(imgs.shape)}")
        n_dets += int(n_k.sum())
    print(f"{label}: K1 detections equal to the plain NMS's on the same predictions ({n_dets} detections), "
          f"metrics through the plain NMS equal", flush=True)
    out.update(launches=launches, route=route, n_labels=n_labels, n_images=n_imgs,
               profile=profile_val_batch(model, batches[0][0], kw))
    return out, batches


EXPORT_NMS = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=8192)  # export.ServingModule's NMS
EXPORT_ARTIFACTS = (  # name -> export.run arguments; every artifact at 640 px, exported on the card
    ("pt2", dict(include=("pt2",), batch=32, dynamic=True)),
    ("pt2_nms", dict(include=("pt2",), batch=32, dynamic=True, nms=True)),
    ("pt2_half", dict(include=("pt2",), batch=32, dynamic=True, half=True)),
    ("onnx", dict(include=("onnx",), batch=32, dynamic=True)),
)


def phase_export(model, batches, gpu):
    """Export and backends on the serving phase's planted yolov3@640, saved as a
    port checkpoint: export.run to pt2 (f32, dynamic batch), pt2 with nms,
    pt2 --half and onnx on the card (seconds and MB each; a None is a
    failure). On the val phase's 32-frame 640x640 batch, MultiBackend of the
    f32 pt2 and the onnx against decode_predictions(model(x)) in f32 (atol
    2e-3, rtol 1e-3); the half pt2's detections after batched_nms against
    the in-process bf16 model's (NMS bars); the nms pt2 launches K1 once a
    call on its shared-memory route, its detections equal to the plain NMS
    on the same predictions; validator.run through MultiBackend(pt2) and
    (onnx) over that batch: K1 once a batch (global-memory route), mAP50
    within 0.005 of the in-process f32 validator's; benchmarks.run over
    checkpoint, pt2 and onnx of those frames written as PNGs, every row
    filled, the artifacts' mAP50-95 within 0.005 of the checkpoint's model
    validated on square batches (the checkpoint row's rect batches
    letterbox these frames to 672 px). A pt2
    exported on the CPU is moved to the card by MultiBackend (or refused,
    with its message, where this torch cannot move it). Times: ms per batch
    of 32 of each backend and of the in-process f32 model, val img/s."""
    import os
    import tempfile
    from pathlib import Path

    from yolov3_tpu_torch import export
    from yolov3_tpu_torch.cli import benchmarks
    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.backend import MultiBackend
    from yolov3_tpu_torch.models.detect_head import decode_predictions
    from yolov3_tpu_torch.models.detection import DetectionModel, optimize_for_inference
    from yolov3_tpu_torch.ops.boxes import xywh2xyxy, xyxy2xywh
    from yolov3_tpu_torch.ops.nms import batched_nms
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint
    from yolov3_tpu_torch.utils.general import file_size, yaml_save

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    ckpt = save_checkpoint(tmp / "ckpt", {"model": model.state_dict()}, spec=model.spec)
    arts, exports = {}, {}
    for name, kw in EXPORT_ARTIFACTS:
        t0 = time.perf_counter()
        art = export.run(str(ckpt), imgsz=640, out_dir=tmp / name, **kw)[kw["include"][0]]
        check(art is not None, f"export {name} failed (try_export returned None)")
        arts[name] = art
        exports[name] = dict(s=time.perf_counter() - t0, mb=file_size(art))
    print("export on the card: " + ", ".join(f"{k} {v['s']:.2f} s {v['mb']:.1f} MB" for k, v in exports.items())
          + f" on {gpu}", flush=True)

    imgs, targets, mask, shapes = batches[0]
    check(imgs.shape == (32, 640, 640, 3) and shapes[0] is None, f"val batch {imgs.shape} is not 32 square frames")
    x = torch.as_tensor(imgs, device=model.device)
    backends = {k: MultiBackend(arts[k]) for k in ("pt2", "pt2_nms", "pt2_half", "onnx")}
    with torch.inference_mode():
        ref = decode_predictions(model(x.float() / 255.0), model.anchors_px, model.spec.strides)
        bf16 = optimize_for_inference(model, bf16=True)
        ref_half = decode_predictions(bf16(x.float() / 255.0), bf16.anchors_px, bf16.spec.strides)
    err = {}
    for k in ("pt2", "onnx"):
        got = backends[k](x)
        check(got.dtype == torch.float32 and got.shape == ref.shape, f"MultiBackend({k}) gave {got.shape} {got.dtype}")
        err[k] = float((got - ref).abs().max())
        check(torch.allclose(got, ref, atol=2e-3, rtol=1e-3), f"MultiBackend({k}) differs from the in-process f32 "
              f"decode by up to {err[k]}")

    with torch.inference_mode():  # the half artifact against the in-process bf16 model, after the serving NMS
        dets_h, n_h = batched_nms(backends["pt2_half"](x), **EXPORT_NMS)
        dets_r, n_r = batched_nms(ref_half, **EXPORT_NMS)
    n_h, n_r = n_h.cpu().numpy(), n_r.cpu().numpy()
    check(np.array_equal(n_h, n_r), f"half pt2 counts {n_h.tolist()} differ from the bf16 model's {n_r.tolist()}")
    half_err = [check_dets(dets_h[i, :k].cpu().numpy(), dets_r[i, :k].cpu().numpy(), f"half pt2 image {i}")
                for i, k in enumerate(n_h)]
    del bf16

    reset_kernel_counts()  # the nms pt2: K1 once a call, the same as the plain NMS on the same predictions
    for _ in range(2):
        out, n = backends["pt2_nms"](x)
    torch.cuda.synchronize()
    nms_launches, route = kernel_counts(), greedy_nms.last_route
    check(nms_launches == {"greedy_nms": 2, "masked_scores": 0, "conv3x3_bn_stats": 0},
          f"pt2 with nms: launches {nms_launches} for 2 calls")
    check("shared memory" in route, f"pt2 with nms: K1 took [{route}]")
    with torch.inference_mode():
        out_p, n_p = batched_nms(backends["pt2"](x), nms_fn=greedy_nms_plain, **EXPORT_NMS)
    check(torch.equal(n, n_p), f"pt2 with nms: n {n.tolist()} vs plain {n_p.tolist()}")
    for i, k in enumerate(n.tolist()):
        check_dets(out[i, :k].cpu().numpy(), out_p[i, :k].cpu().numpy(), f"pt2 with nms image {i}")

    def call(b):
        return lambda: b(x)

    with torch.inference_mode():
        times = {"in-process f32": cuda_ms(lambda: decode_predictions(model(x.float() / 255.0), model.anchors_px,
                                                                      model.spec.strides), iters=5)}
        times.update({k: cuda_ms(call(b), iters=5) for k, b in backends.items()})
    print("backends on the val batch of 32 at 640: f32 pt2 / onnx within "
          + ", ".join(f"{k} {v:.2e}" for k, v in err.items()) + " of the in-process f32 decode; half pt2 detections "
          f"({int(n_h.sum())}) equal to the bf16 model's (box err {max(e[0] for e in half_err):.4f}, conf err "
          f"{max(e[1] for e in half_err):.2e}); nms pt2 K1 launches {nms_launches['greedy_nms']} for 2 calls [{route}], "
          f"detections equal to the plain NMS ({int(n.sum())}); ms per batch of 32: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" on {gpu}", flush=True)

    val = {}
    ref_results = validator.run(model=model, dataloader=[batches[0]])[0]
    for k in ("pt2", "onnx"):
        validator.run(model=backends[k], dataloader=[batches[0]])  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        results = validator.run(model=backends[k], dataloader=[batches[0]])[0]
        wall = time.perf_counter() - t0
        launches, val_route = kernel_counts(), greedy_nms.last_route
        check(launches == {"greedy_nms": 1, "masked_scores": 0, "conv3x3_bn_stats": 0},
              f"val through MultiBackend({k}): launches {launches} for 1 batch")
        check("global memory" in val_route, f"val through MultiBackend({k}): K1 took [{val_route}]")
        check(abs(results[2] - ref_results[2]) <= 0.005, f"val through MultiBackend({k}): mAP50 {results[2]} vs "
              f"{ref_results[2]} in process")
        val[k] = dict(map50=float(results[2]), map=float(results[3]), img_s=len(imgs) / wall, launches=launches)
    print(f"val through MultiBackend over the val batch: in-process f32 mAP50 {ref_results[2]:.4f}; "
          + ", ".join(f"{k} mAP50 {v['map50']:.4f} mAP50-95 {v['map']:.4f}, {v['img_s']:.1f} img/s, K1 "
                      f"{v['launches']['greedy_nms']}" for k, v in val.items()) + f" on {gpu}", flush=True)
    del backends

    root = tmp / "frames"  # the val batch on disk for benchmarks: PNGs and labels clipped to the frame
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(len(imgs)):
        lb = targets[i][mask[i]]
        xyxy = np.clip(xywh2xyxy(lb[:, 1:5]), 0.0, 1.0)
        image_ops.imwrite_png(root / "images" / f"{i:03d}.png", np.ascontiguousarray(imgs[i][:, :, ::-1]), 1)
        (root / "labels" / f"{i:03d}.txt").write_text("".join(
            f"{int(c)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n" for c, (x, y, w, h) in zip(lb[:, 0], xyxy2xywh(xyxy))))
    yaml_save(root / "dataset.yaml", dict(path=str(root), train="images", val="images",
                                          names={i: str(i) for i in range(80)}))
    cwd = os.getcwd()
    os.chdir(tmp)  # benchmarks exports to runs/export under the working directory
    try:
        t0 = time.perf_counter()
        # the card's formats; the TensorFlow ones run on the host only (phase_layout's `layout_tensorflow`)
        rows = benchmarks.run(str(ckpt), data=str(root / "dataset.yaml"), imgsz=640, batch_size=32,
                              formats=("checkpoint", "pt2", "onnx"))
        bench_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check([r[0] for r in rows] == ["checkpoint", "pt2", "onnx"] and all(v is not None for r in rows for v in r),
          f"benchmarks rows {rows}")
    # the checkpoint row validates with rect batches (pad 0.5: these 640 px frames at 672), the artifacts' rows
    # with square ones (the non-native path): the artifacts are held to the checkpoint's model on square batches
    square = validator.run(str(root / "dataset.yaml"), model=model, batch_size=32, imgsz=640, rect=False)[0]
    check(all(abs(r[2] - square[3]) <= 0.005 for r in rows[1:]) and rows[0][2] >= 0.9,
          f"benchmarks mAP50-95 {[r[2] for r in rows]}, the checkpoint's model on square batches {square[3]}")
    print(f"benchmarks ({bench_s:.1f} s): " + "; ".join(f"{f} {mb:.1f} MB mAP50-95 {m:.4f} {ms:.2f} ms/img"
                                                      for f, mb, m, ms in rows)
          + f"; the checkpoint's model on square batches mAP50-95 {square[3]:.4f} on {gpu}", flush=True)

    cpu_art = export.run("yolov3-tiny", include=("pt2",), imgsz=640, batch=2, dynamic=True, out_dir=tmp / "cpu",
                         device="cpu")["pt2"]  # exported on the CPU, served on the card
    check(cpu_art is not None, "the CPU pt2 export failed")
    try:
        moved = MultiBackend(cpu_art)
        with torch.inference_mode():
            got = moved(x[:2])
            want = export.ServingModule(DetectionModel.from_config("yolov3-tiny"))(x[:2])
        check(got.device.type == "cuda" and torch.allclose(got, want, atol=2e-3, rtol=1e-3),
              "a pt2 exported on the CPU and moved to the card differs from the model on the card")
        moved_to = "moved to the card, equal to the model there"
    except RuntimeError as e:
        check("cannot be moved" in str(e), f"a CPU pt2 on the card: {e}")
        moved_to = f"refused: {e}"
    print(f"a pt2 exported on the CPU: {moved_to}", flush=True)
    return dict(exports=exports, max_abs_err=err, half_n=int(n_h.sum()), nms_launches=nms_launches["greedy_nms"],
                nms_route=route, ms_per_batch=times, val=val, in_process_map50=float(ref_results[2]),
                benchmarks=[list(r) for r in rows], benchmarks_square_map=float(square[3]), benchmarks_s=bench_s,
                cpu_pt2=moved_to)


# (h, w) of the HTTP phase's BGR frames: letterbox and scale_boxes run on all but the square one
HTTP_SIZES = ((480, 640), (720, 1280), (640, 640), (375, 500))
HTTP_REQUESTS, HTTP_CLIENTS = 32, 8


def kernel_counts():
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores

    return {"greedy_nms": greedy_nms.launches, "masked_scores": masked_scores.launches,
            "conv3x3_bn_stats": conv3x3_bn_stats.launches}


def reset_kernel_counts():
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores

    greedy_nms.launches = masked_scores.launches = conv3x3_bn_stats.launches = 0


def check_dets(got, want, label):
    """n equal, boxes within 0.1 px, conf within 1e-3, classes equal; returns (box err, conf err)."""
    check(got.shape == want.shape, f"{label}: {len(got)} detections, expected {len(want)}")
    box_err = float(np.abs(got[:, :4] - want[:, :4]).max(initial=0.0))
    conf_err = float(np.abs(got[:, 4] - want[:, 4]).max(initial=0.0))
    check(box_err <= 0.1 and conf_err <= 1e-3 and np.array_equal(got[:, 5], want[:, 5]),
          f"{label}: box err {box_err}, conf err {conf_err}, classes equal {np.array_equal(got[:, 5], want[:, 5])}")
    return box_err, conf_err


def phase_http(model, imgsz=640, device=None):
    """The HTTP front end on the serving phase's planted model, saved as a port
    checkpoint: make_server(port=0, max_batch=8, batch_wait_ms=5) in a thread,
    HTTP_REQUESTS requests from HTTP_CLIENTS client threads (half npy through
    RemoteModel, half PNG bodies) of distinct BGR frames of HTTP_SIZES. Each
    answer is held to the in-process pipeline on the same frame, run in a
    batch of the bucket size the server ran it in (a frame's result may
    depend on the batch size through cuDNN's choice of algorithm; how often it
    does is printed). Launch counts: K2 3 a device call, K1 one a device call
    plus one a fallback. /health counts the requests; a malformed body gets
    400, an unknown path 404; the server is shut down."""
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from pathlib import Path

    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.ops.boxes import scale_boxes
    from yolov3_tpu_torch.serve import RemoteModel, build_batched_infer, make_server
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(6)  # a generator of its own (see make_val_batches' callers)
    frames = [rng.integers(0, 256, size=(*HTTP_SIZES[i % len(HTTP_SIZES)], 3), dtype=np.uint8)
              for i in range(HTTP_REQUESTS)]
    # every other run of len(HTTP_SIZES) requests sends PNG bodies, so each size comes both ways
    bodies = [image_ops.encode_png(f, level=1) if (i // len(HTTP_SIZES)) % 2 else None for i, f in enumerate(frames)]
    boxed = [np.ascontiguousarray(letterbox(f, imgsz, auto=False)[0][:, :, ::-1]) for f in frames]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_http_"))
    try:
        save_checkpoint(tmp / "best", {"model": model.state_dict()}, spec=model.spec,
                        meta={"names": {i: f"class{i}" for i in range(model.spec.nc)}})
        t0 = time.perf_counter()
        server = make_server(weights=str(tmp / "best"), host="127.0.0.1", port=0, imgsz=imgsz, max_batch=8,
                             batch_wait_ms=5, fast=True, device=device)
        setup_s = time.perf_counter() - t0
        batcher = server.predict.batcher
        buckets = {}  # letterboxed frame bytes -> the bucket sizes it was served in
        real_infer = batcher.infer

        def recording_infer(batch):
            fallbacks = real_infer.fallbacks
            out = real_infer(batch)
            for im in batch:  # the bucket size, and whether the batch took the full-decode fallback
                buckets.setdefault(im.tobytes(), set()).add((len(batch), real_infer.fallbacks > fallbacks))
            return out

        batcher.infer = recording_infer
        thread = threading.Thread(target=server.serve_forever, daemon=True, name="chip_smoke_http")
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        remote = RemoteModel(url)
        answers, latency = [None] * HTTP_REQUESTS, [0.0] * HTTP_REQUESTS

        def post(path, body, content_type):
            req = urllib.request.Request(f"{url}{path}", data=body, headers={"Content-Type": content_type})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def client(c):
            for i in range(c, HTTP_REQUESTS, HTTP_CLIENTS):
                t = time.perf_counter()
                if bodies[i] is None:
                    answers[i] = remote(frames[i])
                else:
                    status, out = post("/predict", bodies[i], "image/png")
                    check(status == 200, f"PNG request {i}: HTTP {status} {out}")
                    answers[i] = np.array(out["detections"], np.float32).reshape(-1, 6)
                latency[i] = time.perf_counter() - t

        calls0 = batcher.calls
        # --- the HTTP path: every launch from here to the count read is the path's own
        reset_kernel_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = kernel_counts()
        # --- end of the HTTP path
        check(not any(t.is_alive() for t in clients), "an HTTP client did not finish")
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            health = json.loads(r.read())
        calls = health["batching"]["device_calls"] - calls0
        fallbacks = real_infer.fallbacks
        bad_status, bad = post("/predict", b"\x89PNG\r\n\x1a\n this is no image", "image/png")
        missing_status, _ = post("/nowhere", b"", "image/png")
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        check(not thread.is_alive(), "the HTTP server did not shut down")

        check(health["batching"]["requests"] == HTTP_REQUESTS and health["imgsz"] == imgsz
              and health["names"]["1"] == "class1", f"/health {health}")
        check(bad_status == 400 and "bad image payload" in bad["error"], f"a malformed body got {bad_status}")
        check(missing_status == 404, f"an unknown path got {missing_status}")
        check(launches == {"greedy_nms": calls + fallbacks, "masked_scores": 3 * calls, "conv3x3_bn_stats": 0},
              f"HTTP launches {launches} for {calls} device calls and {fallbacks} fallbacks")

        # each answer against the in-process pipeline on its frame, in a batch of the size it was served in
        infer = build_batched_infer(server.model)
        box_err = conf_err = 0.0
        differ_at_batch_1, n_dets = 0, 0
        for i, (frame, im) in enumerate(zip(frames, boxed)):
            served = buckets.get(im.tobytes())
            check(served is not None and len(served) == 1, f"frame {i} was served in {served}")
            (bucket, fell_back), = served
            refs = {}
            for key in sorted({(bucket, fell_back), (1, False)}):
                batch = np.stack([im] * key[0])
                dets, n = infer.full_fn(batch) if key[1] else infer(batch)
                d = dets[0, : int(n[0])].cpu().numpy().copy()
                if len(d):
                    d[:, :4] = scale_boxes((imgsz, imgsz), d[:, :4], frame.shape[:2])
                refs[key] = d
            want, at_1 = refs[(bucket, fell_back)], refs[(1, False)]
            got = answers[i]
            # JSON rounds to 4 places: compare the in-process rows rounded alike
            e = check_dets(got, np.round(want, 4).astype(np.float32), f"HTTP answer {i} {frame.shape[:2]}")
            box_err, conf_err = max(box_err, e[0]), max(conf_err, e[1])
            n_dets += len(got)
            differ_at_batch_1 += int(len(at_1) != len(want) or not np.array_equal(at_1, want))
        check(n_dets > 0, "no HTTP answer held a detection")
        # the host work of one request, one step at a time on this thread (ms by frame size)
        host_ms = {}
        for hw in HTTP_SIZES:
            i = next(j for j in range(HTTP_REQUESTS) if bodies[j] is not None and frames[j].shape[:2] == hw)
            buf = io.BytesIO()
            np.save(buf, frames[i], allow_pickle=False)
            answer = json.dumps({"detections": [[round(float(v), 4) for v in row] for row in answers[i]]})
            steps = (("png decode", lambda: image_ops.imdecode(bodies[i])),
                     ("npy load", lambda: np.load(io.BytesIO(buf.getvalue()), allow_pickle=False)),
                     ("letterbox", lambda: letterbox(frames[i], imgsz, auto=False)),
                     ("json", lambda: json.dumps({"detections": [[round(float(v), 4) for v in row]
                                                                 for row in answers[i]]})))
            row = {}
            for name, fn in steps:
                t = time.perf_counter()
                for _ in range(3):
                    fn()
                row[name] = (time.perf_counter() - t) / 3 * 1e3
            row.update(png_mb=len(bodies[i]) / 1e6, json_kb=len(answer) / 1e3)
            host_ms[f"{hw[0]}x{hw[1]}"] = row
        lat = np.sort(np.array(latency)) * 1e3
        out = dict(requests=HTTP_REQUESTS, clients=HTTP_CLIENTS, wall_s=wall, req_s=HTTP_REQUESTS / wall,
                   p50_ms=float(np.percentile(lat, 50)), p90_ms=float(np.percentile(lat, 90)),
                   device_calls=calls, fallbacks=fallbacks, launches=launches, setup_s=setup_s,
                   detections=n_dets, max_box_err=box_err, max_conf_err=conf_err,
                   frames_differing_from_batch_1=differ_at_batch_1, host_ms=host_ms)
        print(f"HTTP serving: {HTTP_REQUESTS} requests (half npy, half PNG; {len(HTTP_SIZES)} frame sizes) from "
              f"{HTTP_CLIENTS} clients in {wall:.3f} s = {out['req_s']:.1f} requests/s, latency p50 "
              f"{out['p50_ms']:.1f} ms p90 {out['p90_ms']:.1f} ms; {calls} device calls, {fallbacks} fallbacks, "
              f"launches {launches}; server built and warmed in {setup_s:.2f} s", flush=True)
        print(f"HTTP answers vs the in-process pipeline at the served bucket: n equal ({n_dets} detections), max "
              f"box err {box_err:.3g} px, max conf err {conf_err:.3g}; {differ_at_batch_1} of {HTTP_REQUESTS} "
              f"frames give other rows in a batch of 1; /health counts {HTTP_REQUESTS} requests, 400 and 404 "
              f"answered, server shut down", flush=True)
        print("HTTP host work of one request, ms on one thread: " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {v:.2f}" for n, v in r.items() if n not in ("png_mb", "json_kb"))
            + f" (PNG {r['png_mb']:.2f} MB, JSON {r['json_kb']:.1f} kB)" for k, r in host_ms.items()), flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_fast_false(model, imgsz=640):
    """build_pipeline(fast=False) on one frame of each HTTP size: one K1
    launch a call and no K2; detections equal to the plain NMS over the same
    float32 predictions."""
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.models.detect_head import decode_predictions
    from yolov3_tpu_torch.ops.boxes import scale_boxes
    from yolov3_tpu_torch.ops.nms import batched_nms
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain
    from yolov3_tpu_torch.serve import build_pipeline

    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8) for hw in HTTP_SIZES]
    predict = build_pipeline(model, imgsz, max_batch=1, fast=False)
    predict(frames[2])  # warm-up
    torch.cuda.synchronize()
    # --- the fast=False path: every launch from here to the count read is the path's own
    reset_kernel_counts()
    t0 = time.perf_counter()
    results = [predict(f) for f in frames]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    # --- end of the fast=False path
    check(launches == {"greedy_nms": len(frames), "masked_scores": 0, "conv3x3_bn_stats": 0},
          f"fast=False launches {launches} for {len(frames)} calls")
    box_err = conf_err = 0.0
    for frame, got in zip(frames, results):
        im = np.ascontiguousarray(letterbox(frame, imgsz, auto=False)[0][:, :, ::-1])
        with torch.inference_mode():
            x = torch.as_tensor(im[None], device=model.device).float() / 255.0
            pred = decode_predictions(model(x), model.anchors_px, model.spec.strides)
            dets, n = batched_nms(pred, max_nms=8192, nms_fn=greedy_nms_plain)
        want = dets[0, : int(n[0])].cpu().numpy()
        if len(want):
            want[:, :4] = scale_boxes((imgsz, imgsz), want[:, :4], frame.shape[:2])
        e = check_dets(got, want, f"fast=False {frame.shape[:2]}")
        box_err, conf_err = max(box_err, e[0]), max(conf_err, e[1])
    n_dets = sum(len(r) for r in results)
    check(n_dets > 0, "fast=False found no detection")
    print(f"fast=False: {len(frames)} frames {[f.shape[:2] for f in frames]} in {wall * 1e3:.1f} ms "
          f"({wall / len(frames) * 1e3:.1f} ms a frame), launches {launches}; {n_dets} detections equal to the "
          f"plain NMS on the same f32 predictions (max box err {box_err:.3g}, conf err {conf_err:.3g})", flush=True)
    return dict(launches=launches, ms_per_frame=wall / len(frames) * 1e3, detections=n_dets)


def phase_merge(model, imgs, iou_thres=0.45, max_nms=30000):
    """batched_nms(merge=True), multi-label and class-agnostic, through K1
    against the plain NMS on a pair of val frames: the conf threshold is
    chosen from the frames' own candidate counts so that one image has fewer
    than 3000 candidates (inside merge's gate: boxes merged, the redundant
    filter applied) and the other 3000 or more (outside it: plain greedy
    rows). Agnostic, because the planted head makes every class of a cell a
    candidate: a kept box then overlaps its own cell's other classes and its
    neighbours, so rows survive the redundant filter and move."""
    from yolov3_tpu_torch.models.detect_head import decode_predictions
    from yolov3_tpu_torch.ops.nms import batched_nms
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain

    with torch.inference_mode():
        x = torch.as_tensor(imgs, device=model.device).float() / 255.0
        pred = decode_predictions(model(x), model.anchors_px, model.spec.strides)
    # a (box, class) pair is a candidate above conf c iff min(obj * cls, obj) > c: t_i, the 3000th
    # largest of those per image, is where image i crosses the gate; a c between the lowest and the
    # highest t_i leaves the first image under 3000 candidates and the second at 3000 or more
    obj = pred[..., 4:5]
    v = torch.minimum(pred[..., 5:] * obj, obj).reshape(pred.shape[0], -1)
    t = v.topk(3000, dim=1).values[:, -1].cpu().numpy()
    lo, hi = int(t.argmin()), int(t.argmax())
    check(t[lo] < t[hi], f"every frame crosses merge's 3000-candidate gate at conf {t[lo]}")
    conf = float((t[lo] + t[hi]) / 2)
    n_lo, n_hi = (int(min((v[i] > conf).sum(), max_nms)) for i in (lo, hi))
    check(1 < n_lo < 3000 <= n_hi, f"candidates {n_lo} and {n_hi} at conf {conf}")
    pair = pred[[lo, hi]]
    kw = dict(conf_thres=conf, iou_thres=iou_thres, multi_label=True, agnostic=True, max_nms=max_nms)
    batched_nms(pair, merge=True, **kw)  # warm-up
    torch.cuda.synchronize()
    # --- the merge path: every launch from here to the count read is the path's own
    reset_kernel_counts()
    t0 = time.perf_counter()
    dets_k, n_k = batched_nms(pair, merge=True, **kw)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_counts()
    # --- end of the merge path
    dets_p, n_p = batched_nms(pair, merge=True, nms_fn=greedy_nms_plain, **kw)
    plain, plain_n = batched_nms(pair, **kw)
    n_k, n_p, plain_n = (t.cpu().numpy() for t in (n_k, n_p, plain_n))
    check(launches == {"greedy_nms": 1, "masked_scores": 0, "conv3x3_bn_stats": 0}, f"merge launches {launches}")
    check((n_k == n_p).all(), f"merge n through K1 {n_k.tolist()} != plain {n_p.tolist()}")
    box_err = conf_err = 0.0
    for b in range(2):
        e = check_dets(dets_k[b, : n_k[b]].cpu().numpy(), dets_p[b, : n_p[b]].cpu().numpy(), f"merge image {b}")
        box_err, conf_err = max(box_err, e[0]), max(conf_err, e[1])
    check(n_k[0] > 0, "merge kept no row of the image inside the gate")
    moved = float((dets_k[0, : n_k[0], :4] - plain[0, : n_k[0], :4]).abs().max())
    check(n_k[1] == plain_n[1] and torch.equal(dets_k[1], plain[1]), "the image outside the gate was merged")
    print(f"merge-NMS: conf {conf:.4g}, multi-label, agnostic, iou {iou_thres}: image {lo} with {n_lo} candidates "
          f"(inside the gate: {n_k[0]} rows of {plain_n[0]} kept, boxes moved up to {moved:.3g} px) and image {hi} with "
          f"{n_hi} (outside: {n_k[1]} plain rows); through K1 equal to the plain NMS (box err {box_err:.3g}, conf "
          f"err {conf_err:.3g}); {merge_ms:.2f} ms, launches {launches}", flush=True)
    return dict(conf=conf, candidates=(n_lo, n_hi), rows=n_k.tolist(), greedy_rows=plain_n.tolist(),
                ms=merge_ms, launches=launches)


class ValBatches:
    """An iterable of val batches with the file names the validator's callbacks read."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = type("Names", (), {"im_files": [f"frame{i:03d}.png" for i in
                                                       range(sum(b[0].shape[0] for b in batches))]})()

    def __iter__(self):
        return iter(self.batches)


def phase_save_hybrid(model, batches, map50_f32):
    """validator.run(save_hybrid=True) on the val frames (f32): the labels join
    the predictions as confidence-1 candidates before the host-facing NMS;
    K1 once a batch; every image's detections equal to those through the
    plain NMS; mAP50 beside the plain run's."""
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain

    class Recorder:
        def __init__(self):
            self.preds = {}

        def run(self, event, predn, path, **_):
            self.preds[path] = np.array(predn)

    data = ValBatches(batches)
    rec, rec_plain = Recorder(), Recorder()
    # --- the save_hybrid path: every launch from here to the count read is the path's own
    reset_kernel_counts()
    t0 = time.perf_counter()
    results, _, _ = validator.run(model=model, dataloader=data, save_hybrid=True, callbacks=rec)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    # --- end of the save_hybrid path
    results_plain, _, _ = validator.run(model=model, dataloader=data, save_hybrid=True, callbacks=rec_plain,
                                        nms_fn=greedy_nms_plain)
    check(launches == {"greedy_nms": len(batches), "masked_scores": 0, "conv3x3_bn_stats": 0},
          f"save_hybrid launches {launches} for {len(batches)} batches")
    check(sorted(rec.preds) == sorted(rec_plain.preds) == sorted(data.dataset.im_files), "images seen differ")
    n_dets = 0
    for path, got in rec.preds.items():
        check(np.array_equal(got, rec_plain.preds[path]),
              f"save_hybrid detections of {path} differ from the plain NMS's")
        n_dets += len(got)
    check(np.array_equal(np.array(results[:4]), np.array(results_plain[:4])), "save_hybrid metrics differ")
    map50 = float(results[2])
    check(map50 >= 0.99, f"save_hybrid mAP50 {map50}: every label is a confidence-1 detection")
    print(f"save_hybrid: mAP50 {map50:.4f} mAP50-95 {float(results[3]):.4f} (f32 run without it: mAP50 "
          f"{map50_f32:.4f}); {n_dets} detections through K1 equal to the plain NMS's; {wall:.2f} s for "
          f"{len(data.dataset.im_files)} images, launches {launches}", flush=True)
    return dict(map50=map50, map=float(results[3]), detections=n_dets, s=wall, launches=launches)


K3_KERNELS = ("conv3x3_stats", "bn_stats_finalize")  # the conv kernel and its fixed-order stats reduction
# (label, dtype, B, H, W, Cin, Cout). First yolov3@640's stride-1 3x3 convs at batch 8, one per map
# size and the stem (yolov3-spp's are the same six), then yolov5s@640's (its C3 bottlenecks, Cin =
# Cout; yolov5s-transformer's are among them), then yolov3-tiny@640's: these are timed, at the
# batch of 8 the train phases run. Then, for correctness only, yolov3-tiny at phase_learn's 320 px;
# odd shapes that reach every path of the kernels (each swizzle
# width of the wgmma kernel, a ragged last pixel tile, a Cout that is no multiple of the channel
# tile or of 8, a ragged stem row, the element-load kernel); and small f32 shapes.
K3_SHAPES = (
    ("320x320 32->64", torch.bfloat16, 8, 320, 320, 32, 64),
    ("160x160 64->128", torch.bfloat16, 8, 160, 160, 64, 128),
    ("80x80 128->256", torch.bfloat16, 8, 80, 80, 128, 256),
    ("40x40 256->512", torch.bfloat16, 8, 40, 40, 256, 512),
    ("20x20 512->1024", torch.bfloat16, 8, 20, 20, 512, 1024),
    ("stem 640x640 3->32", torch.bfloat16, 8, 640, 640, 3, 32),
    ("160x160 32->32", torch.bfloat16, 8, 160, 160, 32, 32),
    ("80x80 64->64", torch.bfloat16, 8, 80, 80, 64, 64),
    ("40x40 128->128", torch.bfloat16, 8, 40, 40, 128, 128),
    ("20x20 256->256", torch.bfloat16, 8, 20, 20, 256, 256),
    ("tiny stem 640x640 3->16", torch.bfloat16, 8, 640, 640, 3, 16),
    ("tiny 320x320 16->32", torch.bfloat16, 8, 320, 320, 16, 32),
    ("tiny 160x160 32->64", torch.bfloat16, 8, 160, 160, 32, 64),
    ("tiny 80x80 64->128", torch.bfloat16, 8, 80, 80, 64, 128),
    ("tiny 40x40 128->256", torch.bfloat16, 8, 40, 40, 128, 256),
    ("tiny 40x40 384->256", torch.bfloat16, 8, 40, 40, 384, 256),
    ("tiny 20x20 256->512", torch.bfloat16, 8, 20, 20, 256, 512),
    ("tiny 20x20 512->1024", torch.bfloat16, 8, 20, 20, 512, 1024),
    # phase_learn's: yolov3-tiny at 320 px, batch 32 (LEARN_IMGSZ, LEARN_BS)
    ("learn stem 320x320 3->16", torch.bfloat16, 32, 320, 320, 3, 16),
    ("learn 160x160 16->32", torch.bfloat16, 32, 160, 160, 16, 32),
    ("learn 80x80 32->64", torch.bfloat16, 32, 80, 80, 32, 64),
    ("learn 40x40 64->128", torch.bfloat16, 32, 40, 40, 64, 128),
    ("learn 20x20 128->256", torch.bfloat16, 32, 20, 20, 128, 256),
    ("learn 20x20 384->256", torch.bfloat16, 32, 20, 20, 384, 256),
    ("learn 10x10 256->512", torch.bfloat16, 32, 10, 10, 256, 512),
    ("learn 10x10 512->1024", torch.bfloat16, 32, 10, 10, 512, 1024),
    ("odd 13x19 64->40", torch.bfloat16, 8, 13, 19, 64, 40),
    ("odd 13x19 96->72", torch.bfloat16, 8, 13, 19, 96, 72),
    ("odd 13x19 48->100", torch.bfloat16, 8, 13, 19, 48, 100),
    ("odd stem 37x150 3->32", torch.bfloat16, 3, 37, 150, 3, 32),
    ("odd 13x19 8->12", torch.bfloat16, 8, 13, 19, 8, 12),
    ("odd 13x19 24->100", torch.bfloat16, 8, 13, 19, 24, 100),
    ("odd 13x19 5->7", torch.bfloat16, 8, 13, 19, 5, 7),
    ("f32 16x16 8->16", torch.float32, 8, 16, 16, 8, 16),
    ("f32 8x24 4->8", torch.float32, 8, 8, 24, 4, 8),
    ("f32 odd 13x19 5->7", torch.float32, 8, 13, 19, 5, 7),
)
# yolov3's, yolov5s's and yolov3-tiny's rows, the ones that are timed
K3_TIMED = tuple(row for row in K3_SHAPES if row[1] == torch.bfloat16 and row[2] == 8 and not row[0].startswith("odd"))
K3_MAIN_SHAPE = "80x80 128->256"  # the row of the {"kernels": ...} line
# y: one bf16 ulp of the plain version's rounding / f32 sums in another order
K3_LIMITS = {torch.bfloat16: dict(y_rtol=8e-3, y_atol=1e-2, mean_atol=1e-3, var_rtol=1e-2),
             torch.float32: dict(y_rtol=1e-4, y_atol=1e-4, mean_atol=1e-5, var_rtol=1e-3)}


def phase_conv_bn(shapes=K3_SHAPES, device="cuda", timed=True):
    """The conv3x3 + BN-statistics kernels against the plain version on seeded
    inputs (y ~ N(0, 1) per channel), twice for equal bits, and, for yolov3's
    shapes (bf16, batch 8), the time beside the plain version and two library
    yardsticks: cuDNN's conv + var_mean over an f32 copy of y, and over the
    bf16 y itself (no copy). Kernel and yardsticks are taken by summed kernel
    time in one profiler window and by CUDA events (launch gaps included)."""
    import torch.nn.functional as F

    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats, conv3x3_bn_stats_plain

    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for label, dtype, B, H, W, Cin, Cout in shapes:
        x = torch.randn((B, H, W, Cin), generator=gen, device=device).to(dtype)
        w = (torch.randn((3, 3, Cin, Cout), generator=gen, device=device) / (9 * Cin) ** 0.5).to(dtype)
        with torch.no_grad():
            y_k, mean_k, var_k = conv3x3_bn_stats(x, w)
            route = conv3x3_bn_stats.last_route
            again = conv3x3_bn_stats(x, w)
            y_p, mean_p, var_p = conv3x3_bn_stats_plain(x, w)
        if device == "cuda":
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip((y_k, mean_k, var_k), again)),
                  f"conv3x3_bn_stats {label}: two runs on the same inputs differ in their bits")
            if dtype == torch.bfloat16 and Cin % 16 == 0:
                check(route.startswith("bf16 wgmma"), f"conv3x3_bn_stats {label} took the kernel {route!r}")
        del again
        lim = K3_LIMITS[dtype]
        check(y_k.shape == (B, H, W, Cout) and y_k.dtype == dtype and mean_k.shape == var_k.shape == (Cout,),
              f"conv3x3_bn_stats {label}: wrong output shapes or types")
        y_err = (y_k.float() - y_p.float()).abs()
        y_bad = int((y_err > lim["y_atol"] + lim["y_rtol"] * y_p.float().abs()).sum())
        mean_err = float((mean_k - mean_p).abs().max())
        var_err = float(((var_k - var_p).abs() / var_p.abs()).max())
        row = dict(dtype=str(dtype).split(".")[-1], B=B, H=H, W=W, Cin=Cin, Cout=Cout, route=route,
                   max_abs_err=float(y_err.max()), mean_abs_err=mean_err, var_rel_err=var_err)
        check(y_bad == 0, f"conv3x3_bn_stats {label}: {y_bad} elements of y beyond rtol {lim['y_rtol']} "
                          f"atol {lim['y_atol']} (max abs err {row['max_abs_err']})")
        check(mean_err <= lim["mean_atol"], f"conv3x3_bn_stats {label}: mean err {mean_err} > {lim['mean_atol']}")
        check(var_err <= lim["var_rtol"], f"conv3x3_bn_stats {label}: var rel err {var_err} > {lim['var_rtol']}")
        msg = (f"K3 conv3x3_bn_stats {label} {row['dtype']} B={B} [{route}]: two runs equal, y max abs err {row['max_abs_err']:.3g}, "
               f"mean err {mean_err:.3g}, var rel err {var_err:.3g}")
        if timed and (label, dtype, B, H, W, Cin, Cout) in K3_TIMED:
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            w_view = w_oihw.permute(2, 3, 1, 0)  # as nn.modules.Conv hands its parameter over: no copy

            def kernel():
                return conv3x3_bn_stats(x, w_view)

            def library_f32():  # the statistics over an f32 copy of y, as the plain version takes them
                y = F.conv2d(x_nchw, w_oihw, padding=1)
                return torch.var_mean(y.float(), dim=(0, 2, 3), correction=0)

            def library_bf16():  # the tighter yardstick: no f32 copy of y is written or read
                y = F.conv2d(x_nchw, w_oihw, padding=1)
                return torch.var_mean(y, dim=(0, 2, 3), correction=0)

            with torch.no_grad():
                window = ranges_device_ms((("kernel", kernel), ("library_f32", library_f32),
                                           ("library_bf16", library_bf16)))
                row["launch_ms"] = cuda_ms(kernel)
                row["plain_ms"] = cuda_ms(lambda: conv3x3_bn_stats_plain(x, w), iters=5, warmup=1)
                row["library_f32_event_ms"] = cuda_ms(library_f32)
                row["library_bf16_event_ms"] = cuda_ms(library_bf16)
            row.update(ms=window["kernel"], library_f32_ms=window["library_f32"],
                       library_bf16_ms=window["library_bf16"],
                       library_ms=min(window["library_f32"], window["library_bf16"]))
            flops = 2 * 9 * B * H * W * Cin * Cout
            nbytes = (x.numel() + w.numel() + y_k.numel()) * x.element_size() + 2 * Cout * 4
            t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
            row.update(bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                       tflops=flops / row["ms"] / 1e9)
            msg += (f"; kernel {row['ms']:.4f} ms device ({row['launch_ms']:.4f} ms by events, "
                    f"{row['tflops']:.1f} TFLOP/s), plain "
                    f"{row['plain_ms']:.3f} ms; cuDNN conv + var_mean of an f32 copy {row['library_f32_ms']:.4f} ms "
                    f"device ({row['library_f32_event_ms']:.4f} by events), of the bf16 y "
                    f"{row['library_bf16_ms']:.4f} ms device ({row['library_bf16_event_ms']:.4f} by events); "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows[label] = row
        print(msg, flush=True)
    return rows


def make_train_batch(rng, bs=8, imgsz=640, n_boxes=8, max_labels=32, nc=80):
    """One seeded batch: uint8 frames, n_boxes labels an image padded to max_labels under a mask."""
    imgs = rng.integers(0, 256, size=(bs, imgsz, imgsz, 3), dtype=np.uint8)
    targets = np.zeros((bs, max_labels, 5), np.float32)
    targets[:, :n_boxes, 0] = rng.integers(0, nc, size=(bs, n_boxes))
    targets[:, :n_boxes, 1:3] = rng.uniform(0.1, 0.9, size=(bs, n_boxes, 2))
    targets[:, :n_boxes, 3:5] = rng.uniform(0.04, 0.5, size=(bs, n_boxes, 2))
    mask = np.zeros((bs, max_labels), bool)
    mask[:, :n_boxes] = True
    return imgs, targets, mask


TRAIN_GROUPS = (  # kernel-name substrings -> group, first match wins
    ("K3 conv3x3_bn_stats", K3_KERNELS),
    ("conv backward (cuDNN dgrad/wgrad)", ("dgrad", "wgrad")),
    ("other conv / GEMM (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "sm90", "cudnn", "nvjet")),
    ("batch norm (cuDNN / native)", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("optimizer + EMA + clip (multi-tensor)", ("multi_tensor",)),
)
STEP_RANGES = ("train_step/forward", "train_step/loss", "train_step/optimizer", "train_step/ema")


def profile_train_step(step, batch, iters=2, label="train"):
    """Device time of a train step by kernel group (by kernel name) and by the
    step's own phases (the record_function ranges of train/step.py; the
    backward runs on autograd's thread and is the remainder)."""
    from torch.profiler import ProfilerActivity, profile

    step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a record_function range shows on the device's timeline too (the span from
    # its first kernel to its last): those and the optimizer's own range are no kernels
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                   and e.name not in STEP_RANGES and not e.name.startswith("Optimizer."))
    check(spans, "the profiler saw no device activity in the train step")
    by_group, by_name, busy, edge, total = {}, {}, 0.0, -1.0, 0.0
    for start, end, name in spans:
        group = next((g for g, keys in TRAIN_GROUPS if any(k in name.lower() for k in keys)),
                     "elementwise, loss and other")
        by_group[group] = by_group.get(group, 0.0) + (end - start)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        total += end - start
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    groups = {g: t / iters / 1e3 for g, t in by_group.items()}
    parts = ", ".join(f"{g} {t:.3f} ms" for g, t in sorted(groups.items(), key=lambda x: -x[1]))
    print(f"{label} profile, per step: {parts}; {len(spans) // iters} kernels, device busy "
          f"{busy / wall_us:.1%} of {wall_us / iters / 1e3:.3f} ms wall (profiler on)", flush=True)
    # by phase: the host-side range events carry the kernels launched inside them
    def launched(event):
        return len(event.kernels) + sum(launched(child) for child in event.cpu_children)

    ranges, counts, host_ms, seen = {}, {}, {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in STEP_RANGES:
            key = e.name.split("/")[1]
            ranges[key] = ranges.get(key, 0.0) + e.device_time_total / iters / 1e3
            counts[key] = counts.get(key, 0) + launched(e) // iters
            host_ms[key] = host_ms.get(key, 0.0) + e.cpu_time_total / iters / 1e3
            seen += 1
    if seen == len(STEP_RANGES) * iters and sum(ranges.values()) > 0:
        ranges["backward"] = total / iters / 1e3 - sum(ranges.values())
        counts["backward"] = len(spans) // iters - sum(counts.values())
        print(f"{label} profile, kernel ms per step by phase (backward = launched outside the step's ranges): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ranges.items()), flush=True)
        print(f"{label} profile, kernels per step by phase: " + ", ".join(f"{k} {v}" for k, v in counts.items())
              + "; host ms inside the ranges (profiler on): "
              + ", ".join(f"{k} {v:.1f}" for k, v in host_ms.items()), flush=True)
    else:
        ranges, counts = {}, {}
        print(f"{label} profile by phase: not measured ({seen} range events seen)", flush=True)
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:14]:
        print(f"{label} profile kernel {t / iters / 1e3:.3f} ms  {name[:110]}", flush=True)
    return dict(groups_ms=groups, phases_ms=ranges, phase_kernels=counts, kernels=len(spans) // iters,
                device_busy=busy / wall_us)


YOLOV3_K3_CONVS = 33  # stride-1 3x3 convs of yolov3: K3 launches in each train step
STATES_AGAINST_PLAIN = 6  # states of a train run from which K3 and its plain version each take one f32 step
F32_STEP_LIMITS = dict(loss_rtol=1e-4, norm_rtol=1e-3)


def phase_train(rng, model, bs=8, imgsz=640, steps=10, convs_per_step=YOLOV3_K3_CONVS, label="train"):
    """Drive the train path: 1 + `steps` steps on one seeded batch, then hold
    K3 against its plain version from the run's states (`steps_against_plain`).
    Returns (launches of the conv+statistics kernel in the path's steps,
    measurements); `label` starts each line printed."""
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.train.loss import LossConfig
    from yolov3_tpu_torch.train.optim import build_optimizer
    from yolov3_tpu_torch.train.step import make_train_step

    hyp = {"warmup_epochs": 0.0}  # every other hyper-parameter at its default
    # batch_size = nbs = 64: no accumulation, so every step updates the parameters
    optimizer, _, accumulate = build_optimizer("sgd", model, hyp, epochs=300, steps_per_epoch=1000,
                                               batch_size=64, min_warmup_steps=0)
    check(accumulate == 1, f"accumulate is {accumulate}")
    loss_cfg = LossConfig.from_model(model.spec, hyp)
    step = make_train_step(model, loss_cfg, optimizer)
    state = step.state
    batch = make_train_batch(rng, bs, imgsz, nc=model.spec.nc)
    on_card = model.device.type == "cuda"
    if on_card:
        batch = tuple(torch.as_tensor(a, device=model.device) for a in batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # --- the train path: every launch from here to the count read is the path's own
    conv3x3_bn_stats.launches = 0
    t0 = time.perf_counter()
    losses = [step(*batch)["loss"]]  # warm-up: cuDNN picks its algorithms, the allocator grows
    if on_card:
        torch.cuda.synchronize()
        check(conv3x3_bn_stats.launches == convs_per_step,
              f"{label}: first step launched the conv+statistics kernel {conv3x3_bn_stats.launches} times")
    t1 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(*batch)["loss"])
    if on_card:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = conv3x3_bn_stats.launches
    # --- end of the train path

    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    out = dict(first_step_ms=(t1 - t0) * 1e3, peak_memory_gb=peak_gb, losses=losses)
    msg = (f"{label} path: batch {bs} at {imgsz} px, first step {out['first_step_ms']:.1f} ms "
           "(cuDNN picks its algorithms)")
    if steps:
        out["step_ms"] = (t2 - t1) / steps * 1e3
        out["img_s"] = bs / out["step_ms"] * 1e3
        msg += f", then {steps} steps in {out['step_ms']:.2f} ms/step = {out['img_s']:.1f} img/s"
    print(f"{msg}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; K3 launches {launches}; peak memory {peak_gb:.2f} GB",
          flush=True)
    print(f"{label} losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    check(all(np.isfinite(losses)), f"{label}: a loss is not finite: {losses}")
    kinds = (("bn running_mean", "running_mean"), ("bn running_var", "running_var"))
    if steps:  # the warm-up starts at a weight lr of 0: the first step moves no weight
        check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
        kinds = (("conv weights", "conv.weight"), ("bn weights", "bn.weight"), *kinds)
    check(state.step == steps + 1 and state.ema.updates == steps + 1 and optimizer.updates == steps + 1,
          f"{label}: step counters: step {state.step}, ema {state.ema.updates}, optimizer {optimizer.updates}")
    if on_card:
        check(launches == convs_per_step * (steps + 1),
              f"{label}: {launches} launches of the conv+statistics kernel in {steps + 1} steps, "
              f"expected {convs_per_step} a step")
    after = model.state_dict()

    def moved(keys):
        return sum(not torch.equal(before[k], after[k]) for k in keys), len(keys)

    for kind, suffix in kinds:
        n_moved, n = moved([k for k in before if k.endswith(suffix)])
        check(n_moved == n > 0, f"{label}: only {n_moved} of {n} {kind} changed")
    ema_moved = sum(not torch.equal(before[k], v) for k, v in state.ema.ema.items() if v.is_floating_point())
    check(ema_moved > 0 and all(bool(torch.isfinite(v).all()) for v in state.ema.ema.values()
                                if v.is_floating_point()), f"{label}: the EMA did not move or is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in after.values() if v.is_floating_point()),
          f"{label}: a parameter or BatchNorm statistic is not finite")
    print(f"{label} state: every {', '.join(kind for kind, _ in kinds)} moved, {ema_moved} EMA tensors moved, "
          f"all finite; step {state.step}", flush=True)
    if not on_card:
        return launches, out

    out["profile"] = profile_train_step(step, batch, label=label)
    out["kernel_vs_plain"] = steps_against_plain(model, loss_cfg, optimizer, state, batch, convs_per_step, label)
    return launches, out


def steps_against_plain(model, loss_cfg, optimizer, state, batch, convs, label):
    """K3 against its plain version inside a train run, continued from its
    state (the path's launches are counted by then). From each of
    STATES_AGAINST_PLAIN states, one float32 step through K3 (its f32
    route) and one through the plain version: loss and grad norm within
    F32_STEP_LIMITS; then the run's own bf16 step. The first of those records each K3 call's inputs, and K3
    (the bf16 kernel the path runs) is held against the plain version on them
    at K3_LIMITS: that is the gate on the path's own kernel.

    The whole steps are compared in float32, not bf16: a bf16 step's grad
    norm moves with any rounding difference. Over ten states each of yolov5s
    (two seeds) and yolov3 on an H100 (scripts/train_step_spread.py) the bf16
    step through K3 against the plain one differed by 0.04-7.4%, and two plain
    steps whose weights differ only by their bf16 rounding by 0.1-8.5%."""
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats, conv3x3_bn_stats_plain
    from yolov3_tpu_torch.train.step import make_train_step

    calls = []

    def recording(x, w):  # the inputs as the kernel takes them under autocast
        calls.append((x.detach().to(torch.bfloat16), w.detach().to(torch.bfloat16)))
        return conv3x3_bn_stats(x, w)

    rows = []
    for k in range(STATES_AGAINST_PLAIN):
        saved = copy.deepcopy((model.state_dict(), optimizer.state_dict()))
        res = {}
        for route, fn in (("kernel", conv3x3_bn_stats), ("plain", conv3x3_bn_stats_plain)):
            model.load_state_dict(saved[0])
            optimizer.load_state_dict(copy.deepcopy(saved[1]))  # loading shares the tensors it is given
            m = make_train_step(model, loss_cfg, optimizer, state=state, bn_stats_fn=fn,
                                compute_dtype=torch.float32)(*batch)
            res[route] = (float(m["loss"]), float(m["grad_norm"]))
        model.load_state_dict(saved[0])
        optimizer.load_state_dict(copy.deepcopy(saved[1]))
        make_train_step(model, loss_cfg, optimizer, state=state,
                        bn_stats_fn=recording if k == 0 else conv3x3_bn_stats)(*batch)  # the run's bf16 step
        (loss_k, norm_k), (loss_p, norm_p) = res["kernel"], res["plain"]
        rows.append(dict(loss=(loss_k, loss_p), grad_norm=(norm_k, norm_p),
                         loss_rel=abs(loss_k - loss_p) / abs(loss_p), norm_rel=abs(norm_k - norm_p) / abs(norm_p)))
        print(f"{label} state {k}, a float32 step through K3 and through the plain version: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} ({rows[-1]['loss_rel']:.2e}), grad norm {norm_k:.5f} vs {norm_p:.5f} "
              f"({rows[-1]['norm_rel']:.2e})", flush=True)
        check(rows[-1]["loss_rel"] <= F32_STEP_LIMITS["loss_rtol"],
              f"{label} state {k}: losses differ: {loss_k} vs {loss_p} (rtol {F32_STEP_LIMITS['loss_rtol']})")
        check(rows[-1]["norm_rel"] <= F32_STEP_LIMITS["norm_rtol"],
              f"{label} state {k}: grad norms differ: {norm_k} vs {norm_p} (rtol {F32_STEP_LIMITS['norm_rtol']})")

    lim = K3_LIMITS[torch.bfloat16]
    check(len(calls) == convs, f"{label}: {len(calls)} K3 calls recorded in a step, expected {convs}")
    per_call = []
    with torch.no_grad():
        for x, w in calls:
            (y_k, mean_k, var_k), (y_p, mean_p, var_p) = conv3x3_bn_stats(x, w), conv3x3_bn_stats_plain(x, w)
            y_bad = int(((y_k.float() - y_p.float()).abs() > lim["y_atol"] + lim["y_rtol"] * y_p.float().abs()).sum())
            mean_err = float((mean_k - mean_p).abs().max())
            var_err = float(((var_k - var_p).abs() / var_p.abs().clamp(min=1e-12)).max())
            shape = "x".join(map(str, x.shape))
            check(y_bad == 0 and mean_err <= lim["mean_atol"] and var_err <= lim["var_rtol"],
                  f"{label}: K3 on the step's input {shape}: {y_bad} elements of y out, mean err {mean_err}, "
                  f"var rel err {var_err}")
            per_call.append(dict(x=shape, route=conv3x3_bn_stats.last_route,
                                 y_max_abs_err=float((y_k.float() - y_p.float()).abs().max()),
                                 mean_abs_err=mean_err, var_rel_err=var_err))
    if per_call:
        print(f"{label}: K3 against its plain version on the bf16 step's own {len(per_call)} inputs: all within "
              f"K3_LIMITS; y max abs err {max(r['y_max_abs_err'] for r in per_call):.3g}, mean err "
              f"{max(r['mean_abs_err'] for r in per_call):.3g}, var rel err "
              f"{max(r['var_rel_err'] for r in per_call):.3g}", flush=True)
    return dict(states=rows, per_call=per_call)


REMAT_VARIANTS = (("off", {}), ("whole-body", dict(remat=True)), ("until-7", dict(remat=True, remat_until=7)))


def phase_remat(bs=8, imgsz=640, steps=3):
    """The train step at batch 8 from one state three ways: remat off,
    whole-body remat (segments of 6 layers) and remat_until=7. Per variant:
    peak device memory over its steps, ms per step, K3 launches per step
    (33 plus one per stride-1 3x3 conv of the recomputed layers). The first
    step of each holds remat on to remat off: loss within 1e-5 relative,
    every BatchNorm running statistic within 1e-6 and num_batches_tracked
    equal (updated once), grad norm within 1e-3 relative."""
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.nn.modules import Conv
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.train.loss import LossConfig
    from yolov3_tpu_torch.train.optim import build_optimizer
    from yolov3_tpu_torch.train.step import make_train_step

    model = DetectionModel.from_config("yolov3", seed=0)
    hyp = {"warmup_epochs": 0.0}
    loss_cfg = LossConfig.from_model(model.spec, hyp)
    batch = tuple(torch.as_tensor(a, device=model.device)
                  for a in make_train_batch(np.random.default_rng(8), bs, imgsz, nc=model.spec.nc))
    start = copy.deepcopy(model.state_dict())
    routed = [int(n.split(".")[1]) for n, m in model.named_modules() if isinstance(m, Conv) and m.stats_route]
    check(len(routed) == YOLOV3_K3_CONVS, f"{len(routed)} routed convs")
    stat_keys = [k for k in start if "running_" in k or k.endswith("num_batches_tracked")]
    out = {}
    for label, kw in REMAT_VARIANTS:
        model.load_state_dict(start)
        optimizer, _, _ = build_optimizer("sgd", model, hyp, epochs=300, steps_per_epoch=1000, batch_size=64,
                                          min_warmup_steps=0)
        step = make_train_step(model, loss_cfg, optimizer, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # --- the remat path: every launch from here to the count read is the path's own
        reset_kernel_counts()
        first = step(*batch)
        torch.cuda.synchronize()
        stats = {k: model.state_dict()[k].clone() for k in stat_keys}
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        launches = conv3x3_bn_stats.launches
        # --- end of the remat path
        recomputed = len(routed) if kw.get("remat_until", -1) < 0 else sum(i < kw["remat_until"] for i in routed)
        expected = (len(routed) + (recomputed if kw else 0)) * (steps + 1)
        check(launches == expected, f"remat {label}: {launches} K3 launches in {steps + 1} steps, expected {expected}")
        out[label] = dict(loss=float(first["loss"]), grad_norm=float(first["grad_norm"]), stats=stats,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9, step_ms=step_ms,
                          k3_per_step=launches // (steps + 1))
        del step, optimizer
    base = out["off"]
    for label, _ in REMAT_VARIANTS[1:]:
        r = out[label]
        loss_gap = abs(r["loss"] - base["loss"]) / abs(base["loss"])
        norm_gap = abs(r["grad_norm"] - base["grad_norm"]) / abs(base["grad_norm"])
        stat_gap = max(float((r["stats"][k].double() - base["stats"][k].double()).abs().max()) for k in stat_keys)
        check(loss_gap <= 1e-5, f"remat {label}: loss {r['loss']} vs {base['loss']} (rel gap {loss_gap})")
        check(norm_gap <= 1e-3,
              f"remat {label}: grad norm {r['grad_norm']} vs {base['grad_norm']} (rel gap {norm_gap})")
        check(stat_gap <= 1e-6, f"remat {label}: a BatchNorm statistic differs by {stat_gap}")
        check(all(int(r["stats"][k]) == 1 for k in stat_keys if k.endswith("num_batches_tracked")),
              f"remat {label}: num_batches_tracked advanced more than once")
        r.update(loss_rel_gap=loss_gap, grad_norm_rel_gap=norm_gap, bn_stat_max_gap=stat_gap)
    for label, r in out.items():
        del r["stats"]
        print(f"remat {label}: peak memory {r['peak_gb']:.3f} GB, {r['step_ms']:.2f} ms/step over {steps} steps "
              f"(batch {bs} at {imgsz} px), K3 launches {r['k3_per_step']} a step; first step loss {r['loss']:.6f}, "
              f"grad norm {r['grad_norm']:.5f}"
              + ("" if label == "off" else f"; against remat off: loss rel gap {r['loss_rel_gap']:.3g}, grad norm "
                 f"rel gap {r['grad_norm_rel_gap']:.3g}, BatchNorm statistics max gap {r['bn_stat_max_gap']:.3g}, "
                 "num_batches_tracked 1"), flush=True)
    return out


TRAINER_IMAGES = (64, 32)  # synthetic PNG images in the train and val splits
TRAINER_IMGSZ = 640
TRAINER_BS = 16
TRAINER_WORKERS = 8
TRAINER_EPOCHS = 2


class EpochClock:
    """Host timestamps of the trainer's epochs, taken by callbacks, and an
    optional profiler range around each epoch's train loop."""

    HOOKS = ("on_train_epoch_start", "on_train_batch_start", "on_train_epoch_end", "on_val_end", "on_model_save")

    def __init__(self, callbacks, ranged=False):
        self.marks = []
        self.ranged = ranged
        self._range = None
        for hook in self.HOOKS:
            callbacks.register_action(hook, "clock", lambda hook=hook, **kw: self.mark(hook))

    def mark(self, hook):
        self.marks.append((hook, time.perf_counter()))
        if self.ranged and hook == "on_train_epoch_start":
            self._range = torch.profiler.record_function("trainer/epoch_train_loop")
            self._range.__enter__()
        elif self.ranged and hook == "on_train_epoch_end":
            self._range.__exit__(None, None, None)

    def epochs(self):
        """Per epoch: (train loop s, train loop s from the second batch's
        start, val s, checkpoint save s, epoch wall s). The whole loop holds
        the loader's start-up (its threads, its first batches); the loop from
        the second batch holds the steps after the first."""
        out, t, batches = [], {}, []
        for hook, when in self.marks:
            t[hook] = when
            if hook == "on_train_epoch_start":
                batches = []
            elif hook == "on_train_batch_start":
                batches.append(when)
            elif hook == "on_model_save":
                s, e = t["on_train_epoch_start"], t["on_train_epoch_end"]
                v = max(t.get("on_val_end", e), e)  # noval: no validation time
                out.append((e - s, e - batches[1], v - e, when - v, when - s))
        return out


def busy_share(prof, range_name):
    """Device busy share (merged kernel time over wall) inside the host range `range_name`."""
    window = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU and e.name == range_name]
    check(window, f"the profiler saw no {range_name} range")
    lo, hi = window[0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                   and e.time_range.start >= lo and e.time_range.end <= hi)
    check(spans, "the profiler saw no device activity in the trainer's epoch")
    busy, edge = 0.0, -1.0
    for start, end in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    return busy / (hi - lo), len(spans)


def phase_trainer():
    """Drive the trainer on the card: a synthetic PNG dataset on disk, the
    train loader alone, `train()` for TRAINER_EPOCHS at full width, a resume
    of one more epoch from the full state saved after the last epoch, and
    the stripped `best` served through build_batched_infer. Returns
    (launches of each kernel over the trainer's run, measurements)."""
    import shutil
    import tempfile
    from pathlib import Path

    from yolov3_tpu_torch.data import synthetic
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.data.datasets import DataLoader, DetectionDataset
    from yolov3_tpu_torch.data.image_ops import imread
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores
    from yolov3_tpu_torch.serve import build_batched_infer
    from yolov3_tpu_torch.train.loop import HYPS, train
    from yolov3_tpu_torch.utils.autobatch import check_train_batch_size
    from yolov3_tpu_torch.utils.callbacks import Callbacks
    from yolov3_tpu_torch.utils.checkpoint import load_checkpoint, load_model_from_checkpoint
    from yolov3_tpu_torch.utils.general import yaml_load
    from yolov3_tpu_torch.utils.loggers import read_results

    (n_train, n_val), imgsz, bs, workers, epochs = (TRAINER_IMAGES, TRAINER_IMGSZ, TRAINER_BS, TRAINER_WORKERS,
                                                     TRAINER_EPOCHS)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        t0 = time.perf_counter()
        synthetic.generate(tmp / "shapes", n_images=n_train, imgsz=imgsz, seed=0, n_val=n_val)
        data = str(tmp / "shapes" / "dataset.yaml")
        gen_s = time.perf_counter() - t0

        # the train loader alone: mosaic, HSV, flips at imgsz, `workers` threads (train()'s default hyps)
        ds = DetectionDataset(str(tmp / "shapes/images/train"), imgsz=imgsz, augment=True,
                              hyp=yaml_load(HYPS / "scratch-low.yaml"), batch_size=bs,
                              num_cls=len(synthetic.CLASSES))
        loader = DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True, workers=workers, label_buckets=True)
        t0 = time.perf_counter()
        arrivals = [time.perf_counter() for _ in loader]
        loader_img_s = len(arrivals) * bs / (arrivals[-1] - t0)
        loader_steady_img_s = (len(arrivals) - 1) * bs / (arrivals[-1] - arrivals[0])
        print(f"trainer: {n_train} + {n_val} PNG images written in {gen_s:.2f} s; train loader alone "
              f"(mosaic at {imgsz} px, batch {bs}, {workers} workers): {loader_img_s:.1f} img/s over "
              f"{len(arrivals)} batches, first batch after {(arrivals[0] - t0) * 1e3:.1f} ms, "
              f"{loader_steady_img_s:.1f} img/s after it", flush=True)

        run = tmp / "run"
        kw = dict(cfg="yolov3", batch_size=bs, imgsz=imgsz, noplots=True, workers=workers, save_dir=run)
        steps = n_train // bs
        cb = Callbacks()
        clock = EpochClock(cb)
        full = tmp / "last_full"  # the unstripped `last` of the final epoch, kept for the resume
        cb.register_action("on_model_save", "keep", lambda epoch, final, **_: final and shutil.copytree(
            run / "weights" / "last", full))

        # --- the trainer: every launch from here to the count read is the path's own
        conv3x3_bn_stats.launches = greedy_nms.launches = masked_scores.launches = 0
        t0 = time.perf_counter()
        train(data, epochs=epochs, callbacks=cb, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"conv3x3_bn_stats": conv3x3_bn_stats.launches, "greedy_nms": greedy_nms.launches,
                    "masked_scores": masked_scores.launches}
        # --- end of the trainer

        rows = read_results(run / "results.csv")
        val_batches = -(-n_val // bs)
        per_epoch = clock.epochs()
        print(f"trainer: {epochs} epochs of {steps} steps in {train_s:.2f} s, launches {launches}", flush=True)
        for e, (loop_s, steady_s, val_s, save_s, wall_s) in enumerate(per_epoch):
            print(f"trainer epoch {e}: wall {wall_s:.2f} s = train loop {loop_s:.3f} s ({n_train / loop_s:.1f} img/s; "
                  f"{(steps - 1) * bs / steady_s:.1f} img/s from the second batch) + val {val_s * 1e3:.1f} ms "
                  f"+ checkpoints {save_s:.2f} s; losses "
                  + " ".join(f"{rows[e][k]:.4f}" for k in ("train/box_loss", "train/obj_loss", "train/cls_loss")),
                  flush=True)
        check(len(rows) == epochs and [int(r["epoch"]) for r in rows] == list(range(epochs)),
              f"results.csv rows {[r['epoch'] for r in rows]}")
        check(all(np.isfinite(list(r.values())).all() for r in rows), "a results.csv value is not finite")
        for name in ("last", "best"):
            check(yaml_load(run / "weights" / name / "checkpoint.yaml").get("stripped") is True,
                  f"weights/{name} is not stripped")
        check(launches["conv3x3_bn_stats"] == YOLOV3_K3_CONVS * steps * epochs,
              f"K3 launched {launches['conv3x3_bn_stats']} times in {steps * epochs} steps")
        check(launches["greedy_nms"] == val_batches * epochs,
              f"K1 launched {launches['greedy_nms']} times for {val_batches} val batches x {epochs} epochs")

        # resume one more epoch from the full state of the last epoch, under the profiler
        shutil.rmtree(run / "weights" / "last")
        shutil.copytree(full, run / "weights" / "last")
        saved, _ = load_checkpoint(full)
        cb = Callbacks()
        clock_r = EpochClock(cb, ranged=True)
        resumed = tmp / "resumed_full"
        cb.register_action("on_model_save", "keep", lambda final, **_: final and shutil.copytree(
            run / "weights" / "last", resumed))
        conv3x3_bn_stats.launches = 0
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train(data, epochs=epochs + 1, resume=True, callbacks=cb, **kw)
        busy, n_kernels = busy_share(prof, "trainer/epoch_train_loop")
        resume_launches = conv3x3_bn_stats.launches
        after, meta = load_checkpoint(resumed)
        rows = read_results(run / "results.csv")
        check([int(r["epoch"]) for r in rows] == list(range(epochs + 1)), f"resumed results.csv rows {len(rows)}")
        check(meta["epoch"] == epochs, f"the resumed run saved epoch {meta['epoch']}")
        check(saved["step"] == steps * epochs and after["step"] == steps * (epochs + 1),
              f"step counter {saved['step']} -> {after['step']}")
        upd, accumulate = saved["optimizer"]["updates"], max(round(64 / bs), 1)  # nbs 64
        check(upd == steps * epochs // accumulate and after["optimizer"]["updates"] == upd + steps // accumulate
              and after["ema"]["updates"] == steps * (epochs + 1),
              f"optimizer updates {upd} -> {after['optimizer']['updates']}, ema {after['ema']['updates']}")
        check(upd == 0 or len(saved["optimizer"]["optimizer"]["state"]) > 0, "the saved optimizer state is empty")
        check(resume_launches == YOLOV3_K3_CONVS * steps, f"K3 launched {resume_launches} times on resume")
        (loop_s, steady_s, val_s, save_s, wall_s), = clock_r.epochs()
        print(f"trainer resume: epoch {epochs} from step {saved['step']} (optimizer updates {upd}) to step "
              f"{after['step']} (updates {after['optimizer']['updates']}); wall {wall_s:.2f} s, train loop "
              f"{loop_s:.3f} s under the profiler, device busy {busy:.1%} of it ({n_kernels} kernels)", flush=True)

        # the stripped best, served
        model = load_model_from_checkpoint(run / "weights" / "best")
        frames = np.stack([letterbox(imread(f), imgsz, auto=False)[0][:, :, ::-1]
                           for f in sorted((tmp / "shapes/images/val").glob("*.png"))[:32]])
        infer = build_batched_infer(model)
        infer(frames[:2])  # warm-up
        torch.cuda.synchronize()
        greedy_nms.launches = masked_scores.launches = 0
        t0 = time.perf_counter()
        dets, n = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in infer(frames))
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_launches = {"greedy_nms": greedy_nms.launches, "masked_scores": masked_scores.launches}
        check(dets.shape == (len(frames), 300, 6) and np.isfinite(dets).all(), f"served dets {dets.shape}")
        check(serve_launches["greedy_nms"] >= 1 and serve_launches["masked_scores"] >= 1,
              f"the served batch did not launch K1 and K2: {serve_launches}")
        print(f"trainer serve: stripped best, batch {len(frames)} in {serve_ms:.2f} ms, {infer.fallbacks} "
              f"fallbacks, detections per image mean {n.mean():.2f}, launches {serve_launches}", flush=True)
        # train(batch_size=-1): a trial step at two batch sizes on a copy of the model
        autobatch = check_train_batch_size(model, imgsz=imgsz)
        check(1 <= autobatch <= 1024, f"AutoBatch chose {autobatch}")
        print(f"trainer AutoBatch: batch {autobatch} for yolov3@{imgsz} on this card", flush=True)
        keys = ("loop_s", "loop_from_second_batch_s", "val_s", "save_s", "wall_s")
        out = dict(loader_img_s=loader_img_s, loader_img_s_after_first_batch=loader_steady_img_s,
                   epochs=[dict(zip(keys, e)) for e in per_epoch],
                   train_img_s=[n_train / e[0] for e in per_epoch],
                   train_img_s_from_second_batch=[(steps - 1) * bs / e[1] for e in per_epoch],
                   resume_device_busy=busy, resume_epoch=dict(zip(keys, (loop_s, steady_s, val_s, save_s, wall_s))),
                   serve_ms=serve_ms, serve_launches=serve_launches, autobatch=autobatch, losses=[
                       [r[k] for k in ("train/box_loss", "train/obj_loss", "train/cls_loss")] for r in rows])
        return launches, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- a training run that learns ---------------------------------------------

LEARN_CFG = "yolov3-tiny"
LEARN_PARAMS = 8852366  # yolov3-tiny at its published width, nc 80
LEARN_IMAGES = 256  # the synthetic train split, also the split the bars are read on: one epoch is 256 images
LEARN_IMGSZ = 320
LEARN_BS = 32  # nbs 64: an optimizer update every 2 steps
LEARN_WORKERS = 8
LEARN_EPOCHS = 40  # 320 steps, the first 100 of them warm-up (train/optim.py's least warm-up)
LEARN_PROFILED_EPOCH = 2  # the epoch whose train loop runs under torch.profiler
# scratch-low without augmentation (the images are learned as they are), lr0 0.02, momentum 0.9, no weight
# decay, lrf 0.1: in a tuning run on the card it reached mAP50 0.864 where scratch-low's lr reached 0.810
LEARN_HYP_OVERRIDES = {
    "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.0, "mosaic": 0.0, "mixup": 0.0, "copy_paste": 0.0,
    "lr0": 0.02, "momentum": 0.9, "weight_decay": 0.0, "lrf": 0.1}
LEARN_MAP50 = 0.5  # tests/test_e2e.py:141-142: trained mAP50 > 0.5 and > untrained + 0.4 on the train split
LEARN_MARGIN = 0.4
PLOT_PACKAGES = ("matplotlib", "seaborn", "pandas")


class EpochProfile:
    """torch.profiler over the train loop of one epoch of `train()`, started
    and stopped by its callbacks; the loop runs inside the range `RANGE`."""

    RANGE = "learn/epoch_train_loop"

    def __init__(self, callbacks, epoch):
        self.epoch, self.seen, self.prof, self.range = epoch, -1, None, None
        callbacks.register_action("on_train_epoch_start", "profile", lambda **_: self.start())
        callbacks.register_action("on_train_epoch_end", "profile", lambda **_: self.stop())

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.seen += 1
        if self.seen == self.epoch:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.range = torch.profiler.record_function(self.RANGE)
            self.range.__enter__()

    def stop(self):
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.range = None


def stats_route_convs(model):
    """The model's Convs that take the conv+statistics route in train mode (its stride-1 3x3 convs with a
    BatchNorm, nested ones included): K3 launches a train step."""
    return sum(bool(getattr(m, "stats_route", False)) for m in model.modules())


def phase_learn(gpu, epochs=LEARN_EPOCHS, n_images=LEARN_IMAGES, imgsz=LEARN_IMGSZ, bs=LEARN_BS, cfg=LEARN_CFG,
                hyp_overrides=None, noval=True, device=None):
    """Train yolov3-tiny at its published width (nc 5) from seeded random
    weights on the synthetic shapes written as PNGs, through train.loop.train
    with its default plots (K3 in every step), then validate the trained
    `last` and the untrained model on the train split through
    validator.run(plots=True) (K1 once a batch at K = 30000) and hold JAX's
    bars: trained mAP50 > LEARN_MAP50 and > untrained + LEARN_MARGIN.
    Measures the loop's and the loader's img/s over epochs of n_images, the
    device busy share of one epoch's loop, and which plot files the card's
    host could write. Then check_bf16, profile_layers and model_memory_bytes
    on full-width yolov3 at 640. Returns (launches, measurements)."""
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    from yolov3_tpu_torch.data import image_ops, synthetic
    from yolov3_tpu_torch.data.datasets import DataLoader, DetectionDataset
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.train.loop import HYPS, train
    from yolov3_tpu_torch.utils.callbacks import Callbacks
    from yolov3_tpu_torch.utils.checkpoint import load_model_from_checkpoint
    from yolov3_tpu_torch.utils.general import yaml_load
    from yolov3_tpu_torch.utils.loggers import read_results

    t_phase = time.perf_counter()
    check(DetectionModel.from_config(cfg, device=device).num_params() == LEARN_PARAMS,
          f"{cfg} at nc 80 does not have {LEARN_PARAMS} parameters")
    hyp = {**yaml_load(HYPS / "scratch-low.yaml"), **LEARN_HYP_OVERRIDES, **(hyp_overrides or {})}
    packages = {p: importlib.util.find_spec(p) is not None for p in PLOT_PACKAGES}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_learn_"))
    try:
        data = synthetic.generate(tmp / "shapes", n_images=n_images, imgsz=imgsz, seed=1)  # val: the train split
        nc = len(data["names"])
        # the loader alone: one epoch of the train split as train() loads it (RAM cache, no augmentation)
        t0 = time.perf_counter()
        ds = DetectionDataset(str(tmp / "shapes/images/train"), imgsz=imgsz, augment=True, hyp=hyp, batch_size=bs,
                              num_cls=nc, cache_images="ram")
        cache_s = time.perf_counter() - t0
        loader = DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True, workers=LEARN_WORKERS,
                            label_buckets=True)
        t0 = time.perf_counter()
        arrivals = [time.perf_counter() for _ in loader]
        loader_img_s = len(arrivals) * bs / (arrivals[-1] - t0)
        del ds, loader

        run = tmp / "run"
        cb = Callbacks()
        clock = EpochClock(cb)
        prof = EpochProfile(cb, LEARN_PROFILED_EPOCH)
        steps = n_images // bs
        # --- the training run: every launch from here to the count read is the path's own
        conv3x3_bn_stats.launches = greedy_nms.launches = 0
        t0 = time.perf_counter()
        train(data, cfg=cfg, hyp=hyp, epochs=epochs, batch_size=bs, imgsz=imgsz, noval=noval, noautoanchor=True,
              cache_images="ram", workers=LEARN_WORKERS, save_dir=run, callbacks=cb, seed=0, device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"conv3x3_bn_stats": conv3x3_bn_stats.launches, "greedy_nms": greedy_nms.launches}
        # --- end of the training run
        convs = stats_route_convs(DetectionModel.from_config(cfg, device="cpu"))
        check(launches["conv3x3_bn_stats"] == convs * steps * epochs,
              f"K3 launched {launches['conv3x3_bn_stats']} times in {steps * epochs} steps of {convs} layers")
        busy, n_kernels = busy_share(prof.prof, EpochProfile.RANGE)
        rows = read_results(run / "results.csv")
        per_epoch = clock.epochs()
        unprofiled = [e for i, e in enumerate(per_epoch) if i != LEARN_PROFILED_EPOCH]
        loop_img_s = [n_images / e[0] for e in unprofiled]
        steady_img_s = [(steps - 1) * bs / e[1] for e in unprofiled]  # from the second batch: no loader start-up
        print(f"learn: {cfg} nc {nc}, {epochs} epochs of {steps} steps at batch {bs}, {imgsz} px, {n_images} "
              f"images in {train_s:.1f} s; K3 {launches['conv3x3_bn_stats']} launches "
              f"({launches['conv3x3_bn_stats'] / (steps * epochs):g} a step, {convs} stride-1 3x3 Conv layers); "
              f"loop img/s median {np.median(loop_img_s):.1f} (min {min(loop_img_s):.1f}, max "
              f"{max(loop_img_s):.1f}), {np.median(steady_img_s):.1f} from the second batch; checkpoints median "
              f"{np.median([e[3] for e in unprofiled]):.3f} s an epoch; the loader alone {loader_img_s:.1f} img/s "
              f"over {len(arrivals)} batches "
              f"(RAM cache built in {cache_s:.2f} s); device busy {busy:.1%} of epoch {LEARN_PROFILED_EPOCH}'s loop "
              f"({n_kernels} kernels); per-epoch wall s " + " ".join(f"{e[4]:.2f}" for e in per_epoch), flush=True)
        if not noval:
            print("learn: per-epoch EMA mAP50 on the train split " + " ".join(
                f"{r['metrics/mAP_0.5']:.3f}" for r in rows), flush=True)

        maps, val_launches = {}, {}
        val_batches = -(-n_images // bs)
        for label, model in (("untrained", DetectionModel.from_config(cfg, nc=nc, seed=0, device=device)),
                             ("trained", load_model_from_checkpoint(run / "weights" / "last", device=device))):
            greedy_nms.launches = 0
            t0 = time.perf_counter()
            results, _, _ = validator.run(data, model=model, batch_size=bs, imgsz=imgsz, task="train", plots=True,
                                          save_dir=run / f"val_{label}", workers=LEARN_WORKERS)
            val_s = time.perf_counter() - t0
            maps[label], val_launches[label] = float(results[2]), greedy_nms.launches
            print(f"learn val {label}: mAP50 {results[2]:.4f} mAP50-95 {results[3]:.4f} P {results[0]:.4f} "
                  f"R {results[1]:.4f} in {val_s:.2f} s; K1 {greedy_nms.launches} launches for {val_batches} "
                  f"batches", flush=True)
            check(greedy_nms.launches == val_batches, f"K1 launched {greedy_nms.launches} times in {label} val")
        check(maps["trained"] > LEARN_MAP50 and maps["trained"] > maps["untrained"] + LEARN_MARGIN,
              f"trained mAP50 {maps['trained']:.4f} against untrained {maps['untrained']:.4f}: below the bars "
              f"(> {LEARN_MAP50}, > untrained + {LEARN_MARGIN})")

        written = sorted(str(f.relative_to(run)) for f in (*run.rglob("*.png"), *run.rglob("*.jpg")))
        drawn = {"labels.png", "results.png", "val_trained/PR_curve.png", "val_trained/confusion_matrix.png"}
        numpy_only = {"train_batch0.jpg", "train_batch2.jpg", "val_trained/val_batch0_pred.jpg"}  # in-tree JPEG
        check(numpy_only <= set(written), f"mosaics missing: {sorted(numpy_only - set(written))}")
        for f in numpy_only:
            check(image_ops.imread(run / f).ndim == 3, f"{f} does not decode")
        if packages["matplotlib"]:
            check(drawn <= set(written), f"matplotlib is here, but {sorted(drawn - set(written))} are missing")
        else:
            check(not drawn & set(written), f"no matplotlib, yet {sorted(drawn & set(written))} were written")
        print(f"learn plots: packages on this host {packages}; {len(written)} images written: {written}", flush=True)
        # the tracker sinks train() had on: results.csv always; TensorBoard where it is importable (its events
        # file in the run); W&B and Comet need an API key and ClearML its package, which a run here has not
        events = sorted(run.glob("events.out.tfevents.*"))
        sinks = ["csv"] + (["tb"] if events else [])
        tb_found = importlib.util.find_spec("tensorboard") is not None
        check(bool(events) == tb_found, f"tensorboard importable: {tb_found}, events files {len(events)}")
        print(f"learn loggers: sinks on {sinks} (tensorboard importable: {tb_found}; a missing sink is off, "
              f"as in the JAX package)", flush=True)

        full = learn_yolov3_tools(device)
        out = dict(cfg=cfg, nc=nc, epochs=epochs, steps_per_epoch=steps, batch=bs, imgsz=imgsz, images=n_images,
                   train_s=train_s, loop_img_s=loop_img_s, loop_img_s_from_second_batch=steady_img_s,
                   checkpoint_s=[e[3] for e in per_epoch], loader_img_s=loader_img_s, cache_s=cache_s,
                   device_busy=busy, busy_kernels=n_kernels, epoch_wall_s=[e[4] for e in per_epoch],
                   map50=maps, k3_per_step=launches["conv3x3_bn_stats"] / (steps * epochs), k3_layers=convs,
                   k1_per_val_batch={k: v / val_batches for k, v in val_launches.items()}, plot_packages=packages,
                   logger_sinks=sinks,
                   plots_written=written, losses=[[r[k] for k in ("train/box_loss", "train/obj_loss",
                                                                  "train/cls_loss")] for r in rows], **full)
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"learn: phase {out['phase_s']:.1f} s on {gpu}", flush=True)
        return {"conv3x3_bn_stats": launches["conv3x3_bn_stats"], "greedy_nms": sum(val_launches.values()),
                "greedy_nms_val_batches": 2 * val_batches}, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def learn_yolov3_tools(device=None, imgsz=640):
    """check_bf16, profile_layers and model_memory_bytes on full-width yolov3 at `imgsz`."""
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.utils import checks, profiling

    model = DetectionModel.from_config("yolov3", seed=0, device=device)
    db, dc = checks.bf16_deltas(model, imgsz)
    ok = checks.check_bf16(model, imgsz)
    rows = profiling.profile_layers(model, imgsz=imgsz, batch=1, reps=10)
    layer_gflops, counted = sum(r["gflops"] for r in rows), profiling.model_flops(model, imgsz) / 1e9
    check(abs(layer_gflops - counted) <= 1e-6 * counted, f"layer GFLOPs {layer_gflops} against {counted}")
    check(sum(r["params"] for r in rows) == model.num_params(), "profile_layers' parameters")
    mem = profiling.model_memory_bytes(model, 8, imgsz)
    top = sorted(rows, key=lambda r: -r["ms"])[:5]
    print(f"learn yolov3@{imgsz}: check_bf16 {'passed' if ok else 'FAILED'} (box delta {db:.5f} of imgsz, conf "
          f"delta {dc:.5f}); profile_layers {len(rows)} layers {sum(r['ms'] for r in rows):.3f} ms by CUDA events, "
          f"{layer_gflops:.2f} GFLOPs (FLOP counter over the model {counted:.2f}); slowest "
          + ", ".join(f"{r['i']} {r['op']} {r['ms']:.3f} ms" for r in top)
          + f"; peak memory of an eval forward at batch 8 {mem / 2**30:.3f} GiB", flush=True)
    return dict(yolov3_check_bf16=ok, yolov3_bf16_box_delta=db, yolov3_bf16_conf_delta=dc,
                yolov3_layer_ms=[r["ms"] for r in rows], yolov3_layer_gflops=[r["gflops"] for r in rows],
                yolov3_gflops=counted, yolov3_eval_peak_bytes_b8=mem)


# --- detection from JPEGs on disk --------------------------------------------

DETECT_IMGSZ = 640
DETECT_TARGETS = (16.0, 4.0, 1.0)  # cells an image above conf 0.25 at strides 8, 16, 32
DETECT_VAL_BATCH = 8


def detect_sources():
    """The package's two sample images and the JPEG corpus of tests/data/jpeg."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    return (sorted((root / "yolov3_tpu_torch/data/images").glob("*.jpg"))
            + sorted((root / "tests/data/jpeg").glob("*.jpg")))


JPEG_SYNTHETIC = ((1, 1, 3), (1, 1, 1), (2, 3, 3), (7, 5, 1), (15, 17, 3), (16, 16, 3), (17, 33, 4), (31, 47, 1),
                  (97, 131, 3), (333, 517, 3), (333, 517, 1), (720, 1280, 3))  # (h, w, channels) the encoder takes


def synthetic_jpeg_input(h, w, c):
    """A deterministic uint8 image (h, w, c), 2-D for c == 1: hashed noise on
    alternate 8x8 blocks, a gradient on the others (integer arithmetic only,
    so every host makes the same bytes)."""
    y, x, k = np.meshgrid(*(np.arange(n, dtype=np.uint64) for n in (h, w, c)), indexing="ij")
    noise = ((y * 7919 + x * 104729 + k * 1299709 + 12345) * 2654435761 % (1 << 32)) >> 24
    im = np.where((y // 8 + x // 8) % 2 == 1, noise, (y * 3 + x * 5 + k * 60) % 256).astype(np.uint8)
    return im[..., 0] if c == 1 else im


def jpeg_encode_inputs():
    """(name, image) pairs the JPEG encoder is held to cv2 on: the sample
    images and the corpus as the in-tree decoder reads them, and the
    JPEG_SYNTHETIC shapes (tests/data/jpeg/encode_digests.json pins cv2's
    encoding of each; scripts/make_jpeg_encode_digests.py writes it)."""
    from yolov3_tpu_torch.data import image_ops

    return ([(p.name, image_ops.imread(p)) for p in detect_sources()]
            + [(f"synthetic_{h}x{w}x{c}", synthetic_jpeg_input(h, w, c)) for h, w, c in JPEG_SYNTHETIC])


def phase_jpeg(gpu):
    """Decode both sample images and the corpus with the in-tree decoder; each
    decode's SHA-256 must equal tests/data/jpeg/digests.json (cv2's decode,
    pinned where cv2 is installed: this host has none). ms per megapixel over
    the files, three decodes each. Then encode them and the synthetic images:
    each JPEG's SHA-256 must equal tests/data/jpeg/encode_digests.json
    (cv2.imencode(".jpg") at its defaults); ms per megapixel, three encodes each."""
    import hashlib
    from pathlib import Path

    from yolov3_tpu_torch.data import image_ops

    digests = json.loads((Path(__file__).resolve().parent / "tests/data/jpeg/digests.json").read_text())
    files = detect_sources()
    check(len(files) == len(digests) and len(files) >= 14, f"{len(files)} JPEG files, {len(digests)} digests")
    mp, secs = 0.0, 0.0
    for p in files:
        data = p.read_bytes()
        t0 = time.perf_counter()
        for _ in range(3):
            im = image_ops.decode_jpeg(data)
        secs += (time.perf_counter() - t0) / 3
        mp += im.shape[0] * im.shape[1] / 1e6
        sha = hashlib.sha256(im.tobytes()).hexdigest()
        check(sha == digests[p.name]["sha256"] and list(im.shape) == digests[p.name]["shape"],
              f"JPEG {p.name}: the decode differs from cv2's pinned digest")
    ms_per_mp = secs * 1e3 / mp
    print(f"JPEG: {len(files)} files ({mp:.2f} MP) decode to cv2's pinned digests; {ms_per_mp:.2f} ms per megapixel "
          f"on the host of {gpu}", flush=True)

    pinned = json.loads((Path(__file__).resolve().parent / "tests/data/jpeg/encode_digests.json").read_text())
    inputs = jpeg_encode_inputs()
    check(sorted(n for n, _ in inputs) == sorted(pinned), f"{len(inputs)} images to encode, {len(pinned)} digests")
    enc_mp, enc_secs = 0.0, 0.0
    for name, im in inputs:
        t0 = time.perf_counter()
        for _ in range(3):
            data = image_ops.encode_jpeg(im)
        enc_secs += (time.perf_counter() - t0) / 3
        enc_mp += im.shape[0] * im.shape[1] / 1e6
        check(hashlib.sha256(data).hexdigest() == pinned[name]["sha256"] and len(data) == pinned[name]["bytes"],
              f"JPEG encode of {name} {im.shape}: the bytes differ from cv2.imencode's pinned digest")
    enc_ms_per_mp = enc_secs * 1e3 / enc_mp
    print(f"JPEG encode: {len(inputs)} images ({enc_mp:.2f} MP; 1x1 to 720x1280, gray, BGR and BGRA) encode to "
          f"cv2's pinned digests; {enc_ms_per_mp:.2f} ms per megapixel on the host of {gpu}", flush=True)
    return dict(files=len(files), megapixels=mp, ms_per_mp=ms_per_mp, encoded=len(inputs), encode_megapixels=enc_mp,
                encode_ms_per_mp=enc_ms_per_mp)


def detect_val_ensemble(model, probe, weights, tmp, gpu, batch_size=DETECT_VAL_BATCH):
    """cli.val.run with two weights (an Ensemble) over `probe` (N, S, S, 3 RGB
    uint8, written as PNGs) labelled with the single `model`'s own detections
    above conf 0.25 (f32, plain NMS): K1 once a batch, each batch's
    detections equal to the plain NMS on the same Ensemble predictions, mAP50
    at least 0.95 and within 0.01 of the single model's on the same frames."""
    from yolov3_tpu_torch.cli import val as val_cli
    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.ops.boxes import xyxy2xywh
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain
    from yolov3_tpu_torch.utils.general import yaml_save

    imgsz = probe.shape[1]
    label_fwd = validator.make_forward(model, nms_fn=greedy_nms_plain)
    dets, n = label_fwd(torch.as_tensor(probe, device=model.device))
    dets, n = dets.cpu().numpy(), n.cpu().numpy()
    root = tmp / "selfval"
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    targets, mask = np.zeros((len(probe), dets.shape[1], 5), np.float32), np.zeros((len(probe), dets.shape[1]), bool)
    for i, (d, k) in enumerate(zip(dets, n)):
        lb = d[:k][d[:k, 4] > 0.25]
        xywh = xyxy2xywh(np.clip(lb[:, :4], 0, imgsz)) / imgsz
        targets[i, :len(lb), 0], targets[i, :len(lb), 1:], mask[i, :len(lb)] = lb[:, 5], xywh, True
        image_ops.imwrite_png(root / "images" / "val" / f"{i:03d}.png", np.ascontiguousarray(probe[i][:, :, ::-1]), 1)
        (root / "labels" / "val" / f"{i:03d}.txt").write_text(
            "".join(f"{int(c)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n" for c, (x, y, w, h) in zip(lb[:, 5], xywh)))
    n_labels = int(mask.sum())
    check(n_labels > 0, "the detect model labels no detection above conf 0.25 on its own frames")
    yaml_save(root / "dataset.yaml", dict(path=str(root), train="images/val", val="images/val",
                                          names={i: str(i) for i in range(80)}))
    meta = ((imgsz, imgsz), ((1.0, 1.0), (0.0, 0.0)))  # what the loader gives a square frame at imgsz: boxes clipped
    single_batches = [(probe[i:i + batch_size], targets[i:i + batch_size], mask[i:i + batch_size],
                       [meta] * len(probe[i:i + batch_size])) for i in range(0, len(probe), batch_size)]
    single = validator.run(model=model, dataloader=single_batches)[0]

    real_val_nms, val_seen = validator.batched_nms, []

    def observed_val(pred, **kw):  # the Ensemble's call, kept with its inputs for the plain NMS after the run
        out = real_val_nms(pred, **kw)
        val_seen.append((pred, kw, out))
        return out

    validator.batched_nms = observed_val
    try:
        reset_kernel_counts()
        results, _, speeds = val_cli.run(str(root / "dataset.yaml"), weights=[str(w) for w in weights],
                                         batch_size=batch_size, imgsz=imgsz, workers=4, project=str(tmp / "val"),
                                         device=str(model.device))
        torch.cuda.synchronize()
        val_launches = kernel_counts()["greedy_nms"]
    finally:
        validator.batched_nms = real_val_nms
    n_batches = len(single_batches)
    check(val_launches == n_batches and len(val_seen) == n_batches,
          f"Ensemble val: {val_launches} K1 launches, {len(val_seen)} NMS calls for {n_batches} batches")
    for i, (pred, kw, (vd, vn)) in enumerate(val_seen):
        cells = 3 * sum((imgsz // st) ** 2 for st in (8, 16, 32))
        check(pred.shape[1] == 2 * cells, f"Ensemble val batch {i}: {pred.shape[1]} predictions, not both members'")
        with torch.inference_mode():
            pd, pn = real_val_nms(pred, **{**kw, "nms_fn": greedy_nms_plain})
        check(torch.equal(vn, pn) and torch.equal(vd, pd), f"Ensemble val batch {i}: K1's detections differ from "
              f"the plain NMS's on the same predictions")
    val_seen.clear()
    check(single[2] >= 0.95, f"single-model mAP50 {single[2]} < 0.95 on its own labels")
    check(abs(results[2] - single[2]) <= 0.01, f"Ensemble mAP50 {results[2]} vs single model {single[2]}")
    print(f"cli.val Ensemble of 2 (checkpoint + .pt): {len(probe)} self-labelled images ({n_labels} labels), "
          f"K1 launches {val_launches}, each batch equal to the plain NMS; mP {results[0]:.4f} mR {results[1]:.4f} "
          f"mAP50 {results[2]:.4f} (single model {single[2]:.4f}); speeds {[round(v, 2) for v in speeds]} ms per "
          f"image on {gpu}", flush=True)
    return dict(results=[float(v) for v in results[:4]], single=[float(v) for v in single[:4]], labels=n_labels,
                launches=val_launches, speeds_ms=[float(v) for v in speeds])


def detect_checked(label, n_images, gpu, require_detections=True, **run_kwargs):
    """cli.detect.run(**run_kwargs) with the launches counted and each image's
    batched_nms call kept with its inputs: K1 once an image, at least one
    image through K1's shared-memory route, every image's detections equal to
    the plain NMS on the same decoded predictions (`check_dets`), and, with
    `require_detections`, at least one detection. Returns the run's record."""
    from pathlib import Path

    import yolov3_tpu_torch.cli.detect as detect_cli
    from yolov3_tpu_torch.ops import nms as nms_ops
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain

    real_batched_nms = nms_ops.batched_nms
    seen = []

    def observed(pred, **kw):  # the CLI's call, kept with its inputs for the plain NMS after the run
        out = real_batched_nms(pred, **kw)
        seen.append((greedy_nms.last_route, pred, kw, out))
        return out

    detect_cli.batched_nms = observed
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        save_dir = detect_cli.run(**run_kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        detect_cli.batched_nms = real_batched_nms
    check(launches["greedy_nms"] == n_images, f"detect {label}: {launches['greedy_nms']} K1 launches for "
          f"{n_images} images")
    routes = sorted({r for r, _, _, _ in seen})
    check(any("shared memory" in r for r in routes), f"detect {label}: K1 routes {routes}")
    n_dets = []
    for i, (route, pred, kw, (dets, n)) in enumerate(seen):  # the plain NMS on the same predictions
        with torch.inference_mode():
            pdets, pn = real_batched_nms(pred, **{**kw, "nms_fn": greedy_nms_plain})
        check(torch.equal(n, pn), f"detect {label} image {i}: n {n.tolist()} vs plain {pn.tolist()}")
        m = int(n[0])
        check_dets(dets[0, :m].cpu().numpy(), pdets[0, :m].cpu().numpy(), f"detect {label} image {i}")
        n_dets.append(m)
    check(sum(n_dets) > 0 or not require_detections, f"detect {label}: no detections")
    record = dict(save_dir=Path(save_dir), launches=launches, routes=routes, n=n_dets,
                  speed_ms=dict(detect_cli.run.speed_ms), wall_s=wall, candidates=seen[0][1].shape[1])
    print(f"detect {label}: {n_images} images at {run_kwargs.get('imgsz', 'the default size')}, {sum(n_dets)} "
          f"detections ({min(n_dets)}-{max(n_dets)} an image), K1 launches {launches['greedy_nms']} {routes}, equal "
          f"to the plain NMS; per image: " + ", ".join(f"{k} {v:.2f} ms" for k, v in record["speed_ms"].items())
          + f"; the run {wall:.2f} s (JPEG, label and crop writes included) on {gpu}", flush=True)
    return record


def phase_detect(gpu):
    """The detect user path at yolov3@640 (seeded weights, detections planted on
    the head bias, calibrated on the detect images themselves) through K1:
    cli.detect.run from a port checkpoint over the sample images and the JPEG
    corpus (--save-txt --save-conf --save-crop), again from the same weights as
    a reference-layout yolov3.pt (the detections equal), again with --augment;
    hub.custom(checkpoint) on a list of paths; cli.val.run with both weights
    (an Ensemble) over the detect images letterboxed to 640x640, written as
    PNGs and labelled with the single model's own detections, its mAP50 held
    near the single model's on the same frames. K1 once an image a detect run
    (once a batch for AutoShape and val), at least one image through its
    shared-memory route, every image's (every val batch's) detections equal
    to the plain NMS on the same decoded predictions, annotated PNGs of the
    sources' shapes, txt rows that parse; K1's device time at the detect
    shape (B=1, K as measured, max_det 1000) beside the plain version and the
    bound; the loader alone (JPEG decode + letterbox, which run outside the
    detect CLI's Profiles) in ms an image."""
    import tempfile
    from pathlib import Path

    import yolov3_tpu_torch.cli.detect as detect_cli
    from yolov3_tpu_torch import hub
    from yolov3_tpu_torch.data import image_ops
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.data.loaders import LoadImages
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops import nms as nms_ops
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_detect_"))
    files = detect_sources()
    src = tmp / "images"
    src.mkdir()
    for p in files:
        (src / p.name).write_bytes(p.read_bytes())
    originals = {p.stem: image_ops.imread(p) for p in files}

    model = DetectionModel.from_config("yolov3", seed=0)
    base = [(conv.weight.detach().clone(), conv.bias.detach().clone()) for conv in model.model[-1].m]
    probe = np.stack([letterbox(im, DETECT_IMGSZ, auto=False)[0][:, :, ::-1] for im in originals.values()])
    gains, deltas = calibrate(model, np.ascontiguousarray(probe), targets=DETECT_TARGETS)
    plant_detections(model, base, gains, deltas)
    ckpt = save_checkpoint(tmp / "ckpt", {"model": model.state_dict()}, spec=model.spec)
    pt = tmp / "w" / "yolov3.pt"
    pt.parent.mkdir()
    torch.save({"model": {k: v.detach().float().cpu() for k, v in model.state_dict().items()}}, pt)
    del base

    # the loader alone: JPEG decode + letterbox + HWC->CHW, the host work before detect's first Profile
    for _ in LoadImages(str(src), img_size=DETECT_IMGSZ, stride=32, auto=False):
        pass  # warm: the host library loads, the files are in the page cache
    load_ms = {}
    it = iter(LoadImages(str(src), img_size=DETECT_IMGSZ, stride=32, auto=False))
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        if item is None:
            break
        load_ms[Path(item[0]).stem] = (time.perf_counter() - t0) * 1e3
    load_mean = sum(load_ms.values()) / len(load_ms)
    split = dict(decode=0.0, letterbox=0.0, bgr2rgb=0.0)  # the steps of LoadImages.__next__, one by one
    for p in sorted(src.iterdir()):
        t0 = time.perf_counter()
        im0 = image_ops.imread(p)
        t1 = time.perf_counter()
        im = letterbox(im0, DETECT_IMGSZ, stride=32, auto=False)[0]
        t2 = time.perf_counter()
        np.ascontiguousarray(im[:, :, ::-1])
        t3 = time.perf_counter()
        for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k] += dt * 1e3 / len(load_ms)
    print(f"detect loader alone (LoadImages: JPEG decode + letterbox, outside detect's Profiles): {load_mean:.3f} ms "
          f"an image over {len(load_ms)} (decode {split['decode']:.3f}, letterbox {split['letterbox']:.3f}, BGR->RGB "
          f"copy {split['bgr2rgb']:.3f}); sample1 {load_ms['sample1']:.3f} ms, sample2 {load_ms['sample2']:.3f} ms "
          f"on the host of {gpu}", flush=True)

    runs = {}
    for name, weights, extra in (("ckpt", ckpt, dict(save_txt=True, save_conf=True, save_crop=True)),
                                 ("pt", pt, dict(save_txt=True, save_conf=True, nosave=True)),
                                 ("tta", ckpt, dict(augment=True, nosave=True))):
        runs[name] = detect_checked(name, len(files), gpu, weights=str(weights), source=str(src),
                                    imgsz=(DETECT_IMGSZ, DETECT_IMGSZ), project=str(tmp / "runs"), name=name,
                                    exist_ok=True, **extra)

    # outputs: annotated JPEGs of the sources' shapes (decoded in-tree), parseable txt rows, crops; .pt equal to the
    # checkpoint
    ck, ptr = runs["ckpt"]["save_dir"], runs["pt"]["save_dir"]
    for stem, im in originals.items():
        check(image_ops.imread(ck / f"{stem}.jpg").shape == im.shape, f"annotated {stem}.jpg has another shape")
    check(not list(ck.rglob("*.png")), "detect wrote PNGs; the JAX package writes JPEG")
    n_rows, pairs = 0, set()
    for txt in sorted((ck / "labels").glob("*.txt")):
        rows = np.loadtxt(txt, ndmin=2)
        check(rows.shape[1] == 6 and ((rows[:, 1:5] >= 0) & (rows[:, 1:5] <= 1)).all()
              and ((rows[:, 0] >= 0) & (rows[:, 0] < 80)).all(), f"{txt.name}: rows do not parse")
        other = np.loadtxt(ptr / "labels" / txt.name, ndmin=2)
        check(np.array_equal(rows, other), f"{txt.name}: the .pt run's rows differ from the checkpoint run's")
        n_rows += len(rows)
        pairs |= {(txt.stem, int(c)) for c in rows[:, 0]}
    crops = len(list((ck / "crops").rglob("*.jpg")))  # one file an image and class, as the JAX package writes them
    check(n_rows == sum(runs["ckpt"]["n"]) and crops == len(pairs), f"{n_rows} txt rows, {crops} crops, "
          f"{sum(runs['ckpt']['n'])} detections, {len(pairs)} (image, class) pairs")

    # the same weights exported to a pt2 (f32, dynamic batch) through cli.detect: K1 once an image, the rows of
    # detect through the checkpoint in f32 (half=False: the artifact's dtype). detect folds the checkpoint's
    # BatchNorms, so the pt2 is exported from the folded weights (a fused checkpoint): the unfolded graph's
    # rounding differs, and near-equal scores then swap rows
    from yolov3_tpu_torch import export
    from yolov3_tpu_torch.models.loading import load_weights

    fused = export.export_checkpoint(load_weights(str(ckpt)).fuse(), tmp / "fused")
    check(fused is not None, "detect: the fused checkpoint export failed")
    pt2 = export.run(str(fused), include=("pt2",), imgsz=DETECT_IMGSZ, dynamic=True, out_dir=tmp / "export")["pt2"]
    check(pt2 is not None, "detect: the pt2 export failed")
    f32_rows, pt2_launches = {}, {}
    for name, weights in (("ckpt_f32", ckpt), ("pt2", pt2)):
        reset_kernel_counts()
        save_dir = detect_cli.run(weights=str(weights), source=str(src), imgsz=(DETECT_IMGSZ, DETECT_IMGSZ),
                                  half=False, save_txt=True, save_conf=True, nosave=True, project=str(tmp / "runs"),
                                  name=name, exist_ok=True)
        torch.cuda.synchronize()
        pt2_launches[name] = kernel_counts()["greedy_nms"]
        check(pt2_launches[name] == len(files), f"detect {name}: {pt2_launches[name]} K1 launches for {len(files)} "
              "images")
        f32_rows[name] = {t.stem: np.loadtxt(t, ndmin=2) for t in sorted((Path(save_dir) / "labels").glob("*.txt"))}
    check(f32_rows["pt2"].keys() == f32_rows["ckpt_f32"].keys() and f32_rows["pt2"], "detect pt2: other images")
    n_pt2 = 0
    for stem, want in f32_rows["ckpt_f32"].items():
        got = f32_rows["pt2"][stem]
        same = got.shape == want.shape
        check(same and np.array_equal(got[:, 0], want[:, 0])
              and np.abs(got[:, 1:5] - want[:, 1:5]).max(initial=0) <= 1e-4
              and np.abs(got[:, 5] - want[:, 5]).max(initial=0) <= 1e-3, f"detect pt2 {stem}: rows differ from the "
              f"checkpoint's in f32 ({len(got)} / {len(want)} rows; classes equal "
              f"{same and np.array_equal(got[:, 0], want[:, 0])}, xywh err "
              f"{np.abs(got[:, 1:5] - want[:, 1:5]).max(initial=0) if same else None})")
        n_pt2 += len(got)
    print(f"detect through a pt2 of the same weights: {len(files)} images, {n_pt2} rows equal to detect through the "
          f"checkpoint in f32 (classes equal, xywh within 1e-4 of the image, conf 1e-3), K1 launches "
          f"{pt2_launches['pt2']} on {gpu}", flush=True)

    # K1 at the detect shape: the first image's candidates (B=1, K as the CLI gives it, max_det 1000)
    captured = []

    def capture(*args):
        captured.append(args)
        return greedy_nms(*args)

    auto = hub.custom(str(ckpt))
    x = torch.as_tensor(probe[:1]).cuda().float() / 255.0
    with torch.inference_mode():
        pred = auto.model.predict(x)
        nms_ops.batched_nms(pred, conf_thres=0.25, iou_thres=0.45, max_det=1000, max_nms=8192, nms_fn=capture)
    args = captured[0]
    B, K = args[2].shape
    out_k, n_k = greedy_nms(*args)
    out_p, n_p = greedy_nms_plain(*args)
    check(torch.equal(n_k, n_p) and torch.equal(out_k, out_p), "K1 at the detect shape differs from the plain version")
    route = greedy_nms.last_route
    k1_ms = device_ms(lambda: greedy_nms(*args), NMS_KERNEL)
    k1_plain_ms = cuda_ms(lambda: greedy_nms_plain(*args), iters=3, warmup=1)
    nbytes = B * K * 40 + B * 1000 * 24 + B * 4
    ops = int(n_k.sum()) * K * NMS_OPS_PER_IOU
    k1_bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    k1_bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"K1 greedy_nms detect: B={B} K={K} max_det=1000 [{route}] n={int(n_k[0])} equal to plain; kernel "
          f"{k1_ms:.4f} ms device, plain {k1_plain_ms:.3f} ms, bound {k1_bound_ms:.5f} ms ({k1_bound_by}) on {gpu}",
          flush=True)

    # AutoShape on a list of paths: one batch, one K1 launch
    reset_kernel_counts()
    det = auto([str(p) for p in files], size=DETECT_IMGSZ)
    torch.cuda.synchronize()
    auto_launches = kernel_counts()["greedy_nms"]
    check(auto_launches == 1 and det.n == len(files) and sum(len(p) for p in det.pred) > 0,
          f"AutoShape: {auto_launches} K1 launches, {det.n} images")
    print(f"AutoShape (hub.custom): {det.n} images in one batch, {sum(len(p) for p in det.pred)} detections, "
          f"K1 launches {auto_launches}; {det.t[0]:.2f} ms pre, {det.t[1]:.2f} ms inference, {det.t[2]:.2f} ms post "
          f"per image on {gpu}", flush=True)
    del auto

    val = detect_val_ensemble(model, probe, [ckpt, pt], tmp, gpu)
    return dict(images=len(files), runs={k: {kk: vv for kk, vv in v.items() if kk != "save_dir"}
                                         for k, v in runs.items()},
                k1=dict(B=B, K=K, max_det=1000, route=route, n=int(n_k[0]), ms=k1_ms, plain_ms=k1_plain_ms,
                        bound_ms=k1_bound_ms, bound_by=k1_bound_by),
                autoshape_launches=auto_launches, val=val, load_ms=dict(mean=load_mean, **load_ms), load_split_ms=split,
                pt2_launches=pt2_launches["pt2"], pt2_rows=n_pt2)


ZOO_SERVE = {"yolov5s": (32, 3)}  # (batch, batches served); the other two serve one batch of 8
ZOO_TRAIN_STEPS = 5  # yolov5s trains 1 + 5 steps; the other two take one step


def phase_zoo(rng):
    """The YOLOv5s family at its published widths (YOLOV5_MODELS: ultralytics/yolov5
    v6.0+ models/yolov5s.yaml, hub/yolov5s-transformer.yaml, hub/yolov5s-ghost.yaml),
    nc 80, seeded random weights, 640 px.

    yolov5s (7,235,389 parameters), its BatchNorm statistics taken from the
    frames (`settle_bn`) and detections planted on the head for the served
    frames (`plant_under_topk`): three batches of 32 served through build_batched_infer (BN
    folded, bf16), three K2 launches and one K1 launch a batch, the detections
    equal to the plain score and NMS functions, ms a batch; then a fresh
    yolov5s through phase_train as yolov3 (SGD, bf16 autocast, one seeded
    batch of 8) for 1 + 5 steps: 11 K3 launches a step (its C3 bottlenecks'
    stride-1 3x3 convs), and K3 held against its plain version from the
    run's states (`steps_against_plain`).

    yolov5s-transformer (a C3TR) and yolov5s-ghost (GhostConv, C3Ghost): one
    fused batch of 8 each (K2 3, K1 1, equal to the plain path) and one
    phase_train step each (steps=0), K3 launched 10 and 0 times. yolov5s-ghost exists only in the
    port: the JAX package's parser counts no GhostConv stride, so its Detect
    strides come to 0 and the JAX model cannot be built."""
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
    from yolov3_tpu_torch.ops.score_cuda import masked_scores
    from yolov3_tpu_torch.serve import build_batched_infer

    results, launches = {}, {}
    for name, cfg in YOLOV5_MODELS.items():
        model = DetectionModel.from_config(cfg, seed=0)  # on the card
        n_params = model.num_params()
        check(YOLOV5_PARAMS.get(name, n_params) == n_params, f"{name} has {n_params} parameters")
        check(model.spec.strides == (8, 16, 32), f"{name}: Detect strides {model.spec.strides}")
        bs, n_batches = ZOO_SERVE.get(name, (8, 1))
        frames = rng.integers(0, 256, size=(bs, 640, 640, 3), dtype=np.uint8)
        settle_bn(model, frames[:8])
        targets, counts, _, _ = plant_under_topk(model, frames)
        print(f"{name}: detections planted at targets {[round(t, 2) for t in targets]} cells an image by scale; "
              "above conf 0.25 (f32 eval) by scale, median / max over the frames: "
              + ", ".join(f"{int(np.median(c))} / {int(c.max())}" for c in counts), flush=True)
        infer = build_batched_infer(model)
        imgs = torch.as_tensor(frames, device="cuda")
        infer(imgs)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()

        # --- the served path: every launch from here to the count read is the path's own
        greedy_nms.launches = 0
        masked_scores.launches = 0
        for _ in range(n_batches):
            infer(imgs)
        torch.cuda.synchronize()
        served = {"greedy_nms": greedy_nms.launches, "masked_scores": masked_scores.launches}
        # --- end of the served path

        check(infer.fallbacks == 0, f"{name}: a served batch took the full-decode fallback")
        check(served == {"greedy_nms": n_batches, "masked_scores": 3 * n_batches},
              f"{name}: launches {served} in {n_batches} served batches")
        row = dict(params=n_params, batch=bs, serve_launches=served,
                   fast_path=check_fast_path(infer, model, imgs, f"{name} fast path"))
        msg = f"{name} serving: {n_params} parameters, {n_batches} batches of {bs} at 640 px, launches {served}"
        if name in ZOO_SERVE:
            row["batch_ms"] = cuda_ms(lambda: infer(imgs)[0], iters=10)
            row["img_s"] = bs / row["batch_ms"] * 1e3
            msg += (f"; {row['batch_ms']:.3f} ms per batch of {bs} = {row['img_s']:.1f} img/s "
                    "(device-synchronised, inputs on the card)")
        print(msg, flush=True)
        del infer, model, imgs

        steps = ZOO_TRAIN_STEPS if name in ZOO_SERVE else 0
        k3, row["train"] = phase_train(rng, DetectionModel.from_config(cfg, seed=0), steps=steps,
                                       convs_per_step=YOLOV5_K3_CONVS[name], label=name)
        launches[name] = dict(served, conv3x3_bn_stats=k3)
        results[name] = row
    return launches, results


# yolov3-spp and yolov3-tiny as the package's configs publish them (nc 80): parameters, and K3 launches a
# train step (their stride-1 3x3 Convs, Bottlenecks' included: 33, and 9 on tiny's 640 / 320 / 160 / 80 px
# maps, 2 at 40 and 3 at 20)
FAMILY = {"yolov3-spp": (62998749, 33), "yolov3-tiny": (8852366, 9)}
FAMILY_REQUESTS = 32  # concurrent 640x640 requests through MicroBatcher(max_batch=32)
FAMILY_TRAIN_STEPS = 3  # 1 + 3 train steps at batch 8
FAMILY_ROUNDS = 3  # timing windows of each model's batch of 32, taken in turns
FAMILY_HUB = "yolov3_spp"  # the hub entry point the defaults' check loads


def phase_family(gpu):
    """yolov3-spp and yolov3-tiny at their published widths (nc 80, seeded
    random weights, 640 px), then the package's defaults as a user types them.

    Each model: its parameter count and its K3 launches a step (FAMILY); the
    serving path as yolov3's (`phase_main_path`: detections planted at
    SERVE_TARGETS by head stride, under half each level's top-k on every
    frame, FAMILY_REQUESTS concurrent requests through
    MicroBatcher(max_batch=32), a dense batch through the fallback; K2 once a
    head level and K1 once a device call, K1 once more on the fallback; the
    fast path against the plain score and NMS versions, and K2 against
    masked_scores_plain on each level's rows); K2's device time on each
    level's rows of the served batch beside its byte bound; the val path
    (`phase_val` on 32 self-labelled 640x640 frames: f32 mAP50 >= 0.95, K1 once
    a batch); the train path (`phase_train`: 1 + 3 steps at batch 8, K3 against
    its plain version from the run's states); and ms per batch of 32 of both
    models, FAMILY_ROUNDS rounds timed in turns, medians.

    Then cli.detect.run() with its defaults (yolov3-tiny, the sample images;
    written to a temporary project): K1 once an image, each image's rows equal
    to the plain NMS (`detect_checked`; a seeded random tiny may detect
    nothing at conf 0.25, so that is reported, not required); and
    hub.load(FAMILY_HUB) on those paths: one K1 launch."""
    import tempfile
    from pathlib import Path

    from yolov3_tpu_torch import hub
    from yolov3_tpu_torch.cli.detect import DEFAULT_SOURCE
    from yolov3_tpu_torch.data.datasets import IMG_FORMATS
    from yolov3_tpu_torch.models.detect_head import decode_topk_nhwc
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops.score_cuda import masked_scores
    from yolov3_tpu_torch.serve import build_batched_infer

    rng = np.random.default_rng(21)  # a generator of its own: the earlier phases' frames stay theirs
    out, launches, timed = {}, {}, {}
    for name, (params, convs) in FAMILY.items():
        model = DetectionModel.from_config(name, seed=0)  # full width, nc 80, on the card
        n_params, n_convs = model.num_params(), stats_route_convs(model)
        print(f"{name}: {n_params} parameters, {n_convs} stride-1 3x3 convs with a BatchNorm, head strides "
              f"{list(model.spec.strides)}", flush=True)
        check(n_params == params, f"{name} has {n_params} parameters, expected {params}")
        check(n_convs == convs, f"{name}: {n_convs} Convs take the conv+statistics route, expected {convs}")
        serve_launches, serve, batch = phase_main_path(rng, model, n_requests=FAMILY_REQUESTS,
                                                       label=f"{name} serving", fit_frames=True)
        infer = build_batched_infer(model)
        imgs = torch.as_tensor(batch, device=model.device)
        rows = []
        with torch.inference_mode():  # K2 on each level's rows of the served batch, as the decode hands them over
            feats = infer.serving_model(imgs.to(torch.bfloat16) / 255.0, raw=True)
            decode_topk_nhwc(feats, model.anchors_px, model.spec.strides,
                             score_fn=functools.partial(_recorded, masked_scores, rows))
        levels = []
        for (f, na, no, conf), stride in zip(rows, model.spec.strides):
            nbytes = f.numel() * f.element_size() + f.shape[0] * f.shape[1] * na * 8
            levels.append(dict(stride=stride, rows=list(f.shape), ms=device_ms(lambda: masked_scores(f, na, no, conf),
                                                                               SCORE_KERNEL),
                               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"))
        print(f"{name} K2 masked_scores per level, batch {imgs.shape[0]}: " + "; ".join(
            f"stride {r['stride']} {tuple(r['rows'])} {r['ms']:.4f} ms device, bound {r['bound_ms']:.4f} ms"
            for r in levels) + f" on {gpu}", flush=True)
        timed[name] = (infer, imgs)
        val, _ = phase_val(rng, model, batches=VAL_BATCHES[:1], label=f"{name} val")
        del model, feats, rows
        k3, train = phase_train(rng, DetectionModel.from_config(name, seed=0), steps=FAMILY_TRAIN_STEPS,
                                convs_per_step=convs, label=f"{name} train")
        launches[name] = dict(serve=serve_launches, device_calls=serve["device_calls"],
                              val=val["launches"]["greedy_nms"], k3=k3, k3_per_step=k3 // (FAMILY_TRAIN_STEPS + 1))
        out[name] = dict(params=n_params, serve=serve, k2_levels=levels, val=val, train=train)

    ms = {name: [] for name in timed}  # in turns: on a shared host one window alone has moved by 10%
    for _ in range(FAMILY_ROUNDS):
        for name, (infer, imgs) in timed.items():
            ms[name].append(cuda_ms(lambda: infer(imgs)[0], iters=10))
    for name, rounds in ms.items():
        out[name].update(batch_ms=float(np.median(rounds)), batch_ms_rounds=rounds)
        print(f"{name} serving: {out[name]['batch_ms']:.3f} ms per batch of 32 = "
              f"{32 / out[name]['batch_ms'] * 1e3:.1f} img/s (median of {FAMILY_ROUNDS} rounds in turns: "
              f"{' '.join(f'{v:.3f}' for v in rounds)}; device-synchronised, inputs on the card) on {gpu}", flush=True)
    del timed

    files = sorted(p for p in Path(DEFAULT_SOURCE).iterdir() if p.suffix.lower()[1:] in IMG_FORMATS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as tmp:
        default = detect_checked("defaults (yolov3-tiny)", len(files), gpu, require_detections=False,
                                 project=tmp, exist_ok=True)
    reset_kernel_counts()
    det = hub.load(FAMILY_HUB)([str(p) for p in files])
    torch.cuda.synchronize()
    hub_launches = kernel_counts()["greedy_nms"]
    check(hub_launches == 1 and det.n == len(files), f"hub.load({FAMILY_HUB!r}): {hub_launches} K1 launches, "
                                                     f"{det.n} images")
    print(f"hub.load({FAMILY_HUB!r}) on the {len(files)} default images: one batch, "
          f"{sum(len(p) for p in det.pred)} detections, K1 launches {hub_launches} on {gpu}", flush=True)
    out["defaults"] = dict(detect={k: v for k, v in default.items() if k != "save_dir"}, hub_launches=hub_launches,
                           hub_detections=sum(len(p) for p in det.pred))
    launches["defaults"] = dict(detect=default["launches"]["greedy_nms"], hub=hub_launches)
    return launches, out


PARALLEL_BS = 8  # the seeded train batch: 4 images a rank at world 2
PARALLEL_BOXES = (8, 8, 8, 8, 3, 3, 3, 3)  # labels an image: the halves hold different numbers of targets
PARALLEL_STEPS = 3  # 1 + 2 float32 steps
PARALLEL_TRAINER_IMAGES = (8, 4)  # the trainer phase's synthetic dataset, cut: train and val images
PARALLEL_TRAINER_BS = 4  # a process's batch: 8 images a step over 2 processes
PARALLEL_TIMEOUT_S = 300
# two ranks on the one card: NCCL takes a card a rank, so they name gloo, which stages each
# collective of CUDA tensors through the host
SHARED_CARD_BACKEND = "gloo"


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_train_batch(imgsz=640, max_labels=16, nc=80):
    """The seeded batch of PARALLEL_BS images with PARALLEL_BOXES labels each (a generator of its own)."""
    rng = np.random.default_rng(20)
    imgs = rng.integers(0, 256, size=(PARALLEL_BS, imgsz, imgsz, 3), dtype=np.uint8)
    targets = np.zeros((PARALLEL_BS, max_labels, 5), np.float32)
    mask = np.zeros((PARALLEL_BS, max_labels), bool)
    for i, n in enumerate(PARALLEL_BOXES):
        targets[i, :n, 0] = rng.integers(0, nc, size=n)
        targets[i, :n, 1:3] = rng.uniform(0.1, 0.9, size=(n, 2))
        targets[i, :n, 3:5] = rng.uniform(0.04, 0.5, size=(n, 2))
        mask[i, :n] = True
    return imgs, targets, mask


def parallel_steps(model, batch, steps, mesh=None):
    """`steps` float32 train steps of `model` (SGD at its defaults, no warm-up,
    no accumulation) on `batch` (this rank's rows of it under a process
    group); per step the loss, grad norm, K3 launches and host ms."""
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.parallel import mesh as par
    from yolov3_tpu_torch.train.loss import LossConfig
    from yolov3_tpu_torch.train.optim import build_optimizer
    from yolov3_tpu_torch.train.step import make_train_step

    hyp = {"warmup_epochs": 0.0}
    optimizer, _, _ = build_optimizer("sgd", model, hyp, epochs=300, steps_per_epoch=1000, batch_size=64,
                                      min_warmup_steps=0)
    step = make_train_step(model, LossConfig.from_model(model.spec, hyp), optimizer, compute_dtype=torch.float32,
                           mesh=mesh)
    local = par.shard_batch(batch) if mesh is not None else batch
    local = tuple(torch.as_tensor(a, device=model.device) for a in local)
    rows = []
    for _ in range(steps):
        torch.cuda.synchronize()
        conv3x3_bn_stats.launches = 0
        t0 = time.perf_counter()
        m = step(*local)
        torch.cuda.synchronize()
        rows.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), k3=conv3x3_bn_stats.launches,
                         ms=(time.perf_counter() - t0) * 1e3))
    return rows, step.state


def parallel_worker(cfg_path):
    """One rank of phase_parallel, started as `chip_smoke.py --parallel-worker <config.json>`:
    mode "steps" runs parallel_steps on its rows of the seeded batch; mode
    "cli" runs cli/train.main with the config's arguments. Writes what it
    saw to the config's `out` file."""
    from pathlib import Path

    from yolov3_tpu_torch.ops import cuda_build
    from yolov3_tpu_torch.parallel import mesh as par

    cfg = json.loads(Path(cfg_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()  # the parent's builds, found in the cache
    out = {}
    if cfg["mode"] == "steps":  # this rank's rows of the seeded batch
        from yolov3_tpu_torch.models.detection import DetectionModel

        par.initialize_distributed(f"127.0.0.1:{cfg['port']}", cfg["world"], cfg["rank"], backend=SHARED_CARD_BACKEND)
        try:
            out["backend"] = par.backend()
            model = DetectionModel.from_config("yolov3", seed=0, device=par.rank_device())
            out["steps"], state = parallel_steps(model, parallel_train_batch(), PARALLEL_STEPS,
                                                 mesh=torch.distributed.group.WORLD)
            out["model"] = {k: v.cpu() for k, v in model.state_dict().items()}
            out["ema"] = {k: v.cpu() for k, v in state.ema.ema.items()}
        finally:
            par.destroy_distributed()
    else:  # the trainer CLI, which joins and leaves the group itself: its arguments and the group's
        from yolov3_tpu_torch.cli import train as cli_train
        from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
        from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
        from yolov3_tpu_torch.train import loop

        steps, writes = [], {"save_checkpoint": 0, "strip_checkpoint": 0}

        def keeping(fn):
            def make(*args, **kw):
                steps.append(fn(*args, **kw))
                return steps[-1]
            return make

        def counting(name, fn):
            def call(*args, **kw):
                writes[name] += 1
                return fn(*args, **kw)
            return call

        loop.make_train_step = keeping(loop.make_train_step)
        # the CLI joins the group itself; its ranks share the card, so the backend is named here
        par.initialize_distributed = functools.partial(par.initialize_distributed, backend=SHARED_CARD_BACKEND)
        for name in writes:
            setattr(loop, name, counting(name, getattr(loop, name)))
        conv3x3_bn_stats.launches = greedy_nms.launches = 0
        argv = cfg["argv"] + ["--coordinator", f"127.0.0.1:{cfg['port']}", "--num-processes", str(cfg["world"]),
                              "--process-id", str(cfg["rank"])]
        _, results, save_dir = cli_train.main(cli_train.parse_opt(argv=argv))
        state = steps[-1].state
        out.update(writes=writes, k3=conv3x3_bn_stats.launches, k1=greedy_nms.launches, step=state.step,
                   results=[float(v) for v in results], save_dir=str(save_dir),
                   model={k: v.cpu() for k, v in state.model.state_dict().items()})
    torch.save(out, cfg["out"])
    return 0


def run_ranks(tmp, name, mode, world, argv=(), timeout=PARALLEL_TIMEOUT_S):
    """Start `world` ranks of parallel_worker in `mode` and wait for them
    (every one killed on a failure or the timeout); returns what each wrote."""
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            cfg = tmp / f"{name}{rank}.json"
            cfg.write_text(json.dumps({"mode": mode, "rank": rank, "world": world, "port": port, "argv": list(argv),
                                       "out": str(tmp / f"{name}{rank}.pt")}))
            log = open(tmp / f"{name}{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, __file__, "--parallel-worker", str(cfg)],
                                           stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.perf_counter() + timeout
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"parallel {name} rank {rank} exited {p.returncode}:\n"
              + (tmp / f"{name}{rank}.log").read_text()[-3000:])
    return [torch.load(tmp / f"{name}{r}.pt", weights_only=False) for r in range(world)]


PARALLEL_STATE_LIMITS = dict(rtol=1e-4, atol=1e-6)  # atol: elements near 0 (float32's step at 1 is 1.2e-7)


def state_errors(got, want):
    """Over the floating tensors of two state dicts: the max absolute
    difference, the max relative one where |want| > 1e-2, and whether every
    element is within PARALLEL_STATE_LIMITS (|got - want| <= atol + rtol |want|)."""
    abs_err, rel_err, within = 0.0, 0.0, True
    for k, w in want.items():
        if w.is_floating_point():
            d, w = (got[k].double() - w.double()).abs(), w.double().abs()
            abs_err = max(abs_err, float(d.max()))
            big = w > 1e-2
            if big.any():
                rel_err = max(rel_err, float((d[big] / w[big]).max()))
            within &= bool((d <= PARALLEL_STATE_LIMITS["atol"] + PARALLEL_STATE_LIMITS["rtol"] * w).all())
    return dict(max_abs=abs_err, max_rel=rel_err, within=within)


def phase_parallel(model, serving_batch, val_batches, map50, gpu):
    """Data parallelism on the one card (parallel/mesh.py): the world-1 NCCL
    step, two ranks against one process, sharded serving and validation on
    the planted `model`, and the trainer CLI over two processes. Returns
    (launches of each kernel, measurements)."""
    import shutil
    import tempfile
    from pathlib import Path

    from yolov3_tpu_torch.data import synthetic
    from yolov3_tpu_torch.eval import validator
    from yolov3_tpu_torch.models.detection import DetectionModel
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.parallel import mesh as par
    from yolov3_tpu_torch.serve import MicroBatcher, build_batched_infer
    from yolov3_tpu_torch.utils.checkpoint import load_checkpoint

    out, launches = {}, {}
    t_phase = time.perf_counter()
    batch = parallel_train_batch()

    # 1. a group of one over NCCL, in this process: the grouped step equals the ungrouped one in its bits
    fresh = DetectionModel.from_config("yolov3", seed=0)
    init = copy.deepcopy(fresh.state_dict())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward algorithms that add in a fixed order
    try:
        ref_rows, ref_state = parallel_steps(fresh, batch, 1)
        ref_sd = copy.deepcopy(fresh.state_dict())
        fresh.load_state_dict(init)
        par.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
        try:
            backend = par.backend()
            rows, _ = parallel_steps(fresh, batch, 1, mesh=torch.distributed.group.WORLD)
        finally:
            par.destroy_distributed()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    got_sd = fresh.state_dict()
    stats_equal = all(torch.equal(got_sd[k], ref_sd[k]) for k in ref_sd if "running_" in k)
    all_equal = all(torch.equal(got_sd[k], ref_sd[k]) for k in ref_sd)
    print(f"parallel world 1 ({backend}, in process): a float32 step of the batch of {PARALLEL_BS}: loss "
          f"{rows[0]['loss']!r} vs ungrouped {ref_rows[0]['loss']!r}, grad norm {rows[0]['grad_norm']!r} vs "
          f"{ref_rows[0]['grad_norm']!r}; BatchNorm statistics equal in their bits: {stats_equal}; every "
          f"parameter and buffer: {all_equal}; K3 launches {rows[0]['k3']}", flush=True)
    check(backend == "nccl", f"the world-1 group took {backend}, not NCCL")
    check(rows[0]["loss"] == ref_rows[0]["loss"] and rows[0]["grad_norm"] == ref_rows[0]["grad_norm"]
          and stats_equal, "the world-1 grouped step differs from the ungrouped step")
    check(rows[0]["k3"] == YOLOV3_K3_CONVS, f"the world-1 step launched K3 {rows[0]['k3']} times")
    launches["conv3x3_bn_stats_world1"] = rows[0]["k3"]
    out["world1"] = dict(backend=backend, loss=rows[0]["loss"], grad_norm=rows[0]["grad_norm"],
                         bn_stats_equal=stats_equal, state_equal=all_equal)
    print(f"parallel world 1: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 2. two ranks on the one card against one process on the whole batch
    fresh.load_state_dict(init)
    ref_rows, ref_state = parallel_steps(fresh, batch, PARALLEL_STEPS)
    ref_model = {k: v.cpu() for k, v in fresh.state_dict().items()}
    ref_ema = {k: v.cpu() for k, v in ref_state.ema.ema.items()}
    del fresh, ref_state, init, ref_sd, got_sd
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, "steps", "steps", 2)
        ranks_s = time.perf_counter() - t0
        r0, r1 = ranks
        for k, (a, b) in enumerate(zip(r0["steps"], ref_rows)):
            loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
            print(f"parallel 2 ranks ({r0['backend']}, one card) step {k}: loss {a['loss']:.6f} vs one process "
                  f"{b['loss']:.6f} ({loss_rel:.2e}), grad norm {a['grad_norm']:.5f} vs {b['grad_norm']:.5f} "
                  f"({norm_rel:.2e}); K3 launches a rank {a['k3']} / {r1['steps'][k]['k3']}", flush=True)
            check(loss_rel <= F32_STEP_LIMITS["loss_rtol"] and norm_rel <= F32_STEP_LIMITS["norm_rtol"],
                  f"2 ranks step {k}: loss {loss_rel:.2e} or grad norm {norm_rel:.2e} off one process's")
            check(a["k3"] == r1["steps"][k]["k3"] == YOLOV3_K3_CONVS, f"2 ranks step {k}: K3 launches {a['k3']}")
            check(a == {**r1["steps"][k], "ms": a["ms"]}, f"2 ranks step {k}: the ranks' metrics differ")
        ranks_equal = all(torch.equal(r0[part][k], r1[part][k]) for part in ("model", "ema") for k in r0[part])
        stats = {k: v for k, v in ref_model.items() if "running_" in k}
        errs = {"running statistics": state_errors(r0["model"], stats),
                "parameters": state_errors(r0["model"], {k: v for k, v in ref_model.items() if k not in stats}),
                "EMA": state_errors(r0["ema"], ref_ema)}
        ms_one = float(np.mean([r["ms"] for r in ref_rows[1:]]))
        ms_two = float(np.mean([r["ms"] for r in r0["steps"][1:]]))
        print(f"parallel 2 ranks: the ranks' parameters and EMA equal in their bits: {ranks_equal}; against one "
              f"process (max abs diff, max rel diff where |v| > 1e-2, within rtol 1e-4 atol 1e-6): "
              + ", ".join(f"{k} {v['max_abs']:.2e} {v['max_rel']:.2e} {v['within']}" for k, v in errs.items())
              + f"; ms per step (host clock, synchronised): one process at batch {PARALLEL_BS} {ms_one:.1f}, "
              f"two ranks at {PARALLEL_BS // 2} each on one card {ms_two:.1f} ({ranks_s:.1f} s with start-up) "
              f"on {gpu}", flush=True)
        check(ranks_equal, "the two ranks' parameters or EMA differ")
        check(all(v["within"] for v in errs.values()), f"2 ranks against one process: {errs}")
        launches["conv3x3_bn_stats_per_rank_step"] = r0["steps"][-1]["k3"]
        out["two_ranks"] = dict(backend=r0["backend"], steps=r0["steps"], one_process=ref_rows, errors=errs,
                                ms_one_process=ms_one, ms_two_ranks=ms_two)
        del ranks, r0, r1, ref_model, ref_ema

        # 3. sharded serving over two shards of the card
        mesh = par.create_mesh(["cuda:0", "cuda:0"])
        imgs = torch.as_tensor(serving_batch, device=model.device)
        sharded = build_batched_infer(model, mesh=mesh)
        plain = build_batched_infer(model)
        sharded(imgs)  # warm-up at the shards' batch size
        torch.cuda.synchronize()
        reset_kernel_counts()
        dets_s, n_s = sharded(imgs)
        torch.cuda.synchronize()
        serve_launches = kernel_counts()
        check(sharded.fallbacks == 0, "the sharded batch took the full-decode fallback")
        check(serve_launches == {"greedy_nms": 2, "masked_scores": 6, "conv3x3_bn_stats": 0},
              f"sharded serving launches {serve_launches}, expected K2 6 and K1 2")
        half = len(serving_batch) // 2
        for a in (0, half):
            d, n = plain(imgs[a:a + half])
            check(torch.equal(dets_s[a:a + half], d) and np.array_equal(np.asarray(n_s[a:a + half]),
                                                                         np.asarray(n)),
                  f"shard rows {a}-{a + half} differ from the unsharded call on those rows")
        # against the unsharded batch of 32: the bf16 forward's rows depend on the batch size (cuDNN picks
        # its algorithm by shape), so they are counted, not held; the float32 full path is held at the NMS bars
        d_all, n_all = plain(imgs)
        n_s, n_all, d_s, d_all = np.asarray(n_s), np.asarray(n_all), dets_s.cpu().numpy(), d_all.cpu().numpy()
        differ = [i for i in range(len(n_s))
                  if not (n_s[i] == n_all[i] and np.array_equal(d_s[i, :n_s[i]], d_all[i, :n_all[i]]))]
        n_differ = [i for i in range(len(n_s)) if n_s[i] != n_all[i]]
        full_s, full = build_batched_infer(model, fast=False, mesh=mesh), build_batched_infer(model, fast=False)
        reset_kernel_counts()
        fd_s, fn_s = full_s(imgs)
        torch.cuda.synchronize()
        full_launches = kernel_counts()
        fd, fn = full(imgs)
        for a in (0, half):
            d, n = full(imgs[a:a + half])
            check(torch.equal(fd_s[a:a + half], d) and torch.equal(fn_s[a:a + half], n),
                  f"float32 shard rows {a}-{a + half} differ from the unsharded call on those rows")
        fd_s, fn_s, fd, fn = fd_s.cpu().numpy(), fn_s.cpu().numpy(), fd.cpu().numpy(), fn.cpu().numpy()
        box_err = conf_err = 0.0
        for i in range(len(fn)):
            b, c = check_dets(fd_s[i, :fn_s[i]], fd[i, :fn[i]], f"sharded float32 serving frame {i}")
            box_err, conf_err = max(box_err, b), max(conf_err, c)
        check(full_launches == {"greedy_nms": 2, "masked_scores": 0, "conv3x3_bn_stats": 0},
              f"sharded float32 serving launches {full_launches}, expected K1 2")
        batcher = MicroBatcher(sharded, max_batch=len(serving_batch), batch_wait_ms=50.0, min_bucket=mesh.size)
        check(batcher.buckets == [2, 4, 8, 16, 32], f"MicroBatcher(min_bucket=2) buckets {batcher.buckets}")
        with ThreadPoolExecutor(max_workers=3) as pool:  # one call, padded to the bucket of 4 with the last frame
            answers = [f.result() for f in [pool.submit(batcher.submit, serving_batch[i]) for i in range(3)]]
        want_d, want_n = sharded(serving_batch[[0, 1, 2, 2]])
        check(batcher.calls == 1 and all(n == int(want_n[i]) and np.array_equal(d, want_d[i, :n].cpu().numpy())
                                         for i, (d, n) in enumerate(answers)),
              f"sharded MicroBatcher: {batcher.calls} calls, answers differ from the padded bucket's")
        ms_sharded = cuda_ms(lambda: sharded(imgs)[0], iters=10)
        ms_plain = cuda_ms(lambda: plain(imgs)[0], iters=10)
        print(f"parallel sharded serving (2 shards of {gpu.split(',')[0]}): bf16 fast path, batch of "
              f"{len(serving_batch)}: launches {serve_launches}, each shard's rows equal to the unsharded call on "
              f"them; against the unsharded batch of 32, {len(differ)} frames not equal in their bits, "
              f"{len(n_differ)} with another n (the bf16 forward by batch size); float32 full path: launches "
              f"{full_launches}, each "
              f"shard's rows equal to the unsharded call on them, against the batch of 32 n equal, max box err "
              f"{box_err:.3g} px, conf err {conf_err:.3g}; MicroBatcher(min_bucket=2) buckets {batcher.buckets}, 3 "
              f"requests in {batcher.calls} call; {ms_sharded:.3f} ms per sharded batch, {ms_plain:.3f} unsharded "
              f"(bf16), on {gpu}", flush=True)
        launches.update(greedy_nms_serve=serve_launches["greedy_nms"],
                        masked_scores_serve=serve_launches["masked_scores"])
        out["serving"] = dict(launches=serve_launches, full_launches=full_launches, frames_differ=len(differ),
                              frames_n_differ=len(n_differ), full_box_err=box_err, full_conf_err=conf_err,
                              ms_sharded=ms_sharded, ms_unsharded=ms_plain, buckets=batcher.buckets)

        # 4. sharded validation through the same mesh
        fwd_s, fwd = validator.make_forward(model, mesh=mesh), validator.make_forward(model)
        vb = torch.as_tensor(val_batches[0][0], device=model.device)
        d_s, n_s = fwd_s(vb)
        h = len(vb) // 2
        for a in (0, h):
            d, n = fwd(vb[a:a + h])
            check(torch.equal(d_s[a:a + h], d) and torch.equal(n_s[a:a + h], n),
                  f"sharded val rows {a}-{a + h} differ from the unsharded forward on those rows")
        reset_kernel_counts()
        t0 = time.perf_counter()
        results, _, _ = validator.run(model=model, dataloader=val_batches, sharded=mesh)
        val_s = time.perf_counter() - t0
        val_launches = kernel_counts()
        n_val = sum(len(b[0]) for b in val_batches)
        print(f"parallel sharded val: mAP50 {results[2]:.4f} against unsharded {map50:.4f}; launches "
              f"{val_launches} for {len(val_batches)} batches; per-shard rows equal; {n_val / val_s:.1f} img/s "
              f"(host clock) on {gpu}", flush=True)
        check(abs(results[2] - map50) <= 0.005, f"sharded val mAP50 {results[2]} vs {map50}")
        check(val_launches["greedy_nms"] == 2 * len(val_batches), f"sharded val launches {val_launches}")
        launches["greedy_nms_val"] = val_launches["greedy_nms"]
        out["val"] = dict(map50=float(results[2]), map50_unsharded=float(map50), launches=val_launches,
                          img_s=n_val / val_s)

        # 5. the trainer CLI over two processes: one epoch, then both resume a second
        n_train, n_val = PARALLEL_TRAINER_IMAGES
        synthetic.generate(tmp / "shapes", n_images=n_train, imgsz=640, seed=0, n_val=n_val)
        run = tmp / "run"
        common = ["--data", str(tmp / "shapes" / "dataset.yaml"), "--cfg", "yolov3", "--imgsz", "640",
                  "--batch-size", str(PARALLEL_TRAINER_BS), "--workers", "4", "--noautoanchor", "--sync-bn"]
        t0 = time.perf_counter()
        first = run_ranks(tmp, "cli", "cli", 2, common + ["--epochs", "1", "--project", str(tmp), "--name", "run"])
        files = sorted(p.name for p in (run / "weights").iterdir())
        resumed = run_ranks(tmp, "resume", "cli", 2, common + ["--epochs", "2", "--resume", str(run)])
        trainer_s = time.perf_counter() - t0
        steps_a_epoch = n_train // (2 * PARALLEL_TRAINER_BS)
        val_batches_n = -(-n_val // PARALLEL_TRAINER_BS)
        for label, (r0, r1) in (("first run", first), ("resumed run", resumed)):
            print(f"parallel trainer CLI, {label}: checkpoint writes {r0['writes']} / {r1['writes']} (rank 0 / 1), "
                  f"steps {r0['step']} / {r1['step']}, K3 launches {r0['k3']} / {r1['k3']}, K1 {r0['k1']} / "
                  f"{r1['k1']}, results {r0['results'][:4]}", flush=True)
            # rank 0: `last` every epoch, `best` where the fitness did not fall, both stripped at the end
            check(r0["writes"]["save_checkpoint"] >= 1 and r0["writes"]["strip_checkpoint"] == 2
                  and r1["writes"] == {"save_checkpoint": 0, "strip_checkpoint": 0},
                  f"trainer {label}: checkpoint writes {r0['writes']} / {r1['writes']}")
            check(r0["step"] == r1["step"] == steps_a_epoch, f"trainer {label}: steps {r0['step']} / {r1['step']}")
            check(r0["k3"] == r1["k3"] == YOLOV3_K3_CONVS * steps_a_epoch,
                  f"trainer {label}: K3 launches {r0['k3']} / {r1['k3']}")
            check(r0["k1"] == val_batches_n and r1["k1"] == 0, f"trainer {label}: K1 {r0['k1']} / {r1['k1']}")
            check(r0["results"] == r1["results"], f"trainer {label}: the ranks' results differ")
        ranks_equal = all(torch.equal(resumed[0]["model"][k], v) for k, v in resumed[1]["model"].items())
        last, _ = load_checkpoint(run / "weights" / "last")
        print(f"parallel trainer CLI: weights/ after the first run {files}; after the resume both ranks' "
              f"parameters equal in their bits: {ranks_equal}; stripped last holds {len(last['model'])} tensors; "
              f"{trainer_s:.1f} s for both runs (process start-up and checkpoint writes included)", flush=True)
        check(files == ["best", "last"], f"weights/ holds {files}")
        check(ranks_equal, "the resumed ranks' parameters differ")
        launches.update(conv3x3_bn_stats_trainer=first[0]["k3"] + resumed[0]["k3"],
                        greedy_nms_trainer=first[0]["k1"] + resumed[0]["k1"])
        out["trainer"] = dict(first=[r["writes"] for r in first], seconds=trainer_s, ranks_equal=ranks_equal)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel phase: {out['phase_s']:.1f} s", flush=True)
    return launches, out


LAYOUT_PAD = 128  # lanes an anchor in the padded head: the JAX package's serving_module(pad_lanes=128)
LAYOUT_TRAIN_STEPS = 3  # 1 + 2 float32 steps with and without s2d_stem
LAYOUT_TF_BATCH = 2  # frames of the serving batch through the TensorFlow artifacts, on the host
LAYOUT_ROUNDS = 3  # timing windows of each layout, taken in turns


def phase_layout(model, serving_batch, gpu):
    """The JAX package's TPU layout options in the port (phase 15, after 14,
    on the planted model): the serving batch of 32 through the padded head
    (serving_module(pad_lanes=128) -> decode_topk_nhwc(padded_lanes=128) ->
    nms_from_candidates) and through the 5-D eval head (decode_topk_candidates
    -> nms_from_candidates), each with its launches counted (K2 three, K1
    one). Each layout's kernel run is held to the plain versions on its own
    head outputs: K2 against masked_scores_plain on the very rows the decode
    hands it (the padded bf16 rows with no = 128, the float32 rows of the 5-D
    head; `check_scores`), and the rows against the same decode through
    masked_scores_plain and greedy_nms_plain at the NMS bars; and to the
    plain fast path's rows at the NMS bars. Then the space-to-depth stem
    through the train step (`layout_s2d_train`), and the TensorFlow formats
    where the host has tensorflow (`layout_tensorflow`)."""
    from yolov3_tpu_torch.models.detect_head import decode_topk_candidates, decode_topk_nhwc
    from yolov3_tpu_torch.ops.nms import nms_from_candidates
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms_plain
    from yolov3_tpu_torch.ops.score_cuda import masked_scores_plain
    from yolov3_tpu_torch.serve import build_batched_infer

    infer = build_batched_infer(model)
    serving = infer.serving_model
    padded_graph = serving.serving_module(pad_lanes=LAYOUT_PAD)
    anchors, strides = model.anchors_px, model.spec.strides
    imgs = torch.as_tensor(serving_batch, device=model.device)
    x = imgs.to(serving.dtype) / 255.0  # the fast path's input: uint8 is exact in bf16
    layouts = {  # name: (head, decode)
        "plain": (lambda x: serving(x, raw=True), lambda f, **kw: decode_topk_nhwc(f, anchors, strides, **kw)),
        "padded_head": (padded_graph,
                        lambda f, **kw: decode_topk_nhwc(f, anchors, strides, padded_lanes=LAYOUT_PAD, **kw)),
        "head_5d": (serving, lambda f, **kw: decode_topk_candidates(f, anchors, strides, **kw)),
    }

    @torch.inference_mode()
    def serve(name, feats=None, plain_fns=None):
        """Forward (unless `feats` is given), decode and NMS of one layout:
        through the kernels, or with plain_fns=(score_fn, nms_fn) through those."""
        head, decode = layouts[name]
        feats = head(x) if feats is None else feats
        score, nms = ({}, {}) if plain_fns is None else ({"score_fn": plain_fns[0]}, {"nms_fn": plain_fns[1]})
        boxes, scores, cls_ids, overflow = decode(feats, with_overflow=True, **score)
        dets, n = nms_from_candidates(boxes, scores, cls_ids, **nms)
        return feats, dets, n, overflow

    want, want_n, want_ov = infer.fast_fn(imgs)
    check(not bool(want_ov.any()), "layout: the plain fast path overflowed on the serving batch")
    want, want_n = want.cpu().numpy(), want_n.cpu().numpy()
    for name in layouts:
        serve(name)  # cuDNN picks the padded head conv's algorithm
    # in turns, LAYOUT_ROUNDS rounds of each: on a shared host one window alone has moved by 10%
    ms = {name: [] for name in layouts}
    for _ in range(LAYOUT_ROUNDS):
        for name in layouts:
            ms[name].append(cuda_ms(functools.partial(serve, name), iters=10))
    out = dict(plain_ms=float(np.median(ms["plain"])), plain_ms_rounds=ms["plain"])
    for name in ("padded_head", "head_5d"):
        torch.cuda.synchronize()
        # --- the layout path: every launch from here to the count read is its own
        reset_kernel_counts()
        feats, dets, n, overflow = serve(name)
        torch.cuda.synchronize()
        launches = kernel_counts()
        # --- end of the layout path
        check(launches == {"greedy_nms": 1, "masked_scores": 3, "conv3x3_bn_stats": 0},
              f"layout {name}: launches {launches}, expected K2 3 and K1 1")
        check(not bool(overflow.any()), f"layout {name}: the serving batch overflowed")
        dets, n = dets.cpu().numpy(), n.cpu().numpy()
        check(n.sum() > 0, f"layout {name}: no detection in the serving batch")

        # the same head outputs through the plain versions: K2 on each row tensor the decode hands it
        rows_in = []
        plain_scores = functools.partial(_recorded, masked_scores_plain, rows_in)
        _, dets_p, n_p, overflow_p = serve(name, feats, (plain_scores, greedy_nms_plain))
        check(len(rows_in) == 3, f"layout {name}: the decode scored {len(rows_in)} row tensors, expected 3")
        score_err = max(check_scores(*args, f"layout {name} scale {i}") for i, args in enumerate(rows_in))
        check(not bool(overflow_p.any()), f"layout {name}: the plain versions overflowed")
        dets_p, n_p = dets_p.cpu().numpy(), n_p.cpu().numpy()
        check((n == n_p).all(), f"layout {name}: n {n.tolist()} != plain versions' {n_p.tolist()}")
        errs_p = [check_dets(dets[i, :n[i]], dets_p[i, :n_p[i]], f"layout {name} vs plain versions, image {i}")
                  for i in range(len(n))]

        # the 5-D decode sorts candidates in (a, y, x) order, the NHWC one in (y, x, a): rows of equal score
        # (equal bf16 logits) come out in another order, so there both sides are put in one order first
        order = _tie_order if name == "head_5d" else (lambda d: d)
        errs = [check_dets(order(dets[i, :n[i]]), order(want[i, :want_n[i]]), f"layout {name} image {i}")
                for i in range(len(n))]
        out[name] = dict(launches=launches, n=int(n.sum()), box_err=max(e[0] for e in errs),
                         conf_err=max(e[1] for e in errs), plain_box_err=max(e[0] for e in errs_p),
                         plain_conf_err=max(e[1] for e in errs_p), score_err=score_err,
                         ms=float(np.median(ms[name])), ms_rounds=ms[name])
        r = out[name]
        print(f"layout {name}: batch {len(n)} at {imgs.shape[1]} px, n {r['n']}; against the plain versions on "
              f"its own head outputs (masked_scores_plain, greedy_nms_plain): K2 args equal, max score err "
              f"{score_err:.3g}, rows n equal, max box err {r['plain_box_err']:.3g} px, conf err "
              f"{r['plain_conf_err']:.3g}; against the plain fast path's rows: n equal, max box err "
              f"{r['box_err']:.3g} px, conf err {r['conf_err']:.3g}; launches {launches}, {r['ms']:.3f} ms a "
              f"batch (forward + decode + NMS; median of {LAYOUT_ROUNDS} rounds in turns: "
              f"{' '.join(f'{v:.3f}' for v in ms[name])}) against the plain layout's {out['plain_ms']:.3f} "
              f"({' '.join(f'{v:.3f}' for v in ms['plain'])}) on {gpu}", flush=True)
    out["s2d_train"] = layout_s2d_train(gpu)
    out["tensorflow"] = layout_tensorflow(model, serving_batch[:LAYOUT_TF_BATCH])
    return out


def _recorded(fn, calls, *args):
    """fn(*args), with args appended to `calls`."""
    calls.append(args)
    return fn(*args)


def _tie_order(d):
    """Detection rows by descending score, rows of equal score by their box and class."""
    return d[np.lexsort((d[:, 5], d[:, 3], d[:, 2], d[:, 1], d[:, 0], -d[:, 4]))]


def layout_s2d_train(gpu, steps=LAYOUT_TRAIN_STEPS, bs=8, imgsz=640):
    """Full-width yolov3 with s2d_stem=True against the same seeded model
    without it: `steps` float32 train steps each (1 + 2) on one seeded batch
    under cudnn.deterministic; the losses, grad norms and the whole train
    state (parameters, BatchNorm statistics, momentum, EMA) equal in their
    bits, since the port computes the plain layout; K3 33 launches a step."""
    from yolov3_tpu_torch.models.convert import flatten_train_state
    from yolov3_tpu_torch.models.detection import DetectionModel

    batch = make_train_batch(np.random.default_rng(15), bs, imgsz)  # a generator of its own
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward algorithms that add in a fixed order
    runs = {}
    try:
        for s2d in (True, False):
            model = DetectionModel.from_config("yolov3", seed=0, s2d_stem=s2d)
            check(model.s2d_stem == s2d, "layout: the s2d_stem flag was not kept")
            rows, state = parallel_steps(model, batch, steps)
            runs[s2d] = (rows, {k: v.clone() if torch.is_tensor(v) else v
                                for k, v in flatten_train_state(state).items()})
            del model, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (rows, got), (plain_rows, want) = runs[True], runs[False]
    k3 = [r["k3"] for r in rows]
    check(k3 == [YOLOV3_K3_CONVS] * steps, f"layout s2d: K3 launches {k3} a step, expected {YOLOV3_K3_CONVS}")
    check([(r["loss"], r["grad_norm"]) for r in rows] == [(r["loss"], r["grad_norm"]) for r in plain_rows],
          f"layout s2d: losses {[r['loss'] for r in rows]} != plain {[r['loss'] for r in plain_rows]}")
    check(got.keys() == want.keys(), "layout s2d: the train states hold other keys")
    differ = [k for k, v in want.items() if not (torch.equal(got[k], v) if torch.is_tensor(v) else got[k] == v)]
    check(not differ, f"layout s2d: {len(differ)} state entries differ from the plain run's, e.g. {differ[:3]}")
    losses = " ".join(f"{r['loss']:.6f}" for r in rows)
    print(f"layout s2d_stem: yolov3 at {imgsz} px, batch {bs}, {steps} float32 steps equal to the plain layout's "
          f"in their bits (losses {losses}, "
          f"{len(want)} state entries), K3 {k3} a step, {np.mean([r['ms'] for r in rows[1:]]):.1f} ms a step "
          f"(host clock, deterministic cuDNN) on {gpu}", flush=True)
    return dict(losses=[r["loss"] for r in rows], k3_per_step=k3, state_entries=len(want),
                step_ms=[r["ms"] for r in rows])


def layout_tensorflow(model, frames):
    """The TensorFlow formats, where the host has tensorflow (decided before
    anything is imported): a savedmodel and a tflite exported from a host copy
    of the model, each through MultiBackend on the host, against the port's
    own float32 decode at the forward bar (atol 2e-3, rtol 1e-3). Without
    tensorflow it prints that they were not run, and returns ran=False."""
    import importlib.util
    import tempfile
    from pathlib import Path

    if importlib.util.find_spec("tensorflow") is None:
        print("layout: the TensorFlow formats (savedmodel, tflite) were not run: this host has no tensorflow",
              flush=True)
        return dict(ran=False)
    from yolov3_tpu_torch import export
    from yolov3_tpu_torch.models.backend import MultiBackend

    host = copy.deepcopy(model).cpu().float().eval()
    imgsz = frames.shape[1]
    with torch.inference_mode():
        want = export.ServingModule(host)(torch.from_numpy(frames)).numpy()
    out = dict(ran=True)
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, fn in (("savedmodel", export.export_savedmodel), ("tflite", export.export_tflite)):
            t0 = time.perf_counter()
            path = fn(host, Path(tmp) / model.spec.name, imgsz, len(frames))
            check(path is not None, f"layout: the {fmt} export failed")
            got = MultiBackend(path, device="cpu")(frames).numpy()
            err = float(np.abs(got - want).max())
            check(got.shape == want.shape and bool(np.allclose(got, want, atol=2e-3, rtol=1e-3)),
                  f"layout {fmt}: decode {got.shape} max err {err} against the port's float32 decode")
            out[fmt] = dict(max_abs_err=err, s=time.perf_counter() - t0)
            print(f"layout {fmt}: exported and read back on the host in {out[fmt]['s']:.1f} s, decode of "
                  f"{len(frames)} frames within {err:.3g} of the port's float32 decode", flush=True)
    return out


def phase_kernel_times(rng, tag):
    """K3 at the timed shapes, yolov3's six, yolov5s's four and yolov3-tiny's eight (batch 8, bf16, the
    weight as nn.modules.Conv hands it over), K1 at NMS_SHAPES and K2 at yolov3@640's three scales
    (batch 32, bf16; each scale and the three together): device ms by kernel
    name and ms by CUDA events, each on its own line after `tag`. The first K3
    shape has next to no device work: its time by events is the host's cost of
    one call."""
    from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats
    from yolov3_tpu_torch.ops.nms_cuda import greedy_nms

    masked_scores = score_module().masked_scores

    gen = torch.Generator(device="cuda").manual_seed(0)
    for H, W, Cin, Cout in [(16, 16, 64, 64), *(row[3:] for row in K3_TIMED)]:
        x = torch.randn((8, H, W, Cin), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((Cout, Cin, 3, 3), generator=gen, device="cuda") / (9 * Cin) ** 0.5).to(torch.bfloat16)
        w_view = w.contiguous(memory_format=torch.channels_last).permute(2, 3, 1, 0)
        with torch.no_grad():
            dev = device_ms(lambda: conv3x3_bn_stats(x, w_view), K3_KERNELS, per_call=len(K3_KERNELS))
            ev = cuda_ms(lambda: conv3x3_bn_stats(x, w_view), iters=50)
        print(f"{tag} K3 {H}x{W} {Cin}->{Cout}: device {dev:.4f} ms, events {ev:.4f} ms", flush=True)
    for label, B, K, iou in NMS_SHAPES:
        args = make_candidates(rng, B, K, "cuda")
        dev = device_ms(lambda: greedy_nms(*args, iou, 300), NMS_KERNEL)
        ev = cuda_ms(lambda: greedy_nms(*args, iou, 300), iters=50)
        print(f"{tag} K1 {label}: device {dev:.4f} ms, events {ev:.4f} ms", flush=True)
    heads = make_heads(rng, [(32, m, torch.bfloat16, 0) for m in SCORE_CELLS])
    for label, fs in [*((f"{int(f.shape[1] ** 0.5)}x{int(f.shape[1] ** 0.5)}", [f]) for f in heads),
                      ("3 scales", heads)]:
        def run():
            return [masked_scores(f, 3, 85, 0.25) for f in fs]

        dev = device_ms(run, SCORE_KERNEL, per_call=len(fs))
        ev = cuda_ms(run, iters=50)
        print(f"{tag} K2 {label}: device {dev:.4f} ms, events {ev:.4f} ms", flush=True)


# The YOLOv5 family's small model as ultralytics/yolov5 (v6.0 and later) publishes it,
# models/yolov5s.yaml, written out here (the JAX package ships no such YAML):
# 7,235,389 parameters at nc 80.
YOLOV5_ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
YOLOV5S = {
    "name": "yolov5s", "nc": 80, "depth_multiple": 0.33, "width_multiple": 0.50, "anchors": YOLOV5_ANCHORS,
    "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C3", [128]],
                 [-1, 1, "Conv", [256, 3, 2]], [-1, 6, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
                 [-1, 9, "C3", [512]], [-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]],
                 [-1, 1, "SPPF", [1024, 5]]],
    "head": [[-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3", [256, False]],
             [-1, 1, "Conv", [256, 3, 2]], [[-1, 14], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [512, 3, 2]], [[-1, 10], 1, "Concat", [1]], [-1, 3, "C3", [1024, False]],
             [[17, 20, 23], 1, "Detect", ["nc", "anchors"]]],
}
# ultralytics/yolov5 models/hub/yolov5s-transformer.yaml: yolov5s with a C3TR as layer 8 (7,038,013 parameters)
YOLOV5S_TRANSFORMER = {**YOLOV5S, "name": "yolov5s-transformer",
                       "backbone": [*YOLOV5S["backbone"][:8], [-1, 3, "C3TR", [1024]], YOLOV5S["backbone"][9]]}


def _ghost(rows):
    return [[f, n, {"Conv": "GhostConv", "C3": "C3Ghost"}.get(op, op) if i else op, args]
            for i, (f, n, op, args) in rows]


# ultralytics/yolov5 models/hub/yolov5s-ghost.yaml: GhostConv for every Conv but the 6x6 stem and
# C3Ghost for every C3. The JAX package cannot build it: its parser counts no GhostConv stride, so
# the Detect strides come to 0 (a ZeroDivisionError in detect_head.py)
YOLOV5S_GHOST = {**YOLOV5S, "name": "yolov5s-ghost", "backbone": _ghost(enumerate(YOLOV5S["backbone"])),
                 "head": _ghost((1, row) for row in YOLOV5S["head"])}
YOLOV5_MODELS = {"yolov5s": YOLOV5S, "yolov5s-transformer": YOLOV5S_TRANSFORMER, "yolov5s-ghost": YOLOV5S_GHOST}
YOLOV5_PARAMS = {"yolov5s": 7235389, "yolov5s-transformer": 7038013}
# K3 launches a train step: the C3 bottlenecks' stride-1 3x3 convs (C3TR and C3Ghost have none)
YOLOV5_K3_CONVS = {"yolov5s": 11, "yolov5s-transformer": 10, "yolov5s-ghost": 0}


def main(argv=()):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    if argv and argv[0] == "--parallel-worker":  # a rank that phase_parallel started
        return parallel_worker(argv[1])
    if argv and argv[0] == "--kernel-times":
        if len(argv) > 1:
            sys.path.insert(0, argv[1])  # the package of another tree, ahead of the one beside this file
        phase_kernel_times(np.random.default_rng(0), argv[1] if len(argv) > 1 else ".")
        return 0
    from yolov3_tpu_torch.ops import cuda_build, host_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}",
          flush=True)
    env = optional_packages()
    print(f"env: optional packages on this host {json.dumps(env)}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # the host ops' C++ build beside the nvcc builds
        host_lib = pool.submit(host_build.build)
        built = cuda_build.build_all()
        host_lib = host_lib.result()
    print(f"build: {sorted(built)} and {host_lib.name} in {time.perf_counter() - t0:.1f} s with "
          f"{cuda_build.nvcc()} and {host_build.compiler()} for {gpu}", flush=True)
    for name, (sec, log) in built.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "bytes stack" in ln]
        print(f"build {name}.cu: {sec:.1f} s; " + " | ".join(info), flush=True)

    rng = np.random.default_rng(0)
    nms_rows = phase_nms(rng)
    score = phase_score(rng)
    epilogue = phase_epilogue()
    conv_pool_rows = phase_conv_pool()
    from yolov3_tpu_torch.models.detection import DetectionModel

    model = DetectionModel.from_config("yolov3", seed=0)  # full width, nc=80, on the card
    check(model.num_params() == 61949149, f"yolov3 has {model.num_params()} parameters")
    conv_rows = phase_conv_bn()
    launches, e2e, serving_batch = phase_main_path(rng, model)
    http = phase_http(model)
    fast_false = phase_fast_false(model)
    val, val_batches = phase_val(rng, model)
    merge = phase_merge(model, val_batches[0][0][:8])
    hybrid = phase_save_hybrid(model, val_batches, val["f32"]["map50"])
    exported = phase_export(model, val_batches, gpu)
    parallel_launches, parallel = phase_parallel(model, serving_batch, val_batches, val["f32"]["map50"], gpu)
    host_nms = phase_host_nms(model, serving_batch, val_batches[0][0][:2], gpu)
    layout = phase_layout(model, serving_batch, gpu)
    del model, val_batches  # its head carries the planted detections; the trainer starts from the seeded init
    jpeg = phase_jpeg(gpu)
    detect = phase_detect(gpu)
    launches["conv3x3_bn_stats"], train = phase_train(rng, DetectionModel.from_config("yolov3", seed=0))
    remat = phase_remat()
    trainer_launches, trainer = phase_trainer()
    learn_launches, learn = phase_learn(gpu)
    zoo_launches, zoo = phase_zoo(rng)
    family_launches, family = phase_family(gpu)

    serving = nms_rows["serving"]
    kernels = [
        dict(name="greedy_nms", route="cuda", source="yolov3_tpu_torch/csrc/nms.cu",
             replaces="yolov3_tpu/ops/nms_pallas.py:29", launches=launches["greedy_nms"],
             max_abs_err=max(r["max_abs_err"] for r in nms_rows.values()), ms=serving["ms"],
             plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"], bound_by=serving["bound_by"],
             library_ms=None, latency_bound_ms=serving["latency_bound_ms"],
             val_launches=val["launches"]["greedy_nms"], trainer_launches=trainer_launches["greedy_nms"],
             trainer_serve_launches=trainer["serve_launches"]["greedy_nms"],
             http_launches=http["launches"]["greedy_nms"], fast_false_launches=fast_false["launches"]["greedy_nms"],
             merge_launches=merge["launches"]["greedy_nms"], save_hybrid_launches=hybrid["launches"]["greedy_nms"],
             detect_launches={k: v["launches"]["greedy_nms"] for k, v in detect["runs"].items()},
             detect_autoshape_launches=detect["autoshape_launches"], detect_val_launches=detect["val"]["launches"],
             detect_shape=detect["k1"], zoo_launches={k: v["greedy_nms"] for k, v in zoo_launches.items()},
             export_nms_launches_per_call=exported["nms_launches"] / 2,
             export_val_launches={k: v["launches"]["greedy_nms"] for k, v in exported["val"].items()},
             detect_pt2_launches=detect["pt2_launches"],
             parallel_serve_launches=parallel_launches["greedy_nms_serve"],
             parallel_val_launches=parallel_launches["greedy_nms_val"],
             parallel_trainer_launches_rank0=parallel_launches["greedy_nms_trainer"],
             learn_val_launches=learn_launches["greedy_nms"], host_nms_launches=host_nms["launches"]["greedy_nms"],
             learn_val_launches_per_batch=learn_launches["greedy_nms"] / learn_launches["greedy_nms_val_batches"],
             layout_padded_head_launches=layout["padded_head"]["launches"]["greedy_nms"],
             layout_head_5d_launches=layout["head_5d"]["launches"]["greedy_nms"],
             tiny_serving_shape=nms_rows["tiny serving"],
             family_serve_launches={k: family_launches[k]["serve"]["greedy_nms"] for k in FAMILY},
             family_val_launches={k: family_launches[k]["val"] for k in FAMILY},
             family_detect_default_launches=family_launches["defaults"]["detect"],
             family_hub_launches=family_launches["defaults"]["hub"]),
        dict(name="masked_scores", route="cuda", source="yolov3_tpu_torch/csrc/score.cu",
             replaces="yolov3_tpu/ops/score_pallas.py:43", launches=launches["masked_scores"],
             max_abs_err=score["max_abs_err"], ms=score["ms"], plain_ms=score["plain_ms"],
             bound_ms=score["bound_ms"], bound_by=score["bound_by"], library_ms=None,
             trainer_serve_launches=trainer["serve_launches"]["masked_scores"],
             http_launches=http["launches"]["masked_scores"],
             fast_false_launches=fast_false["launches"]["masked_scores"],
             zoo_launches={k: v["masked_scores"] for k, v in zoo_launches.items()},
             parallel_serve_launches=parallel_launches["masked_scores_serve"],
             layout_padded_head_launches=layout["padded_head"]["launches"]["masked_scores"],
             layout_head_5d_launches=layout["head_5d"]["launches"]["masked_scores"],
             family_serve_launches={k: family_launches[k]["serve"]["masked_scores"] for k in FAMILY}),
        dict(name="conv3x3_bn_stats", route="cuda", source="yolov3_tpu_torch/csrc/conv_bn.cu",
             replaces="yolov3_tpu/ops/conv_bn_pallas.py:33", launches=launches["conv3x3_bn_stats"],
             **{k: conv_rows[K3_MAIN_SHAPE][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             trainer_launches=trainer_launches["conv3x3_bn_stats"],
             remat_launches_per_step={k: v["k3_per_step"] for k, v in remat.items()},
             zoo_launches={k: v["conv3x3_bn_stats"] for k, v in zoo_launches.items()},
             parallel_world1_launches=parallel_launches["conv3x3_bn_stats_world1"],
             parallel_launches_per_rank_step=parallel_launches["conv3x3_bn_stats_per_rank_step"],
             parallel_trainer_launches_per_rank=parallel_launches["conv3x3_bn_stats_trainer"],
             learn_launches=learn_launches["conv3x3_bn_stats"], learn_launches_per_step=learn["k3_per_step"],
             layout_s2d_launches_per_step=layout["s2d_train"]["k3_per_step"],
             family_launches_per_step={k: family_launches[k]["k3_per_step"] for k in FAMILY}),
        dict(name="conv_epilogue", route="cuda", source="yolov3_tpu_torch/csrc/epilogue.cu", replaces=None,
             launches=launches["conv_epilogue"], max_ulps=max(r["ulps"] for r in epilogue.values()),
             **{k: epilogue[EPILOGUE_SHAPES[0][0]][k] for k in ("ms", "plain_ms", "bound_ms")}, bound_by="bytes",
             library_ms=epilogue[EPILOGUE_SHAPES[0][0]]["passes_ms"],
             family_serve_launches={k: family_launches[k]["serve"]["conv_epilogue"] for k in FAMILY}),
        dict(name="conv_pool", route="cuda", source="yolov3_tpu_torch/csrc/conv_pool.cu", replaces=None,
             launches=launches["conv_pool"], max_ulps=max(r["ulps"] for r in conv_pool_rows.values()),
             **{k: conv_pool_rows[CONV_POOL_SHAPES[0][0]][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             family_serve_launches={k: family_launches[k]["serve"]["conv_pool"] for k in FAMILY}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"nms_shapes": nms_rows, "conv_bn_shapes": conv_rows, "epilogue_shapes": epilogue,
                      "conv_pool_shapes": conv_pool_rows,
                      "main_path": e2e, "http": http,
                      "fast_false": fast_false, "val": val, "merge": merge, "save_hybrid": hybrid, "train": train,
                      "remat": remat, "trainer": trainer, "jpeg": jpeg, "detect": detect, "zoo": zoo,
                      "export": exported, "parallel": parallel, "learn": learn, "host_nms": host_nms,
                      "layout": layout, "family": family, "env": env}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
