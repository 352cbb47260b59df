"""Batched serving: the fused bf16 fast path with a full-decode fallback, and
the micro-batcher in front of it (yolov3_tpu/serve.py).

    model = DetectionModel.from_config("yolov3", seed=0)        # on the card
    batcher = MicroBatcher(build_batched_infer(model), max_batch=32)
    dets, n = batcher.submit(frame)   # letterboxed (640, 640, 3) uint8 RGB

The HTTP server, `build_pipeline` (letterbox and scale-back) and the client
are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from yolov3_tpu_torch.models.detect_head import decode_predictions, decode_topk_nhwc
from yolov3_tpu_torch.models.detection import cast_for_inference
from yolov3_tpu_torch.ops.nms import batched_nms, nms_from_candidates
from yolov3_tpu_torch.utils.general import LOGGER


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def build_batched_infer(model, conf_thres=0.25, iou_thres=0.45, max_det=300):
    """((B, H, W, 3) uint8 NHWC) -> ((B, max_det, 6) dets, (B,) n), on the model's device.

    The fast path: BN-folded bf16 forward with a raw NHWC head, the per-scale
    top-k decode (k = 256/128/64; candidate-score kernel) and greedy NMS
    (NMS kernel). A
    per-image overflow flag from the decode marks dense scenes whose
    above-conf candidates exceed the per-scale top-k; such a batch re-runs
    through the float32 unfused forward, the full decode and `batched_nms`
    (max_nms 8192) instead of being silently truncated.

    `infer.fast_fn` / `infer.full_fn` are the two paths (each takes host or
    device uint8 images), `infer.serving_model` the fused bf16 model of the
    first; `infer.fallbacks` counts the batches that took the second.
    """
    full_model = model.eval()
    serving = cast_for_inference(model.fuse())
    device = model.device
    anchors, strides = model.anchors_px, model.spec.strides

    @torch.inference_mode()
    def fast_fn(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(device).to(torch.bfloat16) / 255.0
        feats = serving(x, raw=True)
        boxes, scores, cls_ids, overflow = decode_topk_nhwc(
            feats, anchors, strides, conf_thres=conf_thres, with_overflow=True)
        dets, n = nms_from_candidates(boxes, scores, cls_ids, iou_thres=iou_thres, max_det=max_det)
        return dets, n, overflow

    @torch.inference_mode()
    def full_fn(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(device).float() / 255.0
        pred = decode_predictions(full_model(x), anchors, strides)
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                           max_nms=8192)

    def infer(imgs_u8):
        imgs = torch.as_tensor(imgs_u8).to(device, non_blocking=True)
        dets, n, overflow = fast_fn(imgs)
        # one small device->host copy: per-image counts + the overflow-any flag
        meta = _host(torch.cat([n, overflow.any().to(torch.int32)[None]]))
        if meta[-1]:
            LOGGER.info("serve: top-k candidate overflow — falling back to full decode for this batch")
            infer.fallbacks += 1
            return full_fn(imgs)
        return dets, meta[:-1]

    infer.fast_fn, infer.full_fn = fast_fn, full_fn
    infer.serving_model = serving
    infer.fallbacks = 0
    return infer


class MicroBatcher:
    """Dynamic request batching: coalesce concurrent predicts into one device call.

    Requests arriving within `batch_wait_ms` of the first queued item are
    stacked (up to `max_batch`), padded to the next power-of-two bucket (or
    max_batch), executed once, and the rows are scattered back to the
    waiting threads.
    """

    def __init__(self, infer, max_batch=8, batch_wait_ms=5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.infer = infer
        self.wait_s = batch_wait_ms / 1e3
        self.buckets = []
        b = 1
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self.max_batch = max_batch
        self.q = queue.Queue()
        self.calls = 0
        self.requests = 0
        self._thread = threading.Thread(target=self._loop, daemon=True, name="microbatcher")
        self._thread.start()

    def warmup(self, imgsz):
        """Run every bucket once up front, the fallback path included."""
        for b in self.buckets:
            z = np.zeros((b, imgsz, imgsz, 3), np.uint8)
            _host(self.infer(z)[1])
            _host(self.infer.full_fn(z)[1])

    def submit(self, im):
        """Blocking: letterboxed HWC uint8 -> ((n, 6) dets ndarray, n)."""
        slot, ev = {}, threading.Event()
        self.q.put((im, slot, ev))
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["dets"], slot["n"]

    def _loop(self):
        while True:
            items = [self.q.get()]
            deadline = time.perf_counter() + self.wait_s
            while len(items) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    items.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                # stack inside the try: a malformed frame must fail its
                # waiters, not kill the dispatcher thread
                bucket = next(b for b in self.buckets if b >= len(items))
                batch = np.stack([it[0] for it in items] + [items[-1][0]] * (bucket - len(items)))
                dets, n = self.infer(batch)
                # rows are score-sorted valid-first: fetch only the valid prefix
                n = _host(n)
                dets = _host(dets[:, : int(n.max())])
            except Exception as e:  # noqa: BLE001 — fail every waiter, not the server
                for _, slot, ev in items:
                    slot["err"] = e
                    ev.set()
                continue
            self.calls += 1
            self.requests += len(items)
            for i, (_, slot, ev) in enumerate(items):
                slot["dets"] = dets[i, : int(n[i])].astype(np.float32)
                slot["n"] = int(n[i])
                ev.set()
