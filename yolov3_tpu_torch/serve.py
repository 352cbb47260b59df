"""Batched serving and the HTTP server in front of it (yolov3_tpu/serve.py).

    # server: a port checkpoint directory (train()'s weights/best), a reference .pt or a cfg name
    python -m yolov3_tpu_torch.serve --weights runs/train/exp/weights/best --port 8507

    # client
    from yolov3_tpu_torch.serve import RemoteModel
    model = RemoteModel("http://localhost:8507")
    dets = model(image_bgr)          # (n, 6) [x1, y1, x2, y2, conf, cls] in the image's pixels

    # in process
    predict = build_pipeline(model, imgsz=640, max_batch=8, fast=True)
    dets = predict(image_bgr)

Protocol: POST /predict with a PNG/BMP body (decoded by data/image_ops.py;
other formats only where cv2 or PIL is installed, else 400) or an
`application/x-npy` HWC BGR uint8 array -> JSON {detections: [[x1, y1, x2,
y2, conf, cls], ...] rounded to 4 places, names: {...}, speed_ms}. GET
/health -> the model's name, imgsz, names and the batcher's device calls and
requests. A body that does not decode gets 400, another path 404.

Layers, from the socket down: `make_server` (ThreadingHTTPServer, one thread
a request) -> `build_pipeline`'s predict (letterbox, BGR->RGB, scale-back)
-> `MicroBatcher` (coalesces concurrent requests into one device call) ->
`build_batched_infer` (the fast path: BN-folded bf16 forward, the per-scale
top-k decode through the candidate-score kernel, greedy NMS through the NMS
kernel; or, with fast=False, the f32 full decode and `batched_nms`).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from yolov3_tpu_torch.models.detect_head import decode_predictions, decode_topk_nhwc
from yolov3_tpu_torch.models.detection import cast_for_inference
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.ops.nms import batched_nms, nms_from_candidates
from yolov3_tpu_torch.utils.general import LOGGER

MULTI_GPU = "multi-GPU serving is not ported yet (ROADMAP.md queue 1 item 8)"


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def build_batched_infer(model, conf_thres=0.25, iou_thres=0.45, max_det=300, fast=True, mesh=None,
                        k_per_scale=(256, 128, 64), s2d=False):
    """((B, H, W, 3) uint8 NHWC) -> ((B, max_det, 6) dets, (B,) n), on the model's device.

    fast=True: BN-folded bf16 forward with a raw NHWC head, the per-scale
    top-k decode (`k_per_scale`; candidate-score kernel) and greedy NMS (NMS
    kernel). A per-image overflow flag from the decode marks dense scenes
    whose above-conf candidates exceed the per-scale top-k; such a batch
    re-runs through the full path instead of being silently truncated.
    `infer.fast_fn` / `infer.full_fn` are the two paths (each takes host or
    device uint8 images), `infer.serving_model` the fused bf16 model of the
    first; `infer.fallbacks` counts the batches that took the second.

    fast=False returns the full path alone: the float32 unfused forward,
    `decode_predictions` and `batched_nms` (max_nms 8192).

    `s2d` (the JAX package's space-to-depth stem, a TPU layout) is an exact
    transform: it is accepted and the plain layout computed. `mesh` raises.
    """
    if mesh is not None:
        raise NotImplementedError(f"build_batched_infer(mesh=...): {MULTI_GPU}")
    full_model = model.eval()
    device = model.device
    anchors, strides = model.anchors_px, model.spec.strides

    @torch.inference_mode()
    def full_fn(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(device).float() / 255.0
        pred = decode_predictions(full_model(x), anchors, strides)
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                           max_nms=8192)

    if not fast:
        return full_fn
    serving = cast_for_inference(model.fuse())

    @torch.inference_mode()
    def fast_fn(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(device).to(serving.dtype) / 255.0  # uint8 is exact in bf16
        feats = serving(x, raw=True)
        boxes, scores, cls_ids, overflow = decode_topk_nhwc(
            feats, anchors, strides, k_per_scale=k_per_scale, conf_thres=conf_thres, with_overflow=True)
        dets, n = nms_from_candidates(boxes, scores, cls_ids, iou_thres=iou_thres, max_det=max_det)
        return dets, n, overflow

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
        """Run every bucket once up front, the fast path's fallback included."""
        for b in self.buckets:
            z = np.zeros((b, imgsz, imgsz, 3), np.uint8)
            _host(self.infer(z)[1])
            if hasattr(self.infer, "full_fn"):
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


def build_pipeline(model, imgsz=640, conf_thres=0.25, iou_thres=0.45, max_det=300, max_batch=1,
                   batch_wait_ms=5.0, fast=False, shard=False):
    """Single-image predict fn: letterbox (auto=False) -> BGR to RGB ->
    MicroBatcher -> `build_batched_infer` -> boxes scaled back to the
    image's pixels. predict(im_bgr (H, W, 3) uint8) -> (n, 6) float32;
    `predict.batcher` is the MicroBatcher. The JAX package's automatic
    space-to-depth stem decides nothing here (the layout is plain), and
    shard=True raises."""
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.ops.boxes import scale_boxes

    if shard:
        raise NotImplementedError(f"build_pipeline(shard=True): {MULTI_GPU}")
    infer = build_batched_infer(model, conf_thres, iou_thres, max_det, fast=fast)
    batcher = MicroBatcher(infer, max_batch=max_batch, batch_wait_ms=batch_wait_ms)

    def predict(im_bgr):
        h0, w0 = im_bgr.shape[:2]
        im = letterbox(im_bgr, imgsz, auto=False)[0][:, :, ::-1]  # RGB
        dets, _n = batcher.submit(np.ascontiguousarray(im))
        if len(dets):
            dets[:, :4] = scale_boxes((imgsz, imgsz), dets[:, :4], (h0, w0))
        return dets

    predict.batcher = batcher
    return predict


def make_server(weights, host="0.0.0.0", port=8507, imgsz=640, conf_thres=0.25, iou_thres=0.45, max_batch=8,
                batch_wait_ms=5.0, fast=True, shard=False, device=None):
    """Build the model and the pipeline, run every batch bucket once, and
    return the bound ThreadingHTTPServer (port 0 picks a free port; see
    `server.server_address`); `serve` runs it forever. `weights` is what
    `load_weights` takes. `server.predict` is the pipeline, `server.model`
    the model."""
    from yolov3_tpu_torch.data import image_ops

    model = load_weights(weights, device=device)
    predict = build_pipeline(model, imgsz, conf_thres, iou_thres, max_batch=max_batch,
                             batch_wait_ms=batch_wait_ms, fast=fast, shard=shard)
    names = {int(k): v for k, v in (getattr(model, "names", None)
                                    or {i: str(i) for i in range(model.spec.nc)}).items()}
    predict.batcher.warmup(imgsz)  # every batch bucket once, before the first request
    LOGGER.info(
        f"model {model.spec.name} ready; serving on {host}:{port} "
        f"(micro-batching: max_batch={max_batch}, wait={batch_wait_ms}ms, buckets={predict.batcher.buckets})"
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                b = predict.batcher
                self._json(200, {
                    "model": model.spec.name, "imgsz": imgsz, "names": names, "status": "ok",
                    "batching": {"max_batch": b.max_batch, "device_calls": b.calls,
                                 "requests": b.requests},
                })
            else:
                self._json(404, {"error": "unknown path; use GET /health or POST /predict"})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "POST /predict only"})
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            try:
                if self.headers.get("Content-Type") == "application/x-npy":
                    im = np.load(io.BytesIO(raw), allow_pickle=False)
                else:
                    im = image_ops.imdecode(raw, "the request body")
                if im.ndim != 3 or im.shape[2] != 3:
                    raise ValueError(f"expected 3-channel HWC image, got shape {im.shape}")
                im = np.ascontiguousarray(im, dtype=np.uint8)
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad image payload: {e}"})
            t0 = time.perf_counter()
            dets = predict(im)
            self._json(
                200,
                {
                    "detections": [[round(float(v), 4) for v in row] for row in dets],
                    "names": names,
                    "speed_ms": round((time.perf_counter() - t0) * 1e3, 2),
                },
            )

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    server.predict, server.model = predict, model
    return server


def serve(weights, host="0.0.0.0", port=8507, imgsz=640, conf_thres=0.25, iou_thres=0.45, max_batch=8,
          batch_wait_ms=5.0, fast=True, shard=False, device=None):
    """Serve `weights` over HTTP until the process ends (see `make_server`)."""
    make_server(weights, host, port, imgsz, conf_thres, iou_thres, max_batch, batch_wait_ms, fast, shard,
                device).serve_forever()


class RemoteModel:
    """HTTP client with a local-model call shape."""

    def __init__(self, url):
        self.url = url.rstrip("/")
        import urllib.request

        with urllib.request.urlopen(f"{self.url}/health", timeout=10) as r:
            meta = json.loads(r.read())
        self.names = {int(k): v for k, v in meta["names"].items()}
        self.imgsz = meta["imgsz"]

    def __call__(self, im):
        """im: HWC BGR uint8 ndarray -> (n, 6) detections array."""
        import urllib.request

        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(im), allow_pickle=False)
        req = urllib.request.Request(
            f"{self.url}/predict", data=buf.getvalue(), headers={"Content-Type": "application/x-npy"}
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        return np.array(out["detections"], np.float32).reshape(-1, 6)


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="yolov3-tiny",
                   help="a port checkpoint directory, a reference .pt or a model cfg")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8507)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-batch", type=int, default=8, help="micro-batching: max coalesced requests per device call")
    p.add_argument("--batch-wait-ms", type=float, default=5.0, help="micro-batching: wait after first queued request")
    p.add_argument("--no-fast", action="store_true",
                   help="use the full-parity pipeline instead of the fused bf16 fast path")
    p.add_argument("--shard", action="store_true", help="data-parallel serving (not ported: raises)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args()
    serve(a.weights, a.host, a.port, a.imgsz, a.conf_thres, a.iou_thres,
          a.max_batch, a.batch_wait_ms, fast=not a.no_fast, shard=a.shard, device=a.device)


if __name__ == "__main__":
    main()
