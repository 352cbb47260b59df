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
/health -> the model's name, imgsz, names, the batcher's device calls and
requests, `counters` (the fast path's `infer.fallbacks` and
`infer.level_overflows`, the NMS kernel's `greedy_nms.launches` and
`greedy_nms.route_launches`, the conv epilogue kernel's
`conv_epilogue.launches` and `conv_epilogue.route_launches`, the conv +
max-pool kernel's `conv_pool.launches` and `conv_pool.route_launches`), and
`stages`: {span name: {count, total_s, p50_ms, p95_ms}} of the request
path's spans since the process started
(p50 / p95 over each one's last 1024), `batcher/wait` (the oldest request's queue wait a device call),
`batcher/assemble`, `batcher/call`, `batcher/fetch`, `batcher/scatter`,
`pipeline/letterbox`, `pipeline/scale_back` and the `serve/` stages of
`build_batched_infer` (utils/tracing.py). A body that does not decode gets
400, another path 404.

Layers, from the socket down: `make_server` (ThreadingHTTPServer, one thread
a request) -> `build_pipeline`'s predict (letterbox, BGR->RGB, scale-back)
-> `MicroBatcher` (coalesces concurrent requests into one device call) ->
`build_batched_infer` (the fast path: `optimize_for_inference`'s BN-folded
bf16 forward, the per-scale top-k decode through the candidate-score kernel,
greedy NMS through the NMS kernel; or, with fast=False, the f32 full decode
and `batched_nms`).
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
from yolov3_tpu_torch.models.detection import optimize_for_inference
from yolov3_tpu_torch.models.loading import load_weights
from yolov3_tpu_torch.ops.conv_pool_cuda import conv_pool
from yolov3_tpu_torch.ops.epilogue_cuda import conv_epilogue
from yolov3_tpu_torch.ops.nms import batched_nms, nms_from_candidates
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
from yolov3_tpu_torch.utils.general import LOGGER
from yolov3_tpu_torch.utils.tracing import record, span, stats

def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def topk_per_level(nl, imgsz):
    """The fast path's top-k of each of `nl` head levels at `imgsz` px: 256,
    128, 64 at 640 px and below, 64 for each further level, and above 640 px
    scaled by imgsz // 640 (512, 256, 128, 64 for a P6 model at 1280 px),
    never under 64."""
    return tuple(max(64, (256 >> i) * max(1, imgsz // 640)) for i in range(nl))


def _paths(full_model, serving, conf_thres, iou_thres, max_det, k_per_scale):
    """(full_fn, fast_fn) of one replica: the float32 full path on
    `full_model`, the fast path on the fused bf16 `serving` model (None: no
    fast path), each on its model's device. Both decodes read the replica's
    `anchor_table()`, built here, before the first batch."""
    device = full_model.device
    anchors = full_model.anchor_table()
    strides = full_model.spec.strides

    @torch.inference_mode()
    def full_fn(imgs_u8):
        x = torch.as_tensor(imgs_u8).to(device).float() / 255.0
        pred = decode_predictions(full_model(x), anchors, strides)
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                           max_nms=8192)

    if serving is None:
        return full_fn, None

    @torch.inference_mode()
    def fast_fn(imgs_u8):
        with span("serve/forward"):
            x = torch.as_tensor(imgs_u8).to(device).to(serving.dtype) / 255.0  # uint8 is exact in bf16
            feats = serving(x, raw=True)
        with span("serve/decode"):
            boxes, scores, cls_ids, overflow = decode_topk_nhwc(
                feats, anchors, strides, k_per_scale=k_per_scale, conf_thres=conf_thres, with_overflow=True,
                overflow_per_level=True)
        with span("serve/nms"):
            dets, n = nms_from_candidates(boxes, scores, cls_ids, iou_thres=iou_thres, max_det=max_det)
        return dets, n, overflow

    return full_fn, fast_fn


def build_batched_infer(model, conf_thres=0.25, iou_thres=0.45, max_det=300, fast=True, mesh=None,
                        k_per_scale=None, s2d=False):
    """((B, H, W, 3) uint8 NHWC) -> ((B, max_det, 6) dets, (B,) n), on the model's device.

    fast=True: the BN-folded bf16 forward of `optimize_for_inference` (a
    new model: `model` itself stays as it is) with a raw NHWC head, the
    per-scale top-k decode (`k_per_scale`, by default `topk_per_level` of the
    model's levels at 640 px; candidate-score kernel) and greedy NMS (NMS
    kernel). Per-image, per-level overflow flags from the decode mark dense
    scenes whose above-conf candidates exceed a level's top-k; such a batch
    re-runs through the full path instead of being silently truncated.
    `infer.fast_fn` / `infer.full_fn` are the two paths (each takes host or
    device uint8 images; the fast path's third output is the (B, nl) flags),
    `infer.serving_model` the fused bf16 model of the first;
    `infer.fallbacks` counts the batches that took the second, and
    `infer.level_overflows[i]` those among them that overflowed at level i.

    fast=False returns the full path alone: the float32 forward of `model`
    as given (unfused or fused), `decode_predictions` and `batched_nms`
    (max_nms 8192).

    Spans (utils/tracing.py), a batch each: `serve/copy_in` (the images to
    the device), `serve/forward`, `serve/decode` (top-k decode, the score
    kernel), `serve/nms` (the NMS kernel), `serve/fetch` (the counts and
    the levels' overflow flags to the host), `serve/fallback` (the full path
    after an overflow) and, with fast=False, `serve/full`. Nothing between
    copy-in and fetch makes the host wait on the device: `serve/forward`,
    `/decode` and `/nms` time the host's queueing of the batch,
    `serve/fetch` its wait for the device.

    `mesh` (parallel.mesh.Mesh): data-parallel serving. Each device of the
    mesh holds a replica of the model (and of the fused serving model), a
    batch's rows are split evenly over the devices, each runs its rows
    through the whole path (the score kernel three times and the NMS kernel
    once a shard), and the results are gathered on the mesh's first device,
    where the model must be (`Mesh.apply`). The batch falls back to the full
    path when any shard overflows. A batch the mesh does not divide runs
    unsharded on the first device (MicroBatcher's `min_bucket` keeps buckets
    divisible).

    `s2d` (the JAX package's space-to-depth stem, a TPU layout) is an exact
    transform: it is accepted and the plain layout computed.
    """
    full_model = model.eval()
    device = model.device
    if mesh is not None and mesh.devices[0] != device:
        raise ValueError(f"build_batched_infer: the model is on {device}, the mesh starts at {mesh.devices[0]}")
    nl = model.spec.nl
    k_per_scale = topk_per_level(nl, 640) if k_per_scale is None else k_per_scale
    serving = optimize_for_inference(model, bf16=True) if fast else None
    if mesh is None:
        full_fn, fast_fn = _paths(full_model, serving, conf_thres, iou_thres, max_det, k_per_scale)
    else:
        fulls, servings = mesh.replicas(full_model), mesh.replicas(serving) if fast else [None] * mesh.size
        paths = [_paths(f, sv, conf_thres, iou_thres, max_det, k_per_scale) for f, sv in zip(fulls, servings)]

        def full_fn(imgs_u8):
            return mesh.apply(lambda i, x: paths[i][0](x), imgs_u8)

        def fast_fn(imgs_u8):
            return mesh.apply(lambda i, x: paths[i][1](x), imgs_u8)
    if not fast:
        return span("serve/full")(full_fn)

    def infer(imgs_u8):
        with span("serve/copy_in"):
            imgs = torch.as_tensor(imgs_u8).to(device, non_blocking=True)
        dets, n, overflow = fast_fn(imgs)
        with span("serve/fetch"):  # one small device->host copy: per-image counts + each level's overflow-any flag
            meta = _host(torch.cat([n, overflow.any(0).to(torch.int32)]))
        levels = np.flatnonzero(meta[-nl:])
        if len(levels):
            LOGGER.info(f"serve: top-k candidate overflow at levels {levels.tolist()} — "
                        "falling back to full decode for this batch")
            infer.fallbacks += 1
            for i in levels:
                infer.level_overflows[i] += 1
            with span("serve/fallback"):
                return full_fn(imgs)
        return dets, meta[:-nl]

    infer.fast_fn, infer.full_fn = fast_fn, full_fn
    infer.serving_model = serving
    infer.fallbacks = 0
    infer.level_overflows = [0] * nl
    return infer


class MicroBatcher:
    """Dynamic request batching: coalesce concurrent predicts into one device call.

    Requests arriving within `batch_wait_ms` of the first queued item are
    stacked (up to `max_batch`), padded to the next bucket, executed once,
    and the rows are scattered back to the waiting threads. The buckets are
    min_bucket, 2 min_bucket, 4 min_bucket, ... below max_batch, then
    max_batch itself, or the next doubling where max_batch is not a multiple
    of min_bucket: sharded serving sets min_bucket to the mesh's size, so
    every bucket divides over it.

    Spans (utils/tracing.py), a device call each: `batcher/wait` (how long
    the oldest request of the call waited between `submit` and dispatch),
    `batcher/assemble` (the bucket, `np.stack` and padding), `batcher/call`
    (`infer`), `batcher/fetch` (the valid prefix to the host) and
    `batcher/scatter` (the rows back to the waiting threads).
    """

    def __init__(self, infer, max_batch=8, batch_wait_ms=5.0, min_bucket=1):
        if not 1 <= min_bucket <= max_batch:
            raise ValueError(f"MicroBatcher: need 1 <= min_bucket <= max_batch, got {min_bucket}, {max_batch}")
        self.infer = infer
        self.wait_s = batch_wait_ms / 1e3
        self.buckets = []
        b = min_bucket
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch if max_batch % min_bucket == 0 else b)
        self.max_batch = self.buckets[-1]
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
        self.q.put((im, slot, ev, time.perf_counter()))
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
            record("batcher/wait", time.perf_counter() - items[0][3])
            try:
                # stack inside the try: a malformed frame must fail its
                # waiters, not kill the dispatcher thread
                with span("batcher/assemble"):
                    bucket = next(b for b in self.buckets if b >= len(items))
                    batch = np.stack([it[0] for it in items] + [items[-1][0]] * (bucket - len(items)))
                with span("batcher/call"):
                    dets, n = self.infer(batch)
                with span("batcher/fetch"):  # rows are score-sorted valid-first: fetch only the valid prefix
                    n = _host(n)
                    dets = _host(dets[:, : int(n.max())])
            except Exception as e:  # noqa: BLE001 — fail every waiter, not the server
                for _, slot, ev, _ in items:
                    slot["err"] = e
                    ev.set()
                continue
            self.calls += 1
            self.requests += len(items)
            with span("batcher/scatter"):
                for i, (_, slot, ev, _) in enumerate(items):
                    slot["dets"] = dets[i, : int(n[i])].astype(np.float32)
                    slot["n"] = int(n[i])
                    ev.set()


def build_pipeline(model, imgsz=640, conf_thres=0.25, iou_thres=0.45, max_det=300, max_batch=1,
                   batch_wait_ms=5.0, fast=False, shard=False):
    """Single-image predict fn: letterbox (auto=False) -> BGR to RGB ->
    MicroBatcher -> `build_batched_infer` -> boxes scaled back to the
    image's pixels. predict(im_bgr (H, W, 3) uint8) -> (n, 6) float32;
    `predict.batcher` is the MicroBatcher. The fast path's top-k of each
    head level is `topk_per_level` of the model's levels at `imgsz`. The
    JAX package's automatic space-to-depth stem decides nothing here (the
    layout is plain).
    shard=True: data-parallel serving over every local card
    (parallel.mesh.create_mesh()), or over the devices of `shard` when it is
    a Mesh; the buckets start at the mesh's size. Spans (utils/tracing.py),
    a request each: `pipeline/letterbox` (letterbox, BGR to RGB, the
    contiguous copy) and `pipeline/scale_back`."""
    from yolov3_tpu_torch.data.augment import letterbox
    from yolov3_tpu_torch.ops.boxes import scale_boxes
    from yolov3_tpu_torch.parallel.mesh import Mesh, create_mesh

    mesh = None
    if shard:
        mesh = shard if isinstance(shard, Mesh) else create_mesh()
    min_bucket = mesh.size if mesh is not None else 1
    infer = build_batched_infer(model, conf_thres, iou_thres, max_det, fast=fast, mesh=mesh,
                                k_per_scale=topk_per_level(model.spec.nl, imgsz))
    batcher = MicroBatcher(infer, max_batch=max(max_batch, min_bucket), batch_wait_ms=batch_wait_ms,
                           min_bucket=min_bucket)

    def predict(im_bgr):
        h0, w0 = im_bgr.shape[:2]
        with span("pipeline/letterbox"):
            im = np.ascontiguousarray(letterbox(im_bgr, imgsz, auto=False)[0][:, :, ::-1])  # RGB
        dets, _n = batcher.submit(im)
        with span("pipeline/scale_back"):
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
                    "counters": {"infer.fallbacks": getattr(b.infer, "fallbacks", 0),
                                 "infer.level_overflows": list(getattr(b.infer, "level_overflows", [])),
                                 "greedy_nms.launches": greedy_nms.launches,
                                 "greedy_nms.route_launches": dict(greedy_nms.route_launches),
                                 "conv_epilogue.launches": conv_epilogue.launches,
                                 "conv_epilogue.route_launches": dict(conv_epilogue.route_launches),
                                 "conv_pool.launches": conv_pool.launches,
                                 "conv_pool.route_launches": dict(conv_pool.route_launches)},
                    "stages": stats(("batcher/", "pipeline/", "serve/")),
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
    p.add_argument("--shard", action="store_true", help="data-parallel serving over every local card")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args()
    serve(a.weights, a.host, a.port, a.imgsz, a.conf_thres, a.iou_thres,
          a.max_batch, a.batch_wait_ms, fast=not a.no_fast, shard=a.shard, device=a.device)


if __name__ == "__main__":
    main()
