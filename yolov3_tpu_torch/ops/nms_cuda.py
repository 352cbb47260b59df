"""Batched greedy NMS: the CUDA kernel of csrc/nms.cu and its plain version.

Replaces the TPU kernel `_nms_kernel` / `pallas_greedy_nms` of
yolov3_tpu/ops/nms_pallas.py; the kernel's design and bound are described in
csrc/nms.cu. The plain version is the JAX `_greedy_nms` loop
(ops/nms.py:46-77) with the batch dimension written out.
"""

from __future__ import annotations

import ctypes

import torch

from yolov3_tpu_torch.ops import cuda_build


def greedy_nms_plain(boxes_off, boxes, scores, cls_ids, iou_thres=0.45, max_det=300):
    """Plain PyTorch greedy NMS; same arguments and results as `greedy_nms`."""
    B, K = scores.shape
    s = scores.float().clone()
    out = torch.zeros((B, max_det, 6), dtype=torch.float32, device=scores.device)
    rows = torch.arange(B, device=scores.device)
    x1, y1, x2, y2 = boxes_off.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    for t in range(min(max_det, K)):
        i = s.argmax(1)  # lowest index of the max
        smax = s[rows, i]
        valid = smax > 0.0
        if not bool(valid.any()):
            break
        sel = boxes_off[rows, i]  # (B, 4)
        row = torch.cat([boxes[rows, i], smax[:, None], cls_ids[rows, i][:, None]], 1)
        out[:, t] = torch.where(valid[:, None], row, 0.0)
        lt = torch.maximum(sel[:, None, :2], boxes_off[..., :2])
        rb = torch.minimum(sel[:, None, 2:4], boxes_off[..., 2:4])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        sarea = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
        iou = inter / (sarea[:, None] + area - inter + 1e-7)
        s = torch.where((iou > iou_thres) & valid[:, None], -1.0, s)
        s[rows, i] = -1.0
    return out, (out[..., 4] > 0).sum(1).to(torch.int32)


# greedy_nms_route(K) of csrc/nms.cu: which kernel a launch at K candidates takes
ROUTES = {1: "one or four warps per image, candidates in registers",
          2: "block per image, candidates in shared memory",
          3: "block per image, candidates in global memory"}


def greedy_nms(boxes_off, boxes, scores, cls_ids, iou_thres=0.45, max_det=300):
    """Greedy NMS over prefiltered candidates.

    boxes_off: (B, K, 4) class-offset xyxy boxes (suppression geometry);
    boxes: (B, K, 4) xyxy boxes written to the output; scores: (B, K), invalid
    slots <= 0; cls_ids: (B, K) class ids as floats.
    Returns out (B, max_det, 6) f32 rows [x1, y1, x2, y2, conf, cls] in
    descending score order, zero past the last detection, and n (B,) int32.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one of `ROUTES`, chosen from K; `greedy_nms.last_route` names it).
    """
    if scores.device.type == "cpu":
        return greedy_nms_plain(boxes_off, boxes, scores, cls_ids, iou_thres, max_det)
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {scores.device}")
    B, K = scores.shape
    if K < 1 or boxes_off.shape != (B, K, 4) or boxes.shape != (B, K, 4) or cls_ids.shape != (B, K):
        raise ValueError(f"greedy_nms: shapes {tuple(boxes_off.shape)}, {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(cls_ids.shape)} are not (B,K,4)x2, (B,K)x2")
    boxes_off, boxes, scores, cls_ids = (
        x.to(torch.float32).contiguous() for x in (boxes_off, boxes, scores, cls_ids))
    device = scores.device
    out = torch.empty((B, max_det, 6), dtype=torch.float32, device=device)
    n = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return out, n
    if max_det < 1:
        raise ValueError(f"greedy_nms: max_det is {max_det}")
    lib = _library()
    route = lib.greedy_nms_route(K)
    # only the global-memory kernel keeps its live scores in a scratch buffer
    live = torch.empty((B, K), dtype=torch.float32, device=device) if route == 3 else None
    with torch.cuda.device(device):
        err = lib.greedy_nms_launch(
            boxes_off.data_ptr(), boxes.data_ptr(), scores.data_ptr(), cls_ids.data_ptr(),
            None if live is None else live.data_ptr(), out.data_ptr(), n.data_ptr(), B, K, int(max_det),
            float(iou_thres), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"greedy_nms kernel launch failed: cudaError {err}")
    greedy_nms.launches += 1
    greedy_nms.last_route = ROUTES[route]
    return out, n


greedy_nms.launches = 0
greedy_nms.last_route = None


def _library():
    lib = cuda_build.load("nms")
    fn = lib.greedy_nms_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.greedy_nms_route.argtypes = [ctypes.c_int]
        lib.greedy_nms_route.restype = ctypes.c_int
    return lib
