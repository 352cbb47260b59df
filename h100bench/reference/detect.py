"""Plain detection post-processing: candidate selection, greedy NMS, the
letterbox and the scale back to the image (ultralytics utils/general.py
non_max_suppression and scale_boxes, utils/augmentations.py letterbox).

Greedy NMS is class-aware by the published class-offset trick: each box is
shifted by class * 7680 before the IoU test.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WH = 7680


def xywh2xyxy(b):
    return torch.cat([b[..., :2] - b[..., 2:4] / 2, b[..., :2] + b[..., 2:4] / 2], -1)


def best_class(pred, conf):
    """Serving candidates: (boxes xyxy (B, N, 4), scores (B, N), classes (B, N));
    score = obj * max class probability, -1 unless it and obj pass `conf`."""
    obj = pred[..., 4]
    cls_p, cls = pred[..., 5:].max(-1)
    score = obj * cls_p
    score = torch.where((score > conf) & (obj > conf), score, torch.full_like(score, -1.0))
    return xywh2xyxy(pred[..., :4]), score, cls.float()


def multi_label(pred, conf, max_nms):
    """Validation candidates: every (anchor, class) whose obj * class
    probability and obj pass `conf`, the top `max_nms` by score."""
    bs, n, no = pred.shape
    nc = no - 5
    obj = pred[..., 4]
    scores = (pred[..., 5:] * obj[..., None]).reshape(bs, n * nc)
    valid = (scores > conf) & (obj.repeat_interleave(nc, 1) > conf)
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    k = min(max_nms, scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    boxes = torch.gather(xywh2xyxy(pred[..., :4]), 1, (idx // nc)[..., None].expand(-1, -1, 4))
    return boxes, top, (idx % nc).float()


def greedy_nms(boxes, scores, cls, iou_thres, max_det):
    """Greedy NMS of a batch: repeatedly keep the highest remaining score and
    drop every candidate of the same class whose IoU with it passes
    `iou_thres`. Scores <= 0 are empty slots. Returns (B, max_det, 6)
    [x1, y1, x2, y2, conf, cls] rows, zero-padded, and the kept counts."""
    B, K = scores.shape
    s = scores.float().clone()
    off = boxes + cls[..., None] * MAX_WH
    area = (off[..., 2] - off[..., 0]) * (off[..., 3] - off[..., 1])
    out = torch.zeros((B, max_det, 6), dtype=torch.float32, device=scores.device)
    rows = torch.arange(B, device=scores.device)
    for t in range(min(max_det, K)):
        i = s.argmax(1)
        best = s[rows, i]
        keep = best > 0
        if not bool(keep.any()):
            break
        sel = off[rows, i]
        out[:, t] = torch.where(keep[:, None], torch.cat([boxes[rows, i], best[:, None], cls[rows, i][:, None]], 1),
                                0.0)
        wh = (torch.minimum(sel[:, None, 2:], off[..., 2:]) - torch.maximum(sel[:, None, :2], off[..., :2])).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        sarea = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
        iou = inter / (sarea[:, None] + area - inter + 1e-7)
        s = torch.where((iou > iou_thres) & keep[:, None], torch.full_like(s, -1.0), s)
        s[rows, i] = -1.0
    return out, (out[..., 4] > 0).sum(1)


def letterbox(im, size=640, color=114):
    """Aspect-preserving resize of an HWC uint8 image into a size x size
    square, padded evenly with `color`: bilinear sampling at half-pixel
    centres (OpenCV's INTER_LINEAR geometry), rounded to uint8."""
    h0, w0 = im.shape[:2]
    r = min(size / h0, size / w0)
    w, h = round(w0 * r), round(h0 * r)
    dw, dh = (size - w) / 2, (size - h) / 2
    top, left = round(dh - 0.1), round(dw - 0.1)
    out = np.full((size, size, im.shape[2]), color, np.uint8)
    if (w, h) == (w0, h0):
        out[top:top + h, left:left + w] = im
        return out

    def axis(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(np.int64)
        a = f - i0
        a = np.where(i0 < 0, 0.0, a)
        i0 = np.clip(i0, 0, n_in - 1)
        a = np.where(i0 >= n_in - 1, 0.0, a)
        return i0, np.minimum(i0 + 1, n_in - 1), a

    y0, y1, ay = axis(h, h0)
    x0, x1, ax = axis(w, w0)
    src = im.astype(np.float64)
    rows = src[y0] * (1 - ay)[:, None, None] + src[y1] * ay[:, None, None]
    res = rows[:, x0] * (1 - ax)[None, :, None] + rows[:, x1] * ax[None, :, None]
    out[top:top + h, left:left + w] = np.clip(np.floor(res + 0.5), 0, 255).astype(np.uint8)
    return out


def scale_boxes(size, boxes, shape0):
    """xyxy boxes of the size x size letterbox back to the (h0, w0) image, clipped."""
    h0, w0 = shape0
    gain = min(size / h0, size / w0)
    padw, padh = (size - w0 * gain) / 2, (size - h0 * gain) / 2
    b = boxes.copy()
    b[:, [0, 2]] = ((b[:, [0, 2]] - padw) / gain).clip(0, w0)
    b[:, [1, 3]] = ((b[:, [1, 3]] - padh) / gain).clip(0, h0)
    return b
