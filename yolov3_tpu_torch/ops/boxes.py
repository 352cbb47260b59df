"""Box geometry (yolov3_tpu/ops/boxes.py).

Each function takes numpy arrays (the validator's host loop) or torch
tensors (the decode and the loss) and returns the same kind.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _xp(x):
    """numpy for numpy input, torch for tensors."""
    return np if isinstance(x, np.ndarray) else torch


def xyxy2xywh(x):
    """(x1,y1,x2,y2) corners -> (cx,cy,w,h) center format. Last axis size >=4."""
    xp = _xp(x)
    cx = (x[..., 0] + x[..., 2]) / 2
    cy = (x[..., 1] + x[..., 3]) / 2
    w = x[..., 2] - x[..., 0]
    h = x[..., 3] - x[..., 1]
    return xp.concatenate([xp.stack([cx, cy, w, h], -1), x[..., 4:]], -1)


def xywh2xyxy(x):
    """(cx,cy,w,h) center format -> (x1,y1,x2,y2) corners. Last axis size >=4."""
    xp = _xp(x)
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    out = xp.stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], -1)
    return xp.concatenate([out, x[..., 4:]], -1)


def xywhn2xyxy(x, w=640, h=640, padw=0, padh=0):
    """Normalized (cx,cy,w,h) -> pixel (x1,y1,x2,y2) with optional letterbox pad offsets."""
    xp = _xp(x)
    x1 = w * (x[..., 0] - x[..., 2] / 2) + padw
    y1 = h * (x[..., 1] - x[..., 3] / 2) + padh
    x2 = w * (x[..., 0] + x[..., 2] / 2) + padw
    y2 = h * (x[..., 1] + x[..., 3] / 2) + padh
    return xp.concatenate([xp.stack([x1, y1, x2, y2], -1), x[..., 4:]], -1)


def xyxy2xywhn(x, w=640, h=640, clip=False, eps=0.0):
    """Pixel (x1,y1,x2,y2) -> normalized (cx,cy,w,h), clipped to (w - eps, h - eps) first if asked."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    xp = _xp(x)
    cx = ((x[..., 0] + x[..., 2]) / 2) / w
    cy = ((x[..., 1] + x[..., 3]) / 2) / h
    bw = (x[..., 2] - x[..., 0]) / w
    bh = (x[..., 3] - x[..., 1]) / h
    return xp.concatenate([xp.stack([cx, cy, bw, bh], -1), x[..., 4:]], -1)


def xyn2xy(x, w=640, h=640, padw=0, padh=0):
    """Normalized points (n,2) -> pixel points."""
    xp = _xp(x)
    return xp.stack([w * x[..., 0] + padw, h * x[..., 1] + padh], -1)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to image bounds. `shape` is (height, width)."""
    xp = _xp(boxes)
    x1 = xp.clip(boxes[..., 0], 0, shape[1])
    y1 = xp.clip(boxes[..., 1], 0, shape[0])
    x2 = xp.clip(boxes[..., 2], 0, shape[1])
    y2 = xp.clip(boxes[..., 3], 0, shape[0])
    return xp.concatenate([xp.stack([x1, y1, x2, y2], -1), boxes[..., 4:]], -1)


def scale_boxes(img1_shape, boxes, img0_shape, ratio_pad=None):
    """Rescale xyxy boxes from letterboxed `img1_shape` (h,w) back to native `img0_shape`:
    gain = min(h1/h0, w1/w0), symmetric padding, then clip (reference utils/general.py:613-628)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (img1_shape[1] - img0_shape[1] * gain) / 2, (img1_shape[0] - img0_shape[0] * gain) / 2
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    xp = _xp(boxes)
    out = xp.stack([(boxes[..., 0] - pad[0]) / gain, (boxes[..., 1] - pad[1]) / gain,
                    (boxes[..., 2] - pad[0]) / gain, (boxes[..., 3] - pad[1]) / gain], -1)
    return clip_boxes(xp.concatenate([out, boxes[..., 4:]], -1), img0_shape)


def box_iou(box1, box2, eps=1e-7):
    """Pairwise IoU of two xyxy box sets: (n,4) x (m,4) -> (n,m)."""
    xp = _xp(box1)
    lt = xp.maximum(box1[:, None, :2], box2[None, :, :2])  # (n,m,2)
    rb = xp.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def bbox_iou(box1, box2, xywh=True, GIoU=False, DIoU=False, CIoU=False, eps=1e-7):
    """Elementwise IoU/GIoU/DIoU/CIoU of aligned boxes (broadcastable last-dim-4 tensors).

    The math of the JAX package's `bbox_iou`; CIoU's `alpha` carries no gradient."""
    if xywh:
        x1, y1, w1, h1 = box1.unbind(-1)
        x2, y2, w2, h2 = box2.unbind(-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
        b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
        w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
        w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps

    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # convex height
    if CIoU or DIoU:
        c2 = cw**2 + ch**2 + eps  # convex diagonal squared
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def wh_iou(wh1, wh2, eps=1e-7):
    """IoU of width-height pairs of co-centred boxes: (n,2) x (m,2) -> (n,m)."""
    xp = _xp(wh1)
    inter = xp.minimum(wh1[:, None, 0], wh2[None, :, 0]) * xp.minimum(wh1[:, None, 1], wh2[None, :, 1])
    return inter / (wh1[:, 0:1] * wh1[:, 1:2] + (wh2[:, 0] * wh2[:, 1])[None] - inter + eps)


def bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2's area: (n,4) x (m,4) xyxy -> (n,m)."""
    xp = _xp(box1)
    lt = xp.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = xp.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None] + eps)
