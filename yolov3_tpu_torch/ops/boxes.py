"""Box format conversion and aligned-box IoU (yolov3_tpu/ops/boxes.py, the part the port calls)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x):
    """(cx,cy,w,h) center format -> (x1,y1,x2,y2) corners. Last axis size >=4."""
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    out = torch.stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], -1)
    return torch.cat([out, x[..., 4:]], -1)


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
