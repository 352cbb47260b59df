"""Box format conversion (yolov3_tpu/ops/boxes.py, the part the port calls)."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """(cx,cy,w,h) center format -> (x1,y1,x2,y2) corners. Last axis size >=4."""
    hw = x[..., 2] / 2
    hh = x[..., 3] / 2
    out = torch.stack([x[..., 0] - hw, x[..., 1] - hh, x[..., 0] + hw, x[..., 1] + hh], -1)
    return torch.cat([out, x[..., 4:]], -1)
