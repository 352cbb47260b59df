"""Detect head and decode (yolov3_tpu/models/detect_head.py).

`Detect` holds one 1x1 conv per scale; output channel a*no + o is anchor a's
output o, the reference's view(bs, na, no, ny, nx) split (yolo.py:98). Its
raw form returns (B, ny, nx, na*no) NHWC views of the channels_last conv
outputs; `decode_topk_nhwc` reads them with the candidate-score kernel
(ops/score_cuda.py, csrc/score.cu) and decodes only the top-k candidates.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from yolov3_tpu_torch.ops.score_cuda import masked_scores


def detect_bias(nc: int, na: int, stride: float) -> torch.Tensor:
    """Objectness/class prior bias (reference yolo.py:282-292):
    obj ~ log(8 objects / (640/stride)^2 cells), cls ~ log(0.6/(nc-1))."""
    b = np.zeros((na, nc + 5), dtype=np.float32)
    b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
    b[:, 5 : 5 + nc] += math.log(0.6 / (nc - 0.99999))
    return torch.from_numpy(b.reshape(-1))


class Detect(nn.Module):
    """Per-scale 1x1 output convs (`m.{i}`)."""

    def __init__(self, nc, na, ch, strides):
        super().__init__()
        self.nc, self.na, self.no = nc, na, nc + 5
        self.strides = tuple(strides)
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in ch)

    def forward(self, xs, raw=False):
        """raw=False: (B, na, ny, nx, no) per scale, float32 in eval mode; in
        train mode the maps stay in the compute dtype, so the loss gathers
        before it upcasts and the head's cotangents are in that dtype too.
        raw=True: (B, ny, nx, na*no) in the compute dtype (serving fast path)."""
        outs = []
        for conv, x in zip(self.m, xs):
            y = conv(x).permute(0, 2, 3, 1)  # NHWC: a free view of a channels_last output
            if raw:
                outs.append(y.contiguous())
                continue
            bs, ny, nx, _ = y.shape
            y = y.reshape(bs, ny, nx, self.na, self.no).permute(0, 3, 1, 2, 4)
            outs.append(y if self.training else y.float())
        return tuple(outs)


def make_grid(ny: int, nx: int, device=None):
    """(1, 1, ny, nx, 2) xy cell grid with the -0.5 offset baked in (reference yolo.py:112-123)."""
    yv, xv = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                            torch.arange(nx, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xv, yv], -1).reshape(1, 1, ny, nx, 2) - 0.5


def _anchor_table(anchors, nl, device):
    return torch.as_tensor(np.asarray(anchors, np.float32), device=device).reshape(nl, -1, 2)


def decode_predictions(feats, anchors, strides):
    """Decode raw Detect features to (bs, sum(na*ny*nx), no) xywh+obj+cls.

      xy = (sigmoid(t_xy) * 2 + grid) * stride
      wh = (sigmoid(t_wh) * 2)^2 * anchor_px
      conf = sigmoid(t_conf)

    feats: (bs, na, ny, nx, no) per scale; anchors: (nl, na, 2) pixel anchors.
    """
    anchors = _anchor_table(anchors, len(feats), feats[0].device)
    z = []
    for i, f in enumerate(feats):
        bs, na, ny, nx, no = f.shape
        sig = torch.sigmoid(f.float())
        xy = (sig[..., :2] * 2 + make_grid(ny, nx, f.device)) * strides[i]
        wh = (sig[..., 2:4] * 2) ** 2 * anchors[i].reshape(1, na, 1, 1, 2)
        z.append(torch.cat([xy, wh, sig[..., 4:]], -1).reshape(bs, na * ny * nx, no))
    return torch.cat(z, 1)


def decode_topk_nhwc(feats_raw, anchors, strides, k_per_scale=(256, 128, 64), conf_thres=0.25,
                     with_overflow=False, score_fn=masked_scores):
    """Per-scale top-k candidates from raw NHWC head outputs (B, ny, nx, na*no).

    The flat candidate index runs in (y, x, a) order, the memory order of the
    head output. Per scale: `score_fn` gives the masked scores (obj*cls_max,
    -1 unless both > conf_thres) and the class argmax; a stable descending
    sort takes the top k (ties: lowest index first, as lax.top_k); only those
    k rows are decoded. `score_fn` is the kernel wrapper unless a caller
    hands in the plain version to compare with it.

    Returns (boxes_xyxy (B, K, 4), scores (B, K), cls_ids (B, K)), invalid
    slots at score -1, K = sum of the per-scale k. `with_overflow=True` adds
    a (B,) bool, True where a scale had more valid candidates than its k.
    """
    anchors = _anchor_table(anchors, len(feats_raw), feats_raw[0].device)
    na = anchors.shape[1]
    boxes_all, scores_all, cls_all = [], [], []
    overflow = None
    for i, f in enumerate(feats_raw):
        bs, ny, nx, ch = f.shape
        no = ch // na
        k = min(int(k_per_scale[min(i, len(k_per_scale) - 1)]), na * ny * nx)

        masked, cls_arg = score_fn(f.reshape(bs, ny * nx, ch), na, no, conf_thres)
        if with_overflow:  # valid <=> score stored (score > conf >= 0)
            ov = (masked > 0).sum(1) > k
            overflow = ov if overflow is None else overflow | ov

        top_s, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        a_idx = top_i % na
        y_idx = top_i // (na * nx)
        x_idx = (top_i // na) % nx

        flat = f.reshape(bs, ny * nx * na, no)
        txywh = torch.gather(flat[..., :4], 1, top_i[..., None].expand(-1, -1, 4))
        sig = torch.sigmoid(txywh.float())
        gx = x_idx.float() - 0.5
        gy = y_idx.float() - 0.5
        cx = (sig[..., 0] * 2 + gx) * strides[i]
        cy = (sig[..., 1] * 2 + gy) * strides[i]
        awh = anchors[i][a_idx]  # (bs, k, 2)
        w = (sig[..., 2] * 2) ** 2 * awh[..., 0]
        h = (sig[..., 3] * 2) ** 2 * awh[..., 1]
        boxes_all.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
        scores_all.append(top_s)
        cls_all.append(torch.gather(cls_arg, 1, top_i).float())

    out = (torch.cat(boxes_all, 1), torch.cat(scores_all, 1), torch.cat(cls_all, 1))
    return out + (overflow,) if with_overflow else out
