"""Detect head and decode (yolov3_tpu/models/detect_head.py).

`Detect` holds one 1x1 conv per scale; output channel a*no + o is anchor a's
output o, the reference's view(bs, na, no, ny, nx) split (yolo.py:98). Its
raw form returns (B, ny, nx, na*no) NHWC views of the channels_last conv
outputs; `decode_topk_nhwc` reads them with the candidate-score kernel
(ops/score_cuda.py, csrc/score.cu) and decodes only the top-k candidates.
`forward(raw_pad=P)` is the JAX package's padded head layout (B, ny, nx,
na*P), read by `decode_topk_nhwc(padded_lanes=P)`; `decode_topk_candidates` takes the
5-D (B, na, ny, nx, no) maps of the eval head.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolov3_tpu_torch.ops.score_cuda import masked_scores


def detect_bias_init(nc: int, na: int, stride: float, imgsz: float = 640.0) -> torch.Tensor:
    """Objectness/class prior bias of one head conv, (na * (nc + 5),) float32
    (reference yolo.py:282-292): obj ~ log(8 objects / (imgsz/stride)^2
    cells), cls ~ log(0.6/(nc-1)). The JAX package's `detect_bias_init`
    returns a flax initializer of these values; the port's initialiser
    copies the tensor into the bias."""
    b = np.zeros((na, nc + 5), dtype=np.float32)
    b[:, 4] += math.log(8.0 / (imgsz / stride) ** 2)
    b[:, 5 : 5 + nc] += math.log(0.6 / (nc - 0.99999))
    return torch.from_numpy(b.reshape(-1))


PAD_BIAS = -20.0  # the pad lanes' logit (sigmoid ~2e-9), yolov3_tpu/models/detect_head.py _PadHeadConv


class Detect(nn.Module):
    """Per-scale 1x1 output convs (`m.{i}`)."""

    def __init__(self, nc, na, ch, strides):
        super().__init__()
        self.nc, self.na, self.no = nc, na, nc + 5
        self.strides = tuple(strides)
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in ch)

    def forward(self, xs, raw=False, raw_pad=0):
        """raw=False: (B, na, ny, nx, no) per scale, float32 in eval mode; in
        train mode the maps stay in the compute dtype, so the loss gathers
        before it upcasts and the head's cotangents are in that dtype too.
        raw=True: (B, ny, nx, na*no) in the compute dtype (serving fast path).
        raw_pad=P (P > 0 implies raw): (B, ny, nx, na*P) in the compute
        dtype, anchor a's no outputs at lanes [a*P, a*P + no) and the pad lanes
        at the logit -20, the JAX package's `Detect(raw_pad=P)` and
        `_PadHeadConv` (yolov3_tpu/models/detect_head.py:38-65). The convs'
        parameters are the unpadded head's: the padded weight is built per call."""
        pad = int(raw_pad)
        if pad:
            if pad < self.no:
                raise ValueError(f"Detect: raw_pad={pad} is narrower than the {self.no} outputs of an anchor")
            return tuple(self._padded(conv, x, pad) for conv, x in zip(self.m, xs))
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

    def _padded(self, conv, x, pad):
        na, no = self.na, self.no
        w = conv.weight.reshape(na, no, -1)
        w = F.pad(w, (0, 0, 0, pad - no)).reshape(na * pad, w.shape[-1], 1, 1)
        b = F.pad(conv.bias.reshape(na, no), (0, pad - no), value=PAD_BIAS).reshape(na * pad)
        return F.conv2d(x, w, b).permute(0, 2, 3, 1).contiguous()


def make_grid(ny: int, nx: int, device=None):
    """(1, 1, ny, nx, 2) xy cell grid with the -0.5 offset baked in (reference yolo.py:112-123)."""
    yv, xv = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                            torch.arange(nx, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xv, yv], -1).reshape(1, 1, ny, nx, 2) - 0.5


def _anchor_table(anchors, nl, device):
    """(nl, na, 2) float32 pixel anchors on `device`. A float32 tensor already
    there (a model's `anchor_table()`, which every entry point hands in) is
    only reshaped; numpy or a list is copied there, and on a CUDA device the
    host then waits for the stream."""
    return torch.as_tensor(anchors, dtype=torch.float32, device=device).reshape(nl, -1, 2)


def decode_predictions(feats, anchors, strides):
    """Decode raw Detect features to (bs, sum(na*ny*nx), no) xywh+obj+cls.

      xy = (sigmoid(t_xy) * 2 + grid) * stride
      wh = (sigmoid(t_wh) * 2)^2 * anchor_px
      conf = sigmoid(t_conf)

    feats: (bs, na, ny, nx, no) per scale; anchors: (nl, na, 2) pixel anchors,
    numpy or a float32 tensor on the features' device.
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
                     with_overflow=False, score_fn=masked_scores, padded_lanes=0, overflow_per_level=False):
    """Per-scale top-k candidates from raw NHWC head outputs (B, ny, nx, na*no).

    The flat candidate index runs in (y, x, a) order, the memory order of the
    head output. Per scale: `score_fn` gives the masked scores (obj*cls_max,
    -1 unless both > conf_thres) and the class argmax; a stable descending
    sort takes the top k (ties: lowest index first, as lax.top_k); only those
    k rows are decoded. `score_fn` is the kernel wrapper unless a caller
    hands in the plain version to compare with it.

    `padded_lanes=P` reads the padded layout of `Detect`'s `raw_pad=P`,
    (B, ny, nx, na*P): the same kernel runs on its rows with no = P, so the
    class max and argmax run over lanes [5, P), pad lanes included, as the
    JAX package's padded decode reduces (detect_head.py:276ff). A pad lane's
    logit -20 wins no max that passes conf_thres, so the candidates, their
    flat order and their classes are the plain layout's.

    `anchors`: (nl, na, 2) pixel anchors, numpy or a float32 tensor on the
    features' device (`_anchor_table`).

    Returns (boxes_xyxy (B, K, 4), scores (B, K), cls_ids (B, K)), invalid
    slots at score -1, K = sum of the per-scale k. `with_overflow=True` adds
    a (B,) bool, True where a scale had more valid candidates than its k;
    with `overflow_per_level=True` it is (B, nl), one flag a scale.
    """
    def rows(f, na):
        bs, ny, nx, ch = f.shape
        if padded_lanes and ch != na * int(padded_lanes):
            raise ValueError(f"decode_topk_nhwc: {tuple(f.shape)} is not the padded layout of {na} anchors x "
                             f"{padded_lanes} lanes")
        return f.reshape(bs, ny * nx, ch), ch // na, ny, nx

    return _decode_topk_scales(feats_raw, anchors, strides, k_per_scale, conf_thres, with_overflow, score_fn,
                               rows, anchor_major=False, overflow_per_level=overflow_per_level)


def decode_topk_candidates(feats, anchors, strides, k_per_scale=(256, 128, 64), conf_thres=0.25,
                           with_overflow=False, score_fn=masked_scores):
    """`decode_topk_nhwc` for the 5-D maps of the eval head, (B, na, ny, nx, no)
    per scale (yolov3_tpu/models/detect_head.py:134): the same candidates,
    with the flat index in (a, y, x) order, the JAX function's, which orders
    the top-k's ties. The maps are laid out as (B, ny*nx, na*no) rows for the
    candidate-score kernel, whose scores are then read in (a, y, x) order.
    Same returns as `decode_topk_nhwc`."""

    def rows(f, na):
        bs, _, ny, nx, no = f.shape
        return f.permute(0, 2, 3, 1, 4).reshape(bs, ny * nx, na * no), no, ny, nx

    return _decode_topk_scales(feats, anchors, strides, k_per_scale, conf_thres, with_overflow, score_fn, rows,
                               anchor_major=True)


def _decode_topk_scales(feats, anchors, strides, k_per_scale, conf_thres, with_overflow, score_fn, rows,
                        anchor_major, overflow_per_level=False):
    """The top-k decode of every scale. `rows(f, na)` gives ((B, ny*nx, na*no)
    rows in (y, x, a) order, no, ny, nx); the candidates are sorted in (y, x,
    a) order, or in (a, y, x) order when `anchor_major`."""
    anchors = _anchor_table(anchors, len(feats), feats[0].device)
    na = anchors.shape[1]
    boxes_all, scores_all, cls_all, overflow = [], [], [], []
    for i, f in enumerate(feats):
        flat, no, ny, nx = rows(f, na)
        bs, m = flat.shape[:2]
        k = min(int(k_per_scale[min(i, len(k_per_scale) - 1)]), na * m)

        masked, cls_arg = score_fn(flat, na, no, conf_thres)  # (bs, m*na) in (y, x, a) order
        if with_overflow:  # valid <=> score stored (score > conf >= 0)
            overflow.append((masked > 0).sum(1) > k)
        if anchor_major:
            masked = masked.reshape(bs, m, na).transpose(1, 2).reshape(bs, na * m)

        top_s, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        if anchor_major:
            a_idx, yx = top_i // m, top_i % m
            r = yx * na + a_idx  # the row in (y, x, a) order
        else:
            a_idx, yx, r = top_i % na, top_i // na, top_i
        y_idx, x_idx = yx // nx, yx % nx

        txywh = torch.gather(flat.reshape(bs, m * na, no)[..., :4], 1, r[..., None].expand(-1, -1, 4))
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
        cls_all.append(torch.gather(cls_arg, 1, r).float())

    out = (torch.cat(boxes_all, 1), torch.cat(scores_all, 1), torch.cat(cls_all, 1))
    if not with_overflow:
        return out
    overflow = torch.stack(overflow, 1)
    return out + (overflow if overflow_per_level else overflow.any(1),)
