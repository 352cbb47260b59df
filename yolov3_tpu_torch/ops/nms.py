"""Batched NMS (yolov3_tpu/ops/nms.py): candidate prep in PyTorch, greedy
suppression in the CUDA kernel (ops/nms_cuda.py).

conf = obj * cls (reference general.py:702), candidates above `conf_thres`,
best-class or multi-label expansion, a top-`max_nms` prefilter by score,
then exact greedy NMS with the class-offset trick (c * 7680, general.py:731).
"""

from __future__ import annotations

import torch

from yolov3_tpu_torch.ops.boxes import xywh2xyxy
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms

MAX_WH = 7680  # maximum box width/height used for the class offset


def batched_nms(prediction, conf_thres=0.25, iou_thres=0.45, classes=None, agnostic=False,
                multi_label=False, max_det=300, max_nms=30000, merge=False, nms_fn=None):
    """Batched NMS over decoded predictions.

    prediction: (bs, N, 5+nc) decoded [xywh, obj, cls...].
    Returns out (bs, max_det, 6) [xyxy, conf, cls], zero-padded, and
    n_valid (bs,) int32. `nms_fn` is the kernel wrapper `greedy_nms` (looked
    up when called) unless a caller hands in the plain version to compare.
    """
    if merge:
        raise NotImplementedError("merge-NMS is not ported yet")
    prediction = prediction.float()
    bs, n, no = prediction.shape
    nc = no - 5
    device = prediction.device
    box = xywh2xyxy(prediction[..., :4])  # (bs, N, 4)
    obj = prediction[..., 4]
    cls_scores = prediction[..., 5:] * obj[..., None]  # conf = obj * cls

    if multi_label and nc > 1:
        scores = cls_scores.reshape(bs, -1)  # (bs, N*nc)
        cls_ids = torch.arange(nc, dtype=torch.float32, device=device).repeat(n)
        box_idx = torch.arange(n, device=device).repeat_interleave(nc)
        valid = (scores > conf_thres) & (obj[:, box_idx] > conf_thres)
    else:
        scores = cls_scores.amax(2)
        cls_ids = cls_scores.argmax(2).float()
        box_idx = torch.arange(n, device=device)
        valid = (scores > conf_thres) & (obj > conf_thres)
    cls_ids = cls_ids.expand(bs, -1)

    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=device)
        allowed[list(classes)] = True
        valid &= allowed[cls_ids.long()]

    masked = torch.where(valid, scores, -1.0)
    k = min(max_nms, masked.shape[1])
    # stable descending sort: ties keep the lowest index first, as lax.top_k
    top_scores, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, top_i = top_scores[:, :k], top_i[:, :k]
    top_box = torch.gather(box, 1, box_idx[top_i][..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_ids, 1, top_i)
    offset = torch.zeros_like(top_cls) if agnostic else top_cls * MAX_WH
    nms_fn = nms_fn or greedy_nms
    return nms_fn(top_box + offset[..., None], top_box, top_scores, top_cls, iou_thres, max_det)


def nms_from_candidates(boxes, scores, cls_ids, iou_thres=0.45, max_det=300, agnostic=False,
                        nms_fn=greedy_nms):
    """Greedy NMS over pre-extracted candidates (bs, K, ...), the fast path fed
    by `decode_topk_nhwc`. Scores <= 0 mark invalid slots. `nms_fn` is the
    kernel wrapper unless a caller hands in the plain version to compare.

    Returns (out (bs, max_det, 6), n_valid (bs,)).
    """
    offset = torch.zeros_like(cls_ids) if agnostic else cls_ids * MAX_WH
    scores = torch.where(scores > 0, scores, -1.0)
    return nms_fn(boxes + offset[..., None], boxes, scores, cls_ids, iou_thres, max_det)
