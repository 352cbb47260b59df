"""Batched NMS (yolov3_tpu/ops/nms.py): candidate prep in PyTorch, greedy
suppression in the CUDA kernel (ops/nms_cuda.py).

conf = obj * cls (reference general.py:702), candidates above `conf_thres`,
best-class or multi-label expansion, a top-`max_nms` prefilter by score,
then exact greedy NMS with the class-offset trick (c * 7680, general.py:731),
and, with `merge=True`, the IoU-weighted box merge (general.py:735-742) in
plain tensor ops after the kernel. `non_max_suppression` is the host-facing
form: arrays in, a list of (n, 6) arrays out, apriori labels injected.
"""

from __future__ import annotations

import numpy as np
import torch

from yolov3_tpu_torch.ops.boxes import xywh2xyxy
from yolov3_tpu_torch.ops.nms_cuda import greedy_nms
from yolov3_tpu_torch.utils.general import select_device

MAX_WH = 7680  # maximum box width/height used for the class offset


def batched_nms(prediction, conf_thres=0.25, iou_thres=0.45, classes=None, agnostic=False,
                multi_label=False, max_det=300, max_nms=30000, merge=False, nms_fn=None):
    """Batched NMS over decoded predictions.

    prediction: (bs, N, 5+nc) decoded [xywh, obj, cls...].
    Returns out (bs, max_det, 6) [xyxy, conf, cls], zero-padded, and
    n_valid (bs,) int32. `nms_fn` is the kernel wrapper `greedy_nms` (looked
    up when called) unless a caller hands in the plain version to compare.
    `merge`: weighted-mean merge-NMS over the candidates (`merge_boxes`).
    """
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
    top_box_off = top_box + offset[..., None]
    out, n_valid = (nms_fn or greedy_nms)(top_box_off, top_box, top_scores, top_cls, iou_thres, max_det)
    if merge:
        return merge_boxes(out, n_valid, top_box_off, top_box, top_scores, iou_thres, agnostic)
    return out, n_valid


def merge_boxes(out, n_valid, top_box_off, top_box, top_scores, iou_thres=0.45, agnostic=False):
    """Merge-NMS after the greedy pass (yolov3_tpu/ops/nms.py:216-246,
    reference general.py:735-742), one image at a time so the (max_det, K)
    overlap matrix of one image is the largest tensor.

    Each kept box becomes the score-weighted mean of the candidates it
    overlaps above `iou_thres` (class-offset geometry); a kept box that
    overlaps no candidate but itself is dropped (the `redundant` filter).
    Both apply only where the image has 1 < candidates < 3000. Survivors are
    compacted to the front, so rows stay valid-first and score-sorted.
    """
    rows, counts = [], []
    for b in range(out.shape[0]):
        o, bo, bx, sc = out[b], top_box_off[b], top_box[b], top_scores[b]
        valid_cand = sc > 0
        n_cand = valid_cand.sum()
        sel_off = o[:, :4] if agnostic else o[:, :4] + o[:, 5:6] * MAX_WH
        lt = torch.maximum(sel_off[:, None, :2], bo[None, :, :2])
        rb = torch.minimum(sel_off[:, None, 2:4], bo[None, :, 2:4])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        a1 = (sel_off[:, 2] - sel_off[:, 0]) * (sel_off[:, 3] - sel_off[:, 1])
        a2 = (bo[:, 2] - bo[:, 0]) * (bo[:, 3] - bo[:, 1])
        iou = inter / (a1[:, None] + a2[None, :] - inter + 1e-7)
        ov = (iou > iou_thres) & valid_cand[None, :]  # (max_det, K)
        w = ov * sc.clamp(min=0.0)[None, :]
        merged = torch.matmul(w, bx) / w.sum(1, keepdim=True).clamp(min=1e-7)
        has = o[:, 4] > 0
        do = (n_cand > 1) & (n_cand < 3000)
        o = torch.cat([torch.where((do & has)[:, None], merged, o[:, :4]), o[:, 4:]], 1)
        keep = has & torch.where(do, ov.sum(1) > 1, True)
        order = torch.argsort((~keep).to(torch.uint8), stable=True)
        rows.append(o[order] * keep[order][:, None])
        counts.append(keep.sum())
    return torch.stack(rows), torch.stack(counts).to(n_valid.dtype)


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


def _inject_apriori_labels(pred, labels):
    """Append apriori label rows [cls, x, y, w, h] (pixels) as candidates of
    confidence 1 (hybrid autolabelling, reference general.py:689-695)."""
    nc = pred.shape[2] - 5
    extra = max(len(lb) for lb in labels)
    pads = []
    for lb in labels:
        v = np.zeros((extra, 5 + nc), dtype=np.float32)
        if len(lb):
            lb = np.asarray(lb, dtype=np.float32)
            v[: len(lb), :4] = lb[:, 1:5]
            v[: len(lb), 4] = 1.0
            v[np.arange(len(lb)), lb[:, 0].astype(int) + 5] = 1.0
        pads.append(v)
    return np.concatenate([pred, np.stack(pads)], axis=1)


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45, classes=None, agnostic=False,
                        multi_label=False, labels=(), max_det=300, max_nms=30000, merge=False, engine="auto",
                        device=None, nms_fn=None):
    """Host-facing NMS (yolov3_tpu/ops/nms.py:350-407): the reference's list
    of (n, 6) float32 arrays [xyxy, conf, cls], one per image.

    `prediction`: (bs, N, 5+nc) decoded predictions, a tensor or an array,
    or the (inference, train_out) tuple of a val-mode model. `labels`: per
    image (m, 5) [cls, x, y, w, h] in pixels, injected as candidates of
    confidence 1 (general.py:689-695). The prediction goes to
    `select_device(device)` (None means "cuda") and through `batched_nms`
    there, so the suppression is the NMS kernel on the card.

    `engine`: "auto" (or the JAX package's "xla") runs `batched_nms`; the
    JAX package's "native" host C++ loop is not ported (ROADMAP.md queue 1
    item 10). `nms_fn` as in `batched_nms`.
    """
    if engine == "native":
        raise NotImplementedError("non_max_suppression: engine='native' (the host C++ greedy NMS of "
                                  "yolov3_tpu/native) is not ported yet (ROADMAP.md queue 1 item 10)")
    if engine not in ("auto", "xla"):
        raise ValueError(f"non_max_suppression: unknown engine {engine!r}")
    if isinstance(prediction, (list, tuple)):
        prediction = prediction[0]
    device = select_device(device)
    if labels and any(len(lb) for lb in labels):
        host = prediction.float().cpu().numpy() if isinstance(prediction, torch.Tensor) else prediction
        prediction = _inject_apriori_labels(np.asarray(host, dtype=np.float32), labels)
    prediction = torch.as_tensor(prediction).to(device=device, dtype=torch.float32)
    out, n_valid = batched_nms(prediction, conf_thres=float(conf_thres), iou_thres=float(iou_thres),
                               classes=classes, agnostic=bool(agnostic), multi_label=bool(multi_label),
                               max_det=int(max_det), max_nms=int(max_nms), merge=bool(merge), nms_fn=nms_fn)
    n_valid = n_valid.cpu().numpy()
    out = out[:, : int(n_valid.max(initial=0))].cpu().numpy()
    return [out[i, : n_valid[i]] for i in range(out.shape[0])]
