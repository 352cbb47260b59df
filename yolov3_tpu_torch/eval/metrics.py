"""Detection metrics: AP computation, confusion matrix, fitness (pure numpy,
host-side): the port's own copy of yolov3_tpu/eval/metrics.py.

Semantics parity with the reference metric stack (reference utils/metrics.py
and the ultralytics ap_per_class it imports): per-class PR curves interpolated
at 1000 confidence points, 101-point COCO AP integration, operating point at
max smoothed F1, fitness = 0.1*mAP50 + 0.9*mAP50-95 (metrics.py:15-18).
These run on the host after detections come back from the card; they are
O(detections).
"""

from __future__ import annotations

import numpy as np

from yolov3_tpu_torch.ops.boxes import box_iou


def fitness(x):
    """Weighted fitness of [P, R, mAP@.5, mAP@.5:.95] rows (reference metrics.py:15-18)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (np.asarray(x)[:, :4] * w).sum(1)


def smooth(y, f=0.05):
    """Box-filter smoothing with reflected ends; fraction f of curve length."""
    nf = round(len(y) * f * 2) // 2 + 1  # odd element count
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """101-point interpolated AP from PR points (COCO convention).

    Returns (ap, mpre, mrec) with the precision envelope applied.
    """
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))  # precision envelope
    x = np.linspace(0, 1, 101)
    trapezoid = np.trapezoid if hasattr(np, "trapezoid") else np.trapz  # numpy<2 compat
    ap = trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16, curves=False):
    """Per-class AP at each IoU threshold + P/R/F1 at the max-F1 operating point.

    Args:
        tp: (n_det, n_iou) bool TP matrix from `process_batch`.
        conf: (n_det,) detection confidences.
        pred_cls: (n_det,) predicted class ids.
        target_cls: (n_gt,) ground-truth class ids.

    Returns:
        (tp_count, fp_count, p, r, f1, ap, unique_classes) — ap is (nc, n_iou).
    """
    tp = np.asarray(tp)
    conf = np.asarray(conf)
    pred_cls = np.asarray(pred_cls)
    target_cls = np.asarray(target_cls)

    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    py = []  # PR curve samples at IoU 0.5 per class
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()  # max-F1 operating point
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    base = (tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int))
    if curves:
        return base + ((px, py, p_curve, r_curve, f1_curve),)
    return base


def process_batch(detections, labels, iouv):
    """Greedy IoU matching of detections to labels at each IoU threshold
    (reference val.py:147-188).

    Args:
        detections: (n, 6) [x1, y1, x2, y2, conf, cls].
        labels: (m, 5) [cls, x1, y1, x2, y2].
        iouv: (n_iou,) IoU thresholds, e.g. 0.5:0.95:10.

    Returns:
        (n, n_iou) bool TP matrix.
    """
    detections = np.asarray(detections)
    labels = np.asarray(labels)
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return correct
    iou = np.asarray(box_iou(labels[:, 1:], detections[:, :4]))
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for i in range(len(iouv)):
        li, di = np.where((iou >= iouv[i]) & correct_class)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]  # one label per det
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]  # one det per label
            correct[matches[:, 1].astype(int), i] = True
    return correct


class ConfusionMatrix:
    """(nc+1)^2 confusion matrix including a background row/col
    (reference utils/metrics.py:124-223)."""

    def __init__(self, nc, conf=0.25, iou_thres=0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        """Accumulate one image: detections (n,6) xyxy/conf/cls, labels (m,5) cls/xyxy."""
        if detections is None or len(detections) == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
        det_classes = detections[:, 5].astype(int)
        if len(labels) == 0:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1  # background FP
            return

        iou = np.asarray(box_iou(labels[:, 1:], detections[:, :4]))
        li, di = np.where(iou > self.iou_thres)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct or cls-confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]

    def print(self):
        for i in range(self.nc + 1):
            print(" ".join(map(str, self.matrix[i])))
