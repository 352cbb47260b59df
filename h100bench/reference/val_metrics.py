"""Plain mAP of detections against labels (ultralytics val.py process_batch,
utils/metrics.py ap_per_class and compute_ap): a detection is a true
positive at an IoU threshold when it takes, in order of IoU, a label of its
class not yet taken; AP per class is the area under the precision envelope
over 101 recall points; P and R at the conf of the best smoothed mean F1.
"""

from __future__ import annotations

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def box_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(2)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def process_batch(dets, labels, iouv=IOUV):
    """dets (n, 6) [x1, y1, x2, y2, conf, cls]; labels (m, 5) [cls, x1, y1, x2, y2]
    -> (n, len(iouv)) bool true positives."""
    correct = np.zeros((len(dets), len(iouv)), bool)
    if not len(dets) or not len(labels):
        return correct
    iou = box_iou(labels[:, 1:], dets[:, :4])
    same = labels[:, 0:1] == dets[:, 5]
    for i, t in enumerate(iouv):
        x = np.where((iou >= t) & same)
        if x[0].shape[0]:
            m = np.concatenate([np.stack(x, 1), iou[x[0], x[1]][:, None]], 1)
            if x[0].shape[0] > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1].astype(int), i] = True
    return correct


def _compute_ap(recall, precision):
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    y = np.interp(x, mrec, mpre)
    return float(np.sum((y[1:] + y[:-1]) / 2 * np.diff(x)))


def _smooth(y, f=0.1):
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    return np.convolve(np.concatenate((p * y[0], y, p * y[-1]), 0), np.ones(nf) / nf, mode="valid")


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16):
    """(P, R, AP (classes, 10)) at the best mean F1, per class with labels."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    classes, nt = np.unique(target_cls, return_counts=True)
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((len(classes), tp.shape[1]))
    p, r = np.zeros((len(classes), 1000)), np.zeros((len(classes), 1000))
    for ci, c in enumerate(classes):
        i = pred_cls == c
        n_l, n_p = nt[ci], i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = _compute_ap(recall[:, j], precision[:, j])
    f1 = 2 * p * r / (p + r + eps)
    k = _smooth(f1.mean(0), 0.1).argmax()
    return p[:, k], r[:, k], ap


def mean_ap(stats):
    """(mp, mr, map50, map50-95) of [(tp, conf, cls, label classes)] per image."""
    tp, conf, pcls, tcls = (np.concatenate([s[i] for s in stats], 0) for i in range(4))
    if not len(tp) or not tp.any():
        return 0.0, 0.0, 0.0, 0.0
    p, r, ap = ap_per_class(tp, conf, pcls, tcls)
    return float(p.mean()), float(r.mean()), float(ap[:, 0].mean()), float(ap.mean(1).mean())
