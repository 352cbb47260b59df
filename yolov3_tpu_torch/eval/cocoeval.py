"""In-tree COCO bbox evaluation with pycocotools semantics: the port's own
copy of yolov3_tpu/eval/cocoeval.py.

The reference shells out to pycocotools for the final COCO-JSON eval
(reference val.py:454-479). This module re-implements the bbox COCOeval
pipeline (evaluate -> accumulate -> summarize, Params defaults: iouThrs
0.5:0.05:0.95, recThrs 0:0.01:1, area all/small/medium/large, maxDets
1/10/100) in numpy; the port's `eval.validator._coco_eval` always uses it.

Semantics mirrored from the published pycocotools algorithm:
  - per-(image, category) greedy matching in descending score order, each
    detection taking the best still-unmatched IoU>thr gt; crowd gts can be
    matched repeatedly and use IoU = inter / dt_area;
  - gts outside the area range (or flagged ignore/iscrowd) are ignored;
    detections matched to ignored gts, or unmatched and outside the area
    range, are ignored rather than counted as FPs;
  - precision envelope (running max from the right) sampled at 101 recall
    thresholds; AP averages only entries with at least one gt.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _load(x):
    if isinstance(x, (str, Path)):
        with open(x) as f:
            return json.load(f)
    return x


def _bbox_iou_matrix(dt, gt, iscrowd):
    """IoU of (D,4) vs (G,4) xywh boxes; crowd columns use inter/dt_area."""
    if not len(dt) or not len(gt):
        return np.zeros((len(dt), len(gt)))
    dt = np.asarray(dt, np.float64)
    gt = np.asarray(gt, np.float64)
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, :2] + dt[:, None, 2:4], gt[None, :, :2] + gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = dt[:, 2] * dt[:, 3]
    area_g = gt[:, 2] * gt[:, 3]
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(np.asarray(iscrowd, bool)[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-10)


class COCOBboxEval:
    """evaluate() + accumulate() + summarize() for bbox detections.

    gt: COCO annotations dict/path ({images, annotations, categories}).
    dt: list/path of detections [{image_id, category_id, bbox, score}].
    """

    def __init__(self, gt, dt):
        gt = _load(gt)
        dt = _load(dt)
        self.img_ids = sorted({im["id"] for im in gt.get("images", [])})
        self.cat_ids = sorted({c["id"] for c in gt.get("categories", [])})
        self._gts = defaultdict(list)
        for a in gt.get("annotations", []):
            a.setdefault("iscrowd", 0)
            a.setdefault("area", a["bbox"][2] * a["bbox"][3])
            a.setdefault("ignore", 0)
            self._gts[(a["image_id"], a["category_id"])].append(a)
        self._dts = defaultdict(list)
        known = set(self.img_ids)
        for d in dt:
            if d["image_id"] in known:
                self._dts[(d["image_id"], d["category_id"])].append(d)
        self.precision = None  # (T, R, K, A, M)
        self.recall = None  # (T, K, A, M)
        self.stats = None
        self._iou_cache = {}  # (img_id, cat_id) -> (sorted dts, ious) — like pycocotools self.ious

    # -- evaluate ----------------------------------------------------------
    def _ious_for(self, img_id, cat_id):
        """Score-sorted dts (truncated to maxDets[-1]) + IoU matrix vs gts in
        original order; computed once per (image, category) and reused across
        the 4 area ranges (pycocotools caches identically in computeIoU)."""
        key = (img_id, cat_id)
        if key not in self._iou_cache:
            gts = self._gts[key]
            dts_all = self._dts[key]
            d_ord = np.argsort([-d["score"] for d in dts_all], kind="stable")[: MAX_DETS[-1]]
            dts = [dts_all[i] for i in d_ord]
            iscrowd = [int(g["iscrowd"]) for g in gts]
            ious = _bbox_iou_matrix([d["bbox"] for d in dts], [g["bbox"] for g in gts], iscrowd)
            self._iou_cache[key] = (dts, ious)
        return self._iou_cache[key]

    def _evaluate_img(self, img_id, cat_id, arng, max_det):
        gts = self._gts[(img_id, cat_id)]
        dts, ious_full = self._ious_for(img_id, cat_id)
        if not gts and not dts:
            return None
        # inclusive bounds on both ends: pycocotools ignores only if
        # area < lo or area > hi, so area == 32**2 lands in "small"
        gt_ig = np.array(
            [g["ignore"] or g["iscrowd"] or g["area"] < arng[0] or g["area"] > arng[1] for g in gts],
            dtype=bool,
        )
        # sort gts ignored-last (stable); dts already score-sorted in the cache
        g_ord = np.argsort(gt_ig, kind="stable")
        gts = [gts[i] for i in g_ord]
        gt_ig = gt_ig[g_ord]
        dts = dts[:max_det]
        iscrowd = [int(g["iscrowd"]) for g in gts]
        ious = ious_full[: len(dts)][:, g_ord] if ious_full.size else ious_full[: len(dts)]

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        gtm = np.zeros((T, G), dtype=np.int64)
        dtm = np.zeros((T, D), dtype=np.int64)
        dt_ig = np.zeros((T, D), dtype=bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gtm[ti, gi] > 0 and not iscrowd[gi]:
                        continue  # gt already consumed (crowds are reusable)
                    if m > -1 and not gt_ig[m] and gt_ig[gi]:
                        break  # have a real match; rest are ignored gts
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dtm[ti, di] = gts[m]["id"] if "id" in gts[m] else m + 1
                gtm[ti, m] = 1
        # unmatched dts outside the area range are ignored, not FPs
        d_out = np.array(
            [d["bbox"][2] * d["bbox"][3] < arng[0] or d["bbox"][2] * d["bbox"][3] > arng[1] for d in dts],
            dtype=bool,
        )
        dt_ig |= (dtm == 0) & d_out[None, :]
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dtm": dtm,
            "dt_ig": dt_ig,
            "n_gt": int((~gt_ig).sum()),
        }

    def accumulate(self):
        K, A, M, T, R = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS), len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, arng in enumerate(AREA_RNG.values()):
                # evaluate at the largest maxDet, truncate per M below
                evals = [self._evaluate_img(i, cat, arng, MAX_DETS[-1]) for i in self.img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                npig = sum(e["n_gt"] for e in evals)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate([e["dt_scores"][:max_det] for e in evals])
                    order = np.argsort(-scores, kind="stable")
                    dtm = np.concatenate([e["dtm"][:, :max_det] for e in evals], axis=1)[:, order]
                    dt_ig = np.concatenate([e["dt_ig"][:, :max_det] for e in evals], axis=1)[:, order]
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        q = np.zeros(R)
                        # precision envelope: running max from the right
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[:, :, ki, ai, mi][ti] = q
        self.precision, self.recall = precision, recall
        return self

    def _summary(self, ap=True, iou=None, area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        s = self.precision[..., ai, mi] if ap else self.recall[..., ai, mi]
        if iou is not None:
            s = s[np.isclose(IOU_THRS, iou)]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self, verbose=True):
        """The 12 standard COCO stats; stats[0]=mAP50-95, stats[1]=mAP50."""
        self.stats = [
            self._summary(True),
            self._summary(True, iou=0.5),
            self._summary(True, iou=0.75),
            self._summary(True, area="small"),
            self._summary(True, area="medium"),
            self._summary(True, area="large"),
            self._summary(False, max_det=1),
            self._summary(False, max_det=10),
            self._summary(False, max_det=100),
            self._summary(False, area="small"),
            self._summary(False, area="medium"),
            self._summary(False, area="large"),
        ]
        if verbose:
            names = [
                "AP@[.5:.95]", "AP@.5", "AP@.75", "AP small", "AP medium", "AP large",
                "AR maxDet=1", "AR maxDet=10", "AR maxDet=100", "AR small", "AR medium", "AR large",
            ]
            for n, v in zip(names, self.stats):
                print(f"  {n:<14} = {v:.3f}")
        return self.stats


def evaluate_coco_json(anno_json, pred_json, verbose=True):
    """Convenience: returns (mAP50-95, mAP50) like the pycocotools path."""
    ev = COCOBboxEval(anno_json, pred_json).accumulate()
    stats = ev.summarize(verbose=verbose)
    return stats[0], stats[1]
