"""The numbers that decide `correct`, each computed from the program's
outputs and the plain reference's.

Detections (serving, streaming, validation). Per image, each reference
detection is paired, from the highest conf down, with the unpaired program
detection that overlaps it most, if that IoU is at least 0.5 (or, for boxes
clipped to no area at the frame's edge, if every coordinate is within a
pixel). A detection
weighs its conf's excess over the threshold the path applies: one that sits
just above the threshold on one side and just below it on the other weighs
next to nothing, as rounding should, and a confident one that has no
partner weighs much.
    unmatched    the share of the weight, of both sides, without a partner
    class_flips  the share of pairs whose classes differ
    conf_gap     the largest conf difference of a pair
    conf_gap_mean  the mean conf difference of the pairs
    box_gap      the largest coordinate difference of a pair, in pixels

Each cell's workload file names, under `check`, the numbers it compares and
their limits; the others are noted beside them.

Training. Per parameter leaf, the norm on each side and the gap between
them over the reference's norm of that leaf or of the median leaf,
whichever is larger; the worst leaf counts. Leaves whose reference gradient
is under a thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import numpy as np

PAIR_IOU = 0.5


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def pair_image(got, want, same_class=False):
    """Pairs (i_got, i_want) of one image's (n, 6) [x1, y1, x2, y2, conf, cls] rows:
    whatever their classes, or (multi-label detections) of one class."""
    if not len(got) or not len(want):
        return []
    iou = _iou(want[:, :4], got[:, :4])
    near = np.abs(want[:, None, :4] - got[None, :, :4]).max(-1) <= 1.0
    iou = np.where(near, np.maximum(iou, PAIR_IOU), iou)
    if same_class:
        iou[want[:, 5][:, None] != got[:, 5][None, :]] = 0.0
    free = np.ones(len(got), bool)
    pairs = []
    for w in np.argsort(-want[:, 4], kind="stable"):
        cand = np.where(free, iou[w], 0.0)
        g = int(cand.argmax())
        if cand[g] >= PAIR_IOU:
            free[g] = False
            pairs.append((g, w))
    return pairs


def detection_gaps(got_list, want_list, conf_thres, same_class=False):
    """dict(unmatched, class_flips, conf_gap, box_gap, counted, pairs) over images."""
    counted = unmatched = conf_sum = 0.0
    flips = n_pairs = 0
    conf_gap = box_gap = 0.0
    for got, want in zip(got_list, want_list):
        got, want = np.asarray(got, np.float64).reshape(-1, 6), np.asarray(want, np.float64).reshape(-1, 6)
        pairs = pair_image(got, want, same_class)
        pg = np.zeros(len(got), bool)
        pw = np.zeros(len(want), bool)
        n_pairs += len(pairs)
        for g, w in pairs:
            pg[g] = pw[w] = True
            flips += int(got[g, 5] != want[w, 5])
            conf_gap = max(conf_gap, abs(got[g, 4] - want[w, 4]))
            conf_sum += abs(got[g, 4] - want[w, 4])
            box_gap = max(box_gap, float(np.abs(got[g, :4] - want[w, :4]).max()))
        wg, ww = np.clip(got[:, 4] - conf_thres, 0, None), np.clip(want[:, 4] - conf_thres, 0, None)
        counted += float(wg.sum() + ww.sum())
        unmatched += float(wg[~pg].sum() + ww[~pw].sum())
    return dict(unmatched=unmatched / max(counted, 1e-12), class_flips=flips / max(n_pairs, 1), conf_gap=conf_gap,
                conf_gap_mean=conf_sum / max(n_pairs, 1), box_gap=box_gap, weight=counted, pairs=n_pairs)


def leaf_gaps(got, want, keep=None):
    """{leaf: |norm(got) - norm(want)| / max(norm(want), median leaf norm)} over
    {name: norm} dicts, for the leaves in `keep`."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names}


def moving_leaves(grad_norms):
    """Leaves whose reference gradient norm is at least a thousandth of the median leaf's."""
    med = float(np.median(list(grad_norms.values())))
    return {n for n, v in grad_norms.items() if v >= 1e-3 * med}


def check(run, gaps):
    """Hold the run to the cell's limits: every number its workload's `check` names."""
    for name, limit in run.workload["check"].items():
        run.check(name, gaps[name], limit)
    return gaps


def check_detections(run, got, want, same_class=False):
    gaps = detection_gaps(got, want, run.workload["conf_thres"], same_class)
    run.note(f"compared {len(want)} frames: {gaps}")
    return check(run, gaps)
