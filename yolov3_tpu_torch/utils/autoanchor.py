"""AutoAnchor: anchor fit check + k-means / genetic refit
(yolov3_tpu/utils/autoanchor.py, reference utils/autoanchor.py:27-164).

numpy + scipy on the host. The metric is best-possible recall (BPR) of the
dataset's box sizes against the anchors under the loss's ratio test
(max(r, 1/r) < anchor_t). The JAX package draws from the global np.random;
here the draws come from the `np_rng` (a np.random.RandomState) the caller
passes, scipy's k-means seed included.
"""

from __future__ import annotations

import numpy as np

from yolov3_tpu_torch.utils.general import LOGGER


def anchor_metrics(wh, anchors, thr=4.0):
    """Return (bpr, aat): best-possible recall and anchors-above-threshold/target."""
    r = wh[:, None] / anchors[None]  # (n, na, 2)
    x = np.minimum(r, 1 / r).min(2)  # ratio metric per anchor
    best = x.max(1)
    aat = (x > 1 / thr).sum(1).mean()
    bpr = (best > 1 / thr).mean()
    return bpr, aat


def check_anchors(dataset, model_spec, thr=4.0, imgsz=640, *, np_rng):
    """Check the anchors' fit on a dataset; returns new pixel anchors if a
    k-means refit improves BPR (reference autoanchor.py:27-64), else None."""
    shapes = imgsz * dataset.shapes / dataset.shapes.max(1, keepdims=True)
    scale = np_rng.uniform(0.9, 1.1, size=(shapes.shape[0], 1))
    wh = np.concatenate(
        [lb[:, 3:5] * s for s, lb in zip(shapes * scale, dataset.labels) if len(lb)], 0
    ).astype(np.float32)

    anchors = np.array(model_spec.anchors, np.float32).reshape(-1, 2)
    bpr, aat = anchor_metrics(wh, anchors, thr)
    LOGGER.info(f"AutoAnchor: {aat:.2f} anchors/target, {bpr:.3f} Best Possible Recall (BPR)")
    if bpr > 0.98:
        LOGGER.info("AutoAnchor: current anchors are a good fit to dataset")
        return None
    LOGGER.info("AutoAnchor: anchors are a poor fit, attempting to improve...")
    new = kmean_anchors(wh, n=anchors.shape[0], thr=thr, gen=1000, np_rng=np_rng)
    new_bpr, _ = anchor_metrics(wh, new, thr)
    if new_bpr > bpr:
        LOGGER.info(f"AutoAnchor: new anchors (BPR {new_bpr:.3f}) replace original (BPR {bpr:.3f})")
        return new
    LOGGER.info("AutoAnchor: original anchors retained (better BPR)")
    return None


def _anchor_fitness(wh, anchors, thr):
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1 / r).min(2)
    best = x.max(1)
    return (best * (best > 1 / thr)).mean()


def kmean_anchors(wh, n=9, thr=4.0, gen=1000, verbose=False, *, np_rng):
    """Whitened k-means seed + genetic evolution on anchor fitness
    (reference autoanchor.py:67-164)."""
    from scipy.cluster.vq import kmeans

    wh = wh[(wh >= 2.0).any(1)]  # drop tiny boxes (<2px)
    s = wh.std(0)
    try:
        k = kmeans(wh / s, n, iter=30, seed=np_rng)[0] * s
        assert n == len(k)
    except Exception:  # noqa: BLE001
        k = np.sort(np_rng.rand(n * 2)).reshape(n, 2) * wh.mean()
    k = k[np.argsort(k.prod(1))]

    f = _anchor_fitness(wh, k, thr)
    sh = k.shape
    mp, sigma = 0.9, 0.1  # mutation probability / scale
    rng = np.random.default_rng(0)
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            # noise centred at 1: genes that do not mutate stay exactly 1
            v = ((rng.random(sh) < mp) * rng.random() * rng.normal(0, sigma, sh) + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = _anchor_fitness(wh, kg, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        LOGGER.info(f"AutoAnchor: evolved anchors, fitness={f:.4f}")
    return k.astype(np.float32)
