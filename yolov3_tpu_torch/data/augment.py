"""Host-side augmentation (yolov3_tpu/data/augment.py): letterbox, HSV
jitter, random perspective, mosaic, mixup, cutout, copy-paste.

Every image operation goes through the host image layer (data/image_ops.py),
never OpenCV. Randomness comes from the generators the caller passes: `rng`
(a random.Random) where the JAX package calls the global `random`, and
`np_rng` (a np.random.RandomState) where it calls the global `np.random`.
Seeded alike, they replay the JAX package's draws one for one.

The letterbox rounding and the perspective matrix are kept bit-identical to
the JAX package (and its reference, augmentations.py:104-216), because they
feed scale_boxes and the trained weights.
"""

from __future__ import annotations

import math

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.ops.boxes import bbox_ioa, xywhn2xyxy


def letterbox(im, new_shape=(640, 640), color=(114, 114, 114), auto=True, scale_fill=False, scaleup=True, stride=32):
    """Aspect-preserving resize + pad to `new_shape` (or a stride multiple if auto).

    Returns (image, (rw, rh) ratio, (dw, dh) padding)."""
    shape = im.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:  # only downscale (better val mAP)
        r = min(r, 1.0)

    ratio = r, r
    new_unpad = round(shape[1] * r), round(shape[0] * r)
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # minimal rectangle: pad only to stride multiple
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = new_shape[1] / shape[1], new_shape[0] / shape[0]

    dw /= 2
    dh /= 2
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    im = image_ops.resize_pad(im, new_unpad, top, bottom, left, right, color)
    return im, ratio, (dw, dh)


class Albumentations:
    """Optional albumentations pipeline (reference augmentations.py:14-54);
    inactive when the package is missing."""

    def __init__(self, size=640):
        self.transform = None
        try:
            import albumentations as A

            self.transform = A.Compose(
                [A.Blur(p=0.01), A.MedianBlur(p=0.01), A.ToGray(p=0.01), A.CLAHE(p=0.01)],
                bbox_params=A.BboxParams(format="yolo", label_fields=["class_labels"]),
            )
        except ImportError:
            pass

    def __call__(self, im, labels, p=1.0, *, rng):
        if self.transform and rng.random() < p:
            new = self.transform(image=im, bboxes=labels[:, 1:], class_labels=labels[:, 0])
            im = new["image"]
            labels = np.array([[c, *b] for c, b in zip(new["class_labels"], new["bboxes"])], np.float32)
            if not len(labels):
                labels = np.zeros((0, 5), np.float32)
        return im, labels


def augment_hsv(im, hgain=0.5, sgain=0.5, vgain=0.5, *, np_rng):
    """In-place LUT-based HSV jitter of a BGR uint8 image (reference augmentations.py:57-73)."""
    if not (hgain or sgain or vgain):
        return
    r = np_rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = image_ops.bgr2hsv(im)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(im.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(im.dtype)
    hsv = np.stack((lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]), -1)
    image_ops.hsv2bgr(hsv, out=im)


def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Filter post-affine boxes: min size, area retention, aspect ratio sanity."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def rotation_matrix(angle, scale, center=(0.0, 0.0)):
    """cv2.getRotationMatrix2D(center, angle, scale): 2x3, angle in degrees."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def random_perspective(im, targets=(), degrees=10, translate=0.1, scale=0.1, shear=10, perspective=0.0,
                       border=(0, 0), *, rng):
    """Random composed affine (centre, perspective, rotation + scale, shear,
    translation; the C·P·R·S·T matrix of reference augmentations.py:137-216)
    on an image and its xyxy-labelled targets.

    targets: (n, 5) [cls, x1, y1, x2, y2] pixel boxes. Returns (im, targets)."""
    height = im.shape[0] + border[0] * 2
    width = im.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -im.shape[1] / 2
    C[1, 2] = -im.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = image_ops.warp_perspective(im, M, (width, height))
        else:
            im = image_ops.warp_affine(im, M[:2], (width, height))

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)  # corners
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.1)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return im, targets


def mixup(im, labels, im2, labels2, *, np_rng):
    """Beta(32,32) image blend + label union (reference augmentations.py:270-275, arxiv 1710.09412)."""
    r = np_rng.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    labels = np.concatenate((labels, labels2), 0)
    return im, labels


def copy_paste(im, labels, segments, p=0.5, *, rng):
    """Copy-paste of segment instances (reference augmentations.py:219-240,
    arxiv 2012.07177): round(p * n) instances drawn by `rng.sample`, each
    mirrored left-right, and pasted where its mirrored box overlaps every
    label by less than 30%; a pasted instance adds its label and its
    mirrored segment (a list, appended to). The paste mask is the mirrored
    polygons filled as cv2.drawContours(FILLED) fills them
    (image_ops.fill_poly). Returns (im, labels, segments); `im` is changed
    in place."""
    n = len(segments)
    if p and n:
        h, w, _ = im.shape
        mask = np.zeros(im.shape, np.uint8)
        for j in rng.sample(range(n), k=round(p * n)):
            lb, seg = labels[j], segments[j]
            box = w - lb[3], lb[2], w - lb[1], lb[4]
            ioa = bbox_ioa(np.array(box, np.float32)[None], labels[:, 1:5].astype(np.float32))[0]
            if (ioa < 0.30).all():
                labels = np.concatenate((labels, [[lb[0], *box]]), 0)
                segments.append(np.concatenate((w - seg[:, 0:1], seg[:, 1:2]), 1))
                image_ops.fill_poly(mask, segments[-1].astype(np.int32), (1, 1, 1))
        i = mask[:, ::-1].astype(bool)
        im[i] = im[:, ::-1][i]
    return im, labels, segments


def cutout(im, labels, p=0.5, *, rng):
    """Random occlusion squares; drop labels >60% obscured (reference augmentations.py:243-267)."""
    if rng.random() < p:
        h, w = im.shape[:2]
        scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
        for s in scales:
            mask_h = rng.randint(1, int(h * s))
            mask_w = rng.randint(1, int(w * s))
            xmin = max(0, rng.randint(0, w) - mask_w // 2)
            ymin = max(0, rng.randint(0, h) - mask_h // 2)
            xmax = min(w, xmin + mask_w)
            ymax = min(h, ymin + mask_h)
            im[ymin:ymax, xmin:xmax] = [rng.randint(64, 191) for _ in range(3)]
            if len(labels) and s > 0.03:
                box = np.array([xmin, ymin, xmax, ymax], np.float32)
                ioa = bbox_ioa(box[None], xywhn2xyxy(labels[:, 1:5], w, h))[0]
                labels = labels[ioa < 0.60]
    return labels


def mosaic4(images, labels_list, imgsz, mosaic_border, hyp, *, rng):
    """Compose 4 images into a 2x-canvas mosaic with a random centre
    (reference utils/dataloaders.py:764-822), then random_perspective crops
    back to imgsz. labels are (n,5) [cls, xywhn]; returns (im, labels_xyxy_pixels)."""
    s = imgsz
    yc, xc = (int(rng.uniform(-x, 2 * s + x)) for x in mosaic_border)
    labels4 = []
    im4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    for i, (im, labels) in enumerate(zip(images, labels_list)):
        h, w = im.shape[:2]
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        im4[y1a:y2a, x1a:x2a] = im[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if labels.size:
            lb = labels.copy()
            lb[:, 1:] = xywhn2xyxy(labels[:, 1:], w, h, padw, padh)
            labels4.append(lb)

    labels4 = np.concatenate(labels4, 0) if labels4 else np.zeros((0, 5), np.float32)
    np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])

    im4, labels4, _ = copy_paste(im4, labels4, [], p=hyp.get("copy_paste", 0.0), rng=rng)
    return random_perspective(
        im4,
        labels4,
        degrees=hyp.get("degrees", 0.0),
        translate=hyp.get("translate", 0.1),
        scale=hyp.get("scale", 0.5),
        shear=hyp.get("shear", 0.0),
        perspective=hyp.get("perspective", 0.0),
        border=mosaic_border,
        rng=rng,
    )
