"""Synthetic shapes dataset: a seeded stand-in for coco128 that needs no
download (yolov3_tpu/data/synthetic.py).

Coloured circles, squares, triangles, rings and crosses on a textured
background with exact YOLO labels, in the images/ + labels/ layout, written
as PNG through the host image layer. The shapes are drawn with numpy masks,
so the pixels are not those of the JAX package's cv2-drawn JPEGs; the
layout, the labels' meaning and `dataset.yaml` are the same.

    python -m yolov3_tpu_torch.data.synthetic --out ../datasets/shapes128 --n 128
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.utils.general import LOGGER, yaml_save

CLASSES = ("circle", "square", "triangle", "ring", "cross")


def shape_mask(cls, r):
    """(2r+1, 2r+1) bool mask of one shape of half-size r, centred."""
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    if cls == 0:  # circle
        return dx * dx + dy * dy <= r * r
    if cls == 1:  # square
        return np.ones_like(dx, bool)
    if cls == 2:  # triangle: apex (0, -r), base from (-r, r) to (r, r)
        return (2 * dx <= dy + r) & (-2 * dx <= dy + r)
    t = max(2, r // 3)
    if cls == 3:  # ring
        d2 = dx * dx + dy * dy
        return (d2 <= r * r) & (d2 >= (r - t) * (r - t))
    return (np.abs(dy) <= t) | (np.abs(dx) <= t)  # cross


def _write_split(out, split, n_images, imgsz, max_objects, rng, pool):
    img_dir, lbl_dir = out / "images" / split, out / "labels" / split
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    writes = []
    for i in range(n_images):
        h = int(rng.integers(imgsz * 3 // 4, imgsz * 5 // 4))
        w = int(rng.integers(imgsz * 3 // 4, imgsz * 5 // 4))
        im = image_ops.resize_linear(rng.integers(60, 190, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
        lines = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls = int(rng.integers(0, len(CLASSES)))
            r = int(rng.integers(max(6, imgsz // 24), imgsz // 5))
            cx = int(rng.integers(r, w - r))
            cy = int(rng.integers(r, h - r))
            color = rng.integers(0, 255, 3).astype(np.uint8)
            im[cy - r : cy + r + 1, cx - r : cx + r + 1][shape_mask(cls, r)] = color
            lines.append(f"{cls} {cx / w:.6f} {cy / h:.6f} {2 * r / w:.6f} {2 * r / h:.6f}")
        im = np.clip(im.astype(np.int16) + rng.normal(0, 6, im.shape), 0, 255).astype(np.uint8)
        # the draws above stay in order; encoding (zlib, which releases the GIL) runs on the pool
        writes.append(pool.submit(image_ops.imwrite_png, img_dir / f"{i:05d}.png", im, 1))
        (lbl_dir / f"{i:05d}.txt").write_text("\n".join(lines))
    for f in writes:
        f.result()


def generate(out_dir, n_images=128, imgsz=320, max_objects=6, seed=0, split="train", n_val=0):
    """Write the dataset and its dataset.yaml; returns the dataset dict.

    `n_images` go to images/<split>. With n_val > 0, n_val more images go
    to images/val and are the val split; otherwise val is <split> itself."""
    out = Path(out_dir)
    rng = np.random.default_rng(seed)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        _write_split(out, split, n_images, imgsz, max_objects, rng, pool)
        if n_val:
            _write_split(out, "val", n_val, imgsz, max_objects, rng, pool)
    data = {
        "path": str(out.resolve()),
        "train": f"images/{split}",
        "val": "images/val" if n_val else f"images/{split}",
        "names": dict(enumerate(CLASSES)),
    }
    yaml_save(out / "dataset.yaml", data)
    LOGGER.info(f"synthetic shapes dataset: {n_images + n_val} images -> {out}")
    return data


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="../datasets/shapes128")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--n-val", type=int, default=0)
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    generate(a.out, a.n, a.imgsz, seed=a.seed, n_val=a.n_val)
